"""internvl2-1b [vlm] — InternViT frontend (STUB) + qwen2-0.5b-class LM backbone.

24L d_model=896 14H (GQA kv=2) d_ff=4864 vocab=151655, head_dim=64.
[arXiv:2404.16821; hf]. Per the assignment the vision frontend is a stub:
``input_specs()`` supplies precomputed (batch, n_patches, d_model) patch embeddings
prepended to the token embeddings.
"""
from repro_torch.models.config import ArchConfig, GLOBAL_ATTN

CONFIG = ArchConfig(
    name="internvl2-1b",
    family="vlm",
    n_layers=24,
    d_model=896,
    n_heads=14,
    n_kv_heads=2,
    d_ff=4864,
    vocab_size=151_655,
    head_dim=64,
    attn_pattern=(GLOBAL_ATTN,),
    qkv_bias=True,
    mlp="swiglu",
    frontend="vision_patches",
    n_frontend_tokens=256,   # one 448x448 tile -> 256 visual tokens after pixel-shuffle
    rope_theta=1_000_000.0,
    tie_embeddings=True,
)
