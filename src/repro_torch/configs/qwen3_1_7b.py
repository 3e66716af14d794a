"""qwen3-1.7b [dense] — qk_norm, GQA.

28L d_model=2048 16H (GQA kv=8) d_ff=6144 vocab=151936, head_dim=128.
[hf:Qwen/Qwen3-8B family; hf].
"""
from repro_torch.models.config import ArchConfig, GLOBAL_ATTN

CONFIG = ArchConfig(
    name="qwen3-1.7b",
    family="dense",
    n_layers=28,
    d_model=2048,
    n_heads=16,
    n_kv_heads=8,
    d_ff=6144,
    vocab_size=151_936,
    head_dim=128,
    attn_pattern=(GLOBAL_ATTN,),
    qk_norm=True,
    mlp="swiglu",
    rope_theta=1_000_000.0,
    tie_embeddings=True,
)
