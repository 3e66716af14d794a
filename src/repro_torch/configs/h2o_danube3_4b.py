"""h2o-danube-3-4b [dense] — llama+mistral mix with sliding-window attention.

24L d_model=3840 32H (GQA kv=8) d_ff=10240 vocab=32000, head_dim=120.
[arXiv:2401.16818; unverified]. SWA window 4096 on all layers (mistral-style).
"""
from repro_torch.models.config import ArchConfig, LOCAL_ATTN

CONFIG = ArchConfig(
    name="h2o-danube3-4b",
    family="dense",
    n_layers=24,
    d_model=3840,
    n_heads=32,
    n_kv_heads=8,
    d_ff=10240,
    vocab_size=32_000,
    head_dim=120,
    attn_pattern=(LOCAL_ATTN,),
    window=4096,
    mlp="swiglu",
    rope_theta=10_000.0,
    tie_embeddings=False,
)
