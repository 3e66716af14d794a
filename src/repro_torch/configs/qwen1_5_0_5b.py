"""qwen1.5-0.5b [dense] — QKV bias, full attention.

24L d_model=1024 16H (GQA kv=16, i.e. MHA) d_ff=2816 vocab=151936, head_dim=64.
[hf:Qwen/Qwen1.5-0.5B; hf].
"""
from repro_torch.models.config import ArchConfig, GLOBAL_ATTN

CONFIG = ArchConfig(
    name="qwen1.5-0.5b",
    family="dense",
    n_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    d_ff=2816,
    vocab_size=151_936,
    head_dim=64,
    attn_pattern=(GLOBAL_ATTN,),
    qkv_bias=True,
    mlp="swiglu",
    rope_theta=1_000_000.0,
    tie_embeddings=True,
)
