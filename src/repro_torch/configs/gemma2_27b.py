"""gemma2-27b [dense] — local+global alternating attention, logit softcaps.

46L d_model=4608 32H (GQA kv=16) d_ff=36864 vocab=256000, head_dim=128.
[arXiv:2408.00118; hf]. Window 4096 on local layers; attn softcap 50, final softcap 30.
"""
from repro_torch.models.config import ArchConfig, LOCAL_ATTN, GLOBAL_ATTN

CONFIG = ArchConfig(
    name="gemma2-27b",
    family="dense",
    n_layers=46,
    d_model=4608,
    n_heads=32,
    n_kv_heads=16,
    d_ff=36864,
    vocab_size=256_000,
    head_dim=128,
    attn_pattern=(LOCAL_ATTN, GLOBAL_ATTN),
    window=4096,
    attn_logit_softcap=50.0,
    final_logit_softcap=30.0,
    mlp="geglu",
    rope_theta=10_000.0,
    tie_embeddings=True,
    emb_scale=True,
)
