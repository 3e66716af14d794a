"""recurrentgemma-2b [hybrid] — RG-LRU + local attention, 2:1 (Griffin).

26L d_model=2560 10H (GQA kv=1, i.e. MQA) d_ff=7680 vocab=256000, head_dim=256.
[arXiv:2402.19427; hf]. Pattern (recurrent, recurrent, local-attn); 26 = 8x3 + 2
remainder recurrent layers. lru_width=2560, local window 2048.
"""
from repro_torch.models.config import ArchConfig, RECURRENT, LOCAL_ATTN

CONFIG = ArchConfig(
    name="recurrentgemma-2b",
    family="hybrid",
    n_layers=26,
    d_model=2560,
    n_heads=10,
    n_kv_heads=1,
    d_ff=7680,
    vocab_size=256_000,
    head_dim=256,
    attn_pattern=(RECURRENT, RECURRENT, LOCAL_ATTN),
    window=2048,
    lru_width=2560,
    conv1d_width=4,
    mlp="geglu",
    tie_embeddings=True,
    emb_scale=True,
)
