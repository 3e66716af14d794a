"""moonshot-v1-16b-a3b [moe] — kimi/moonlight-style, 64 experts top-6.

48L d_model=2048 16H (GQA kv=16) d_ff=1408/expert vocab=163840, head_dim=128.
[hf:moonshotai/Moonlight-16B-A3B; hf]. 64 % 16 == 0 -> true expert parallelism
over the `model` mesh axis.
"""
from repro_torch.models.config import ArchConfig, GLOBAL_ATTN

CONFIG = ArchConfig(
    name="moonshot-v1-16b-a3b",
    family="moe",
    n_layers=48,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=1408,
    vocab_size=163_840,
    head_dim=128,
    attn_pattern=(GLOBAL_ATTN,),
    n_experts=64,
    top_k=6,
    mlp="swiglu",
    tie_embeddings=False,
)
