"""falcon-mamba-7b [ssm] — Mamba-1, attention-free.

64L d_model=4096 d_ff=0 vocab=65024, ssm_state=16, expand=2 (d_inner=8192),
d_conv=4, dt_rank=256. [arXiv:2410.05355; unverified].
"""
from repro_torch.models.config import ArchConfig, SSM

CONFIG = ArchConfig(
    name="falcon-mamba-7b",
    family="ssm",
    n_layers=64,
    d_model=4096,
    n_heads=1,          # unused (attention-free)
    n_kv_heads=1,
    d_ff=0,             # mamba block subsumes the MLP
    vocab_size=65_024,
    attn_pattern=(SSM,),
    ssm_state=16,
    d_conv=4,
    expand=2,
    mlp="swiglu",       # unused
    tie_embeddings=False,
)
