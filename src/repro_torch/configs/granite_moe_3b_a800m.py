"""granite-moe-3b-a800m [moe] — 40 experts top-8.

32L d_model=1536 24H (GQA kv=8) d_ff=512/expert vocab=49155, head_dim=64.
[hf:ibm-granite/granite-3.0 family; hf]. NOTE: the assignment header says
"MoE 40e top-8" while the trailing note says "32 experts"; we follow the primary
spec field (40 experts, top-8). 40 % 16 != 0, so experts are TP-sharded along the
expert hidden dim rather than EP-sharded (see DESIGN.md §5).
"""
from repro_torch.models.config import ArchConfig, GLOBAL_ATTN

CONFIG = ArchConfig(
    name="granite-moe-3b-a800m",
    family="moe",
    n_layers=32,
    d_model=1536,
    n_heads=24,
    n_kv_heads=8,
    d_ff=512,
    vocab_size=49_155,
    head_dim=64,
    attn_pattern=(GLOBAL_ATTN,),
    n_experts=40,
    top_k=8,
    # perf iteration B: pad expert tensors to 48 (%16==0) for clean expert
    # parallelism on the production mesh — see EXPERIMENTS.md §Perf
    expert_pad_to=48,
    mlp="swiglu",
    tie_embeddings=True,
)
