"""fnbench-tiny — paper-workload analogue (FunctionBench, Table 1).

A small dense LM standing in for the `rnn_serving`-class serverless workload used in
the paper's evaluation and sharing case study (Fig. 7). Small enough to run real
cold-start measurements on CPU; big enough that dependency loading dominates.
"""
from repro_torch.models.config import ArchConfig, GLOBAL_ATTN

CONFIG = ArchConfig(
    name="fnbench-tiny",
    family="dense",
    n_layers=4,
    d_model=256,
    n_heads=4,
    n_kv_heads=2,
    d_ff=1024,
    vocab_size=2048,
    head_dim=64,
    attn_pattern=(GLOBAL_ATTN,),
    mlp="swiglu",
    tie_embeddings=True,
    max_seq_len=4096,
)
