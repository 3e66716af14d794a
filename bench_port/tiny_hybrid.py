"""A family for the benchmark's CPU tests only, whose layers differ: Mamba-1
layers (``reference/mamba1.py``) and GQA attention layers with a SwiGLU MLP
(``reference/dense_gqa.py``) in the port's pattern ``("ssm", "ssm", "ssm",
"local")``. No configuration of ``BENCHMARK.json`` uses it. It shows that the
seeded weights, the reference and the restore check follow a model whose
layers differ, laid out as the port lays out a pattern: one stacked dict a
pattern position, the remainder layers unstacked. Its configuration names
the Mamba mixer's widths with Jamba's keys (``mamba_d_state``, ...)."""
from __future__ import annotations

import torch

from bench_port.reference import dense_gqa, mamba1

PATTERN = ("ssm", "ssm", "ssm", "local")

#: one pattern unit and two remainder layers, at the tests' tiny widths
CONFIG = {
    "name": "tiny-hybrid", "family": "tiny_hybrid", "num_hidden_layers": 6,
    "hidden_size": 64, "intermediate_size": 128, "num_attention_heads": 4,
    "num_key_value_heads": 2, "head_dim": 16, "mamba_d_state": 4, "mamba_d_conv": 4,
    "mamba_expand": 2, "mamba_dt_rank": 4, "time_step_min": 0.001, "time_step_max": 0.1,
    "vocab_size": 256, "rms_norm_eps": 1e-05, "rope_theta": 10000.0, "sliding_window": 16,
    "tie_word_embeddings": False, "torch_dtype": "bfloat16", "live_instance_cap": 2,
    "limits": {"logit_rms_gap": 0.03, "answer_rms_gap_max": 0.08}}


def _mixer(c: dict) -> dict:
    """The configuration as ``mamba1`` reads it."""
    return dict(c, intermediate_size=c["mamba_expand"] * c["hidden_size"],
                state_size=c["mamba_d_state"], conv_kernel=c["mamba_d_conv"],
                time_step_rank=c["mamba_dt_rank"], layer_norm_epsilon=c["rms_norm_eps"])


def norm_eps(c: dict) -> float:
    return c["rms_norm_eps"]


def _is_ssm(i: int) -> bool:
    """Whether layer ``i`` is a Mamba-1 layer: the pattern, cycled."""
    return PATTERN[i % len(PATTERN)] == "ssm"


def port_arch(c: dict) -> dict:
    """The port's ``ArchConfig`` fields for this configuration."""
    f = dense_gqa.port_arch(c)
    f.update(family="hybrid", attn_pattern=PATTERN, ssm_state=c["mamba_d_state"],
             d_conv=c["mamba_d_conv"], expand=c["mamba_expand"], dt_rank=c["mamba_dt_rank"])
    return f


def layer_leaves(c: dict, i: int):
    """Layer ``i``'s leaves: a Mamba-1 layer's or an attention layer's."""
    if _is_ssm(i):
        return mamba1.layer_leaves(_mixer(c), i)
    return dense_gqa.layer_leaves(c, i)


def block(w: dict, x: torch.Tensor, c: dict, product, i: int) -> torch.Tensor:
    """Layer ``i`` on x (L, d_model), fp32."""
    if _is_ssm(i):
        return mamba1.block(w, x, _mixer(c), product, i)
    return dense_gqa.block(w, x, c, product, i)
