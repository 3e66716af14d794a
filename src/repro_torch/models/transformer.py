"""Dense decoder-only transformer: init and prefill forward.

Port of ``repro.models.transformer`` for the dense family: GLOBAL/LOCAL
attention layers with a dense MLP. Parameters keep the reference layout, so a
page table built by either package names the same leaves: one repeating
pattern unit stacked along a leading ``n_units`` axis in ``params["unit"]``
(a tuple, one dict per pattern position), remainder layers in
``params["rem"]``. JAX's ``vmap`` init draws the stacked leaves directly
here, and its ``lax.scan`` over units is a Python loop that indexes the
stacked leaves by unit.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional

import torch

from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.models import attention as attn
from repro_torch.models.config import GLOBAL_ATTN, LOCAL_ATTN, ArchConfig
from repro_torch.models.layers import (
    embed_tokens,
    init_embedding,
    init_mlp,
    init_rmsnorm,
    mlp,
    rmsnorm,
    unembed,
)


def check_supported(cfg: ArchConfig) -> None:
    """Raise for the configurations this slice of the port does not run."""
    if (cfg.family not in ("dense",) or cfg.n_experts > 0 or cfg.is_encoder_decoder
            or cfg.frontend is not None
            or any(t not in (GLOBAL_ATTN, LOCAL_ATTN) for t in cfg.attn_pattern)):
        raise NotImplementedError(
            f"{cfg.name}: only the dense family (global/local attention, dense "
            "MLP) is ported; SSM, RG-LRU, MoE, encoder-decoder and VLM configs "
            "wait for ROADMAP.md queue 1, 'Other architectures'")


def _init_layer(gen: torch.Generator, cfg: ArchConfig, dtype, lead=()) -> Dict[str, Any]:
    return {
        "ln1": init_rmsnorm(gen, cfg.d_model, dtype, lead),
        "attn": attn.init_attention(gen, cfg, dtype, lead),
        "ln2": init_rmsnorm(gen, cfg.d_model, dtype, lead),
        "mlp": init_mlp(gen, cfg, dtype, lead),
    }


def init_params(gen: torch.Generator, cfg: ArchConfig,
                dtype=torch.bfloat16) -> Dict[str, Any]:
    """Random parameters on ``gen.device``, drawn from ``gen``."""
    check_supported(cfg)
    lead = (cfg.n_pattern_units,)
    return {
        "embed": init_embedding(gen, cfg, dtype),
        "final_norm": init_rmsnorm(gen, cfg.d_model, dtype),
        "unit": tuple(_init_layer(gen, cfg, dtype, lead) for _ in cfg.attn_pattern),
        "rem": tuple(_init_layer(gen, cfg, dtype)
                     for _ in range(cfg.n_remainder_layers)),
    }


def _index(tree: Any, i: int) -> Any:
    if isinstance(tree, dict):
        return {k: _index(v, i) for k, v in tree.items()}
    return tree[i]


def _apply_layer(p: Dict[str, Any], x: torch.Tensor, cfg: ArchConfig, ltype: str,
                 positions: torch.Tensor, attention_fn: Callable) -> torch.Tensor:
    h = rmsnorm(p["ln1"], x, cfg.norm_eps)
    x = x + attn.attention_prefill(p["attn"], h, cfg, ltype, positions,
                                   causal=True, attention_fn=attention_fn)
    h = rmsnorm(p["ln2"], x, cfg.norm_eps)
    return x + mlp(p["mlp"], h, cfg.mlp)


def forward(
    params: Dict[str, Any],
    tokens: torch.Tensor,                   # (B, S) integer
    cfg: ArchConfig,
    *,
    logits_slice: Optional[int] = None,     # keep only the last N positions' logits
    return_features: bool = False,          # skip unembed
    attention_fn: Callable = flash_attention,
) -> torch.Tensor:
    """Logits fp32 (B, S, Vp), or features (B, S, D) with ``return_features``.

    The reference also returns an aux loss and a decode state; the dense
    prefill path has no aux loss and the decode state comes with the decode
    slice.
    """
    check_supported(cfg)
    x = embed_tokens(params["embed"], tokens, cfg)
    positions = torch.arange(x.shape[1], dtype=torch.int32, device=x.device)
    for u in range(cfg.n_pattern_units):
        for i, ltype in enumerate(cfg.attn_pattern):
            x = _apply_layer(_index(params["unit"][i], u), x, cfg, ltype, positions,
                             attention_fn)
    for i, p in enumerate(params.get("rem", ())):
        ltype = cfg.attn_pattern[i % len(cfg.attn_pattern)]
        x = _apply_layer(p, x, cfg, ltype, positions, attention_fn)
    x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    if logits_slice is not None:
        x = x[:, -logits_slice:]
    return x if return_features else unembed(params["embed"], x, cfg)
