"""GQA attention, prefill path (port of ``repro.models.attention``).

Covers full causal ("global") and sliding-window ("local") layers, attention
logit softcapping, per-head qk RMSNorm and QKV bias. The attention core is the
flash-attention kernel (``kernels/flash_attention``), where the reference
docstring places it: the JAX package serves prefill with its jnp blockwise
path, the port with the kernel. Decode, the KV cache and cross attention come
with the decode slice.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.models.config import LOCAL_ATTN, ArchConfig
from repro_torch.models.layers import _he, _zeros, apply_rope


def init_attention(gen: torch.Generator, cfg: ArchConfig, dtype, lead=(), *,
                   cross: bool = False) -> dict:
    d, h, hk, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    p = {
        "wq": _he(gen, (*lead, d, h * hd), d, dtype),
        "wk": _he(gen, (*lead, d, hk * hd), d, dtype),
        "wv": _he(gen, (*lead, d, hk * hd), d, dtype),
        "wo": _he(gen, (*lead, h * hd, d), h * hd, dtype),
    }
    if cfg.qkv_bias:
        p["bq"] = _zeros(gen, (*lead, h * hd), dtype)
        p["bk"] = _zeros(gen, (*lead, hk * hd), dtype)
        p["bv"] = _zeros(gen, (*lead, hk * hd), dtype)
    if cfg.qk_norm and not cross:
        p["q_norm"] = _zeros(gen, (*lead, hd), dtype)
        p["k_norm"] = _zeros(gen, (*lead, hd), dtype)
    return p


def _qk_rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    xf = x.float()
    xf = xf * torch.rsqrt(xf.square().mean(dim=-1, keepdim=True) + eps)
    return (xf * (1.0 + scale.float())).to(x.dtype)


def _project_qkv(params: dict, xq: torch.Tensor, xkv: torch.Tensor, cfg: ArchConfig):
    """Returns q (B,Sq,H,hd), k/v (B,Sk,Hkv,hd)."""
    h, hk, hd = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    q = xq @ params["wq"]
    k = xkv @ params["wk"]
    v = xkv @ params["wv"]
    if "bq" in params:
        q, k, v = q + params["bq"], k + params["bk"], v + params["bv"]
    q = q.reshape(*xq.shape[:-1], h, hd)
    k = k.reshape(*xkv.shape[:-1], hk, hd)
    v = v.reshape(*xkv.shape[:-1], hk, hd)
    if "q_norm" in params:
        q = _qk_rmsnorm(q, params["q_norm"], cfg.norm_eps)
        k = _qk_rmsnorm(k, params["k_norm"], cfg.norm_eps)
    return q, k, v


def attention_prefill(
    params: dict,
    x: torch.Tensor,                # (B, S, D)
    cfg: ArchConfig,
    layer_type: str,
    positions: torch.Tensor,        # (S,)
    *,
    causal: bool = True,
    attention_fn: Callable = flash_attention,
) -> torch.Tensor:
    """Projections + rope + attention core + out-projection -> (B, S, D).

    ``attention_fn`` is the core over (B, H, S, hd) tensors: the kernel
    wrapper by default, or its plain version to check the kernel path.
    """
    q, k, v = _project_qkv(params, x, x, cfg)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    window: Optional[int] = cfg.window if layer_type == LOCAL_ATTN else None
    out = attention_fn(
        q.transpose(1, 2).contiguous(), k.transpose(1, 2).contiguous(),
        v.transpose(1, 2).contiguous(),
        causal=causal, window=window, softcap=cfg.attn_logit_softcap)
    out = out.transpose(1, 2).reshape(*x.shape[:-1], -1)
    return out @ params["wo"]
