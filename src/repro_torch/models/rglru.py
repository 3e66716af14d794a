"""RG-LRU recurrent block (Griffin / recurrentgemma-2b), port of ``repro.models.rglru``.

Real-gated linear recurrent unit:
    r_t = sigmoid(W_a x_t + b_a)            recurrence gate
    i_t = sigmoid(W_x x_t + b_x)            input gate
    log a_t = -c * softplus(Lambda) * r_t   (c = 8)
    h_t = a_t h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)

Full (W, W) gate matrices, as in the reference. Prefill runs the recurrence
through the ``diag_recurrence`` kernel (``recurrence_fn``); a decode step is
plain tensor ops, as in the reference. State per layer: ``h`` (B, W) fp32 and
the conv tail of pre-conv inputs.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels.diag_recurrence import diag_recurrence
from repro_torch.models.config import ArchConfig
from repro_torch.models.layers import _he, _zeros, matmul
from repro_torch.models.recurrence import (
    causal_conv1d,
    causal_conv1d_step,
    chunked_diag_recurrence,
    conv_tail,
)

_C = 8.0  # Griffin's fixed recurrence-sharpness constant


class RGLRUState(NamedTuple):
    h: torch.Tensor        # (B, W) fp32
    conv: torch.Tensor     # (B, width-1, W)


def init_rglru(gen: torch.Generator, cfg: ArchConfig, dtype, lead=()) -> dict:
    d, w = cfg.d_model, cfg.resolved_lru_width
    # init so that a = exp(-c*softplus(L)) is uniform in [0.9, 0.999]
    a0 = 0.9 + 0.099 * torch.rand((*lead, w), generator=gen, device=gen.device)
    lam = torch.log(torch.expm1(-torch.log(a0) / _C))
    return {
        "linear_x": _he(gen, (*lead, d, w), d, dtype),
        "linear_y": _he(gen, (*lead, d, w), d, dtype),
        "conv_w": _he(gen, (*lead, w, cfg.conv1d_width), cfg.conv1d_width, dtype),
        "conv_b": _zeros(gen, (*lead, w), dtype),
        "w_a": _he(gen, (*lead, w, w), w, dtype),
        "b_a": _zeros(gen, (*lead, w), torch.float32),
        "w_x": _he(gen, (*lead, w, w), w, dtype),
        "b_x": _zeros(gen, (*lead, w), torch.float32),
        "lambda": lam,
        "out_proj": _he(gen, (*lead, w, d), w, dtype),
    }


def _gates(params: dict, xb: torch.Tensor):
    """xb: (B, S, W) -> (a, b) recurrence terms, fp32."""
    xf = xb.float()
    r = torch.sigmoid(xf @ params["w_a"].float() + params["b_a"])
    i = torch.sigmoid(xf @ params["w_x"].float() + params["b_x"])
    log_a = -_C * F.softplus(params["lambda"]) * r
    a = torch.exp(log_a)
    multiplier = torch.sqrt(torch.clamp_min(1.0 - torch.exp(2.0 * log_a), 1e-8))
    b = multiplier * (i * xf)
    return a, b


def rglru_prefill(
    params: dict,
    x: torch.Tensor,               # (B, S, D)
    cfg: ArchConfig,
    *,
    make_state: bool = False,
    recurrence_fn: Callable = diag_recurrence,
) -> Tuple[torch.Tensor, Optional[RGLRUState]]:
    """``(out (B, S, D), state or None)``. ``recurrence_fn`` is the kernel
    wrapper by default, or its plain version to check the kernel path."""
    B = x.shape[0]
    w = cfg.resolved_lru_width
    xb_pre = matmul(x, params["linear_x"])                   # (B, S, W) pre-conv
    yb = F.gelu(matmul(x, params["linear_y"]), approximate="tanh")
    xb = causal_conv1d(xb_pre, params["conv_w"], params["conv_b"])
    a, b = _gates(params, xb)
    h0 = torch.zeros((B, w), dtype=torch.float32, device=x.device)
    h_all, h_final = chunked_diag_recurrence(a, b, h0, recurrence_fn=recurrence_fn)
    out = matmul(h_all.to(x.dtype) * yb, params["out_proj"])
    state = None
    if make_state:                        # the conv state holds PRE-conv inputs
        state = RGLRUState(h=h_final, conv=conv_tail(xb_pre, cfg.conv1d_width))
    return out, state


def rglru_decode(
    params: dict,
    x: torch.Tensor,               # (B, 1, D)
    state: RGLRUState,
    cfg: ArchConfig,
) -> Tuple[torch.Tensor, RGLRUState]:
    """One token. The reference returns a new state; the port writes ``h``
    and ``conv`` in place (cast to their dtypes) and returns the same state."""
    xb = matmul(x, params["linear_x"])                        # (B, 1, W)
    yb = F.gelu(matmul(x, params["linear_y"]), approximate="tanh")
    conv_out, conv_state = causal_conv1d_step(xb, state.conv, params["conv_w"],
                                              params["conv_b"])
    a, b = _gates(params, conv_out)
    h = a[:, 0] * state.h + b[:, 0]
    out = matmul(h[:, None].to(x.dtype) * yb, params["out_proj"])
    state.h.copy_(h)
    state.conv.copy_(conv_state)
    return out, state


def empty_rglru_state(cfg: ArchConfig, batch: int, dtype, device=None) -> RGLRUState:
    w = cfg.resolved_lru_width
    return RGLRUState(
        h=torch.zeros((batch, w), dtype=torch.float32, device=device),
        conv=torch.zeros((batch, cfg.conv1d_width - 1, w), dtype=dtype, device=device),
    )
