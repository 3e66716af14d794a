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

Under tensor parallelism (``par``, where the width divides the model axis) a
rank holds a block of the W channels: columns of ``linear_x``, ``linear_y``,
``w_a`` and ``w_x``, rows of ``conv_w`` and ``out_proj``, and its ``conv_b``,
``b_a``, ``b_x`` and ``lambda`` (the reference's rules). ``linear_x`` and
``linear_y`` are column-parallel behind ``f``; the conv runs on the rank's
channels; the gates' products read the whole width (each rank holds every
input row of its output columns), so the conv output is gathered over
``model`` first (``sharding.gather_model``, whose backward sums the
gradient over ``model``); the recurrence runs on W / tp channels and
``out_proj`` is row-parallel, then ``g``. The decode state holds the rank's
channels: ``h`` (B, W / tp) and ``conv`` (B, width - 1, W / tp).
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels.diag_recurrence import diag_recurrence
from repro_torch.models.config import ArchConfig
from repro_torch.models.layers import _he, _zeros, matmul
from repro_torch.models.sharding import Parallel, f, g, gather_model, tp_of
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


def _split(par: Optional[Parallel]) -> bool:
    return tp_of(par) > 1 and par.caps["shard_lru"]


def _gates(params: dict, xb: torch.Tensor, par: Optional[Parallel] = None):
    """xb: (B, S, W) -> (a, b) recurrence terms, fp32 (with ``par``: this
    rank's channels in and out, the whole width gathered for the products)."""
    xf = xb.float()
    xw = gather_model(xb, -1, par).float() if _split(par) else xf
    r = torch.sigmoid(xw @ params["w_a"].float() + params["b_a"])
    i = torch.sigmoid(xw @ params["w_x"].float() + params["b_x"])
    log_a = -_C * F.softplus(params["lambda"]) * r
    a = torch.exp(log_a)
    multiplier = torch.sqrt(torch.clamp_min(1.0 - torch.exp(2.0 * log_a), 1e-8))
    b = multiplier * (i * xf)
    return a, b


def _branches(params: dict, x: torch.Tensor, par: Optional[Parallel]):
    """The pre-conv input and the gelu branch, (B, S, W) each (this rank's
    channels with ``par``)."""
    xin = f(x, par) if _split(par) else x
    return (matmul(xin, params["linear_x"]),
            F.gelu(matmul(xin, params["linear_y"]), approximate="tanh"))


def _out(y: torch.Tensor, params: dict, par: Optional[Parallel]) -> torch.Tensor:
    out = matmul(y, params["out_proj"])
    return g(out, par) if _split(par) else out


def rglru_prefill(
    params: dict,
    x: torch.Tensor,               # (B, S, D)
    cfg: ArchConfig,
    *,
    make_state: bool = False,
    recurrence_fn: Callable = diag_recurrence,
    par: Optional[Parallel] = None,
) -> Tuple[torch.Tensor, Optional[RGLRUState]]:
    """``(out (B, S, D), state or None)``. ``recurrence_fn`` is the kernel
    wrapper by default, or its plain version to check the kernel path."""
    xb_pre, yb = _branches(params, x, par)                  # (B, S, W) pre-conv
    xb = causal_conv1d(xb_pre, params["conv_w"], params["conv_b"])
    a, b = _gates(params, xb, par)
    h0 = torch.zeros((x.shape[0], xb.shape[-1]), dtype=torch.float32, device=x.device)
    h_all, h_final = chunked_diag_recurrence(a, b, h0, recurrence_fn=recurrence_fn)
    out = _out(h_all.to(x.dtype) * yb, params, par)
    state = None
    if make_state:                        # the conv state holds PRE-conv inputs
        state = RGLRUState(h=h_final, conv=conv_tail(xb_pre, cfg.conv1d_width))
    return out, state


def rglru_decode(
    params: dict,
    x: torch.Tensor,               # (B, 1, D)
    state: RGLRUState,
    cfg: ArchConfig,
    par: Optional[Parallel] = None,
) -> Tuple[torch.Tensor, RGLRUState]:
    """One token. The reference returns a new state; the port writes ``h``
    and ``conv`` in place (cast to their dtypes) and returns the same state."""
    xb, yb = _branches(params, x, par)                        # (B, 1, W)
    conv_out, conv_state = causal_conv1d_step(xb, state.conv, params["conv_w"],
                                              params["conv_b"])
    a, b = _gates(params, conv_out, par)
    h = a[:, 0] * state.h + b[:, 0]
    out = _out(h[:, None].to(x.dtype) * yb, params, par)
    state.h.copy_(h)
    state.conv.copy_(conv_state)
    return out, state


def empty_rglru_state(cfg: ArchConfig, batch: int, dtype, device=None,
                      par: Optional[Parallel] = None) -> RGLRUState:
    """With ``par``: this rank's channels."""
    w = cfg.resolved_lru_width // (par.tp if _split(par) else 1)
    return RGLRUState(
        h=torch.zeros((batch, w), dtype=torch.float32, device=device),
        conv=torch.zeros((batch, cfg.conv1d_width - 1, w), dtype=dtype, device=device),
    )
