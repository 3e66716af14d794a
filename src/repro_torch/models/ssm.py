"""Mamba-1 selective-state-space block (falcon-mamba-7b), port of ``repro.models.ssm``.

The block subsumes both temporal mixing and the MLP. Prefill follows the
reference's chunk-fused path: for each chunk of ``chunk`` positions the
recurrence inputs a and b, ``(B, chunk, d_inner, N)`` in fp32, are built for
that chunk only (one ``ssm_terms`` call: the kernel on the card), run
through the ``diag_recurrence`` kernel as ``(B, chunk, d_inner * N)`` from
the carried state (``chunked_diag_recurrence`` flattens the channels), and
contracted with ``C_t`` at once, so the full-length ``(B, S, d_inner, N)``
tensors never exist. A decode step builds its a and b the same way, then
updates the state in plain tensor ops, as in the reference. State per layer:
``h (B, d_inner, N)`` fp32 and the conv tail of pre-conv inputs.

The reference's ``REPRO_PERF_BASELINE`` branch (an environment-gated unfused
copy of the same numbers) is not ported.

Under tensor parallelism (``par``) a rank holds a block of the d_inner
channels: matching columns of ``in_proj``'s x half and z half (the logical
shard, ``models/sharding.py``), its rows of ``conv_w``, ``conv_b``, ``D``,
``dt_bias``, ``A_log``, ``x_proj`` and ``out_proj``, and its columns of
``dt_proj``. ``x_proj`` is row-parallel and followed by ``g``, so dt, B and
C are whole on every rank and enter its channels through ``f``;
``out_proj`` is row-parallel, then ``g``. The recurrence runs over the
rank's d_inner / tp * N channels.
"""
from __future__ import annotations

import math
from typing import Callable, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch import spans
from repro_torch.kernels.diag_recurrence import diag_recurrence
from repro_torch.kernels.ssm_terms import ssm_terms
from repro_torch.models.config import ArchConfig
from repro_torch.models.layers import _he, _zeros, matmul
from repro_torch.models.sharding import Parallel, f, g, tp_of
from repro_torch.models.recurrence import (
    causal_conv1d,
    causal_conv1d_step,
    chunked_diag_recurrence,
    conv_tail,
)


class SSMState(NamedTuple):
    h: torch.Tensor           # (B, d_inner, N) fp32
    conv: torch.Tensor        # (B, d_conv-1, d_inner)


def init_ssm(gen: torch.Generator, cfg: ArchConfig, dtype, lead=()) -> dict:
    d, di, n, r = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.resolved_dt_rank
    dev = gen.device
    # S4D-real initialization for A; dt bias so softplus(dt) spans [1e-3, 1e-1]
    a_init = torch.arange(1, n + 1, dtype=torch.float32, device=dev).repeat(*lead, di, 1)
    u = torch.rand((*lead, di), generator=gen, device=dev)
    dt = torch.exp(u * (math.log(0.1) - math.log(1e-3)) + math.log(1e-3))
    dt_bias = dt + torch.log(-torch.expm1(-dt))              # inverse softplus
    return {
        "in_proj": _he(gen, (*lead, d, 2 * di), d, dtype),
        "conv_w": _he(gen, (*lead, di, cfg.d_conv), cfg.d_conv, dtype),
        "conv_b": _zeros(gen, (*lead, di), dtype),
        "x_proj": _he(gen, (*lead, di, r + 2 * n), di, dtype),
        "dt_proj": _he(gen, (*lead, r, di), r, dtype),
        "dt_bias": dt_bias,
        "A_log": torch.log(a_init),
        "D": torch.ones((*lead, di), dtype=torch.float32, device=dev),
        "out_proj": _he(gen, (*lead, di, d), di, dtype),
    }


def _split(par: Optional[Parallel]) -> bool:
    return tp_of(par) > 1 and par.caps["shard_inner"]


def _ssm_inputs(params: dict, x: torch.Tensor, par: Optional[Parallel] = None):
    """Shared projections. x: (B, S, D) -> (x_in, z), (B, S, d_inner) each
    (this rank's channels with ``par``)."""
    return matmul(f(x, par) if _split(par) else x, params["in_proj"]).chunk(2, dim=-1)


def _selective_terms(params: dict, x_conv: torch.Tensor, cfg: ArchConfig,
                     par: Optional[Parallel] = None):
    """x_conv: (B, S, di) post conv+silu -> a, b (B, S, di, n) fp32 and C_t."""
    n, r = cfg.ssm_state, cfg.resolved_dt_rank
    proj = matmul(x_conv, params["x_proj"])                    # (B, S, r+2n)
    if _split(par):
        proj = f(g(proj, par), par)
    dt_r, b_ssm, c_ssm = proj.split([r, n, n], dim=-1)
    a, b = ssm_terms(matmul(dt_r, params["dt_proj"]), params["dt_bias"], params["A_log"],
                     x_conv, b_ssm)
    return a, b, c_ssm


def ssm_prefill(
    params: dict,
    x: torch.Tensor,              # (B, S, D)
    cfg: ArchConfig,
    *,
    make_state: bool = False,
    chunk: int = 256,
    recurrence_fn: Callable = diag_recurrence,
    par: Optional[Parallel] = None,
) -> Tuple[torch.Tensor, Optional[SSMState]]:
    """``(out (B, S, D), state or None)``; one ``recurrence_fn`` call per
    chunk (the kernel wrapper by default, or its plain version), the chunk
    loop in one span, ``ssm.scan``.

    The last chunk is as long as what is left of the sequence. The reference
    pads it with zero inputs instead, whose decay still applies to the carry,
    so its state differs from this one when S > chunk and S % chunk != 0
    (ROADMAP.md queue 3); the outputs agree.
    """
    B, S, _ = x.shape
    n = cfg.ssm_state
    x_in, z = _ssm_inputs(params, x, par)
    di = x_in.shape[-1]
    x_conv = F.silu(causal_conv1d(x_in, params["conv_w"], params["conv_b"]))
    h = torch.zeros((B, di, n), dtype=torch.float32, device=x.device)
    ys = []
    with spans.span("ssm.scan"):
        for c0 in range(0, S, chunk):
            a, b, c_ssm = _selective_terms(params, x_conv[:, c0:c0 + chunk], cfg, par)
            h_all, h = chunked_diag_recurrence(a, b, h, recurrence_fn=recurrence_fn)
            ys.append(torch.einsum("bsdn,bsn->bsd", h_all, c_ssm.float()))
    y = torch.cat(ys, dim=1)
    y = (y + params["D"] * x_conv.float()).to(x.dtype)
    out = matmul(y * F.silu(z), params["out_proj"])
    if _split(par):
        out = g(out, par)
    state = None
    if make_state:
        state = SSMState(h=h, conv=conv_tail(x_in, cfg.d_conv))
    return out, state


def ssm_decode(
    params: dict,
    x: torch.Tensor,              # (B, 1, D)
    state: SSMState,
    cfg: ArchConfig,
    par: Optional[Parallel] = None,
) -> Tuple[torch.Tensor, SSMState]:
    """One token. The reference returns a new state; the port writes ``h``
    and ``conv`` in place (cast to their dtypes) and returns the same state."""
    x_in, z = _ssm_inputs(params, x, par)
    conv_out, conv_state = causal_conv1d_step(x_in, state.conv, params["conv_w"],
                                              params["conv_b"])
    x_conv = F.silu(conv_out)                                  # (B, 1, di)
    a, b, c_ssm = _selective_terms(params, x_conv, cfg, par)
    h = a[:, 0] * state.h + b[:, 0]                            # (B, di, n)
    y = torch.einsum("bdn,bn->bd", h, c_ssm[:, 0].float())
    y = (y + params["D"] * x_conv[:, 0].float()).to(x.dtype)[:, None]
    out = matmul(y * F.silu(z), params["out_proj"])
    if _split(par):
        out = g(out, par)
    state.h.copy_(h)
    state.conv.copy_(conv_state)
    return out, state


def empty_ssm_state(cfg: ArchConfig, batch: int, dtype, device=None,
                    par: Optional[Parallel] = None) -> SSMState:
    """With ``par``: this rank's channels."""
    di = cfg.d_inner // par.tp if _split(par) else cfg.d_inner
    return SSMState(
        h=torch.zeros((batch, di, cfg.ssm_state), dtype=torch.float32, device=device),
        conv=torch.zeros((batch, cfg.d_conv - 1, di), dtype=dtype, device=device),
    )
