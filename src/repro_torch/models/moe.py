"""Top-k routed mixture-of-experts with sort-based dispatch (port of ``repro.models.moe``).

Per batch row, the ``S * top_k`` assignments are sorted by expert id (stable,
so each expert's tokens keep their order), ranked within their expert, and
those ranked past the expert capacity C are dropped. The kept ones are
gathered into a (B, E, C, D) buffer for the batched per-expert products;
each token then sums its kept experts' outputs, weighted by its renormalised
top-k gates. The router covers the ``n_experts`` real experts; the weights
cover ``n_experts_padded`` (granite pads 40 to 48), and the pad experts
receive no token. ``no_drop=True`` (decode) sets C to the token count, so no
assignment is dropped.

Where the reference leaves an order to the library, the port fixes it:
``top_k`` breaks equal gates towards the lower expert index, as
``lax.top_k`` does, and the combine gathers each token's K outputs and sums
them in a fixed order instead of adding through a scatter, so a run on the
card gives the same bits every time (CUDA's scatter-add uses atomics). The
per-expert products are plain ``torch`` products, as the reference leaves
them to XLA; no Pallas kernel is involved.

Under tensor parallelism (``par``) routing, capacity and the drop-by-rank
stay replicated and identical on every rank. With ``shard_experts`` a rank
holds ``n_experts_padded / tp`` experts and runs their products over the
slots routed to them; with only ``shard_expert_ff`` it holds a block of
every expert's hidden width. Either way the combine gives partial sums that
meet in ``g``; the token activations entering the experts and the gate
weights entering the combine pass through ``f``. The aux loss is replicated,
not summed over ranks. The reference's ``_maybe_constrain`` is an XLA layout
hint and has no counterpart.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models.config import ArchConfig
from repro_torch.models.layers import _he, promote
from repro_torch.models.sharding import Parallel, f, g, tp_of


def init_moe(gen: torch.Generator, cfg: ArchConfig, dtype, lead=()) -> dict:
    d, f, e = cfg.d_model, cfg.d_ff, cfg.n_experts_padded
    p = {"router": _he(gen, (*lead, d, cfg.n_experts), d, torch.float32)}
    if cfg.mlp in ("swiglu", "geglu"):
        p["w_gate"] = _he(gen, (*lead, e, d, f), d, dtype)
    p["w_in"] = _he(gen, (*lead, e, d, f), d, dtype)
    p["w_out"] = _he(gen, (*lead, e, f, d), f, dtype)
    return p


def expert_capacity(cfg: ArchConfig, n_tokens: int, *, no_drop: bool = False) -> int:
    if no_drop:
        return n_tokens          # worst case: every token routes to the same expert
    cap = int(cfg.capacity_factor * n_tokens * cfg.top_k / cfg.n_experts)
    return max(min(cap, n_tokens), min(cfg.top_k, n_tokens))


def top_k(gates: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The ``k`` largest gates along the last axis and their indices, equal
    gates ordered by index as ``lax.top_k`` orders them (``torch.topk``
    promises no order among ties)."""
    values, index = torch.sort(gates, dim=-1, descending=True, stable=True)
    return values[..., :k], index[..., :k]


def moe_ffn(params: dict, x: torch.Tensor, cfg: ArchConfig, *,
            no_drop: bool = False, par: Optional[Parallel] = None
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, D) -> (out (B, S, D) in x's dtype, aux loss fp32 scalar)."""
    caps = par.caps if tp_of(par) > 1 else {}
    split_e = caps.get("shard_experts", False)
    split = split_e or caps.get("shard_expert_ff", False)
    B, S, D = x.shape
    E_real, K, E = cfg.n_experts, cfg.top_k, cfg.n_experts_padded
    C = expert_capacity(cfg, S, no_drop=no_drop)
    dev = x.device

    gates = torch.softmax(x.float() @ params["router"], dim=-1)       # (B, S, E_real)
    top_w, top_i = top_k(gates, K)                                      # (B, S, K)
    top_w = top_w / top_w.sum(dim=-1, keepdim=True)

    # load-balancing auxiliary loss (Switch-style): E * mean_b sum_e(f_e * p_e)
    e_flat = top_i.reshape(B, S * K)
    ce = torch.zeros((B, E_real), dtype=torch.float32, device=dev).scatter_add_(
        1, e_flat, torch.ones_like(e_flat, dtype=torch.float32)) / (S * K)
    aux = E_real * (gates.mean(dim=1) * ce).sum(dim=-1).mean() * cfg.router_aux_coef

    # ---- sort-based dispatch: rank each assignment within its expert
    e_sorted, order = torch.sort(e_flat, dim=-1, stable=True)
    counts = torch.zeros((B, E_real), dtype=torch.int64, device=dev).scatter_add_(
        1, e_flat, torch.ones_like(e_flat))
    starts = counts.cumsum(dim=-1) - counts
    ranks = torch.arange(S * K, device=dev)[None] - starts.gather(1, e_sorted)
    slot = torch.where(ranks < C, e_sorted * C + ranks, E * C)         # E*C: dropped
    t_sorted = order // K                                               # token of each
    # the token in each of the E*C expert slots (S: empty), through a sentinel
    # column E*C that takes the dropped assignments
    slot_tok = torch.full((B, E * C + 1), S, dtype=torch.int64, device=dev)
    slot_tok.scatter_(1, slot, t_sorted)
    slot_tok = slot_tok[:, :E * C]

    e0, El = 0, E                                   # this rank's experts
    if split_e:
        e0, e1 = par.span(E)
        El = e1 - e0
        slot_tok = slot_tok[:, e0 * C:(e0 + El) * C]
    xin = f(x, par) if split else x
    x_pad = torch.cat([xin, xin.new_zeros((B, 1, D))], dim=1)
    rows = torch.arange(B, device=dev)[:, None]
    xe = x_pad[rows, slot_tok].reshape(B, El, C, D)

    # ---- batched per-expert FFN
    if cfg.mlp in ("swiglu", "geglu"):
        xe_g, w_gate = promote(xe, params["w_gate"])
        gate = torch.einsum("becd,edf->becf", xe_g, w_gate)
        act = F.silu(gate) if cfg.mlp == "swiglu" else F.gelu(gate, approximate="tanh")
        xe_i, w_in = promote(xe, params["w_in"])
        h = act * torch.einsum("becd,edf->becf", xe_i, w_in)
    else:
        xe_i, w_in = promote(xe, params["w_in"])
        h = F.gelu(torch.einsum("becd,edf->becf", xe_i, w_in), approximate="tanh")
    h, w_out = promote(h, params["w_out"])
    ye = torch.einsum("becf,efd->becd", h, w_out)                      # (B, El, C, D)

    # ---- combine: each token's K outputs gathered back to token order and
    # summed, weighted (a dropped assignment, or one to another rank's
    # expert, reads the zero row El*C)
    slot_of = torch.empty_like(slot).scatter_(1, order, slot)          # (B, S*K)
    if split_e:
        local = slot_of - e0 * C
        slot_of = torch.where((local >= 0) & (local < El * C), local, El * C)
    ye_pad = torch.cat([ye.reshape(B, El * C, D), ye.new_zeros((B, 1, D))], dim=1)
    w_flat = top_w.reshape(B, S * K).to(x.dtype)
    if split:
        w_flat = f(w_flat, par)
    contrib = (ye_pad[rows, slot_of] * w_flat[..., None]).to(x.dtype)   # (B, S*K, D)
    out = contrib.reshape(B, S, K, D).sum(dim=2)
    return (g(out, par) if split else out), aux
