"""Plain fp32 reference of a Mamba-1 language model (falcon-mamba-7b's widths).

Each layer is ``x + mixer(rmsnorm(x))``, the mixer Mamba-1's selective scan
(Gu and Dao, arXiv:2312.00752, Algorithm 2): in_proj to (x, z), a causal
depthwise convolution with bias and SiLU on x, x_proj to (dt_r, B, C),
``dt = softplus(dt_r @ dt_proj + dt_bias)``, ``A = -exp(A_log)``, the
recurrence ``h_t = exp(dt_t A) h_{t-1} + dt_t x_t B_t`` per channel and
state, ``y_t = h_t . C_t + D x_t``, gated by SiLU(z), then out_proj.

Departure from falcon-mamba-7b as published (arXiv:2410.05355): the
published model also normalises B, C and dt with a weightless RMS norm
inside the mixer; the port runs plain Mamba-1, and this reference follows
the port, so it compares like with like.
"""
from __future__ import annotations

import math

import torch

from bench_port.reference.common import rmsnorm, silu, softplus
from bench_port.reference.weights import padded_vocab


def dims(c: dict):
    """(d_model, d_inner, state, conv width, dt rank)."""
    return (c["hidden_size"], c["intermediate_size"], c["state_size"],
            c["conv_kernel"], c["time_step_rank"])


def norm_eps(c: dict) -> float:
    return c["layer_norm_epsilon"]


def port_arch(c: dict) -> dict:
    """The port's ``ArchConfig`` fields for this configuration."""
    d, di, n, k, r = dims(c)
    return dict(name=c["name"], family="ssm", n_layers=c["num_hidden_layers"],
                d_model=d, n_heads=1, n_kv_heads=1, d_ff=0,
                vocab_size=c["vocab_size"], attn_pattern=("ssm",), ssm_state=n,
                d_conv=k, expand=di // d, dt_rank=r, norm_eps=norm_eps(c),
                tie_embeddings=c["tie_word_embeddings"])


def layer_leaves(c: dict, i: int):
    """Layer ``i``'s leaves in the port's layout (``weights.py``); every
    layer has the same."""
    d, di, n, k, r = dims(c)
    dt = c["torch_dtype"]
    return [
        (("ln1", "scale"), (d,), dt, ("normal", 0.0, 0.1)),
        (("ssm", "in_proj"), (d, 2 * di), dt, ("he", d)),
        (("ssm", "conv_w"), (di, k), dt, ("he", k)),
        (("ssm", "conv_b"), (di,), dt, ("normal", 0.0, 0.1)),
        (("ssm", "x_proj"), (di, r + 2 * n), dt, ("he", di)),
        (("ssm", "dt_proj"), (r, di), dt, ("he", r)),
        (("ssm", "dt_bias"), (di,), "float32",
         ("dt_bias", c["time_step_min"], c["time_step_max"])),
        (("ssm", "A_log"), (di, n), "float32", ("a_log",)),
        (("ssm", "D"), (di,), "float32", ("normal", 1.0, 0.1)),
        (("ssm", "out_proj"), (di, d), dt, ("he", di)),
    ]


def causal_conv(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Depthwise causal convolution: out[t, c] = sum_j w[c, j] x[t - K + 1 + j, c]."""
    L, K = x.shape[0], w.shape[1]
    xp = torch.cat([x.new_zeros((K - 1, x.shape[1])), x])
    return sum(xp[j: j + L] * w[:, j] for j in range(K))


def diag_scan(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """h (L, C) of ``h_t = a_t h_{t-1} + b_t`` from h = 0: blocks of T ~ sqrt(L)
    steps walked side by side, each block's carry-in chained after, then
    added through the block's running product of a."""
    L, C = a.shape
    T = math.isqrt(max(L - 1, 0)) + 1
    nb = -(-L // T)
    pad = nb * T - L
    if pad:
        a = torch.cat([a, a.new_ones((pad, C))])
        b = torch.cat([b, b.new_zeros((pad, C))])
    a3, b3 = a.view(nb, T, C), b.view(nb, T, C)
    h, prod = torch.empty_like(b3), torch.empty_like(a3)
    hc, pc = b3.new_zeros((nb, C)), a3.new_ones((nb, C))
    for t in range(T):
        hc = a3[:, t] * hc + b3[:, t]
        pc = pc * a3[:, t]
        h[:, t], prod[:, t] = hc, pc
    carry = torch.empty((nb, C), dtype=a.dtype, device=a.device)
    c = a.new_zeros((C,))
    for i in range(nb):
        carry[i] = c
        c = prod[i, T - 1] * c + h[i, T - 1]
    h += prod * carry[:, None]
    return h.view(nb * T, C)[:L]


def block(w: dict, x: torch.Tensor, c: dict, product, i: int) -> torch.Tensor:
    """Layer ``i`` on x (L, d_model), fp32; every layer is the same block."""
    _, di, n, _, r = dims(c)
    h = rmsnorm(x, w[("ln1", "scale")], norm_eps(c))
    xin, z = product(h, w[("ssm", "in_proj")]).split(di, dim=-1)
    xc = silu(causal_conv(xin, w[("ssm", "conv_w")]) + w[("ssm", "conv_b")])
    dt_r, bm, cm = product(xc, w[("ssm", "x_proj")]).split([r, n, n], dim=-1)
    dt = softplus(product(dt_r, w[("ssm", "dt_proj")]) + w[("ssm", "dt_bias")])
    A = -torch.exp(w[("ssm", "A_log")])                              # (di, n)
    L = x.shape[0]
    a = torch.exp(dt[:, :, None] * A).view(L, di * n)
    b = ((dt * xc)[:, :, None] * bm[:, None, :]).view(L, di * n)
    hs = diag_scan(a, b).view(L, di, n)
    del a, b
    y = torch.einsum("ldn,ln->ld", hs, cm) + w[("ssm", "D")] * xc
    return x + product(y * silu(z), w[("ssm", "out_proj")])


def model_flops(c: dict, L: int) -> int:
    """FLOPs of one prompt of L tokens through the model, the last position's
    logits only: every projection (2 a multiply-add), the convolution, and
    the scan's state update and output contraction (2 + 2 per channel and
    state); the elementwise work around them is not counted."""
    d, di, n, k, r = dims(c)
    per_layer = (2 * L * d * 2 * di + 2 * L * di * k + 2 * L * di * (r + 2 * n)
                 + 2 * L * r * di + 4 * L * di * n + 2 * L * di * d)
    vp = padded_vocab(c)
    return c["num_hidden_layers"] * per_layer + 2 * d * vp + 2 * vp * 16
