"""Plain fp32 reference of a dense decoder with grouped-query attention
(h2o-danube3-4b's widths).

Each layer is ``x + attn(rmsnorm(x))`` then ``x + mlp(rmsnorm(x))``:
q, k, v projections without bias, rotary embeddings in the half-split form
on q and k, causal softmax attention over keys no more than ``window - 1``
positions back, each group of ``heads / kv_heads`` query heads sharing one
key/value head, the output projection, and a SwiGLU MLP
(``(silu(x W_gate) * x W_in) W_out``).
"""
from __future__ import annotations

import math

import torch

from bench_port.reference.common import rmsnorm, rope, silu
from bench_port.reference.weights import padded_vocab


def dims(c: dict):
    """(d_model, heads, kv heads, head dim, d_ff)."""
    return (c["hidden_size"], c["num_attention_heads"], c["num_key_value_heads"],
            c["head_dim"], c["intermediate_size"])


def norm_eps(c: dict) -> float:
    return c["rms_norm_eps"]


def port_arch(c: dict) -> dict:
    """The port's ``ArchConfig`` fields for this configuration."""
    d, h, hk, hd, f = dims(c)
    return dict(name=c["name"], family="dense", n_layers=c["num_hidden_layers"],
                d_model=d, n_heads=h, n_kv_heads=hk, d_ff=f,
                vocab_size=c["vocab_size"], head_dim=hd, attn_pattern=("local",),
                window=c["sliding_window"], mlp="swiglu", rope_theta=c["rope_theta"],
                norm_eps=norm_eps(c), tie_embeddings=c["tie_word_embeddings"])


def layer_leaves(c: dict, i: int):
    """Layer ``i``'s leaves in the port's layout (``weights.py``); every
    layer has the same."""
    d, h, hk, hd, f = dims(c)
    dt = c["torch_dtype"]
    return [
        (("ln1", "scale"), (d,), dt, ("normal", 0.0, 0.1)),
        (("attn", "wq"), (d, h * hd), dt, ("he", d)),
        (("attn", "wk"), (d, hk * hd), dt, ("he", d)),
        (("attn", "wv"), (d, hk * hd), dt, ("he", d)),
        (("attn", "wo"), (h * hd, d), dt, ("he", h * hd)),
        (("ln2", "scale"), (d,), dt, ("normal", 0.0, 0.1)),
        (("mlp", "w_gate"), (d, f), dt, ("he", d)),
        (("mlp", "w_in"), (d, f), dt, ("he", d)),
        (("mlp", "w_out"), (f, d), dt, ("he", f)),
    ]


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              window: int) -> torch.Tensor:
    """q (L, H, hd), k/v (L, Hkv, hd) -> (L, H, hd): one key/value head at a
    time, over its group of query heads."""
    L, H, hd = q.shape
    g = H // k.shape[1]
    i = torch.arange(L, device=q.device)
    lag = i[:, None] - i[None, :]
    keep = (lag >= 0) & (lag < window)
    out = torch.empty_like(q)
    for j in range(k.shape[1]):
        qg = q[:, j * g:(j + 1) * g]                                   # (L, g, hd)
        s = torch.einsum("qgd,kd->gqk", qg, k[:, j]) / math.sqrt(hd)
        p = torch.softmax(s.masked_fill(~keep, float("-inf")), dim=-1)
        out[:, j * g:(j + 1) * g] = torch.einsum("gqk,kd->qgd", p, v[:, j])
    return out


def block(w: dict, x: torch.Tensor, c: dict, product, i: int) -> torch.Tensor:
    """Layer ``i`` on x (L, d_model), fp32; every layer is the same block."""
    _, h, hk, hd, _ = dims(c)
    L = x.shape[0]
    y = rmsnorm(x, w[("ln1", "scale")], norm_eps(c))
    q = rope(product(y, w[("attn", "wq")]).view(L, h, hd), c["rope_theta"])
    k = rope(product(y, w[("attn", "wk")]).view(L, hk, hd), c["rope_theta"])
    v = product(y, w[("attn", "wv")]).view(L, hk, hd)
    o = attention(q, k, v, c["sliding_window"]).reshape(L, h * hd)
    x = x + product(o, w[("attn", "wo")])
    y = rmsnorm(x, w[("ln2", "scale")], norm_eps(c))
    gate = silu(product(y, w[("mlp", "w_gate")]))
    return x + product(gate * product(y, w[("mlp", "w_in")]), w[("mlp", "w_out")])


def attention_pairs(L: int, window: int) -> int:
    """(query, key) pairs a causal window leaves over L positions."""
    w = min(window, L)
    return w * (w + 1) // 2 + (L - w) * w


def model_flops(c: dict, L: int) -> int:
    """FLOPs of one prompt of L tokens through the model, the last position's
    logits only: the projections and the MLP (2 a multiply-add) and the two
    attention products over the pairs the mask leaves (4 per pair and head
    dimension); norms, rope and softmax are not counted."""
    d, h, hk, hd, f = dims(c)
    per_layer = (2 * L * d * (h + 2 * hk) * hd + 2 * L * h * hd * d
                 + 4 * h * hd * attention_pairs(L, c["sliding_window"])
                 + 3 * 2 * L * d * f)
    vp = padded_vocab(c)
    return c["num_hidden_layers"] * per_layer + 2 * d * vp + 2 * vp * 16
