"""Core neural layers: norms, rotary embeddings, MLPs, embeddings.

Port of ``repro.models.layers``: plain functions ``apply(params, x, ...)`` over
dicts of tensors, with params made by a matching ``init_*`` that draws from a
``torch.Generator`` on the generator's device. Activations run in the
parameter dtype; norms and rotary embeddings in fp32, as in the reference.

Under tensor parallelism (``par``, a :class:`~repro_torch.models.sharding.
Parallel` with a model axis > 1) the embedding is vocab-parallel (each rank
holds a block of rows of ``tok`` and of columns of ``head``), and the MLP is
column-parallel into its hidden width and row-parallel out of it, with the
Megatron pair ``f``/``g`` around both.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.models.config import ArchConfig
from repro_torch.models.sharding import Parallel, f, g, tp_of


def promote(*xs: torch.Tensor):
    """``xs`` cast to their common dtype, as JAX's type promotion would
    (``torch.promote_types``; fp32 with bf16 gives fp32). Tensors already of
    that dtype are returned as they are."""
    dtype = xs[0].dtype
    for x in xs[1:]:
        dtype = torch.promote_types(dtype, x.dtype)
    return tuple(x if x.dtype == dtype else x.to(dtype) for x in xs)


def matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` in the promoted dtype: where an fp32 activation meets a bf16
    weight the product runs in fp32, as in JAX (PyTorch's ``@`` refuses mixed
    dtypes). Equal dtypes take ``x @ w`` unchanged."""
    x, w = promote(x, w)
    return x @ w


def _he(gen: torch.Generator, shape, scale_dim: int, dtype) -> torch.Tensor:
    x = torch.randn(tuple(shape), generator=gen, dtype=torch.float32,
                    device=gen.device)
    return x.div_(math.sqrt(scale_dim)).to(dtype)     # in place: one fp32 copy at a time


def _zeros(gen: torch.Generator, shape, dtype) -> torch.Tensor:
    return torch.zeros(tuple(shape), dtype=dtype, device=gen.device)


# ---------------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------------

def init_rmsnorm(gen: torch.Generator, d: int, dtype, lead=()) -> dict:
    return {"scale": _zeros(gen, (*lead, d), dtype)}  # (1 + scale) parameterization


def rmsnorm(params: dict, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    dtype = x.dtype
    x = x.float()
    var = x.square().mean(dim=-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    return (x * (1.0 + params["scale"].float())).to(dtype)


# ---------------------------------------------------------------------------------
# Rotary position embeddings (half-split form, not interleaved)
# ---------------------------------------------------------------------------------

def rope_frequencies(head_dim: int, theta: float, device=None) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (..., S, H, hd); positions: broadcastable to (..., S)."""
    if theta <= 0:
        return x
    hd = x.shape[-1]
    freqs = rope_frequencies(hd, theta, device=x.device)          # (hd/2,)
    angles = positions.float()[..., None] * freqs                 # (..., S, hd/2)
    angles = angles[..., None, :]                                 # (..., S, 1, hd/2)
    sin, cos = torch.sin(angles), torch.cos(angles)
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def _sinusoid_scale(d_model: int, device=None) -> torch.Tensor:
    half = d_model // 2
    return torch.exp(-torch.arange(half, dtype=torch.float32, device=device)
                     * math.log(10_000.0) / max(half - 1, 1))


def sinusoidal_positions(n_pos: int, d_model: int, device=None) -> torch.Tensor:
    """Whisper-style sinusoidal table (n_pos, d_model), fp32, computed on the
    fly (no params)."""
    pos = torch.arange(n_pos, dtype=torch.float32, device=device)[:, None]
    angles = pos * _sinusoid_scale(d_model, device)[None, :]
    return torch.cat([torch.sin(angles), torch.cos(angles)], dim=-1)


def sinusoidal_position_at(pos: torch.Tensor, d_model: int) -> torch.Tensor:
    """Sinusoidal rows for scalar or (B,) positions: (d_model,) or (B, d_model)."""
    angles = pos.float()[..., None] * _sinusoid_scale(d_model, pos.device)
    return torch.cat([torch.sin(angles), torch.cos(angles)], dim=-1)


# ---------------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------------

def init_mlp(gen: torch.Generator, cfg: ArchConfig, dtype, lead=()) -> dict:
    d, f = cfg.d_model, cfg.d_ff
    if cfg.mlp in ("swiglu", "geglu"):
        return {
            "w_gate": _he(gen, (*lead, d, f), d, dtype),
            "w_in": _he(gen, (*lead, d, f), d, dtype),
            "w_out": _he(gen, (*lead, f, d), f, dtype),
        }
    return {"w_in": _he(gen, (*lead, d, f), d, dtype),
            "w_out": _he(gen, (*lead, f, d), f, dtype)}


def mlp(params: dict, x: torch.Tensor, kind: str,
        par: Optional[Parallel] = None) -> torch.Tensor:
    """With ``par`` and a sharded hidden width the weights are this rank's
    columns of ``w_gate``/``w_in`` and rows of ``w_out``: ``f`` before, ``g``
    after."""
    if tp_of(par) > 1 and par.caps["shard_ff"]:
        return g(mlp(params, f(x, par), kind), par)
    if kind in ("swiglu", "geglu"):
        gate = matmul(x, params["w_gate"])
        act = F.silu(gate) if kind == "swiglu" else F.gelu(gate, approximate="tanh")
        return matmul(act * matmul(x, params["w_in"]), params["w_out"])
    return matmul(F.gelu(matmul(x, params["w_in"]), approximate="tanh"), params["w_out"])


# ---------------------------------------------------------------------------------
# Embeddings / unembedding
# ---------------------------------------------------------------------------------

def padded_vocab(cfg: ArchConfig, multiple: int = 512) -> int:
    """Vocab rounded up so the embedding table shards evenly on the model axis."""
    return ((cfg.vocab_size + multiple - 1) // multiple) * multiple


def init_embedding(gen: torch.Generator, cfg: ArchConfig, dtype) -> dict:
    v = padded_vocab(cfg)
    p = {"tok": _he(gen, (v, cfg.d_model), cfg.d_model, dtype)}
    if not cfg.tie_embeddings:
        p["head"] = _he(gen, (cfg.d_model, v), cfg.d_model, dtype)
    return p


def embed_tokens(params: dict, tokens: torch.Tensor, cfg: ArchConfig,
                 par: Optional[Parallel] = None) -> torch.Tensor:
    """With ``par``, ``tok`` holds this rank's block of rows: rows of tokens
    in its range, zeros elsewhere, summed over the model ranks (``g``)."""
    if tp_of(par) > 1:
        tok = params["tok"]
        local = tokens.long() - par.tp_rank * tok.shape[0]
        mine = (local >= 0) & (local < tok.shape[0])
        x = tok[local.clamp(0, tok.shape[0] - 1)] * mine[..., None].to(tok.dtype)
        x = g(x, par)
    else:
        x = params["tok"][tokens.long()]
    if cfg.emb_scale:
        x = x * torch.tensor(math.sqrt(cfg.d_model), dtype=x.dtype)
    return x


def unembed(params: dict, x: torch.Tensor, cfg: ArchConfig,
            par: Optional[Parallel] = None) -> torch.Tensor:
    """Logits in fp32; the product runs in the parameter dtype (the promoted
    one where the activations are wider) and is cast afterwards, as in the
    reference. With ``par`` they are this rank's block of the padded
    vocabulary, ``(..., Vp / tp)``: ``head`` holds its columns, ``tok`` its
    rows; the softcap is elementwise and stays local."""
    table = params["head"] if "head" in params else params["tok"].T
    logits = matmul(f(x, par), table).float()
    return softcap(logits, cfg.final_logit_softcap)


def softcap(logits: torch.Tensor, cap: Optional[float]) -> torch.Tensor:
    if not cap:
        return logits
    return cap * torch.tanh(logits / cap)
