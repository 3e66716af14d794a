"""GQA attention: prefill and single-token decode (port of ``repro.models.attention``).

Covers full causal ("global") and sliding-window ("local") layers, attention
logit softcapping, per-head qk RMSNorm and QKV bias. The attention cores are
the port's kernels, where the reference docstring places them: prefill runs
``kernels/flash_attention`` (the JAX package serves it with its jnp blockwise
path), decode runs ``kernels/decode_attention``.

KV caches are ring buffers of capacity C (``min(window, seq)`` for local
layers, ``seq`` for global) with an explicit per-slot logical position array
``k_pos`` (-1 = empty), laid out ``(B, Hkv, C, hd)`` as in the reference; the
decode mask is computed from positions, so ring wraparound needs no special
case and each batch row keeps its own position stream.

Cross attention (whisper's decoder over the encoder output) has no rope and
no mask: a prompt's queries go through ``kernels/flash_attention`` with
``causal=False`` over the Senc encoder keys, a decode step's one query
through ``kernels/decode_attention`` over them with an all-valid mask. The
reference computes both with its jnp blockwise path. The encoder keys and
values are projected once per prompt (:func:`project_cross_kv`) and kept
``(B, Hkv, Senc, hd)``, the cache layout, so the kernels read them without
a transpose; the reference keeps them ``(B, Senc, Hkv, hd)``. Under tensor
parallelism the cross attention splits its heads as self attention does,
but the decode state keeps every kv head (replicated over ``model``, as the
reference's rule has it): a prompt gathers its layers' projected heads
(:func:`whole_cross_kv`) and a decode step slices the heads its q heads use.

Dtypes: where activations and cache or weights differ, the port promotes as
JAX does (``layers.promote`` / ``layers.matmul``).

Under tensor parallelism (``par``; ``models/sharding.py``) a rank projects
its block of q heads when the heads divide the model axis, and its block of
kv heads when those do; ``wo`` is row-parallel, then ``g``. Where the kv
heads are replicated beside sharded q heads, a prefill passes k and v
through ``f`` and hands the kernel the kv heads its q heads use (a slice, or
one kv head per q head where its q heads split a group unevenly), so the
kernel sees a uniform group. A decode cache whose positions are split over
``data`` or ``model`` (``sharding.decode_state_pspecs``) is attended rank by
rank over its own slots; each rank's ``(out, lse)`` are merged with
:func:`~repro_torch.models.sharding.combine_attention`, and only the rank
that owns the new token's ring slot writes it. Where the positions are
split over ``model`` while the q heads are too, each rank first gathers all
q heads, attends them over its slots, and keeps its own heads for ``wo``.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Tuple

import torch

from repro_torch.kernels.decode_attention import decode_attention as decode_kernel
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.models.config import LOCAL_ATTN, ArchConfig
from repro_torch.models.layers import _he, _zeros, apply_rope, matmul, promote
from repro_torch.models.sharding import Parallel, combine_attention, f, g, gather_dim, tp_of


class KVCache(NamedTuple):
    k: torch.Tensor       # (B, Hkv, C, hd)
    v: torch.Tensor       # (B, Hkv, C, hd)
    k_pos: torch.Tensor   # (B, C) int32 logical position per slot, -1 = empty


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


def _sharded(par: Optional[Parallel]) -> Tuple[bool, bool]:
    """(q heads split over model, kv heads split over model)."""
    if tp_of(par) == 1:
        return False, False
    caps = par.caps
    return caps["shard_q"], caps["shard_kv"]


def _project_qkv(params: dict, xq: torch.Tensor, xkv: torch.Tensor, cfg: ArchConfig,
                 par: Optional[Parallel] = None):
    """Returns q (B,Sq,H,hd), k/v (B,Sk,Hkv,hd): with ``par``, H and Hkv are
    this rank's heads where they are split (the projections' columns are)."""
    shard_q, shard_kv = _sharded(par)
    hd = cfg.resolved_head_dim
    q = matmul(f(xq, par) if shard_q else xq, params["wq"])
    xk = f(xkv, par) if shard_kv else xkv
    k = matmul(xk, params["wk"])
    v = matmul(xk, params["wv"])
    if "bq" in params:
        q, k, v = q + params["bq"], k + params["bk"], v + params["bv"]
    q = q.reshape(*xq.shape[:-1], -1, hd)
    k = k.reshape(*xkv.shape[:-1], -1, hd)
    v = v.reshape(*xkv.shape[:-1], -1, hd)
    if "q_norm" in params:
        q_norm = f(params["q_norm"], par) if shard_q else params["q_norm"]
        k_norm = f(params["k_norm"], par) if shard_kv else params["k_norm"]
        q = _qk_rmsnorm(q, q_norm, cfg.norm_eps)
        k = _qk_rmsnorm(k, k_norm, cfg.norm_eps)
    return q, k, v


def _kv_for_local_q(k: torch.Tensor, v: torch.Tensor, cfg: ArchConfig, par: Parallel,
                    dim: int = 2):
    """Replicated k/v (B, S, Hkv, hd), or with ``dim=1`` (B, Hkv, S, hd) ->
    the kv heads this rank's q heads use, in a uniform group: a slice where
    its q heads cover whole groups or lie in one, else one kv head per q
    head."""
    g_ = cfg.n_heads // cfg.n_kv_heads
    h0, h1 = par.span(cfg.n_heads)
    idx = [h // g_ for h in range(h0, h1)]
    first, n = idx[0], idx[-1] - idx[0] + 1
    gl = (h1 - h0) // n
    if gl * n == h1 - h0 and idx == [first + i // gl for i in range(h1 - h0)]:
        return k.narrow(dim, first, n), v.narrow(dim, first, n)
    at = torch.tensor(idx, device=k.device)
    return k.index_select(dim, at), v.index_select(dim, at)


# ---------------------------------------------------------------------------------
# Cache construction / update
# ---------------------------------------------------------------------------------

def cache_capacity(cfg: ArchConfig, layer_type: str, seq_len: int) -> int:
    if layer_type == LOCAL_ATTN:
        return min(cfg.window, seq_len)
    return seq_len


def build_cache_from_prefill(k: torch.Tensor, v: torch.Tensor, capacity: int) -> KVCache:
    """Ring-aligned cache from prefill keys: position p lives at slot p % C.
    k/v arrive as (B, S, Hkv, hd); the cache stores (B, Hkv, C, hd)."""
    B, S, Hkv, hd = k.shape
    C = capacity
    kt, vt = k.transpose(1, 2), v.transpose(1, 2)          # (B, Hkv, S, hd)
    dev = k.device
    if C >= S:
        kc = k.new_zeros((B, Hkv, C, hd))
        vc = v.new_zeros((B, Hkv, C, hd))
        kc[:, :, :S] = kt
        vc[:, :, :S] = vt
        k_pos = torch.cat([torch.arange(S, dtype=torch.int32, device=dev),
                           torch.full((C - S,), -1, dtype=torch.int32, device=dev)])
    else:
        shift = S % C
        kc = torch.roll(kt[:, :, S - C:], shift, dims=2).contiguous()
        vc = torch.roll(vt[:, :, S - C:], shift, dims=2).contiguous()
        k_pos = torch.roll(torch.arange(S - C, S, dtype=torch.int32, device=dev), shift)
    return KVCache(kc, vc, k_pos.expand(B, C).contiguous())


def shard_slots(cache: KVCache, par: Optional[Parallel]) -> KVCache:
    """This rank's block of a cache's slots where its positions are split
    (``par.seq_axes``); the cache itself otherwise."""
    if par is None or par.seq_axes is None:
        return cache
    s0, s1 = par.span(cache.k.shape[2], par.seq_axes)
    return KVCache(cache.k[:, :, s0:s1].clone(), cache.v[:, :, s0:s1].clone(),
                   cache.k_pos[:, s0:s1].clone())


def empty_cache(cfg: ArchConfig, layer_type: str, batch: int, seq_len: int, dtype,
                device=None, par: Optional[Parallel] = None) -> KVCache:
    """With ``par``: this rank's kv heads and block of slots."""
    C = cache_capacity(cfg, layer_type, seq_len)
    hk, hd = cfg.n_kv_heads, cfg.resolved_head_dim
    if par is not None:
        if _sharded(par)[1]:
            hk //= par.tp
        C //= par.block(par.seq_axes)[0]
    return KVCache(
        torch.zeros((batch, hk, C, hd), dtype=dtype, device=device),
        torch.zeros((batch, hk, C, hd), dtype=dtype, device=device),
        torch.full((batch, C), -1, dtype=torch.int32, device=device),
    )


def _positions(pos, batch: int, device) -> torch.Tensor:
    """``pos`` (scalar or (B,)) as a (B,) int64 tensor on ``device``."""
    return torch.as_tensor(pos, device=device).to(torch.int64).reshape(-1).expand(batch)


def update_cache(cache: KVCache, k_new: torch.Tensor, v_new: torch.Tensor, pos,
                 par: Optional[Parallel] = None) -> KVCache:
    """Write one token per batch row at its ring slot ``pos_b % C`` (per-slot
    positions: continuous batching). k_new/v_new: (B, 1, Hkv, hd); pos: scalar
    or (B,).

    The reference builds a new cache with a masked select; the port writes the
    slot in place (three small index writes instead of a copy of the cache per
    layer per step) and returns the same, updated cache. Where ``par`` splits
    the positions, the cache holds this rank's block of the C slots and only
    the rank that owns a row's slot writes it (the others write back what
    they hold: no host sync to decide).
    """
    B, Hkv, Cl, hd = cache.k.shape
    pos_b = _positions(pos, B, cache.k.device)
    rows = torch.arange(B, device=cache.k.device)
    count, index = par.block(par.seq_axes) if par is not None else (1, 0)
    if count == 1:
        slot = pos_b % Cl
        cache.k[rows, :, slot] = k_new[:, 0].to(cache.k.dtype)
        cache.v[rows, :, slot] = v_new[:, 0].to(cache.v.dtype)
        cache.k_pos[rows, slot] = pos_b.to(torch.int32)
        return cache
    local = pos_b % (Cl * count) - index * Cl
    mine = (local >= 0) & (local < Cl)
    slot = local.clamp(0, Cl - 1)
    keep = mine[:, None, None]
    cache.k[rows, :, slot] = torch.where(keep, k_new[:, 0].to(cache.k.dtype),
                                         cache.k[rows, :, slot])
    cache.v[rows, :, slot] = torch.where(keep, v_new[:, 0].to(cache.v.dtype),
                                         cache.v[rows, :, slot])
    cache.k_pos[rows, slot] = torch.where(mine, pos_b.to(torch.int32),
                                          cache.k_pos[rows, slot])
    return cache


def decode_valid(k_pos: torch.Tensor, pos, window: Optional[int]) -> torch.Tensor:
    """(B, C) bool: the slots the new token at ``pos`` attends to, from the
    slots' logical positions (ring wraparound safe, per batch row)."""
    pos_b = _positions(pos, k_pos.shape[0], k_pos.device)[:, None]
    valid = (k_pos >= 0) & (k_pos <= pos_b)
    if window is not None:
        valid &= (pos_b - k_pos) < window
    return valid


def decode_attention(
    q: torch.Tensor,              # (B, 1, H, hd)
    cache: KVCache,
    pos,                          # int scalar or (B,): position of the new token
    *,
    window: Optional[int],
    attn_softcap: Optional[float],
    decode_fn: Callable = decode_kernel,
    par: Optional[Parallel] = None,
) -> torch.Tensor:
    """The new token's attention over the cache -> (B, 1, H, hd).

    ``decode_fn`` is the core over q (B, H, hd) and the cache: the kernel
    wrapper by default, or its plain version to check the kernel path. q and
    the cache enter it in their promoted dtype. Where ``par`` splits the
    cache's positions, the core also returns its lse and the ranks' partial
    results are merged (:func:`~repro_torch.models.sharding.combine_attention`);
    where they are split over ``model`` while q's heads are too, all heads
    are gathered first and this rank's are kept after the merge.
    """
    B, _, H, hd = q.shape
    valid = decode_valid(cache.k_pos, pos, window)
    seq_axes = par.seq_axes if par is not None else None
    gather_q = seq_axes is not None and "model" in seq_axes and _sharded(par)[0]
    if gather_q:
        q = gather_dim(q.contiguous(), 2, "model", par)
    qh, k, v = promote(q[:, 0].contiguous(), cache.k, cache.v)
    if seq_axes is None:
        return decode_fn(qh, k, v, valid, softcap=attn_softcap).reshape(B, 1, H, hd)
    out, lse = decode_fn(qh, k, v, valid, softcap=attn_softcap, return_lse=True)
    out = combine_attention(out, lse, par.group(seq_axes))
    if gather_q:
        h0, h1 = par.span(out.shape[1])
        out = out[:, h0:h1]
    return out.reshape(B, 1, H, hd)


# ---------------------------------------------------------------------------------
# Full attention sublayer (projections + rope + core + out-projection)
# ---------------------------------------------------------------------------------

def attention_prefill(
    params: dict,
    x: torch.Tensor,                # (B, S, D)
    cfg: ArchConfig,
    layer_type: str,
    positions: torch.Tensor,        # (S,)
    *,
    causal: bool = True,
    attention_fn: Callable = flash_attention,
    make_cache: bool = False,
    state_len: Optional[int] = None,   # total cache capacity (prompt + generation)
    par: Optional[Parallel] = None,
):
    """Projections + rope + attention core + out-projection -> (B, S, D), or
    ``(out, KVCache)`` with ``make_cache``.

    ``attention_fn`` is the core over (B, H, S, hd) tensors: the kernel
    wrapper by default, or its plain version to check the kernel path. With
    ``par`` the core runs at this rank's heads and the cache is this rank's
    part of the decode state.
    """
    shard_q, shard_kv = _sharded(par)
    q, k, v = _project_qkv(params, x, x, cfg, par)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    kc, vc = k, v                                 # the cache keeps what the state holds
    if shard_q and not shard_kv:
        k, v = _kv_for_local_q(f(k, par), f(v, par), cfg, par)
    window: Optional[int] = cfg.window if layer_type == LOCAL_ATTN else None
    out = attention_fn(
        q.transpose(1, 2).contiguous(), k.transpose(1, 2).contiguous(),
        v.transpose(1, 2).contiguous(),
        causal=causal, window=window, softcap=cfg.attn_logit_softcap)
    out = matmul(out.transpose(1, 2).reshape(*x.shape[:-1], -1), params["wo"])
    if shard_q:
        out = g(out, par)
    if not make_cache:
        return out
    cap = cache_capacity(cfg, layer_type, max(state_len or 0, x.shape[1]))
    return out, shard_slots(build_cache_from_prefill(kc, vc, cap), par)


def attention_decode(
    params: dict,
    x: torch.Tensor,                # (B, 1, D)
    cache: KVCache,
    pos,                            # int scalar or (B,)
    cfg: ArchConfig,
    layer_type: str,
    *,
    decode_fn: Callable = decode_kernel,
    par: Optional[Parallel] = None,
):
    """One token's attention sublayer -> ``(out (B, 1, D), cache)``; the
    cache is updated in place (:func:`update_cache`)."""
    q, k, v = _project_qkv(params, x, x, cfg, par)
    pos_t = torch.as_tensor(pos, dtype=torch.int32, device=x.device)
    pos_arr = pos_t.reshape(-1, 1) if pos_t.dim() else pos_t[None]     # (B,1) | (1,)
    q = apply_rope(q, pos_arr, cfg.rope_theta)
    k = apply_rope(k, pos_arr, cfg.rope_theta)
    cache = update_cache(cache, k, v, pos_t, par)
    window = cfg.window if layer_type == LOCAL_ATTN else None
    out = decode_attention(q, cache, pos_t, window=window,
                           attn_softcap=cfg.attn_logit_softcap, decode_fn=decode_fn,
                           par=par)
    out = matmul(out.reshape(*x.shape[:-1], -1), params["wo"])
    return (g(out, par) if _sharded(par)[0] else out), cache


# ---------------------------------------------------------------------------------
# Cross attention (encoder-decoder)
# ---------------------------------------------------------------------------------

def project_cross_kv(params: dict, enc_out: torch.Tensor, cfg: ArchConfig,
                     par: Optional[Parallel] = None):
    """The encoder output's keys and values for one cross-attention layer,
    each ``(B, Hkv, Senc, hd)``: with ``par``, this rank's kv heads where
    they split over ``model``."""
    hd = cfg.resolved_head_dim
    B, Senc = enc_out.shape[:2]
    x = f(enc_out, par) if _sharded(par)[1] else enc_out
    k = matmul(x, params["wk"]).reshape(B, Senc, -1, hd)
    v = matmul(x, params["wv"]).reshape(B, Senc, -1, hd)
    return k.transpose(1, 2).contiguous(), v.transpose(1, 2).contiguous()


def whole_cross_kv(k: torch.Tensor, v: torch.Tensor, cfg: ArchConfig,
                   par: Optional[Parallel] = None):
    """A layer's cross keys and values with every kv head, as the decode
    state keeps them: replicated over ``model`` and split over the batch
    only (the reference's rule: Senc = 1500 and 12 kv heads do not divide
    the model axis). Gathered (no gradient) where :func:`project_cross_kv`
    gave this rank's heads."""
    if not _sharded(par)[1]:
        return k, v
    return gather_dim(k, 1, "model", par), gather_dim(v, 1, "model", par)


def _cross_q(params: dict, x: torch.Tensor, cfg: ArchConfig,
             par: Optional[Parallel] = None) -> torch.Tensor:
    """(B, Sq, H, hd): this rank's q heads where they split over ``model``."""
    q = matmul(f(x, par) if _sharded(par)[0] else x, params["wq"])
    if "bq" in params:
        q = q + params["bq"]
    return q.reshape(*x.shape[:-1], -1, cfg.resolved_head_dim)


def _cross_out(out: torch.Tensor, params: dict, x: torch.Tensor,
               par: Optional[Parallel]) -> torch.Tensor:
    out = matmul(out.reshape(*x.shape[:-1], -1), params["wo"])
    return g(out, par) if _sharded(par)[0] else out


def cross_attention(params: dict, x: torch.Tensor, enc_k: torch.Tensor,
                    enc_v: torch.Tensor, cfg: ArchConfig, *,
                    attention_fn: Callable = flash_attention,
                    par: Optional[Parallel] = None) -> torch.Tensor:
    """x (B, Sq, D) over the encoder's keys and values ``(B, Hkv, Senc, hd)``,
    non-causal -> (B, Sq, D). ``attention_fn`` is the core: the kernel wrapper
    by default, or its plain version. With ``par`` the keys are
    :func:`project_cross_kv`'s: a rank whose q heads split over ``model``
    beside replicated kv heads takes the kv heads its q heads use."""
    shard_q, shard_kv = _sharded(par)
    q = _cross_q(params, x, cfg, par)
    if shard_q and not shard_kv:
        enc_k, enc_v = _kv_for_local_q(f(enc_k, par), f(enc_v, par), cfg, par, dim=1)
    qh, k, v = promote(q.transpose(1, 2).contiguous(), enc_k.contiguous(),
                       enc_v.contiguous())
    out = attention_fn(qh, k, v, causal=False, window=None, softcap=None)
    return _cross_out(out.transpose(1, 2), params, x, par)


def cross_attention_decode(params: dict, x: torch.Tensor, enc_k: torch.Tensor,
                           enc_v: torch.Tensor, valid: torch.Tensor, cfg: ArchConfig, *,
                           decode_fn: Callable = decode_kernel,
                           par: Optional[Parallel] = None) -> torch.Tensor:
    """One token's cross attention: x (B, 1, D) -> (B, 1, D), through the
    one-query core over the encoder positions ``valid`` (Senc,) marks (all of
    them, in the model). The keys and values are the decode state's, every
    kv head (:func:`whole_cross_kv`); with ``par`` a rank whose q heads split
    over ``model`` attends over the kv heads they use."""
    q = _cross_q(params, x, cfg, par)
    if _sharded(par)[0]:
        enc_k, enc_v = _kv_for_local_q(enc_k, enc_v, cfg, par, dim=1)
    qh, k, v = promote(q[:, 0].contiguous(), enc_k.contiguous(), enc_v.contiguous())
    out = decode_fn(qh, k, v, valid, softcap=None)
    return _cross_out(out, params, x, par)
