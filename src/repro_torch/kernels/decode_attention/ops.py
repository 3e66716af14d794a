"""Flash decode: one new query token per (batch, head) against a KV cache.

Replaces the TPU kernel ``src/repro/kernels/decode_attention/kernel.py``
(``decode_attention_pallas``), with its contract: q ``(B, H, d)``, k/v cache
``(B, Hkv, S, d)`` of one dtype, a validity mask, optional softcap and scale,
GQA by ``h -> h // g``, fp32 online softmax, output in ``q.dtype``, masked
logits at the finite ``NEG_INF``. The mask is ``(S,)`` as in the reference, or
``(B, S)``, one row per batch entry, as the model's per-slot ring positions
need (``models/attention.py`` builds it from ``k_pos``).

On the card it is bound by bytes: each decode step streams the filled part
of the cache once. The CUDA kernel (``csrc/decode_attention.cu``) cuts each
(batch, kv head) row's live extent, its first to its last valid slot, found
on the device, into ``n_splits`` shares (:func:`split_range`); the host picks
``n_splits`` from the batch and the card alone (:func:`plan_splits`), with no
sync. Each block streams its share through a ring of shared-memory stages
with ``cp.async``, computes all ``g`` grouped heads from each K/V tile, keeps
the online softmax in fp32, and skips tiles whose slots are all invalid; a
second kernel merges the splits. With ``return_lse`` the wrappers also
return each head's logsumexp of its scores, ``(B, H)`` fp32, which a cache
whose positions are split over ranks merges with
(``models/sharding.combine_attention``); the kernel writes it only when its
pointer is passed.

The kernel is the PyTorch op ``repro_torch::decode_attention``: the plain
version on the CPU, the kernel on CUDA and a fake implementation for meta
and fake tensors, which the dry run (``launch/dryrun.py``) traces through.
"""
from __future__ import annotations

import ctypes
import functools
import math
import threading
from typing import Optional, Tuple

import torch
from torch.utils.flop_counter import register_flop_formula

from repro_torch import spans
from repro_torch.kernels.build import check, library, on_device, refuse_grad

NEG_INF = -2.0e38
#: (head dim, H/Hkv) pairs with a compiled kernel: every config's and the
#: tests' shapes, as ``DECODE_SHAPES`` in ``csrc/decode_attention.cu`` lists
#: them (a config that needs another pair adds it to both); d=120
#: (h2o-danube3) runs on shared-memory tiles 128 wide whose pad columns are
#: zeros, reading the cache in place; (16, 2) is the reduced qwen3-1.7b that
#: examples/serve_e2e_torch.py serves
SHAPES = ((16, 2), (32, 1), (64, 1), (64, 2), (64, 3), (64, 7), (120, 4), (120, 7),
          (128, 1), (128, 2), (128, 8), (256, 10))
TILE = 32                        # cache rows per pipeline stage in the kernel
MAX_SPLITS = 4096                # the combine kernel's limit
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_count_lock = threading.Lock()


def decode_attention_plain(q, k_cache, v_cache, valid, *, softcap=None,
                           scale=None, return_lse: bool = False):
    """Plain PyTorch version, mirroring ``decode_attention/ref.py``: fp32
    einsum, softcap, finite ``NEG_INF`` mask, softmax, einsum, cast. ``valid``
    is ``(S,)`` or ``(B, S)``. With ``return_lse``: ``(out, lse)``, lse the
    logsumexp of the masked scores, ``(B, H)`` fp32 (about ``NEG_INF`` for a
    row with no valid slot)."""
    B, H, d = q.shape
    Hkv, S = k_cache.shape[1], k_cache.shape[2]
    g = H // Hkv
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    qg = q.reshape(B, Hkv, g, d).float()
    s = torch.einsum("bhgd,bhsd->bhgs", qg, k_cache.float()) * scale
    if softcap is not None:
        s = softcap * torch.tanh(s / softcap)
    mask = valid.bool().reshape(-1 if valid.dim() == 2 else 1, 1, 1, S)
    s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhgs,bhsd->bhgd", p, v_cache.float()).reshape(B, H, d).to(q.dtype)
    if return_lse:
        return out, torch.logsumexp(s, dim=-1).reshape(B, H)
    return out


def check_shape(d: int, group: int) -> None:
    """Raise ``ValueError`` unless a kernel is compiled for head dim ``d`` and
    ``group`` = H/Hkv query heads per kv head."""
    if (d, group) not in SHAPES:
        raise ValueError(f"the kernel takes (head dim, H/Hkv) in {SHAPES}, got "
                         f"({d}, {group})")


def plan_splits(B: int, Hkv: int, S: int, n_sms: int, blocks_per_sm: int) -> int:
    """``n_splits``: how many blocks share each (batch, kv head) row, so that
    the ``B * Hkv * n_splits`` blocks fill the card in one wave
    (``blocks_per_sm`` resident per SM) and no row has more splits than
    tiles. Reads no mask: the kernel cuts each row's live extent itself."""
    fit = max(1, n_sms * blocks_per_sm // (B * Hkv))
    return min(fit, -(-S // TILE), MAX_SPLITS)


def split_range(lo: int, hi: int, split: int, n_splits: int,
                tile: int = TILE) -> Tuple[int, int]:
    """``[s0, s1)``, the slots split ``split`` of ``n_splits`` takes of a row
    whose live extent is ``[lo, hi]`` (empty when ``s0 == s1``), as the kernel
    computes it: shares of ``ceil(len / n_splits)`` slots rounded up to whole
    tiles, in order, so they cover ``[lo, hi]`` once and split 0 starts at
    ``lo``. A row with no valid slot has the extent ``[0, S - 1]``."""
    per = -(-(hi - lo + 1) // n_splits)
    share = -(-per // tile) * tile
    s1 = min(hi + 1, lo + (split + 1) * share)
    return min(s1, lo + split * share), s1


@functools.lru_cache(maxsize=None)
def _launch_fn():
    fn = library("decode_attention").decode_attention_launch
    fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 7
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_float, ctypes.c_int,
                      ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def blocks_per_sm(device_index: int, d: int, dtype: torch.dtype, g: int) -> int:
    """How many split-kernel blocks fit on one SM at this configuration (its
    shared-memory ring sets it), from the CUDA occupancy query."""
    fn = library("decode_attention").decode_attention_blocks_per_sm
    fn.argtypes = [ctypes.c_int] * 3 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    n = ctypes.c_int(0)
    with on_device(torch.device("cuda", device_index)):
        check(fn(d, _DTYPE_CODES[dtype], g, ctypes.byref(n)), "decode_attention occupancy")
    if n.value < 1:
        raise RuntimeError(f"decode_attention: no block fits an SM at d={d}, "
                           f"{dtype}, g={g}")
    return n.value


def _check_args(q, k_cache, v_cache, valid) -> None:
    if q.dim() != 3 or k_cache.dim() != 4 or v_cache.shape != k_cache.shape:
        raise ValueError(f"want q (B,H,d) and k/v (B,Hkv,S,d), got {tuple(q.shape)}, "
                         f"{tuple(k_cache.shape)}, {tuple(v_cache.shape)}")
    B, H, d = q.shape
    Hkv, S = k_cache.shape[1], k_cache.shape[2]
    if k_cache.shape[0] != B or k_cache.shape[3] != d or Hkv == 0 or H % Hkv:
        raise ValueError(f"incompatible q {tuple(q.shape)} and cache "
                         f"{tuple(k_cache.shape)}")
    if S == 0:
        raise ValueError("attention over an empty cache is undefined")
    if tuple(valid.shape) not in ((S,), (B, S)):
        raise ValueError(f"valid must be ({S},) or ({B}, {S}), got {tuple(valid.shape)}")
    if not (q.dtype == k_cache.dtype == v_cache.dtype):
        raise TypeError(f"q and cache dtypes differ: {q.dtype}, {k_cache.dtype}, "
                        f"{v_cache.dtype}")
    if not (q.device == k_cache.device == v_cache.device == valid.device):
        raise ValueError("q, cache and mask must be on one device")
    if q.device.type not in ("cpu", "cuda", "meta"):
        raise ValueError(f"unsupported device {q.device}")


@torch.library.custom_op("repro_torch::decode_attention", mutates_args=(),
                         device_types="cpu")
def _decode_op(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
               valid: torch.Tensor, softcap: Optional[float], scale: Optional[float],
               with_lse: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(out, lse)``; lse ``(B, H)`` fp32 with ``with_lse``, else empty."""
    if with_lse:
        return decode_attention_plain(q, k_cache, v_cache, valid, softcap=softcap,
                                      scale=scale, return_lse=True)
    return (decode_attention_plain(q, k_cache, v_cache, valid, softcap=softcap,
                                   scale=scale), q.new_empty((0,), dtype=torch.float32))


@_decode_op.register_kernel("cuda")
def _decode_cuda(q, k_cache, v_cache, valid, softcap, scale, with_lse):
    B, H, d = q.shape
    Hkv, S = k_cache.shape[1], k_cache.shape[2]
    if q.dtype not in _DTYPE_CODES:
        raise TypeError(f"the kernel takes float32 or bfloat16, got {q.dtype}")
    check_shape(d, H // Hkv)
    if not all(t.is_contiguous() and t.data_ptr() % 16 == 0 for t in (q, k_cache, v_cache)):
        raise ValueError("q and the cache must be contiguous and 16-byte aligned")
    if B * Hkv > 65535:
        raise ValueError(f"B*Hkv = {B * Hkv} exceeds the grid limit 65535")
    n_sms = torch.cuda.get_device_properties(q.device).multi_processor_count
    fit = blocks_per_sm(q.device.index if q.device.index is not None
                        else torch.cuda.current_device(), d, q.dtype, H // Hkv)
    out = launch_splits(q, k_cache, v_cache, valid, plan_splits(B, Hkv, S, n_sms, fit),
                        softcap=softcap, scale=scale, return_lse=with_lse)
    return out if with_lse else (out, q.new_empty((0,), dtype=torch.float32))


@_decode_op.register_fake
def _decode_fake(q, k_cache, v_cache, valid, softcap, scale, with_lse):
    """Shapes only, and the kernel's refusal of an uncompiled (head dim,
    group) pair, so a traced program the card would refuse fails too."""
    check_shape(q.shape[2], q.shape[1] // k_cache.shape[1])
    lse_shape = tuple(q.shape[:2]) if with_lse else (0,)
    return torch.empty_like(q), q.new_empty(lse_shape, dtype=torch.float32)


@register_flop_formula(torch.ops.repro_torch.decode_attention)
def decode_attention_flops(q_shape, k_shape, *args, out_shape=None, **kwargs) -> int:
    """Two products of 2 FLOPs a multiply-add (q.K and p.V) over every slot:
    an upper bound, since the kernel reads only each row's live extent, which
    the mask sets at run time."""
    B, H, d = q_shape
    return 4 * B * H * k_shape[2] * d


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
                     valid: torch.Tensor, *, softcap: Optional[float] = None,
                     scale: Optional[float] = None, return_lse: bool = False):
    """Attention of q ``(B, H, d)`` over a cache ``(B, Hkv, S, d)`` where
    ``valid`` (``(S,)`` or ``(B, S)``, bool or integer) marks the live slots;
    with ``return_lse``, ``(out, lse)`` (see :func:`decode_attention_plain`).

    The PyTorch op ``repro_torch::decode_attention``: CPU tensors run
    :func:`decode_attention_plain`; CUDA tensors launch the kernel
    (contiguous, 16-byte aligned fp32 or bf16, (d, g) in :data:`SHAPES`),
    counted in ``decode_attention.launches``; a fake implementation gives
    shapes (``torch.export``, meta tensors, the dry run) and refuses the
    pairs the kernel does. The kernel has no backward: a CUDA input that
    requires a gradient while grad mode is on raises.
    """
    with spans.span("kernel.decode_attention"):
        _check_args(q, k_cache, v_cache, valid)
        if q.device.type == "cuda":
            refuse_grad("decode_attention", q, k_cache, v_cache)
        out, lse = _decode_op(q, k_cache, v_cache, valid, softcap,
                              None if scale is None else float(scale), return_lse)
        return (out, lse) if return_lse else out


def launch_splits(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
                  valid: torch.Tensor, n_splits: int, *, softcap: Optional[float] = None,
                  scale: Optional[float] = None, return_lse: bool = False):
    """Launch the kernel on CUDA tensors that :func:`decode_attention` has
    checked, with ``n_splits`` blocks per (batch, kv head) row (the planner's
    choice there; other counts for a sweep). Counted in
    ``decode_attention.launches``."""
    B, H, d = q.shape
    Hkv, S = k_cache.shape[1], k_cache.shape[2]
    mask = (valid if valid.dtype == torch.bool else valid != 0).contiguous().view(
        torch.uint8)
    out = torch.empty_like(q)
    part = (torch.empty(B * H * n_splits * (d + 2), dtype=torch.float32,
                        device=q.device) if n_splits > 1 else None)
    lse = torch.empty((B, H), dtype=torch.float32, device=q.device) if return_lse else None
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    with on_device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        status = _launch_fn()(q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
                              mask.data_ptr(), out.data_ptr(),
                              part.data_ptr() if part is not None else None,
                              lse.data_ptr() if lse is not None else None,
                              B, H, Hkv, S, d, _DTYPE_CODES[q.dtype],
                              S if valid.dim() == 2 else 0, float(scale),
                              int(softcap is not None),
                              float(softcap) if softcap is not None else 0.0,
                              n_splits, stream)
    check(status, "decode_attention")
    with _count_lock:
        decode_attention.launches += 1
    return (out, lse) if return_lse else out


decode_attention.launches = 0
