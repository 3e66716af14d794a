"""Flash attention: blockwise online-softmax attention for prefill.

Replaces the TPU kernel ``src/repro/kernels/flash_attention/kernel.py``
(``flash_attention_pallas``), with the same contract: q ``(B, H, Sq, d)``,
k/v ``(B, Hkv, Sk, d)``, causal / sliding-window / softcap options, GQA by
``h -> h // g``, fp32 accumulation, output in ``q.dtype``.

On the card it is bound by operations at the prefill shapes. The CUDA source
(``csrc/flash_attention.cu``) has two routes, chosen by :func:`plan` from the
dtype alone: bf16 runs ``tc_bf16``, products on the tensor cores
(``mma.sync`` m16n8k16, fp32 accumulation, P rounded to bf16 before P.V as
the JAX model rounds it), K/V tiles double-buffered through ``cp.async``;
fp32 runs ``cuda_core``, fp32 products on CUDA cores, which keeps the fp32
bar of 2e-5 that TF32 would break. Both keep the running max, denominator and
accumulator in fp32 registers, skip kv tiles that the causal or window mask
hides from a whole q tile, and launch causal q tiles heaviest first.
"""
from __future__ import annotations

import ctypes
import functools
import math
import threading
from typing import List, NamedTuple, Optional

import torch

from repro_torch.kernels.build import check, library, on_device

NEG_INF = -2.0e38
#: head dims with a compiled kernel; 120 (h2o-danube3) runs on tiles 128 wide
#: whose pad columns are zeros in shared memory, never in device memory
HEAD_DIMS = (32, 64, 120, 128, 256)
ROUTES = ("cuda_core", "tc_bf16")     # index = the route code the CUDA side takes
#: (block_q, block_k) of the tensor-core route at every head dim, as compiled
#: in csrc/flash_attention.cu: 4 warps of 16 q rows, 64-key tiles (on one
#: H100, 128-row q tiles, 32- or 128-key tiles and 32 rows per warp were all
#: slower; PERF.md)
TC_TILES = (64, 64)
CORE_TILES = (64, 64)
_count_lock = threading.Lock()


class FlashPlan(NamedTuple):
    route: str            # "tc_bf16" or "cuda_core"
    block_q: int
    block_k: int
    n_q_tiles: int
    heavy_first: bool     # launch the q tiles with the most unmasked keys first


def plan(dtype: torch.dtype, d: int, Sq: int, causal: bool) -> FlashPlan:
    """The launch geometry for one call: bf16 runs on the tensor cores, fp32 on
    CUDA cores; causal q tiles (whose work grows with the tile index) are
    launched in reverse so the longest ones start first. Both routes take
    every head dim in :data:`HEAD_DIMS`."""
    if d not in HEAD_DIMS:
        raise ValueError(f"the kernel takes head dim in {HEAD_DIMS}, got {d}")
    if dtype == torch.bfloat16:
        route, (bq, bk) = "tc_bf16", TC_TILES
    elif dtype == torch.float32:
        route, (bq, bk) = "cuda_core", CORE_TILES
    else:
        raise TypeError(f"the kernel takes float32 or bfloat16, got {dtype}")
    return FlashPlan(route, bq, bk, -(-Sq // bq), bool(causal))


def q_tile_order(p: FlashPlan) -> List[int]:
    """The q tile each launch position (grid row ``blockIdx.y``) computes, as
    the CUDA side maps it."""
    n = p.n_q_tiles
    return [n - 1 - y if p.heavy_first else y for y in range(n)]


def flash_attention_plain(q, k, v, *, causal=True, window=None, softcap=None,
                          scale=None) -> torch.Tensor:
    """Plain PyTorch version, mirroring ``flash_attention/ref.py``: fp32
    einsum, softcap, finite ``NEG_INF`` mask, softmax, einsum, cast."""
    B, H, Sq, d = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    g = H // Hkv
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    qg = q.reshape(B, Hkv, g, Sq, d).float()
    s = torch.einsum("bhgqd,bhkd->bhgqk", qg, k.float()) * scale
    if softcap is not None:
        s = softcap * torch.tanh(s / softcap)
    qi = torch.arange(Sq, device=q.device)[:, None]
    ki = torch.arange(Sk, device=q.device)[None, :]
    mask = torch.ones((Sq, Sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= ki <= qi
    if window is not None:
        mask &= (qi - ki) < window
    s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhgqk,bhkd->bhgqd", p, v.float())
    return out.reshape(B, H, Sq, d).to(q.dtype)


@functools.lru_cache(maxsize=None)
def _launch_fn():
    fn = library("flash_attention").flash_attention_launch
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 10
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                      ctypes.c_int, ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: Optional[int] = None,
                    softcap: Optional[float] = None,
                    scale: Optional[float] = None) -> torch.Tensor:
    """Attention over q ``(B, H, Sq, d)`` and k/v ``(B, Hkv, Sk, d)``.

    CPU tensors run :func:`flash_attention_plain`; CUDA tensors launch the
    kernel on the route :func:`plan` picks (contiguous fp32 or bf16, d in
    :data:`HEAD_DIMS`; bf16 16-byte aligned), counted in
    ``flash_attention.launches`` and per route in
    ``flash_attention.launches_by_route``.
    """
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"want q (B,H,Sq,d) and k/v (B,Hkv,Sk,d), got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    B, H, Sq, d = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    if k.shape[0] != B or k.shape[3] != d or Hkv == 0 or H % Hkv:
        raise ValueError(f"incompatible q {tuple(q.shape)} and k {tuple(k.shape)}")
    if Sk == 0:
        raise ValueError("attention over zero keys is undefined")
    if not (q.dtype == k.dtype == v.dtype):
        raise TypeError(f"q, k, v dtypes differ: {q.dtype}, {k.dtype}, {v.dtype}")
    if not (q.device == k.device == v.device):
        raise ValueError("q, k, v must be on one device")
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, window=window,
                                     softcap=softcap, scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    p = plan(q.dtype, d, Sq, causal)
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("q, k, v must be contiguous")
    if p.route == "tc_bf16" and any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("the tensor-core route takes 16-byte aligned q, k, v")
    if p.n_q_tiles > 65535:
        raise ValueError(f"{p.n_q_tiles} q tiles exceed the grid limit 65535")
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    out = torch.empty_like(q)
    fn = _launch_fn()
    with on_device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        status = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                    B, H, Hkv, Sq, Sk, d, ROUTES.index(p.route), p.block_q, p.block_k,
                    int(p.heavy_first), float(scale), int(causal),
                    int(window is not None), int(window) if window is not None else 0,
                    int(softcap is not None),
                    float(softcap) if softcap is not None else 0.0, stream)
    check(status, "flash_attention")
    with _count_lock:
        flash_attention.launches += 1
        flash_attention.launches_by_route[p.route] += 1
    return out


flash_attention.launches = 0
flash_attention.launches_by_route = dict.fromkeys(ROUTES, 0)
