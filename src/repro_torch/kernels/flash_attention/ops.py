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

The kernel is the PyTorch op ``repro_torch::flash_attention``: the plain
version on the CPU, the kernel on CUDA, a fake implementation for
``torch.export`` and an autograd formula. When a gradient will be taken the
forward (either route) also writes each row's log-sum-exp in fp32, and the
backward runs FlashAttention-2's algorithm in CUDA on the tensor cores
(:func:`flash_attention_backward`, itself the op
``repro_torch::flash_attention_backward`` with a fake), on the route
:data:`BWD_ROUTES` names for the dtype: bf16 on ``mma.sync`` with fp32 sums
and P and dS rounded to bf16 before their products (``tc_bf16``), fp32 as
three TF32 products per product (``tc_tf32x3``), which keeps the fp32 bar.
"""
from __future__ import annotations

import ctypes
import functools
import math
import threading
from typing import List, NamedTuple, Optional, Tuple

import numpy as np
import torch
from torch.utils.flop_counter import register_flop_formula

from repro_torch import spans
from repro_torch.kernels.build import check, launch_pass, library, on_device

NEG_INF = -2.0e38
#: head dims with a compiled forward kernel; 120 (h2o-danube3) runs on tiles
#: 128 wide whose pad columns are zeros in shared memory, never in device
#: memory; 16 is the reduced qwen3-1.7b that examples/serve_e2e_torch.py serves
HEAD_DIMS = (16, 32, 64, 120, 128, 256)
#: head dims with compiled backward kernels (every trained config's)
BWD_HEAD_DIMS = (32, 64, 120, 128, 256)
ROUTES = ("cuda_core", "tc_bf16")     # index = the route code the CUDA side takes
#: (block_q, block_k) of the tensor-core route at every head dim, as compiled
#: in csrc/flash_attention.cu: 4 warps of 16 q rows, 64-key tiles (on one
#: H100, 128-row q tiles, 32- or 128-key tiles and 32 rows per warp were all
#: slower; PERF.md)
TC_TILES = (64, 64)
CORE_TILES = (64, 64)
#: the backward's route by dtype; the CUDA side takes 0 for fp32, 1 for bf16
BWD_ROUTES = {torch.float32: "tc_tf32x3", torch.bfloat16: "tc_bf16"}
#: rows of the backward's resident tiles (keys in the dK/dV launch, queries in
#: the dQ launch), as compiled in csrc/flash_attention.cu (BwdCfg::TR): each
#: launch has one block row per tile of them
BWD_ROWS = 64
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


def _plain_scores(q, k, causal, window, softcap, scale) -> torch.Tensor:
    """The plain version's logits ``(B, Hkv, g, Sq, Sk)`` in fp32: scaled,
    soft-capped, masked logits set to the finite :data:`NEG_INF`."""
    B, H, Sq, d = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    qg = q.reshape(B, Hkv, H // Hkv, Sq, d).float()
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
    return torch.where(mask, s, torch.full_like(s, NEG_INF))


def flash_attention_plain(q, k, v, *, causal=True, window=None, softcap=None,
                          scale=None) -> torch.Tensor:
    """Plain PyTorch version, mirroring ``flash_attention/ref.py``: fp32
    einsum, softcap, finite ``NEG_INF`` mask, softmax, einsum, cast."""
    B, H, Sq, d = q.shape
    p = torch.softmax(_plain_scores(q, k, causal, window, softcap, scale), dim=-1)
    out = torch.einsum("bhgqk,bhkd->bhgqd", p, v.float())
    return out.reshape(B, H, Sq, d).to(q.dtype)


def flash_attention_backward_plain(q, k, v, dout, *, causal=True, window=None,
                                   softcap=None, scale=None
                                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(dq, dk, dv)``: ``torch.autograd.grad`` through
    :func:`flash_attention_plain` at the same inputs. On bf16 inputs every
    product runs in fp32 and each gradient is rounded to bf16 once, as the
    kernel's are."""
    with torch.enable_grad():
        qkv = [t.detach().requires_grad_(True) for t in (q, k, v)]
        out = flash_attention_plain(*qkv, causal=causal, window=window, softcap=softcap,
                                    scale=scale)
        return torch.autograd.grad(out, qkv, dout)


def _check_args(q, k, v) -> None:
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
    if q.device.type not in ("cpu", "cuda", "meta"):
        raise ValueError(f"unsupported device {q.device}")


@functools.lru_cache(maxsize=None)
def _launch_fn():
    fn = library("flash_attention").flash_attention_launch
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 10
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                      ctypes.c_int, ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def _backward_fn():
    fn = library("flash_attention").flash_attention_backward_launch
    fn.argtypes = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 8
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                      ctypes.c_int, ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


@torch.library.custom_op("repro_torch::flash_attention", mutates_args=(),
                         device_types="cpu")
def _flash_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool,
              window: Optional[int], softcap: Optional[float], scale: float,
              with_lse: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(out, lse)``; lse ``(B, H, Sq)`` fp32 with ``with_lse``, else empty."""
    out = flash_attention_plain(q, k, v, causal=causal, window=window, softcap=softcap,
                                scale=scale)
    if not with_lse:
        return out, q.new_empty((0,), dtype=torch.float32)
    s = _plain_scores(q, k, causal, window, softcap, scale)
    return out, torch.logsumexp(s, dim=-1).reshape(q.shape[:3])


@_flash_op.register_kernel("cuda")
def _flash_cuda(q, k, v, causal, window, softcap, scale, with_lse):
    B, H, Sq, d = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    p = plan(q.dtype, d, Sq, causal)
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("q, k, v must be contiguous")
    if p.route == "tc_bf16" and any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("the tensor-core route takes 16-byte aligned q, k, v")
    if p.n_q_tiles > 65535:
        raise ValueError(f"{p.n_q_tiles} q tiles exceed the grid limit 65535")
    out = torch.empty_like(q)
    lse = q.new_empty((B, H, Sq) if with_lse else (0,), dtype=torch.float32)
    fn = _launch_fn()
    with on_device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        status = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                    lse.data_ptr() if with_lse else None,
                    B, H, Hkv, Sq, Sk, d, ROUTES.index(p.route), p.block_q, p.block_k,
                    int(p.heavy_first), float(scale), int(causal),
                    int(window is not None), int(window) if window is not None else 0,
                    int(softcap is not None),
                    float(softcap) if softcap is not None else 0.0, stream)
    check(status, "flash_attention")
    with _count_lock:
        flash_attention.launches += 1
        flash_attention.launches_by_route[p.route] += 1
        flash_attention.launches_by_pass[launch_pass()] += 1
    return out, lse


@_flash_op.register_fake
def _flash_fake(q, k, v, causal, window, softcap, scale, with_lse):
    lse_shape = tuple(q.shape[:3]) if with_lse else (0,)
    return torch.empty_like(q), q.new_empty(lse_shape, dtype=torch.float32)


def _flash_setup(ctx, inputs, output) -> None:
    q, k, v, causal, window, softcap, scale, _ = inputs
    ctx.save_for_backward(q, k, v, *output)
    ctx.opts = dict(causal=causal, window=window, softcap=softcap, scale=scale)


def _flash_grad(ctx, dout, _dlse):
    q, k, v, out, lse = ctx.saved_tensors
    dq, dk, dv = flash_attention_backward(q, k, v, out, lse, dout, **ctx.opts)
    return dq, dk, dv, None, None, None, None, None


_flash_op.register_autograd(_flash_grad, setup_context=_flash_setup)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: Optional[int] = None,
                    softcap: Optional[float] = None,
                    scale: Optional[float] = None) -> torch.Tensor:
    """Attention over q ``(B, H, Sq, d)`` and k/v ``(B, Hkv, Sk, d)``.

    CPU tensors run :func:`flash_attention_plain`; CUDA tensors launch the
    kernel on the route :func:`plan` picks (contiguous fp32 or bf16, d in
    :data:`HEAD_DIMS`; bf16 16-byte aligned), counted in
    ``flash_attention.launches``, per route in
    ``flash_attention.launches_by_route`` and per pass (``forward``, or
    ``recompute`` inside a backward) in ``flash_attention.launches_by_pass``.
    Differentiable: when grad mode is on and an input requires a gradient,
    the kernel also writes the rows' log-sum-exp for the backward.
    """
    with spans.span("kernel.flash_attention"):
        _check_args(q, k, v)
        scale = scale if scale is not None else 1.0 / math.sqrt(q.shape[3])
        with_lse = torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v))
        return _flash_op(q, k, v, causal, window, softcap, float(scale), with_lse)[0]


def flash_attention_backward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                             out: torch.Tensor, lse: torch.Tensor, dout: torch.Tensor, *,
                             causal: bool = True, window: Optional[int] = None,
                             softcap: Optional[float] = None,
                             scale: Optional[float] = None
                             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(dq, dk, dv)`` of :func:`flash_attention` given its output ``out``,
    its rows' log-sum-exp ``lse`` and the output's gradient ``dout``.

    CPU tensors run :func:`flash_attention_backward_plain` (``out`` and
    ``lse`` unused); other tensors go through the PyTorch op
    ``repro_torch::flash_attention_backward``: on CUDA it launches the
    backward kernels (fp32 or bf16, contiguous and 16-byte aligned; the
    gradients in the inputs' dtype), counted in
    ``flash_attention_backward.launches`` and per route (:data:`BWD_ROUTES`)
    in ``flash_attention_backward.launches_by_route``; on meta and fake
    tensors its fake implementation gives the shapes.
    """
    _check_args(q, k, v)
    if q.device.type == "cpu":
        return flash_attention_backward_plain(q, k, v, dout, causal=causal, window=window,
                                              softcap=softcap, scale=scale)
    B, H, Sq, d = q.shape
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"the flash_attention backward takes float32 or bfloat16, "
                        f"got {q.dtype}")
    if out.dtype != q.dtype or dout.dtype != q.dtype:
        raise TypeError(f"out and dout must be {q.dtype}, got {out.dtype}, {dout.dtype}")
    if d not in BWD_HEAD_DIMS:
        raise ValueError(f"the backward takes head dim in {BWD_HEAD_DIMS}, got {d}")
    if tuple(lse.shape) != (B, H, Sq):
        raise ValueError(f"lse {tuple(lse.shape)} is not (B, H, Sq): the forward ran "
                         f"without a gradient to take")
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    return _flash_bwd_op(q, k, v, out, lse, dout.contiguous(), causal, window, softcap,
                         float(scale))


@torch.library.custom_op("repro_torch::flash_attention_backward", mutates_args=(),
                         device_types="cuda")
def _flash_bwd_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, out: torch.Tensor,
                  lse: torch.Tensor, dout: torch.Tensor, causal: bool,
                  window: Optional[int], softcap: Optional[float], scale: float
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    B, H, Sq, d = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    if not all(t.is_contiguous() for t in (q, k, v, out, lse)):
        raise ValueError("q, k, v, out and lse must be contiguous")
    if any(t.data_ptr() % 16 for t in (q, k, v, out, dout)):
        raise ValueError("the backward takes 16-byte aligned q, k, v, out and dout")
    if -(-max(Sq, Sk) // BWD_ROWS) > 65535:
        raise ValueError(f"Sq {Sq} / Sk {Sk} exceed the grid limit")
    route = BWD_ROUTES[q.dtype]
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    delta = torch.empty_like(lse)
    with on_device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        status = _backward_fn()(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), dout.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            B, H, Hkv, Sq, Sk, d, int(q.dtype == torch.bfloat16),
            int(causal), float(scale), int(causal),
            int(window is not None), int(window) if window is not None else 0,
            int(softcap is not None), float(softcap) if softcap is not None else 0.0,
            stream)
    check(status, "flash_attention_backward")
    with _count_lock:
        flash_attention_backward.launches += 1
        flash_attention_backward.launches_by_route[route] += 1
    return dq, dk, dv


@_flash_bwd_op.register_fake
def _flash_bwd_fake(q, k, v, out, lse, dout, causal, window, softcap, scale):
    return torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)


@functools.lru_cache(maxsize=None)
def attention_pairs(Sq: int, Sk: int, causal: bool, window: Optional[int]) -> int:
    """The (query, key) pairs the mask leaves, as the plain version's mask
    places them (query i, key j: ``j <= i`` when causal, ``i - j < window``
    with a window)."""
    i = np.arange(Sq, dtype=np.int64)
    lo = np.maximum(i - window + 1, 0) if window is not None else np.zeros_like(i)
    hi = np.minimum(i, Sk - 1) if causal else np.full_like(i, Sk - 1)
    return int(np.clip(hi - lo + 1, 0, None).sum())


@register_flop_formula(torch.ops.repro_torch.flash_attention)
def flash_attention_flops(q_shape, k_shape, v_shape, causal, window, *args,
                          out_shape=None, **kwargs) -> int:
    """Two products of 2 FLOPs a multiply-add (QK^T and PV) over the pairs
    the mask leaves: the kernel skips the tiles the mask hides."""
    B, H, Sq, d = q_shape
    return 4 * B * H * d * attention_pairs(Sq, k_shape[2], causal, window)


@register_flop_formula(torch.ops.repro_torch.flash_attention_backward)
def flash_attention_backward_flops(q_shape, k_shape, v_shape, out_shape_, lse_shape,
                                   dout_shape, causal, window, *args, out_shape=None,
                                   **kwargs) -> int:
    """FlashAttention-2's backward: five products of the forward's size (QK^T
    again, dP = dO V^T, dV = P^T dO, dQ = dS K, dK = dS^T Q)."""
    B, H, Sq, d = q_shape
    return 10 * B * H * d * attention_pairs(Sq, k_shape[2], causal, window)


flash_attention.launches = 0
flash_attention.launches_by_route = dict.fromkeys(ROUTES, 0)
flash_attention.launches_by_pass = dict.fromkeys(("forward", "recompute"), 0)
flash_attention_backward.launches = 0
flash_attention_backward.launches_by_route = dict.fromkeys(BWD_ROUTES.values(), 0)
