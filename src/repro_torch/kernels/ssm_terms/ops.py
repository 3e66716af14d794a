"""Recurrence inputs of the Mamba-1 selective scan: ``a = exp(dt * A)`` and
``b = (dt * x) * B`` with ``dt = softplus(raw + dt_bias)`` and ``A =
-exp(A_log)``.

Replaces no TPU kernel: the reference builds a and b in jnp inside
``src/repro/models/ssm.py`` ``_selective_terms`` and XLA fuses the chain.
Takes the dt_proj product's raw output ``raw``, ``x`` (both ``(B, S, di)``;
x in the conv's ``(B, di, S)`` memory layout as the model hands it over),
``B`` ``(B, S, n)`` (a view of x_proj's product), each with any strides,
and ``dt_bias`` ``(di,)`` and ``A_log`` ``(di, n)``; returns ``a``, ``b``
``(B, S, di, n)`` in fp32, the layout ``diag_recurrence`` scans.

On the card it is bound by bytes: a and b written once, 8 bytes an element,
against inputs 1/n that size. The CUDA source (``csrc/ssm_terms.cu``) gives
a warp 32 adjacent channels over 32 rows, computes dt once a (row, channel),
keeps ``-exp(A_log)`` in registers and writes a and b in 512-byte runs,
with no fp32 intermediate in device memory. It computes the plain
expression's operations in the same order in fp32 (``expf``, ``log1pf``,
PyTorch's softplus threshold of 20, no fused multiply-add).

The kernel is the PyTorch op ``repro_torch::ssm_terms``: the plain version
on the CPU, the kernel on CUDA (bf16 or fp32 inputs; raises on anything
else), a fake implementation for meta tensors and ``torch.export``, and an
autograd formula in tensor ops, :func:`ssm_terms_backward`. Its work is
elementwise, so it registers no FLOP formula (``launch/cost.py`` counts no
elementwise FLOPs).
"""
from __future__ import annotations

import ctypes
import functools
import threading
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch import spans
from repro_torch.kernels.build import check, library, on_device

#: state sizes the kernel instantiates: falcon-mamba-7b's 16 and the reduced
#: presets' 4 (a lane stores 4 states of 128 / n channels)
STATES = (4, 16)
_count_lock = threading.Lock()


def _acc(dt_bias: torch.Tensor) -> torch.dtype:
    """The dtype a and b are computed in: fp32, or float64 for float64 inputs."""
    return torch.promote_types(dt_bias.dtype, torch.float32)


def ssm_terms_plain(raw: torch.Tensor, dt_bias: torch.Tensor, A_log: torch.Tensor,
                    x: torch.Tensor, B: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version: the reference's ``_selective_terms`` expression."""
    acc = _acc(dt_bias)
    dt = F.softplus(raw.to(acc) + dt_bias)
    A = -torch.exp(A_log)
    a = torch.exp(dt[..., None] * A)
    b = (dt * x.to(acc))[..., None] * B.to(acc)[:, :, None, :]
    return a, b


def ssm_terms_backward(raw, dt_bias, A_log, x, B, a, g_a: Optional[torch.Tensor],
                       g_b: Optional[torch.Tensor]):
    """Gradients of ``(raw, dt_bias, A_log, x, B)`` from those of a and b
    (either may be None): ``da/ddt = a A``, ``da/dA = a dt``, ``dA/dA_log =
    A``, ``db/ddt = x B``, ``db/dx = dt B``, ``db/dB = dt x``, and ``ddt/draw
    = ddt/ddt_bias = sigmoid(raw + dt_bias)`` (1 past the softplus threshold,
    as ``softplus_backward`` has it)."""
    acc = a.dtype
    z = raw.to(acc) + dt_bias
    dt = F.softplus(z)
    A = -torch.exp(A_log)
    xf = x.to(acc)
    g_dt = torch.zeros_like(dt)
    g_A = torch.zeros_like(A)
    g_x = torch.zeros_like(xf)
    g_B = torch.zeros(B.shape, dtype=acc, device=B.device)
    if g_a is not None:
        g_aa = g_a * a
        g_dt = g_dt + (g_aa * A).sum(-1)
        g_A = (g_aa * dt[..., None]).sum((0, 1))
    if g_b is not None:
        g_bB = (g_b * B.to(acc)[:, :, None, :]).sum(-1)
        g_dt = g_dt + g_bB * xf
        g_x = g_bB * dt
        g_B = (g_b * (dt * xf)[..., None]).sum(2)
    g_z = torch.ops.aten.softplus_backward(g_dt, z, 1, 20)
    return (g_z.to(raw.dtype), g_z.sum((0, 1)).to(dt_bias.dtype), (g_A * A).to(A_log.dtype),
            g_x.to(x.dtype), g_B.to(B.dtype))


@functools.lru_cache(maxsize=None)
def _launch_fn():
    fn = library("ssm_terms").ssm_terms_launch
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 5 + [ctypes.c_void_p] * 2
    fn.restype = ctypes.c_int
    return fn


def _check_args(raw, dt_bias, A_log, x, B) -> None:
    if raw.dim() != 3 or x.shape != raw.shape:
        raise ValueError(f"want raw and x (B,S,di), got {tuple(raw.shape)}, {tuple(x.shape)}")
    Bn, S, di = raw.shape
    if A_log.dim() != 2 or A_log.shape[0] != di or tuple(dt_bias.shape) != (di,):
        raise ValueError(f"want dt_bias ({di},) and A_log ({di}, n), got "
                         f"{tuple(dt_bias.shape)}, {tuple(A_log.shape)}")
    if tuple(B.shape) != (Bn, S, A_log.shape[1]):
        raise ValueError(f"want B ({Bn}, {S}, {A_log.shape[1]}), got {tuple(B.shape)}")
    if not (raw.dtype == x.dtype == B.dtype and dt_bias.dtype == A_log.dtype):
        raise TypeError(f"want raw, x, B of one dtype and dt_bias, A_log of one, got "
                        f"{raw.dtype}, {x.dtype}, {B.dtype}; {dt_bias.dtype}, {A_log.dtype}")
    if len({t.device for t in (raw, dt_bias, A_log, x, B)}) != 1:
        raise ValueError("raw, dt_bias, A_log, x, B must be on one device")
    if raw.device.type not in ("cpu", "cuda", "meta"):
        raise ValueError(f"unsupported device {raw.device}")


def _run_cuda(raw, dt_bias, A_log, x, B) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel on CUDA tensors, counted in ``ssm_terms.launches``."""
    if raw.dtype not in (torch.bfloat16, torch.float32) or dt_bias.dtype != torch.float32:
        raise TypeError(f"the kernel takes bf16 or float32 raw, x, B and float32 dt_bias, "
                        f"A_log, got {raw.dtype} and {dt_bias.dtype}")
    Bn, S, di = raw.shape
    n = A_log.shape[1]
    if n not in STATES:
        raise ValueError(f"the kernel takes a state size in {STATES}, got {n}")
    if not (dt_bias.is_contiguous() and A_log.is_contiguous()):
        raise ValueError("dt_bias and A_log must be contiguous")
    a = torch.empty((Bn, S, di, n), dtype=torch.float32, device=raw.device)
    b = torch.empty_like(a)
    if a.numel() == 0:
        return a, b
    strides = (ctypes.c_longlong * 9)(*raw.stride(), *x.stride(), *B.stride())
    with on_device(raw.device):
        stream = torch.cuda.current_stream(raw.device).cuda_stream
        status = _launch_fn()(raw.data_ptr(), dt_bias.data_ptr(), A_log.data_ptr(),
                              x.data_ptr(), B.data_ptr(), a.data_ptr(), b.data_ptr(),
                              int(raw.dtype == torch.bfloat16), Bn, S, di, n,
                              ctypes.addressof(strides), stream)
    check(status, "ssm_terms")
    with _count_lock:
        ssm_terms.launches += 1
    return a, b


@torch.library.custom_op("repro_torch::ssm_terms", mutates_args=(), device_types="cpu")
def _terms_op(raw: torch.Tensor, dt_bias: torch.Tensor, A_log: torch.Tensor,
              x: torch.Tensor, B: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    return ssm_terms_plain(raw, dt_bias, A_log, x, B)


_terms_op.register_kernel("cuda")(_run_cuda)


@_terms_op.register_fake
def _terms_fake(raw, dt_bias, A_log, x, B):
    shape = (*raw.shape, A_log.shape[1])
    acc = _acc(dt_bias)
    return raw.new_empty(shape, dtype=acc), raw.new_empty(shape, dtype=acc)


def _terms_setup(ctx, inputs, output) -> None:
    ctx.save_for_backward(*inputs, output[0])


def _terms_grad(ctx, g_a, g_b):
    return ssm_terms_backward(*ctx.saved_tensors, g_a, g_b)


_terms_op.register_autograd(_terms_grad, setup_context=_terms_setup)


def ssm_terms(raw: torch.Tensor, dt_bias: torch.Tensor, A_log: torch.Tensor,
              x: torch.Tensor, B: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(a, b)``, each ``(B, S, di, n)``, of one chunk's selective scan.

    CPU tensors run :func:`ssm_terms_plain`; CUDA tensors launch the kernel
    (bf16 or float32 raw, x and B; float32 dt_bias and A_log; n in
    :data:`STATES`), counted in ``ssm_terms.launches``. Differentiable: the
    backward is :func:`ssm_terms_backward`.
    """
    with spans.span("kernel.ssm_terms"):
        _check_args(raw, dt_bias, A_log, x, B)
        return _terms_op(raw, dt_bias, A_log, x, B)


ssm_terms.launches = 0
