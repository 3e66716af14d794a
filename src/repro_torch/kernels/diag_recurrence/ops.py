"""Diagonal linear recurrence: ``h_t = a_t * h_{t-1} + b_t`` over channels.

Replaces the TPU kernel ``src/repro/kernels/diag_recurrence/kernel.py``
(``diag_recurrence_pallas``), with its oracle's contract
(``diag_recurrence/ref.py``): a, b ``(B, S, C)``, h0 ``(B, C)``; returns
``(h_all (B, S, C), h_final (B, C))``, ``h_final`` equal to ``h_all[:, -1]``.
It serves the Mamba-1 selective scan (channels = d_inner * ssm_state) and the
RG-LRU (channels = lru_width).

On the card it is bound by bytes: a and b read once and h_all written once,
12 bytes per element. The CUDA source (``csrc/diag_recurrence.cu``) has two
routes, chosen by :func:`plan_recurrence` from the shape and the SM count:
``sequential`` gives each thread one (b, channel) and walks the sequence with
coalesced loads issued several rows ahead of the dependent chain, rounding
like PyTorch's ``a * h + b``, so it equals :func:`diag_recurrence_plain` bit
for bit; ``chunked``, for shapes with too few channels to fill the card, cuts
the sequence into chunks and gives each (b, channel, chunk) a thread: one
launch folds each chunk into its product of a and its end state from zero,
a second composes each chunk's carry-in from h0 over the earlier chunks and
runs the chunk from it (within the reference's 1e-4 of the plain version).

The kernel is the PyTorch op ``repro_torch::diag_recurrence``: the plain
version on the CPU, the kernel on CUDA, a fake implementation for
``torch.export`` and an autograd formula, :func:`diag_recurrence_backward`:
the adjoint of a diagonal linear recurrence is the same recurrence run
backwards in time, so the backward on the card is one more launch of this
kernel, with the flips, the shift and the products as tensor ops around it.
"""
from __future__ import annotations

import ctypes
import functools
import threading
from typing import Callable, NamedTuple, Optional, Tuple

import torch
from torch.utils.flop_counter import register_flop_formula

from repro_torch import spans
from repro_torch.kernels.build import check, launch_pass, library, on_device

ROUTES = ("sequential", "chunked")
U = 8                          # rows per load group in the kernel; chunks are multiples
#: B * C at or above this many threads per SM keeps the sequential route
#: (one thread per channel). On one H100 the chunked route won at 10,240
#: channels (78 per SM) and lost at 20,480 (155), at S=512 and 2048
#: (``python -m repro_torch.kernels.sweep``; PERF.md)
SEQUENTIAL_MIN_THREADS_PER_SM = 128
#: the chunked route aims at this many (b, channel, chunk) threads per SM
CHUNK_THREADS_PER_SM = 640
MAX_CHUNKS = 64                # the apply pass composes at most this many carries
_count_lock = threading.Lock()


class RecurrencePlan(NamedTuple):
    route: str                 # "sequential" or "chunked"
    chunk: int                 # rows per chunk (S on the sequential route)
    n_chunks: int


def plan_recurrence(B: int, S: int, C: int, n_sms: int) -> RecurrencePlan:
    """The route for one call: ``sequential`` where ``B * C`` threads fill the
    card (or the sequence is too short to cut), else ``chunked``
    (:func:`chunked_plan`)."""
    if B * C < SEQUENTIAL_MIN_THREADS_PER_SM * n_sms:
        p = chunked_plan(B, S, C, n_sms)
        if p is not None:
            return p
    return RecurrencePlan("sequential", S, 1)


def chunked_plan(B: int, S: int, C: int, n_sms: int) -> Optional[RecurrencePlan]:
    """Chunks of a multiple of :data:`U` rows, enough of them for about
    :data:`CHUNK_THREADS_PER_SM` (b, channel, chunk) threads per SM and at
    most :data:`MAX_CHUNKS`; None when that leaves fewer than two chunks."""
    want = min(MAX_CHUNKS, -(-CHUNK_THREADS_PER_SM * n_sms // (B * C)))
    per = -(-S // want)
    chunk = -(-per // U) * U
    n_chunks = -(-S // chunk)
    return RecurrencePlan("chunked", chunk, n_chunks) if n_chunks >= 2 else None


def diag_recurrence_plain(a: torch.Tensor, b: torch.Tensor, h0: torch.Tensor
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version: a sequential loop over S, ``diag_recurrence_ref``'s
    semantics."""
    h = h0.clone()
    h_all = torch.empty_like(a)
    for t in range(a.shape[1]):
        h = a[:, t] * h + b[:, t]
        h_all[:, t] = h
    return h_all, h


def diag_recurrence_backward(a: torch.Tensor, h0: torch.Tensor, h_all: torch.Tensor,
                             g_all: torch.Tensor, g_final: torch.Tensor,
                             recurrence_fn: Callable
                             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(da, db, dh0)`` of ``h_t = a_t * h_{t-1} + b_t`` from the gradients
    ``g_all`` of ``h_all`` and ``g_final`` of ``h_final``.

    The adjoint ``g_t = G_t + a_{t+1} g_{t+1}``, ``g_{S-1} = G_{S-1} +
    G_final``, is the recurrence over reversed time with decay ``a'_s =
    a_{S-s}`` (``a'_0 = 1``), input ``flip(G)`` and initial state
    ``G_final``: one call of ``recurrence_fn`` (the kernel's launcher on the
    card, :func:`diag_recurrence_plain` on the CPU). Then ``db = g``,
    ``da_t = g_t h_{t-1}`` (``h_{-1} = h0``) and ``dh0 = a_0 g_0``.
    """
    B, S, C = a.shape
    if S == 0:
        return torch.zeros_like(a), torch.zeros_like(a), g_final.clone()
    a_rev = torch.cat([torch.ones_like(a[:, :1]), a[:, 1:].flip(1)], dim=1)
    g_rev, _ = recurrence_fn(a_rev, g_all.flip(1).contiguous(), g_final.contiguous())
    g = g_rev.flip(1)
    h_prev = torch.cat([h0[:, None], h_all[:, :-1]], dim=1)
    return g * h_prev, g, a[:, 0] * g[:, 0]


@functools.lru_cache(maxsize=None)
def _launch_fn():
    fn = library("diag_recurrence").diag_recurrence_launch
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _check_args(a, b, h0) -> None:
    if a.dim() != 3 or b.shape != a.shape or tuple(h0.shape) != (a.shape[0], a.shape[2]):
        raise ValueError(f"want a, b (B,S,C) and h0 (B,C), got {tuple(a.shape)}, "
                         f"{tuple(b.shape)}, {tuple(h0.shape)}")
    if not (a.dtype == b.dtype == h0.dtype):
        raise TypeError(f"a, b, h0 dtypes differ: {a.dtype}, {b.dtype}, {h0.dtype}")
    if not (a.device == b.device == h0.device):
        raise ValueError("a, b, h0 must be on one device")
    if a.device.type not in ("cpu", "cuda", "meta"):
        raise ValueError(f"unsupported device {a.device}")


def _run_cuda(a: torch.Tensor, b: torch.Tensor, h0: torch.Tensor, pass_: str = ""
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel on CUDA tensors, on the route :func:`plan_recurrence` picks;
    ``pass_`` names the pass for ``launches_by_pass`` (default: ``forward``,
    or ``recompute`` inside a backward)."""
    if a.dtype != torch.float32:
        raise TypeError(f"the kernel takes float32, got {a.dtype}")
    if not (a.is_contiguous() and b.is_contiguous() and h0.is_contiguous()):
        raise ValueError("a, b, h0 must be contiguous")
    B, S, C = a.shape
    if B > 65535:
        raise ValueError(f"B = {B} exceeds the grid limit 65535")
    if S == 0:
        return torch.empty_like(a), h0.clone()
    n_sms = torch.cuda.get_device_properties(a.device).multi_processor_count
    return run_plan(a, b, h0, plan_recurrence(B, S, C, n_sms), pass_)


@torch.library.custom_op("repro_torch::diag_recurrence", mutates_args=(),
                         device_types="cpu")
def _diag_op(a: torch.Tensor, b: torch.Tensor, h0: torch.Tensor
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    return diag_recurrence_plain(a, b, h0)


_diag_op.register_kernel("cuda")(_run_cuda)


@_diag_op.register_fake
def _diag_fake(a, b, h0):
    return torch.empty_like(a), torch.empty_like(h0)


def _diag_setup(ctx, inputs, output) -> None:
    a, _, h0 = inputs
    ctx.save_for_backward(a, h0, output[0])


def _diag_grad(ctx, g_all, g_final):
    a, h0, h_all = ctx.saved_tensors
    g_all = torch.zeros_like(h_all) if g_all is None else g_all
    g_final = torch.zeros_like(h0) if g_final is None else g_final
    if a.device.type == "cpu":
        fn = diag_recurrence_plain
    elif a.device.type == "cuda":
        fn = functools.partial(_run_cuda, pass_="backward")
    else:                       # meta or fake tensors: the op's fake, for shapes
        fn = _diag_op
    return diag_recurrence_backward(a, h0, h_all, g_all, g_final, fn)


_diag_op.register_autograd(_diag_grad, setup_context=_diag_setup)


@register_flop_formula(torch.ops.repro_torch.diag_recurrence)
def diag_recurrence_flops(a_shape, *args, out_shape=None, **kwargs) -> int:
    """One multiply and one add per element of a."""
    B, S, C = a_shape
    return 2 * B * S * C


def diag_recurrence(a: torch.Tensor, b: torch.Tensor, h0: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(h_all, h_final)`` of the recurrence over a, b ``(B, S, C)`` from h0
    ``(B, C)``.

    CPU tensors run :func:`diag_recurrence_plain`; CUDA tensors launch the
    kernel on the route :func:`plan_recurrence` picks (contiguous float32),
    counted in ``diag_recurrence.launches``, per route in
    ``diag_recurrence.launches_by_route`` and per pass (``forward``,
    ``recompute``, ``backward``) in ``diag_recurrence.launches_by_pass``.
    Differentiable: the backward is :func:`diag_recurrence_backward`.
    """
    with spans.span("kernel.diag_recurrence"):
        _check_args(a, b, h0)
        return _diag_op(a, b, h0)


def run_plan(a: torch.Tensor, b: torch.Tensor, h0: torch.Tensor, plan: RecurrencePlan,
             pass_: str = "") -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch ``plan`` on CUDA tensors that :func:`diag_recurrence` has checked
    (the planner's choice there; other plans for a sweep), counted in
    ``diag_recurrence.launches``, ``launches_by_route`` and
    ``launches_by_pass``."""
    B, S, C = a.shape
    h_all = torch.empty_like(a)
    h_final = torch.empty_like(h0)
    chunked = plan.route == "chunked"
    scratch = (torch.empty(2 * B * plan.n_chunks * C, dtype=torch.float32, device=a.device)
               if chunked else None)
    with on_device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        status = _launch_fn()(a.data_ptr(), b.data_ptr(), h0.data_ptr(), h_all.data_ptr(),
                              h_final.data_ptr(),
                              scratch.data_ptr() if chunked else None,
                              B, S, C, plan.chunk if chunked else 0, stream)
    check(status, "diag_recurrence")
    pass_ = pass_ or launch_pass()
    with _count_lock:
        diag_recurrence.launches += 1
        diag_recurrence.launches_by_route[plan.route] += 1
        diag_recurrence.launches_by_pass[pass_] += 1
    return h_all, h_final


diag_recurrence.launches = 0
diag_recurrence.launches_by_route = dict.fromkeys(ROUTES, 0)
diag_recurrence.launches_by_pass = dict.fromkeys(("forward", "recompute", "backward"), 0)
