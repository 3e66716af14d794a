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
"""
from __future__ import annotations

import ctypes
import functools
import threading
from typing import NamedTuple, Optional, Tuple

import torch

from repro_torch.kernels.build import check, library, on_device

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


@functools.lru_cache(maxsize=None)
def _launch_fn():
    fn = library("diag_recurrence").diag_recurrence_launch
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def diag_recurrence(a: torch.Tensor, b: torch.Tensor, h0: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(h_all, h_final)`` of the recurrence over a, b ``(B, S, C)`` from h0
    ``(B, C)``.

    CPU tensors run :func:`diag_recurrence_plain`; CUDA tensors launch the
    kernel on the route :func:`plan_recurrence` picks (contiguous float32),
    counted in ``diag_recurrence.launches`` and per route in
    ``diag_recurrence.launches_by_route``.
    """
    if a.dim() != 3 or b.shape != a.shape or tuple(h0.shape) != (a.shape[0], a.shape[2]):
        raise ValueError(f"want a, b (B,S,C) and h0 (B,C), got {tuple(a.shape)}, "
                         f"{tuple(b.shape)}, {tuple(h0.shape)}")
    if not (a.dtype == b.dtype == h0.dtype):
        raise TypeError(f"a, b, h0 dtypes differ: {a.dtype}, {b.dtype}, {h0.dtype}")
    if not (a.device == b.device == h0.device):
        raise ValueError("a, b, h0 must be on one device")
    if a.device.type == "cpu":
        return diag_recurrence_plain(a, b, h0)
    if a.device.type != "cuda":
        raise ValueError(f"unsupported device {a.device}")
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
    return run_plan(a, b, h0, plan_recurrence(B, S, C, n_sms))


def run_plan(a: torch.Tensor, b: torch.Tensor, h0: torch.Tensor, plan: RecurrencePlan
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch ``plan`` on CUDA tensors that :func:`diag_recurrence` has checked
    (the planner's choice there; other plans for a sweep), counted in
    ``diag_recurrence.launches`` and ``launches_by_route``."""
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
    with _count_lock:
        diag_recurrence.launches += 1
        diag_recurrence.launches_by_route[plan.route] += 1
    return h_all, h_final


diag_recurrence.launches = 0
diag_recurrence.launches_by_route = dict.fromkeys(ROUTES, 0)
