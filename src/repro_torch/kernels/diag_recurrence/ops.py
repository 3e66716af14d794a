"""Diagonal linear recurrence: ``h_t = a_t * h_{t-1} + b_t`` over channels.

Replaces the TPU kernel ``src/repro/kernels/diag_recurrence/kernel.py``
(``diag_recurrence_pallas``), with its oracle's contract
(``diag_recurrence/ref.py``): a, b ``(B, S, C)``, h0 ``(B, C)``; returns
``(h_all (B, S, C), h_final (B, C))``, ``h_final`` equal to ``h_all[:, -1]``.
It serves the Mamba-1 selective scan (channels = d_inner * ssm_state) and the
RG-LRU (channels = lru_width).

On the card it is bound by bytes: a and b read once and h_all written once,
12 bytes per element. The CUDA kernel (``csrc/diag_recurrence.cu``) gives each
thread one (b, channel), walks the sequence with coalesced loads issued
several rows ahead of the dependent chain, and rounds like PyTorch's ``a * h +
b``, so it equals :func:`diag_recurrence_plain` bit for bit.
"""
from __future__ import annotations

import ctypes
import threading
from typing import Tuple

import torch

from repro_torch.kernels.build import check, library

_count_lock = threading.Lock()


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


def _launch_fn():
    fn = library("diag_recurrence").diag_recurrence_launch
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def diag_recurrence(a: torch.Tensor, b: torch.Tensor, h0: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(h_all, h_final)`` of the recurrence over a, b ``(B, S, C)`` from h0
    ``(B, C)``.

    CPU tensors run :func:`diag_recurrence_plain`; CUDA tensors launch the
    kernel (contiguous float32), counted in ``diag_recurrence.launches``.
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
    h_all = torch.empty_like(a)
    h_final = torch.empty_like(h0)
    fn = _launch_fn()
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        status = fn(a.data_ptr(), b.data_ptr(), h0.data_ptr(), h_all.data_ptr(),
                    h_final.data_ptr(), B, S, C, stream)
    check(status, "diag_recurrence")
    with _count_lock:
        diag_recurrence.launches += 1
    return h_all, h_final


diag_recurrence.launches = 0
