"""Paged gather: assemble contiguous buffers from pooled pages.

Replaces the TPU kernel ``src/repro/kernels/page_gather/kernel.py``
(``page_gather_pallas``). It is the device-side hot path of WarmSwap restore:
the pool keeps every image's pages in one device buffer shared by all
tenants, and each restore gathers a page list into a fresh buffer.

On the card it is bound by bytes (each row read once and written once:
``2 * K * row_bytes`` over 3.35 TB/s). The CUDA kernel (``csrc/page_gather.cu``)
copies rows as raw bytes, 16 bytes per thread with neighbouring threads on
neighbouring addresses, so any dtype moves at the same rate.
"""
from __future__ import annotations

import ctypes
import threading

import torch

from repro_torch.kernels.build import check, library

_count_lock = threading.Lock()


def page_gather_plain(pool: torch.Tensor, page_ids: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: ``pool[page_ids]`` (a copy)."""
    return pool[page_ids.long()]


def _launch_fn():
    fn = library("page_gather").page_gather_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_longlong, ctypes.c_longlong, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def page_gather(pool: torch.Tensor, page_ids: torch.Tensor) -> torch.Tensor:
    """``out[i, :] = pool[page_ids[i], :]`` for a ``(P, E)`` pool of any dtype.

    ``page_ids`` is int32 or int64 and every id must lie in ``[0, P)``. For a
    CUDA pool the ids may be on the pool's device or on the CPU (a host page
    list is checked without a device sync, then copied over). CPU pools run
    the plain version; CUDA pools launch the kernel, counted in
    ``page_gather.launches``.
    """
    if pool.dim() != 2 or page_ids.dim() != 1:
        raise ValueError(f"want pool (P, E) and ids (K,), got {tuple(pool.shape)} "
                         f"and {tuple(page_ids.shape)}")
    if page_ids.dtype not in (torch.int32, torch.int64):
        raise TypeError(f"page ids must be int32 or int64, got {page_ids.dtype}")
    if not pool.is_contiguous():
        raise ValueError("pool must be contiguous")
    P, K = pool.shape[0], page_ids.shape[0]
    if K:
        lo, hi = (int(v) for v in torch.aminmax(page_ids))
        if lo < 0 or hi >= P:
            raise IndexError(f"page ids must lie in [0, {P}), got [{lo}, {hi}]")
    if pool.device.type == "cpu":
        if page_ids.device.type != "cpu":
            raise ValueError("a CPU pool takes CPU page ids")
        return page_gather_plain(pool, page_ids)
    if pool.device.type != "cuda":
        raise ValueError(f"unsupported device {pool.device}")
    if page_ids.device.type == "cpu":
        # staged through pinned memory so the copy does not wait for the stream
        page_ids = page_ids.to(torch.int32).contiguous().pin_memory().to(
            pool.device, non_blocking=True)
    elif page_ids.device != pool.device:
        raise ValueError("page ids must be on the CPU or on the pool's device")
    page_ids = page_ids.to(torch.int32).contiguous()
    out = torch.empty((K, pool.shape[1]), dtype=pool.dtype, device=pool.device)
    if K == 0 or pool.shape[1] == 0:
        return out
    fn = _launch_fn()
    with torch.cuda.device(pool.device):
        stream = torch.cuda.current_stream(pool.device).cuda_stream
        status = fn(pool.data_ptr(), page_ids.data_ptr(), out.data_ptr(), K,
                    pool.shape[1] * pool.element_size(), stream)
    check(status, "page_gather")
    with _count_lock:
        page_gather.launches += 1
    return out


page_gather.launches = 0
