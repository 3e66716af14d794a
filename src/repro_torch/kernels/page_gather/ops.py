"""Paged gather: assemble contiguous buffers from pooled pages.

Replaces the TPU kernel ``src/repro/kernels/page_gather/kernel.py``
(``page_gather_pallas``). It is the device-side hot path of WarmSwap restore:
the pool keeps every image's pages in one device buffer shared by all
tenants, and each restore gathers a page list into a fresh buffer.

On the card it is bound by bytes (each row read once and written once:
``2 * K * row_bytes`` over 3.35 TB/s). The CUDA kernel (``csrc/page_gather.cu``)
copies rows as raw bytes, so any dtype moves at the same rate: a persistent
grid walks (row, chunk) work items and moves each with ``cp.async.bulk``
through a ring of shared-memory stages, so reads and writes overlap on every
SM. :func:`plan_gather` fixes the grid, chunk size and work-item split;
:func:`item_span` is the split of one item as the kernel makes it. A host
page list of up to :data:`INLINE_IDS` ids (the page server's spans) travels
in the launch's parameters: no pinned copy, no host-to-device transfer.
"""
from __future__ import annotations

import ctypes
import functools
import threading
from typing import Iterator, NamedTuple, Tuple

import torch

from repro_torch import spans
from repro_torch.kernels.build import check, library, on_device, refuse_grad

CHUNK_BYTES = 32 * 1024     # bytes per work item (a bulk copy's size)
STAGES = 3                  # shared-memory stages per block (2 to 8)
BLOCKS_PER_SM = 2           # STAGES * CHUNK_BYTES = 96 KiB per block: two fit an SM
BULK_ALIGN = 16             # a bulk copy's address and size alignment
INLINE_IDS = 960            # host ids that ride in the launch parameters (csrc)
_count_lock = threading.Lock()


class GatherPlan(NamedTuple):
    chunk_bytes: int        # a multiple of BULK_ALIGN
    n_chunks: int           # work items per row
    n_items: int            # K * n_chunks
    grid: int               # persistent blocks; block b takes items b, b + grid, ...
    stages: int


def plan_gather(K: int, row_bytes: int, n_sms: int) -> GatherPlan:
    """Cut ``K`` rows of ``row_bytes`` into work items of at most
    :data:`CHUNK_BYTES` (rows shorter than that are one item each) and size a
    persistent grid of :data:`BLOCKS_PER_SM` blocks per SM, or fewer when
    there are fewer items."""
    chunk = min(CHUNK_BYTES, -(-row_bytes // BULK_ALIGN) * BULK_ALIGN)
    n_chunks = -(-row_bytes // chunk)
    n_items = K * n_chunks
    return GatherPlan(chunk, n_chunks, n_items,
                      max(1, min(n_items, BLOCKS_PER_SM * n_sms)), STAGES)


def item_span(p: GatherPlan, row_bytes: int, item: int) -> Tuple[int, int, int]:
    """``(row, start, length)``: the bytes ``[start, start + length)`` of
    output row ``row`` that work item ``item`` copies."""
    row, c = divmod(item, p.n_chunks)
    start = c * p.chunk_bytes
    return row, start, min(p.chunk_bytes, row_bytes - start)


def bulk_bytes(src_addr: int, dst_addr: int, length: int) -> int:
    """How many leading bytes of an item go through the bulk copy (the rest go
    through the kernel's byte path): all whole 16-byte units when both
    addresses are 16-byte aligned, none otherwise."""
    if (src_addr | dst_addr) % BULK_ALIGN:
        return 0
    return length - length % BULK_ALIGN


def block_items(p: GatherPlan, block: int) -> Iterator[int]:
    """The work items block ``block`` of the persistent grid takes, in order."""
    return iter(range(block, p.n_items, p.grid))


def page_gather_plain(pool: torch.Tensor, page_ids: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: ``pool[page_ids]`` (a copy)."""
    return pool[page_ids.long()]


@functools.lru_cache(maxsize=None)
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


@functools.lru_cache(maxsize=None)
def _launch_fn():
    lib = library("page_gather")
    if lib.page_gather_inline_ids() != INLINE_IDS:
        raise RuntimeError("csrc/page_gather.cu and ops.INLINE_IDS disagree")
    fn = lib.page_gather_launch
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_longlong] * 4 + [
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def page_gather(pool: torch.Tensor, page_ids: torch.Tensor) -> torch.Tensor:
    """``out[i, :] = pool[page_ids[i], :]`` for a ``(P, E)`` pool of any dtype.

    ``page_ids`` is int32 or int64 and every id must lie in ``[0, P)``. For a
    CUDA pool the ids may be on the pool's device or on the CPU: a host page
    list is checked without a device sync, then passed in the launch's
    parameters (up to :data:`INLINE_IDS` ids) or copied over through pinned
    memory. CPU pools run the plain version; CUDA pools launch the kernel,
    counted in ``page_gather.launches``. The kernel has no backward: a CUDA
    pool that requires a gradient while grad mode is on raises.
    """
    with spans.span("kernel.page_gather"):
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
        refuse_grad("page_gather", pool)
        if page_ids.device.type != "cpu" and page_ids.device != pool.device:
            raise ValueError("page ids must be on the CPU or on the pool's device")
        page_ids = page_ids.to(torch.int32).contiguous()
        host_ids = None
        if page_ids.device.type == "cpu":
            if K <= INLINE_IDS:
                host_ids, page_ids = page_ids, None
            else:   # too long for the launch parameters: through pinned memory
                page_ids = page_ids.pin_memory().to(pool.device, non_blocking=True)
        out = torch.empty((K, pool.shape[1]), dtype=pool.dtype, device=pool.device)
        row_bytes = pool.shape[1] * pool.element_size()
        if K == 0 or row_bytes == 0:
            return out
        p = plan_gather(K, row_bytes, _sm_count(pool.device))
        fn = _launch_fn()
        with on_device(pool.device):
            stream = torch.cuda.current_stream(pool.device).cuda_stream
            status = fn(pool.data_ptr(),
                        page_ids.data_ptr() if page_ids is not None else None,
                        host_ids.data_ptr() if host_ids is not None else None,
                        out.data_ptr(), K, row_bytes, p.chunk_bytes, p.n_chunks, p.grid,
                        p.stages, stream)
        check(status, "page_gather")
        with _count_lock:
            page_gather.launches += 1
        return out


page_gather.launches = 0
