"""The ``fleet_vec`` cap=1 group recursion, every group in one launch.

Has no TPU kernel counterpart: the reference runs the recursion as a jitted
``jax.lax.scan`` under ``enable_x64`` (``src/repro/core/fleet_vec.py``,
``_get_scan_fn``), one dispatch per ``(worker, fn)`` group. The port batches
all groups of a ``simulate_fleet_vec`` call into CSR form: ``t`` holds the
float64 arrivals of every group, one group after another, and ``offsets``
(int64, ``G + 1`` entries) cuts it, group ``g`` owning
``t[offsets[g]:offsets[g + 1]]``.

Each group is a Lindley recursion on one rotating instance, carried in
``(alive, free, exp)`` from ``(False, 0.0, 0.0)``. The six outputs hold, per
arrival, the latency sample, the queue wait, the service start and the
instance's expiry after it (float64), and whether it cold-started or queued
(uint8). The contract is bit identity with the reference's solvers, so both
versions keep its expression shapes: ``(start - t) * 60.0``,
``wait + svc``, ``start + svc60``, ``free2 + ka``.

On the card the CUDA kernel (``csrc/fleet_scan.cu``) runs one thread per
group; it is bound by the serial chain of the longest group, or by its 42
bytes per arrival. CPU tensors run :func:`fleet_scan_plain`.
"""
from __future__ import annotations

import ctypes
import functools
import threading
from typing import Tuple

import torch

from repro_torch.kernels.build import check, library, on_device

#: bytes each arrival moves: 8 read, 4 float64 and 2 uint8 written
BYTES_PER_ARRIVAL = 8 + 4 * 8 + 2
_count_lock = threading.Lock()

Outputs = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor,
                torch.Tensor, torch.Tensor]


def _check(t: torch.Tensor, offsets: torch.Tensor) -> None:
    if t.dim() != 1 or t.dtype != torch.float64:
        raise TypeError(f"want float64 arrivals (N,), got {t.dtype} {tuple(t.shape)}")
    if offsets.dim() != 1 or offsets.dtype != torch.int64 or offsets.numel() < 1:
        raise TypeError(f"want int64 offsets (G + 1,), got {offsets.dtype} "
                        f"{tuple(offsets.shape)}")
    if t.device != offsets.device:
        raise ValueError("arrivals and offsets must be on one device")
    # the kernel indexes t by offsets: a bad batch would read out of bounds
    if (int(offsets[0]) != 0 or int(offsets[-1]) != t.shape[0]
            or bool((offsets[1:] < offsets[:-1]).any())):
        raise ValueError(f"offsets must rise from 0 to len(t) = {t.shape[0]}")


def fleet_scan_plain(t: torch.Tensor, offsets: torch.Tensor, warm_s: float,
                     cold_s: float, wm: float, cold60: float, ka: float) -> Outputs:
    """Plain PyTorch version: float64 across groups, sequential over the step
    index. The groups are ordered longest first, so the groups still running
    at step ``k`` are a prefix of that order: a group that has ended is masked
    out of every later step by the prefix's length. Separate elementwise ops
    only (no fused multiply-add), so each is rounded as the reference rounds
    it."""
    _check(t, offsets)
    dev = t.device
    n = t.shape[0]
    sample = torch.empty(n, dtype=torch.float64, device=dev)
    wait = torch.empty_like(sample)
    start = torch.empty_like(sample)
    exp2 = torch.empty_like(sample)
    cold = torch.empty(n, dtype=torch.uint8, device=dev)
    queued = torch.empty_like(cold)
    lengths, order = torch.sort(offsets[1:] - offsets[:-1], descending=True, stable=True)
    lo = offsets[:-1][order]
    G = lengths.shape[0]
    # live[k]: how many groups run step k (lengths are sorted descending)
    steps = int(lengths[0]) if G else 0
    live = torch.searchsorted(-lengths, -torch.arange(steps, device=dev),
                              right=False).tolist()
    alive = torch.zeros(G, dtype=torch.bool, device=dev)
    free = torch.zeros(G, dtype=torch.float64, device=dev)
    exp = torch.zeros(G, dtype=torch.float64, device=dev)
    f64 = dict(dtype=torch.float64, device=dev)
    warm_v, cold_v = torch.tensor(warm_s, **f64), torch.tensor(cold_s, **f64)
    wm_v, cold60_v = torch.tensor(wm, **f64), torch.tensor(cold60, **f64)
    for k in range(steps):
        g = live[k]
        idx = lo[:g] + k
        tk = t[idx]
        alive2 = alive[:g] & (exp[:g] >= tk)
        q = alive2 & (free[:g] > tk)
        st = torch.where(q, free[:g], tk)
        svc = torch.where(alive2, warm_v, cold_v)
        svc60 = torch.where(alive2, wm_v, cold60_v)
        w = (st - tk) * 60.0
        s = w + svc
        f2 = st + svc60
        e2 = f2 + ka
        sample[idx] = s
        wait[idx] = w
        start[idx] = st
        exp2[idx] = e2
        cold[idx] = (~alive2).to(torch.uint8)
        queued[idx] = q.to(torch.uint8)
        alive[:g] = True
        free[:g] = f2
        exp[:g] = e2
    return sample, wait, start, exp2, cold, queued


@functools.lru_cache(maxsize=None)
def _launch_fn():
    fn = library("fleet_scan").fleet_scan_launch
    fn.argtypes = ([ctypes.c_void_p] * 2 + [ctypes.c_longlong] + [ctypes.c_double] * 5
                   + [ctypes.c_void_p] * 7)
    fn.restype = ctypes.c_int
    return fn


def fleet_scan(t: torch.Tensor, offsets: torch.Tensor, warm_s: float,
               cold_s: float, wm: float, cold60: float, ka: float) -> Outputs:
    """Run every group's cap=1 recursion: ``(sample, wait, start, exp2, cold,
    queued)`` per arrival, in ``t``'s order.

    CPU tensors run the plain version; CUDA tensors launch the kernel once,
    counted in ``fleet_scan.launches``. ``offsets`` must start at 0, never
    decrease and end at ``len(t)`` (checked; on the card that costs a device
    sync before the launch).
    """
    _check(t, offsets)
    if t.device.type == "cpu":
        return fleet_scan_plain(t, offsets, warm_s, cold_s, wm, cold60, ka)
    if t.device.type != "cuda":
        raise ValueError(f"unsupported device {t.device}")
    t = t.contiguous()
    offsets = offsets.contiguous()
    n = t.shape[0]
    sample = torch.empty(n, dtype=torch.float64, device=t.device)
    wait = torch.empty_like(sample)
    start = torch.empty_like(sample)
    exp2 = torch.empty_like(sample)
    cold = torch.empty(n, dtype=torch.uint8, device=t.device)
    queued = torch.empty_like(cold)
    fn = _launch_fn()
    with on_device(t.device):
        stream = torch.cuda.current_stream(t.device).cuda_stream
        status = fn(t.data_ptr(), offsets.data_ptr(), offsets.shape[0] - 1,
                    float(warm_s), float(cold_s), float(wm), float(cold60), float(ka),
                    sample.data_ptr(), wait.data_ptr(), start.data_ptr(),
                    exp2.data_ptr(), cold.data_ptr(), queued.data_ptr(), stream)
    check(status, "fleet_scan")
    with _count_lock:
        fleet_scan.launches += 1
    return sample, wait, start, exp2, cold, queued


fleet_scan.launches = 0
