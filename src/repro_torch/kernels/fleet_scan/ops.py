"""The ``fleet_vec`` cap=1 group recursion, every group in one call.

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

On the card the CUDA kernel (``csrc/fleet_scan.cu``) cuts each group into
segments of at most ``segment`` arrivals, one thread a segment, so its
chain is the longest segment's (``segment + warmup`` steps), not the longest
group's. Why that keeps the bits: after a group's first arrival the carry is
just the bits of ``free`` (``alive`` is true, ``exp`` is ``free + ka``), so
two runs over the same arrivals whose ``free`` agree after some arrival agree
on every output after it; an arrival that finds the instance warm and idle
sets ``free`` from its own time, so runs from different carries soon merge.
Pass 1 starts each segment that is not its group's first from a guessed
carry ``warmup`` arrivals early (the arrival before them warm and not
queued) and records the ``free`` it entered and left its segment with.
Pass 2 checks each boundary bitwise and reruns a segment whose entry was
wrong from its left neighbour's exit, up to the first arrival where the
rerun's ``free`` meets the stored run's; rounds repeat while a rerun changed
an exit (see the kernel's header). Pass 1 stages arrivals and outputs
through shared memory by bulk async copies. The bytes bound stays
:data:`BYTES_PER_ARRIVAL`, 42 B an arrival. CPU tensors run
:func:`fleet_scan_plain`.
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
#: the kernel's segment length and warm-up arrivals (``python -m
#: repro_torch.kernels.sweep --fleet-scan`` times the choices)
SEGMENT = 256
WARMUP = 8
_count_lock = threading.Lock()

Outputs = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor,
                torch.Tensor, torch.Tensor]


def _check(t: torch.Tensor, offsets: torch.Tensor, segment: int = 1):
    """Check the batch with one read of ``offsets`` on the host; return
    ``(seg_first, segments, most segments of one group)`` for segments of
    ``segment`` arrivals (:func:`segment_prefix`)."""
    if t.dim() != 1 or t.dtype != torch.float64:
        raise TypeError(f"want float64 arrivals (N,), got {t.dtype} {tuple(t.shape)}")
    if offsets.dim() != 1 or offsets.dtype != torch.int64 or offsets.numel() < 1:
        raise TypeError(f"want int64 offsets (G + 1,), got {offsets.dtype} "
                        f"{tuple(offsets.shape)}")
    if t.device != offsets.device:
        raise ValueError("arrivals and offsets must be on one device")
    seg_first = segment_prefix(offsets, segment)
    per_group = seg_first[1:] - seg_first[:-1]
    first, last, falls, n_seg, most = torch.stack([
        offsets[0], offsets[-1], (offsets[1:] - offsets[:-1]).clamp(max=0).sum(),
        seg_first[-1], per_group.max() if per_group.numel() else seg_first[0]]).tolist()
    # the kernel indexes t by offsets: a bad batch would read out of bounds
    if first != 0 or last != t.shape[0] or falls:
        raise ValueError(f"offsets must rise from 0 to len(t) = {t.shape[0]}")
    return seg_first, n_seg, most


def _check_cut(segment: int, warmup: int) -> None:
    if isinstance(segment, bool) or not isinstance(segment, int) or segment < 1:
        raise ValueError(f"segment must be an int >= 1, got {segment!r}")
    if isinstance(warmup, bool) or not isinstance(warmup, int) or warmup < 0:
        raise ValueError(f"warmup must be an int >= 0, got {warmup!r}")


def segment_prefix(offsets: torch.Tensor, segment: int) -> torch.Tensor:
    """The segment table's group index, by torch ops on ``offsets``' device:
    group ``g`` cut into ``segment``-arrival segments (its last shorter)
    owns segments ``seg_first[g] .. seg_first[g + 1] - 1``. The kernel's
    pass 1 expands it into one row a segment."""
    lengths = offsets[1:] - offsets[:-1]
    seg_first = torch.zeros_like(offsets)
    torch.cumsum(torch.div(lengths + (segment - 1), segment, rounding_mode="floor"), 0,
                 out=seg_first[1:])
    return seg_first


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


_VOID, _LL, _INT, _DBL = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_double


@functools.lru_cache(maxsize=None)
def _launch_fns():
    lib = library("fleet_scan")
    consts_outs = [_DBL] * 5 + [_VOID] * 6
    segments = lib.fleet_scan_segment_launch
    segments.argtypes = [_VOID] * 3 + [_LL] * 3 + [_INT] + consts_outs + [_VOID] * 5
    repair = lib.fleet_scan_repair_launch
    repair.argtypes = [_VOID] * 3 + [_LL, _INT, _INT] + consts_outs + [_VOID] * 7
    for fn in (segments, repair):
        fn.restype = ctypes.c_int
    return segments, repair


def fleet_scan(t: torch.Tensor, offsets: torch.Tensor, warm_s: float,
               cold_s: float, wm: float, cold60: float, ka: float, *,
               segment: int = SEGMENT, warmup: int = WARMUP) -> Outputs:
    """Run every group's cap=1 recursion: ``(sample, wait, start, exp2, cold,
    queued)`` per arrival, in ``t``'s order.

    CPU tensors run the plain version (``segment`` and ``warmup`` do not
    change its result, nor the kernel's: they cut the work). CUDA tensors run
    the kernel's two passes, counted as one call in ``fleet_scan.launches``;
    ``fleet_scan.last`` then holds the call's ``segments``, ``rounds`` of
    pass 2, ``repaired`` arrivals (those pass 2 rewrote) and CUDA ``launches``
    of the library (pass 1 and each round queued), a diagnostic no result
    reads. ``offsets`` must start at 0, never decrease and end at ``len(t)``:
    checked with one host read; on the card pass 2 costs one more read, of
    its rounds' flags, and more only when a rerun crossed a segment's end.
    """
    _check_cut(segment, warmup)
    if t.device.type == "cpu":
        return fleet_scan_plain(t, offsets, warm_s, cold_s, wm, cold60, ka)
    if t.device.type != "cuda":
        raise ValueError(f"unsupported device {t.device}")
    offsets = offsets.contiguous()
    seg_first, n_seg, most = _check(t, offsets, segment)
    t = t.contiguous()
    if t.data_ptr() % 16:           # bulk copies need 16-byte aligned rows
        t = t.clone()
    dev = t.device
    n = t.shape[0]
    sample = torch.empty(n, dtype=torch.float64, device=dev)
    wait = torch.empty_like(sample)
    start = torch.empty_like(sample)
    exp2 = torch.empty_like(sample)
    cold = torch.empty(n, dtype=torch.uint8, device=dev)
    queued = torch.empty_like(cold)
    last = {"segments": n_seg, "rounds": 0, "repaired": 0, "launches": 0}
    if n_seg:
        _run(t, offsets, seg_first, segment, warmup, n_seg, most,
             (float(warm_s), float(cold_s), float(wm), float(cold60), float(ka)),
             (sample, wait, start, exp2, cold, queued), last)
    with _count_lock:
        fleet_scan.launches += 1
        fleet_scan.last = last
    return sample, wait, start, exp2, cold, queued


def _run(t, offsets, seg_first, segment, warmup, n_seg, most, consts, outs,
         last) -> None:
    """Pass 1, then rounds of pass 2 until one changes no exit carry: one
    round, then 4, 16, 64, ... more queued at a time (a round after one that
    changed nothing returns at once), each batch's flags read in one copy."""
    segments_fn, repair_fn = _launch_fns()
    dev = t.device
    seg_lo = torch.empty(n_seg + 1, dtype=torch.int64, device=dev)
    seg_glo = torch.empty(n_seg, dtype=torch.int64, device=dev)
    entry = torch.empty(n_seg, dtype=torch.float64, device=dev)
    exits = [torch.empty_like(entry), torch.empty_like(entry)]
    changed = [torch.empty(n_seg, dtype=torch.uint8, device=dev) for _ in range(2)]
    counts = torch.zeros(2 * most, dtype=torch.int64, device=dev)
    head = (t.data_ptr(), seg_lo.data_ptr(), seg_glo.data_ptr(), n_seg)
    tail = (*consts, *(o.data_ptr() for o in outs))
    scratch = (*(x.data_ptr() for x in exits + changed), counts.data_ptr())
    with on_device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        check(segments_fn(t.data_ptr(), offsets.data_ptr(), seg_first.data_ptr(),
                          offsets.shape[0] - 1, segment, n_seg, warmup, *tail,
                          seg_lo.data_ptr(), seg_glo.data_ptr(), entry.data_ptr(),
                          exits[0].data_ptr(), stream), "fleet_scan pass 1")
        # round r leaves the first r + 2 segments of each group right, so no
        # round past most - 1 can have anything to change
        queued, batch, more = 0, 1, True       # round 0 alone, then 4, 16, ...
        while more and queued < most:
            todo = min(batch, most - queued)
            check(repair_fn(*head, queued, todo, *tail, entry.data_ptr(), *scratch,
                            stream),
                  "fleet_scan pass 2")
            flags = counts[2 * queued:2 * (queued + todo)].tolist()
            for i in range(todo):
                if not more:             # round queued + i returned at once
                    break
                last["rounds"] += 1
                last["repaired"] += flags[2 * i]
                more = bool(flags[2 * i + 1])
            queued += todo
            batch *= 4
    if more:
        raise RuntimeError(f"fleet_scan: pass 2 still changed a carry after {most} rounds")
    last["launches"] = 1 + queued


fleet_scan.launches = 0
fleet_scan.last = None
