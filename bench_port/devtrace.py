"""Reading ``torch.profiler``'s trace of the traced part of a window.

Device operations (kernels, copies, sets) and the harness's own spans
(``torch.profiler.record_function`` around each call into the program) come
out of one profiler, on one time base, in microseconds. From them: the
device's busy time (the union of its operations' intervals), each kernel's
summed time, and the idle gaps between operations, split by the span the
host was inside.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Tuple

Interval = Tuple[str, float, float]      # (name, start us, end us)


@dataclass
class Trace:
    ops: List[Interval] = field(default_factory=list)      # device operations
    spans: List[Interval] = field(default_factory=list)    # the harness's spans
    start: float = 0.0                                      # the traced window, us
    end: float = 0.0

    @property
    def window_s(self) -> float:
        return (self.end - self.start) / 1e6


def collect(prof, span_names: Iterable[str]) -> Trace:
    """The device operations and the named spans of a finished profile; the
    window runs from the first span's start to the last span's end."""
    from torch.autograd import DeviceType
    names = set(span_names)
    t = Trace()
    for e in prof.events():
        r = (e.name, float(e.time_range.start), float(e.time_range.end))
        if e.name in names:          # a span shows on the host and the device timeline
            if e.device_type != DeviceType.CUDA:
                t.spans.append(r)
        elif e.device_type == DeviceType.CUDA:
            t.ops.append(r)
    if t.spans:
        t.start = min(s for _, s, _ in t.spans)
        t.end = max(e for _, _, e in t.spans)
    t.ops.sort(key=lambda r: r[1])
    t.spans.sort(key=lambda r: r[1])
    return t


def merged(ops: List[Interval], lo: float, hi: float) -> List[Tuple[float, float]]:
    """The union of the operations' intervals, clipped to [lo, hi]."""
    out: List[Tuple[float, float]] = []
    for _, s, e in sorted(ops, key=lambda r: r[1]):
        s, e = max(s, lo), min(e, hi)
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], e))
        else:
            out.append((s, e))
    return out


def busy_s(t: Trace) -> float:
    return sum(e - s for s, e in merged(t.ops, t.start, t.end)) / 1e6


def kernel_s(t: Trace, *needles: str) -> Tuple[float, int]:
    """(seconds, launches) of the operations whose name holds any needle."""
    hits = [e - s for n, s, e in t.ops if any(k in n for k in needles)]
    return sum(hits) / 1e6, len(hits)


def idle_gaps(t: Trace) -> Dict[str, float]:
    """Seconds the device sat idle inside the window, split by the span the
    host was inside (``harness`` outside every span; spans do not nest)."""
    gaps: Dict[str, float] = {}
    spans = sorted(t.spans, key=lambda r: r[1])
    first = 0
    cursor = t.start
    for s, e in merged(t.ops, t.start, t.end) + [(t.end, t.end)]:
        if s > cursor:
            while first < len(spans) and spans[first][2] <= cursor:
                first += 1
            covered = 0.0
            for name, a, b in spans[first:]:
                if a >= s:
                    break
                over = min(b, s) - max(a, cursor)
                if over > 0:
                    gaps[name] = gaps.get(name, 0.0) + over / 1e6
                    covered += over
            if s - cursor > covered:
                gaps["harness"] = gaps.get("harness", 0.0) + (s - cursor - covered) / 1e6
        cursor = max(cursor, e)
    return gaps


def top_ops(t: Trace, n: int = 10, width: int = 96) -> List[List]:
    """The ``n`` device operations with the most summed time, by name."""
    by: Dict[str, float] = {}
    for name, s, e in t.ops:
        by[name] = by.get(name, 0.0) + (e - s) / 1e6
    return [[k[:width], v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:n]]
