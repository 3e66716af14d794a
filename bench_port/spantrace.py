"""The port's program spans (``repro_torch.spans``) beside the device trace.

The port's spans are live while a profiler records, so a ``--trace 1``
window's traced part leaves them in the port's memory. The first reader of
a run takes them (:func:`records`) and keeps them for the run's other
readers. A program without ``repro_torch.spans`` gives none, and the
readers that need them read nothing.

The spans run on ``time.perf_counter_ns``, the profiler on its own clock.
Each program root runs inside one of the harness's spans (``coldstart``
inside ``cold_start``, ``instance.invoke`` inside ``invoke``), one for one
and in the same order: a straight line fitted to the pairs' midpoints maps
the spans onto the profiler's clock (:func:`placed`). From there: the
device's idle time inside any interval (:class:`Busy`), and each idle gap
of the window split by the innermost program span open on the harness's
thread (:func:`idle_by_span`).
"""
from __future__ import annotations

import bisect
from collections import Counter
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np

from bench_port import devtrace

#: each program root and the harness span it runs inside
ROOTS = {"coldstart": "cold_start", "instance.invoke": "invoke"}


class Placed(NamedTuple):
    """A program span on the profiler's clock (us)."""
    name: str
    start: float
    end: float
    parent: Optional[str]
    invocation: Optional[int]
    thread: int


_taken: Tuple[object, list] = (None, [])


def records(ctx) -> list:
    """The program spans of the run ``ctx`` reads (a traced run's), taken
    from the port once and kept for the run's other readers; [] for an
    untraced run or a program without spans."""
    global _taken
    if ctx.trace is None:
        return []
    if _taken[0] is not ctx.trace:
        try:
            from repro_torch import spans
        except ImportError:
            recs = []
        else:
            recs = spans.take()
        _taken = (ctx.trace, recs)
    return _taken[1]


def clock_fit(trace: devtrace.Trace, recs: Sequence) -> Optional[Tuple[float, float, float]]:
    """``(a, b, x0)``: profiler us = t + a + b * (t - x0) for a span time t
    in us, fitted to the midpoints of the program roots and the harness
    spans holding them; None when the two do not pair one for one."""
    xs, ys = [], []
    for root, outer in ROOTS.items():
        mine = sorted((r for r in recs if r.name == root and r.parent is None),
                      key=lambda r: r.start_ns)
        theirs = [s for s in trace.spans if s[0] == outer]
        if len(mine) != len(theirs):
            return None
        for r, (_, s, e) in zip(mine, theirs):
            mid = (r.start_ns + r.end_ns) / 2e3
            xs.append(mid)
            ys.append((s + e) / 2 - mid)
    if not xs:
        return None
    x0 = float(np.mean(xs))
    if len(xs) == 1 or np.ptp(xs) == 0:
        return float(ys[0]), 0.0, x0
    b, a = np.polyfit(np.asarray(xs) - x0, np.asarray(ys), 1)
    return float(a), float(b), x0


def placed(ctx) -> List[Placed]:
    """The run's program spans on the profiler's clock ([] if unmapped)."""
    recs = records(ctx)
    fit = clock_fit(ctx.trace, recs) if recs else None
    if fit is None:
        return []
    a, b, x0 = fit

    def at(ns: int) -> float:
        t = ns / 1e3
        return t + a + b * (t - x0)
    return [Placed(r.name, at(r.start_ns), at(r.end_ns), r.parent, r.invocation, r.thread)
            for r in recs]


def harness_thread(spans: Sequence[Placed]) -> Optional[int]:
    """The thread the program's roots ran on (the harness's loop)."""
    roots = Counter(p.thread for p in spans if p.name in ROOTS and p.parent is None)
    return roots.most_common(1)[0][0] if roots else None


class Busy:
    """The union of the device's operations over the traced window, asked
    for its busy and idle time inside any interval (us)."""

    def __init__(self, trace: devtrace.Trace):
        merged = devtrace.merged(trace.ops, trace.start, trace.end)
        self.starts = [s for s, _ in merged]
        self.ends = [e for _, e in merged]
        self.before = [0.0]                  # busy time before each interval
        for s, e in merged:
            self.before.append(self.before[-1] + e - s)

    def _upto(self, t: float) -> float:
        i = bisect.bisect_right(self.starts, t) - 1
        if i < 0:
            return 0.0
        return self.before[i] + min(t, self.ends[i]) - self.starts[i]

    def idle(self, a: float, b: float) -> float:
        return max(0.0, (b - a) - (self._upto(b) - self._upto(a)))


def innermost(spans: Sequence[Placed], lo: float, hi: float
              ) -> List[Tuple[float, float, str, str]]:
    """``(start, end, innermost, root)`` pieces of [lo, hi] under nested
    spans of one thread, where some span is open."""
    out: List[Tuple[float, float, str, str]] = []
    stack: List[Tuple[float, str]] = []
    cursor = lo

    def emit(upto: float) -> None:
        nonlocal cursor
        upto = min(upto, hi)
        if upto > cursor and stack:
            out.append((cursor, upto, stack[-1][1], stack[0][1]))
        cursor = max(cursor, upto)

    for p in sorted(spans, key=lambda p: (p.start, -p.end)):
        while stack and stack[-1][0] <= p.start:
            emit(stack[-1][0])
            stack.pop()
        emit(p.start)
        stack.append((p.end, p.name))
    while stack:
        emit(stack[-1][0])
        stack.pop()
    return out


def idle_by_span(trace: devtrace.Trace, spans: Sequence[Placed]) -> Dict[str, float]:
    """Seconds the device sat idle inside the window, split by the innermost
    program span open on the harness's thread: ``<root>/<span>`` (``<root>``
    alone where the root is the innermost). Idle time outside every program
    span keeps the harness span's name, as in ``devtrace.idle_gaps``, so the
    entries of a root plus its harness span's own entry sum to that harness
    span's share of ``devtrace.idle_gaps``."""
    thread = harness_thread(spans)
    mine = [p for p in spans if p.thread == thread]
    busy = Busy(trace)
    out: Dict[str, float] = {}
    covered: List[Tuple[str, float, float]] = []
    for s, e, inner, root in innermost(mine, trace.start, trace.end):
        idle = busy.idle(s, e)
        if idle > 0:
            key = root if inner == root else f"{root}/{inner}"
            out[key] = out.get(key, 0.0) + idle / 1e6
        covered.append(("", s, e))
    # what no program span covers: the harness's own split of the rest
    rest = devtrace.Trace(ops=trace.ops + covered, spans=trace.spans,
                          start=trace.start, end=trace.end)
    for name, v in devtrace.idle_gaps(rest).items():
        out[name] = out.get(name, 0.0) + v
    return out


def _forwards(spans: Sequence[Placed], cold: bool) -> List[Placed]:
    """The harness thread's ``forward`` spans of cold starts' first requests
    (``cold``) or of warm invocations."""
    thread = harness_thread(spans)
    cold_ids = {p.invocation for p in spans if p.name == "coldstart"}
    return [p for p in spans if p.name == "forward" and p.thread == thread
            and (p.invocation in cold_ids) == cold]


def forward_idle_pct(ctx, cold: bool) -> Optional[float]:
    """The share of the traced forwards' time (first requests' or warm ones')
    in which the device sat idle (%)."""
    if ctx.trace is None or not ctx.trace.ops:
        return None
    fw = _forwards(placed(ctx), cold)
    total = sum(p.end - p.start for p in fw)
    if total <= 0:
        return None
    busy = Busy(ctx.trace)
    return 100.0 * sum(busy.idle(p.start, p.end) for p in fw) / total


def coldstart_host_idle_ms(ctx) -> Optional[float]:
    """Median over the traced cold starts of the device's idle ms inside
    ``coldstart`` but outside its ``forward``."""
    if ctx.trace is None or not ctx.trace.ops:
        return None
    spans = placed(ctx)
    busy = Busy(ctx.trace)
    fw: Dict[Optional[int], float] = {}
    for p in _forwards(spans, cold=True):
        fw[p.invocation] = fw.get(p.invocation, 0.0) + busy.idle(p.start, p.end)
    v = [busy.idle(p.start, p.end) - fw.get(p.invocation, 0.0)
         for p in spans if p.name == "coldstart" and p.parent is None]
    return float(np.median(v)) / 1e3 if v else None
