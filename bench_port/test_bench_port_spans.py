"""The program spans' metrics (``spantrace.py`` and its readers): a traced run
on the CPU reports the ones that need no device; on hand-built traces the
clock fit puts the program's roots inside the harness's spans, the idle
split puts each gap on the innermost span and sums to the harness's own
split, and the device-idle readers count what a plain walk over the time
counts; a program without spans reads nothing and raises nothing."""
import json
import sys
import time

import numpy as np
import pytest
import torch

from bench_port import devtrace, harness, spantrace
from bench_port.conftest import write_bench
from repro_torch import spans
from repro_torch.spans import Span

CPU = torch.device("cpu")
SEED = 2**31 + 977
DEVICE_READERS = {"forward.idle_pct.cold", "forward.idle_pct.warm", "coldstart.host_idle_ms"}

# a window of 200 us: a cold start, the loop's own time, a warm invocation
HARNESS = [("cold_start", 0.0, 100.0), ("traffic", 100.0, 110.0), ("invoke", 110.0, 200.0)]
OPS = [("k", 5.0, 10.0), ("k", 30.0, 40.0), ("k", 60.0, 70.0), ("k", 64.0, 72.0),
       ("k", 120.0, 150.0), ("k", 170.0, 171.0)]
MAIN, STREAM = 1, 2
INV_COLD, INV_WARM = 11, 12
# (name, start, end, parent, invocation, thread) in us on the harness's clock
PROGRAM = [
    ("coldstart", 2.0, 98.0, None, INV_COLD, MAIN),
    ("coldstart.migration", 20.0, 50.0, "coldstart", INV_COLD, MAIN),
    ("migration.stream", 21.0, 49.0, "migration.fault", INV_COLD, STREAM),
    ("coldstart.execution", 52.0, 96.0, "coldstart", INV_COLD, MAIN),
    ("instance.invoke", 53.0, 95.5, "coldstart.execution", INV_COLD, MAIN),
    ("forward", 55.0, 95.0, "instance.invoke", INV_COLD, MAIN),
    ("kernel.flash_attention", 58.0, 61.0, "forward", INV_COLD, MAIN),
    ("instance.invoke", 112.0, 198.0, None, INV_WARM, MAIN),
    ("forward", 115.0, 195.0, "instance.invoke", INV_WARM, MAIN),
    ("kernel.flash_attention", 160.0, 180.0, "forward", INV_WARM, MAIN),
]


def _trace():
    return devtrace.Trace(ops=list(OPS), spans=list(HARNESS), start=0.0, end=200.0)


def _placed():
    return [spantrace.Placed(*p) for p in PROGRAM]


def _walk(trace, placed, step=0.01):
    """The idle split by a plain walk over the window in small steps."""
    busy = [(s, e) for _, s, e in trace.ops]
    mine = [p for p in placed if p.thread == MAIN]
    out = {}
    for t in np.arange(trace.start + step / 2, trace.end, step):
        if any(s <= t < e for s, e in busy):
            continue
        open_ = sorted((p for p in mine if p.start <= t < p.end), key=lambda p: p.start)
        if open_:
            root, inner = open_[0].name, open_[-1].name
            key = root if root == inner else f"{root}/{inner}"
        else:
            key = next((n for n, s, e in trace.spans if s <= t < e), "harness")
        out[key] = out.get(key, 0.0) + step / 1e6
    return out


def test_the_split_puts_each_gap_on_the_innermost_span():
    trace = _trace()
    got = spantrace.idle_by_span(trace, _placed())
    want = _walk(trace, _placed())
    assert set(got) == set(want)
    for k in want:
        assert got[k] == pytest.approx(want[k], abs=0.03e-6), k
    # a span of another thread (the BULK stream) takes no gap
    assert not any("migration.stream" in k for k in got)
    assert got["coldstart/coldstart.migration"] == pytest.approx(20e-6)


def test_the_split_sums_to_the_harness_split_and_leaves_it_unchanged():
    trace = _trace()
    before = devtrace.idle_gaps(trace)
    got = spantrace.idle_by_span(trace, _placed())
    assert devtrace.idle_gaps(trace) == before
    cold = sum(v for k, v in got.items() if k.split("/")[0] == "coldstart")
    assert cold + got.get("cold_start", 0.0) == pytest.approx(before["cold_start"], abs=1e-12)
    warm = sum(v for k, v in got.items() if k.split("/")[0] == "instance.invoke")
    assert warm + got.get("invoke", 0.0) == pytest.approx(before["invoke"], abs=1e-12)
    assert got["traffic"] == pytest.approx(before["traffic"], abs=1e-12)
    assert sum(got.values()) == pytest.approx(sum(before.values()), abs=1e-12)


def _records(offset_us, rate):
    """PROGRAM as the port records it: ns on a clock that runs ``rate`` times
    the profiler's, ``offset_us`` apart."""
    return [Span(n, int(round((s - offset_us) / rate * 1e3)),
                 int(round((e - offset_us) / rate * 1e3)), p, i, t)
            for n, s, e, p, i, t in PROGRAM]


def test_the_clock_fit_maps_the_roots_into_the_harness_spans():
    trace = _trace()
    recs = _records(offset_us=-3.0e10, rate=1.0 + 1e-4)
    a, b, x0 = spantrace.clock_fit(trace, recs)
    for r, want in zip(recs, PROGRAM):
        t = r.start_ns / 1e3
        assert t + a + b * (t - x0) == pytest.approx(want[1], abs=1.5)
    assert spantrace.clock_fit(trace, recs[1:]) is None     # a root without its pair


class _Ctx:
    def __init__(self, trace):
        self.trace = trace


@pytest.fixture
def program(monkeypatch):
    """The port's spans replaced by PROGRAM on a clock 3e10 us apart."""
    recs = _records(offset_us=-3.0e10, rate=1.0)
    monkeypatch.setattr(spans, "take", lambda: list(recs))
    return recs


def test_the_device_idle_readers_on_a_hand_built_trace(program):
    ctx = _Ctx(_trace())
    read = {n: harness.reader(harness.HERE, n) for n in DEVICE_READERS}
    # cold forward 55-95: busy 60-72 -> idle 28 of 40
    assert read["forward.idle_pct.cold"](ctx) == pytest.approx(70.0, abs=0.1)
    # warm forward 115-195: busy 120-150, 170-171 -> idle 49 of 80
    assert read["forward.idle_pct.warm"](ctx) == pytest.approx(100 * 49 / 80, abs=0.1)
    # coldstart 2-98: busy 5-10, 30-40, 60-72 -> idle 69; its forward's 28
    assert read["coldstart.host_idle_ms"](ctx) == pytest.approx(41e-3, abs=1e-4)
    us = harness.reader(harness.HERE, "kernel.host_us")(ctx)
    assert us == pytest.approx(np.median([3.0, 20.0]), abs=0.01)


def test_a_program_without_spans_reads_nothing(monkeypatch):
    monkeypatch.setitem(sys.modules, "repro_torch.spans", None)
    monkeypatch.setattr(spantrace, "_taken", (None, []))
    ctx = _Ctx(_trace())
    for name in DEVICE_READERS | {"kernel.host_us"}:
        assert harness.reader(harness.HERE, name)(ctx) is None


def test_the_profile_keeps_program_spans_out_of_the_harness_trace():
    from torch.profiler import ProfilerActivity, profile
    spans.take()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with torch.profiler.record_function("invoke"):
            with spans.invocation(), spans.span("instance.invoke"):
                with spans.span("forward"):
                    torch.ones(8) @ torch.ones(8)
    recs = spans.take()
    t = devtrace.collect(prof, harness.SPANS)
    assert [s[0] for s in t.spans] == ["invoke"] and t.ops == []
    assert {r.name for r in recs} == {"instance.invoke", "forward"}
    assert {"instance.invoke", "forward"} <= {e.name for e in prof.events()}


@pytest.mark.parametrize("workload,want", [
    ("m.tail", {"kernel.host_us", "migration.fault_wait_ms"}),
    ("d.hot", {"kernel.host_us"})])
def test_a_traced_cpu_run_reports_the_span_metrics(tmp_path, workload, want):
    bench = write_bench(tmp_path)
    cell = harness.load_cell(workload, bench, bench.parent)
    # long enough for cold starts in the untraced half on a busy CPU
    r = harness.run_cell(cell, SEED, 3.0, True, CPU, time.perf_counter())
    assert r["correct"], r["checks"]
    assert want <= set(r["metrics"])
    assert not DEVICE_READERS & set(r["metrics"])     # no device operations on the CPU
    assert r["metrics"]["kernel.host_us"]["value"] > 0
    assert spans.take() == []                         # the readers took the run's spans
    json.dumps(r)


@pytest.mark.gpu
def test_on_the_card_program_spans_add_no_device_event():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from torch.profiler import ProfilerActivity, profile
    spans.take()
    a = torch.randn(512, 512, device="cuda")
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with torch.profiler.record_function("invoke"):
            with spans.invocation(), spans.span("instance.invoke"):
                with spans.span("forward"):
                    (a @ a).sum().item()
    spans.take()
    t = devtrace.collect(prof, harness.SPANS)
    assert t.ops and not {n for n, _, _ in t.ops} & {"instance.invoke", "forward"}
