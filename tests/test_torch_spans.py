"""The port's program spans (``repro_torch.spans``): off they record nothing
and cost one shared no-op object; on, parents nest and invocation ids hold
across the BULK stream's thread; a cold start's phases are its spans and its
``PhaseTimes`` their durations; a profiler turns them on and shows each by
name; and the repaired ``MigrationStats``: a fault wait that includes the
stream's join, one ``page_gather`` call a page request."""
from __future__ import annotations

import os
import sys
import threading

import pytest
import torch

from repro_torch import spans
from repro_torch.core import (
    ColdStartConfig,
    ColdStartOrchestrator,
    DependencyManager,
    FunctionRegistry,
    LinkModel,
    RestorePolicy,
)
from repro_torch.core import workloads as wl
from repro_torch.kernels.page_gather import page_gather

PHASES = ["coldstart.boot", "coldstart.communication", "coldstart.migration",
          "coldstart.handler_import", "coldstart.execution", "coldstart.release"]
HARNESS_NAMES = {"traffic", "evict", "cold_start", "invoke"}


@pytest.fixture
def clean():
    spans.disable()
    spans.take()
    yield
    spans.disable()
    spans.take()


def _orchestrator(tmp, link=None):
    mgr = DependencyManager(device="cpu", link=link)
    reg = FunctionRegistry(store_dir=str(tmp / "store"))
    execs = wl.make_model_executables("model-tiny")
    mgr.register_image("model-tiny", "model-tiny",
                       wl.model_params_builder("model-tiny", device="cpu"),
                       executables=execs)
    w = wl.WORKLOADS["lr_serving"]
    reg.register("lr_serving", w.image_id, w.handler_builder, w.handler_fn,
                 write_baseline_checkpoint=False)
    return ColdStartOrchestrator(mgr, reg, ColdStartConfig(link=link or LinkModel()))


@pytest.fixture(scope="module")
def orch(tmp_path_factory):
    return _orchestrator(tmp_path_factory.mktemp("spans"))


def test_off_records_nothing_and_returns_one_no_op(clean):
    assert not spans.live()
    first = spans.span("forward")
    assert spans.span("kernel.flash_attention") is first
    assert spans.invocation() is first
    with spans.span("forward"), spans.invocation(7):
        with spans.phase("coldstart.boot") as ph:
            pass
    assert ph.seconds >= 0.0
    assert spans.carry(len) is len
    assert spans.take() == []


def test_on_parents_nest_and_invocation_ids_hold(clean):
    spans.enable()
    with spans.invocation() as outer:
        with spans.span("a"):
            with spans.span("b"):
                with spans.invocation() as inner:       # inside one: kept
                    with spans.phase("c") as ph:
                        pass
        with spans.invocation(41):
            with spans.span("d"):
                pass
    with spans.invocation() as other:
        with spans.span("e"):
            pass
    recs = {r.name: r for r in spans.take()}
    assert inner == outer and other != outer
    assert [recs[k].parent for k in "abcde"] == [None, "a", "b", None, None]
    assert [recs[k].invocation for k in "abcde"] == [outer] * 3 + [41, other]
    assert recs["a"].start_ns <= recs["b"].start_ns <= recs["c"].start_ns
    assert recs["c"].end_ns <= recs["b"].end_ns <= recs["a"].end_ns
    assert ph.seconds == (recs["c"].end_ns - recs["c"].start_ns) / 1e9
    assert {r.thread for r in recs.values()} == {threading.get_ident()}
    assert spans.take() == []


def test_a_carried_thread_takes_the_starting_span_and_invocation(clean):
    spans.enable()
    seen = {}

    def work():
        with spans.span("worker"):
            seen["thread"] = threading.get_ident()
    with spans.invocation(5), spans.span("starter"):
        t = threading.Thread(target=spans.carry(work))
        t.start()
        t.join()
    (w,) = [r for r in spans.take() if r.name == "worker"]
    assert (w.parent, w.invocation, w.thread) == ("starter", 5, seen["thread"])


def test_threads_recording_at_once_lose_no_span(clean):
    spans.enable()
    n_threads, n_spans = 4 * (os.cpu_count() or 1) + 1, 200
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work(k):
            with spans.invocation(k):
                for _ in range(n_spans):
                    with spans.span(f"outer{k}"), spans.span(f"inner{k}"):
                        pass
        threads = [threading.Thread(target=work, args=(k,)) for k in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(interval)
    recs = spans.take()
    assert len(recs) == 2 * n_threads * n_spans
    for r in recs:
        k = r.invocation
        assert r.name in (f"outer{k}", f"inner{k}")
        assert r.parent == (f"outer{k}" if r.name == f"inner{k}" else None)


def test_a_bulk_cold_start_gives_its_phases_in_order(orch, clean):
    spans.enable()
    inst, t = orch.cold_start_warmswap("lr_serving", RestorePolicy.BULK)
    recs = spans.take()
    (root,) = [r for r in recs if r.name == "coldstart"]
    assert root.parent is None and root.invocation is not None
    phases = sorted((r for r in recs if r.parent == "coldstart"), key=lambda r: r.start_ns)
    assert [r.name for r in phases] == PHASES
    assert all(a.end_ns <= b.start_ns for a, b in zip(phases, phases[1:]))
    assert root.start_ns <= phases[0].start_ns and phases[-1].end_ns <= root.end_ns
    dur = {r.name: (r.end_ns - r.start_ns) / 1e9 for r in recs}
    assert t.boot == dur["coldstart.boot"]
    assert t.communication == dur["coldstart.communication"]
    assert t.migration == dur["coldstart.migration"]
    assert t.handler_import == dur["coldstart.handler_import"]
    assert t.execution == dur["instance.invoke"] <= dur["coldstart.execution"]
    assert {r.invocation for r in recs} == {root.invocation}
    assert not {r.name for r in recs} & HARNESS_NAMES
    names = {r.name for r in recs}
    assert {"pool.request", "pool.ensure_live", "migration.fault", "migration.wait_all",
            "forward", "forward.embed", "forward.layer.global", "forward.head",
            "kernel.page_gather", "kernel.flash_attention"} <= names
    by = {r.name: r for r in recs}
    assert by["pool.ensure_live"].parent == "pool.request"
    assert by["pool.request"].parent == "coldstart.communication"
    assert by["forward"].parent == "instance.invoke"


def test_the_stream_threads_spans_carry_the_cold_starts_id(orch, clean):
    spans.enable()
    orch.cold_start_warmswap("lr_serving", RestorePolicy.BULK)
    recs = spans.take()
    (root,) = [r for r in recs if r.name == "coldstart"]
    (stream,) = [r for r in recs if r.name == "migration.stream"]
    assert stream.thread != root.thread
    assert (stream.parent, stream.invocation) == ("migration.fault", root.invocation)
    installs = [r for r in recs if r.name == "migration.install" and r.thread == stream.thread]
    assert installs and all(r.parent == "migration.stream" and r.invocation == root.invocation
                            for r in installs)


def test_a_profiler_turns_spans_on_and_shows_each_by_name(orch, clean):
    from torch.profiler import ProfilerActivity, profile
    assert not spans.live()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        assert spans.live()
        orch.cold_start_warmswap("lr_serving", RestorePolicy.BULK)
    assert not spans.live()
    main = threading.get_ident()
    recs = spans.take()
    mine = {r.name for r in recs if r.thread == main}
    shown = {e.name for e in prof.events()}
    assert "coldstart" in mine and len(mine) >= 15
    assert mine <= shown, sorted(mine - shown)


def test_each_page_request_is_one_page_gather_call(orch, clean):
    spans.enable()
    before = page_gather.launches
    inst, _ = orch.cold_start_warmswap("lr_serving", RestorePolicy.BULK)
    calls = [r for r in spans.take() if r.name == "kernel.page_gather"]
    stats = inst.migration_stats
    assert stats.requests == len(calls) > 1
    # the CPU runs the plain gather, which counts no launch; on the card the
    # wrapper counts one launch a call with pages in it
    assert page_gather.launches == before
    assert not hasattr(stats, "stream_s")


@pytest.mark.parametrize("policy", [RestorePolicy.BULK, RestorePolicy.LAZY])
def test_the_fault_wait_counts_the_block_on_the_stream(policy, clean, tmp_path):
    latency = 0.01
    orch = _orchestrator(tmp_path, LinkModel(latency_s=latency))
    spans.enable()
    inst, t = orch.cold_start_warmswap("lr_serving", policy)
    recs = spans.take()
    stats = inst.migration_stats
    # the faults, and under BULK the block in wait_all (LAZY's wait_all is
    # its faults)
    blocks = ("migration.fault", "migration.wait_all") if policy == RestorePolicy.BULK \
        else ("migration.fault",)
    waited = sum((r.end_ns - r.start_ns) / 1e9 for r in recs if r.name in blocks)
    assert stats.faults == sum(r.name == "migration.fault" for r in recs)
    assert stats.fault_wait_s == pytest.approx(waited, abs=1e-9)
    # every page request sleeps the link's latency, and the cold start
    # blocked until the last one was in
    assert stats.fault_wait_s >= 0.9 * stats.requests * latency
    assert stats.fault_wait_s <= t.migration


@pytest.mark.gpu
def test_on_the_card_page_requests_equal_page_gather_launches(clean, tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    mgr = DependencyManager(device="cuda")
    reg = FunctionRegistry(store_dir=str(tmp_path / "store"))
    mgr.register_image("model-tiny", "model-tiny",
                       wl.model_params_builder("model-tiny", device="cuda"),
                       executables=wl.make_model_executables("model-tiny"))
    w = wl.WORKLOADS["lr_serving"]
    reg.register("lr_serving", w.image_id, w.handler_builder, w.handler_fn,
                 write_baseline_checkpoint=False)
    orch = ColdStartOrchestrator(mgr, reg, ColdStartConfig())
    before = page_gather.launches
    inst, _ = orch.cold_start_warmswap("lr_serving", RestorePolicy.BULK)
    assert page_gather.launches - before == inst.migration_stats.requests
