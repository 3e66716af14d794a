"""The yardstick's arithmetic and the metric readers, on hand-worked shapes."""
import math

import pytest

from bench_port import devtrace, harness, work
from bench_port.conftest import HERE, TINY
from bench_port.reference import dense_gqa, mamba1


def test_bounds_and_kernel_work():
    assert work.bound_s(3.35e12, 0) == pytest.approx(1.0)
    assert work.bound_s(0, 989e12) == pytest.approx(1.0)
    assert work.bound_s(0, 67e12, "float32") == pytest.approx(1.0)
    assert work.gather_work(100) == 200
    assert work.recurrence_work(1, 256, 10) == (3 * 256 * 10 * 4 + 2 * 10 * 4, 2 * 256 * 10)
    moved, ops = work.ssm_prefill_recurrence(600, 10, 3)      # chunks 256, 256, 88
    assert moved == 3 * (3 * 600 * 10 * 4 + 3 * 2 * 10 * 4) and ops == 3 * 2 * 600 * 10


def test_attention_pairs_and_flash_work():
    assert work.attention_pairs(4, 4, True, None) == 10
    assert work.attention_pairs(4, 4, True, 2) == 7          # 1 + 2 + 2 + 2
    assert work.attention_pairs(3, 3, False, None) == 9
    assert dense_gqa.attention_pairs(4, 2) == 7 and dense_gqa.attention_pairs(5, 8) == 15
    moved, ops = work.flash_work(1, 4, 2, 4, 8, None)
    assert moved == (2 * 4 * 4 * 8 + 2 * 2 * 4 * 8) * 2 and ops == 4 * 4 * 8 * 10


def test_model_flops_by_hand():
    c = TINY["tiny-mamba"]            # d 64, di 128, n 4, k 4, r 4, 2 layers, Vp 512
    per_layer = (2 * 10 * 64 * 256 + 2 * 10 * 128 * 4 + 2 * 10 * 128 * 12
                 + 2 * 10 * 4 * 128 + 4 * 10 * 128 * 4 + 2 * 10 * 128 * 64)
    assert mamba1.model_flops(c, 10) == 2 * per_layer + 2 * 64 * 512 + 2 * 512 * 16
    c = TINY["tiny-dense"]            # d 64, 4 heads / 2 kv of 16, ff 128, window 16
    per_layer = (2 * 20 * 64 * 8 * 16 + 2 * 20 * 64 * 64 + 4 * 4 * 16 * (136 + 4 * 16)
                 + 6 * 20 * 64 * 128)
    assert dense_gqa.model_flops(c, 20) == 2 * per_layer + 2 * 64 * 512 + 2 * 512 * 16


def _trace():
    return devtrace.Trace(
        ops=[("page_gather_kernel<x>", 10.0, 20.0), ("gemm", 15.0, 30.0),
             ("diag_recurrence_kernel", 50.0, 60.0)],
        spans=[("cold_start", 0.0, 40.0), ("traffic", 40.0, 45.0), ("invoke", 45.0, 100.0)],
        start=0.0, end=100.0)


def test_trace_reading():
    t = _trace()
    assert devtrace.merged(t.ops, t.start, t.end) == [(10.0, 30.0), (50.0, 60.0)]
    assert devtrace.busy_s(t) == pytest.approx(30e-6)
    assert devtrace.kernel_s(t, "page_gather") == (pytest.approx(10e-6), 1)
    gaps = devtrace.idle_gaps(t)           # 0-10 and 30-40 in cold_start, 40-45 traffic,
    assert gaps == pytest.approx({"cold_start": 20e-6, "traffic": 5e-6,   # 45-50 and
                                  "invoke": 45e-6})                        # 60-100 invoke
    assert devtrace.top_ops(t)[0][0] == "gemm"


def _ctx(trace=None):
    invs = [harness.Invocation(i, 0, 100 * (i + 1), "cold", 0.01 * (i + 1),
                               traced=trace is not None and i >= 8,
                               phases={"communication": 0.001, "migration": 0.002 * (i + 1),
                                       "execution": 0.003},
                               migration={"requests": 13, "bytes_transferred": 1000})
            for i in range(10)]
    invs += [harness.Invocation(10 + i, 1, 100, "warm", 0.001 * (i + 1)) for i in range(20)]
    return harness.Context(TINY["tiny-mamba"], mamba1, 2.0, 5.0, invs, trace)


def test_end_to_end_readers():
    ctx = _ctx()
    read = lambda name: harness.reader(HERE, name)(ctx)          # noqa: E731
    assert read("cold_start_p90_ms") == pytest.approx(91.0)     # numpy's linear p90 of 10..100
    assert read("warm_invoke_p95_ms") == pytest.approx(19.05)
    assert read("invocations_per_s") == pytest.approx(15.0)
    assert read("setup_s") == 5.0


def test_per_layer_readers():
    ctx = _ctx(_trace())
    read = lambda name: harness.reader(HERE, name)(ctx)          # noqa: E731
    assert read("pool.request_ms") == pytest.approx(1.0)
    assert read("coldstart.migration_ms") == pytest.approx(9.0)   # median of 2..16 ms
    assert read("coldstart.first_request_ms") == pytest.approx(3.0)
    assert read("migration.page_requests") == 13
    # two traced cold starts gathered 1000 bytes each: 4000 bytes moved in 10 us
    assert read("page_gather_roofline") == pytest.approx(100 * 4000 / 3.35e12 / 10e-6)
    c = ctx.config
    moved, ops = work.ssm_prefill_recurrence(900, 128 * 4, 2)
    m2, o2 = work.ssm_prefill_recurrence(1000, 128 * 4, 2)
    assert read("diag_recurrence_roofline") == pytest.approx(
        100 * work.bound_s(moved + m2, ops + o2, "float32") / 10e-6)
    flops = sum(mamba1.model_flops(c, 100 * (i + 1)) for i in range(8))
    assert read("mfu_pct.cold") == pytest.approx(100 * flops / (0.36 * 989e12))
    assert read("device.idle_pct") == pytest.approx(70.0)
    assert read("flash_attention_roofline") is None        # no attention in this model
    assert harness.reader(HERE, "page_gather_roofline")(_ctx()) is None   # no trace


def test_a_roofline_reads_nothing_without_its_kernel():
    ctx = _ctx(devtrace.Trace(ops=[("gemm", 0.0, 1.0)], spans=[("invoke", 0.0, 2.0)],
                              start=0.0, end=2.0))
    assert harness.reader(HERE, "page_gather_roofline")(ctx) is None
    assert harness.reader(HERE, "diag_recurrence_roofline")(ctx) is None
    assert not math.isnan(harness.reader(HERE, "device.idle_pct")(ctx))
