"""The port's simulation track against the JAX package's, bit for bit.

The same specs, traces and seeds go through ``repro.core`` and
``repro_torch.core``; the tolerance is bit identity everywhere: ``==`` on
every counter and float, sha256 on every per-request sample buffer (the
contract of ``tests/test_fleet_equiv.py`` and ``tests/test_golden_replay.py``).
"""
import glob
import hashlib
import json
import os
import tempfile

import numpy as np
import pytest
import torch

import repro.core.coldstart as jcs
import repro.core.costmodel as jcm
import repro.core.fleet as jfleet
import repro.core.fleet_vec as jvec
import repro.core.oracle as joracle
import repro.core.pool as jpool
import repro.core.registry as jreg
import repro.core.scenario as jscn
import repro.core.simulator as jsim
import repro.core.traces as jtraces
import repro.core.workloads as jwl
import repro_torch.core.coldstart as tcs
import repro_torch.core.costmodel as tcm
import repro_torch.core.fleet as tfleet
import repro_torch.core.fleet_vec as tvec
import repro_torch.core.oracle as toracle
import repro_torch.core.pool as tpool
import repro_torch.core.registry as treg
import repro_torch.core.scenario as tscn
import repro_torch.core.simulator as tsim
import repro_torch.core.traces as ttraces
import repro_torch.core.workloads as twl
from tests._torch_parity import reference_lax_scan

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCENARIOS = sorted(glob.glob(os.path.join(ROOT, "benchmarks", "scenarios", "*.json")))
DATA = os.path.join(ROOT, "tests", "data")
AZURE_CSV = os.path.join(ROOT, "benchmarks", "data", "azure_sample.csv.gz")

#: the scenarios whose smoke run takes well under a second in the reference
PARITY = ["degenerate", "sharing_fig7", "multi_tenant", "fleet_base", "page_headline",
          "bounded_cache", "placement", "prewarm", "queueing", "churn"]
SAMPLE_FIELDS = ("latency_samples_s", "queue_wait_s", "sample_fn")
INT_FIELDS = ("n_invocations", "n_cold", "n_warm", "n_queued", "n_workers",
              "pool_misses", "evictions", "max_concurrent_instances",
              "placement_warm_hits", "placement_pool_hits", "memory_bytes",
              "cache_local_hits", "cache_remote_hits", "cache_misses",
              "shared_cache_peak_bytes", "shared_cache_evictions",
              "pages_transferred", "prewarm_spawns", "prewarm_hits",
              "prewarm_dropped")
FLOAT_FIELDS = ("total_latency_s", "queue_delay_s", "instance_resident_min",
                "horizon_min")


def _sha(a) -> str:
    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()


def assert_same_fleet(a, b, label=""):
    """Bit identity between two fleet results (either package's)."""
    for name in SAMPLE_FIELDS:
        x, y = getattr(a, name), getattr(b, name)
        assert x.shape == y.shape and x.dtype == y.dtype, f"{label}: {name}"
        assert _sha(x) == _sha(y), f"{label}: {name} bytes differ"
    for name in INT_FIELDS + FLOAT_FIELDS:
        assert getattr(a, name) == getattr(b, name), \
            f"{label}: {name} {getattr(a, name)!r} != {getattr(b, name)!r}"
    assert a.per_fn_latency == b.per_fn_latency, label
    assert a.per_fn_invocations == b.per_fn_invocations, label
    assert a.per_worker == b.per_worker, label


def _port_traces(traces):
    """The reference's traces as the port's ``Trace`` objects (same floats)."""
    return [ttraces.Trace(t.fn_index, t.rate_per_min, t.arrivals_min.copy(),
                          image_id=t.image_id) for t in traces]


# ------------------------------------------------------------------- scenarios
@pytest.mark.parametrize("path", SCENARIOS, ids=lambda p: os.path.basename(p)[:-5])
def test_every_checked_in_spec_loads_the_same(path):
    j = jscn.Scenario.from_file(path)
    t = tscn.Scenario.from_file(path)
    assert t.to_dict() == j.to_dict()
    assert t.smoke_scaled().to_dict() == j.smoke_scaled().to_dict()


@pytest.mark.parametrize("name", PARITY)
def test_scenario_smoke_parity(name):
    path = os.path.join(ROOT, "benchmarks", "scenarios", f"{name}.json")
    j = jscn.run(jscn.Scenario.from_file(path), smoke=True)
    t = tscn.run(tscn.Scenario.from_file(path), smoke=True)
    assert t.to_dict() == j.to_dict()
    assert set(t.raw) == set(j.raw)
    for m in j.raw:
        for f in SAMPLE_FIELDS:
            if hasattr(j.raw[m], f):
                assert _sha(getattr(t.raw[m], f)) == _sha(getattr(j.raw[m], f)), \
                    f"{name}/{m}/{f}"


def test_page_headline_band_through_both_engines():
    """The paper's 2.2-3.2x dependency-loading band and fleet == fleet_vec,
    as ``tests/test_fleet_equiv.py`` asserts for the reference."""
    path = os.path.join(ROOT, "benchmarks", "scenarios", "page_headline.json")
    scn = tscn.Scenario.from_file(path).smoke_scaled()
    ev = tscn.run(scn.with_overrides({"engine": "fleet"}))
    vec = tscn.run(scn.with_overrides({"engine": "fleet_vec"}))
    for m in ev.raw:
        assert_same_fleet(ev.raw[m], vec.raw[m], label=m)
    assert ev.summary == vec.summary
    assert 2.2 <= vec.summary["dependency_loading_speedup"] <= 3.2


# ------------------------------------------------------------- golden replay
def _golden():
    doc = json.load(open(os.path.join(DATA, "golden_trace.json")))
    exp = json.load(open(os.path.join(DATA, "golden_expected.json")))
    traces = [ttraces.Trace(d["fn_index"], d["rate_per_min"],
                            np.array(d["arrivals_min"], np.float64),
                            image_id=d["image_id"])
              for d in doc["traces"]]
    return doc, exp, traces


GOLDEN_ENGINES = {
    "fleet": lambda tr, m, c, f: tfleet._simulate_fleet_impl(tr, m, c, f),
    "fleet_vec": lambda tr, m, c, f: tvec.simulate_fleet_vec(tr, m, c, f, scan=False),
    "fleet_vec_scan_cpu": lambda tr, m, c, f: tvec.simulate_fleet_vec(
        tr, m, c, f, scan=True, device="cpu"),
}


@pytest.mark.parametrize("engine", list(GOLDEN_ENGINES))
@pytest.mark.parametrize("method", ["warmswap", "prebaking", "baseline"])
def test_golden_replay(engine, method):
    doc, exp, traces = _golden()
    cost = tsim.CostModel.paper_table2()
    r = GOLDEN_ENGINES[engine](traces, method, cost, tfleet.FleetConfig(**doc["fleet"]))
    want = exp["methods"][method]
    for name in SAMPLE_FIELDS:
        got = getattr(r, name)
        ref = np.array(want[name], got.dtype)
        bad = np.flatnonzero(got != ref)
        assert bad.size == 0, f"{engine}/{method}: {name} differs at {bad[:1]}"
    assert (r.n_cold, r.n_warm, r.n_queued) == \
        (want["n_cold"], want["n_warm"], want["n_queued"])
    assert r.total_latency_s == want["total_latency_s"]
    assert r.memory_bytes == want["memory_bytes"]
    assert r.instance_resident_min == want["instance_resident_min"]
    if engine == "fleet_vec_scan_cpu":    # baseline under affinity takes the event engine
        fast = tvec.fast_path_reason(traces, method, cost,
                                     tfleet.FleetConfig(**doc["fleet"])) is None
        assert (tvec.SCAN_STATS["groups"] > 0) == fast == (method != "baseline")


# ------------------------------------------------------------ scan path, whole
def _scan_traces():
    return jtraces.generate_fleet_traces(n_functions=8, horizon_min=1200.0, seed=0,
                                         total_rate_per_min=6.0)


@pytest.mark.parametrize("method", ["warmswap", "prebaking", "baseline"])
@pytest.mark.parametrize("n_workers", [1, 4])
def test_scan_path_bit_identical(method, n_workers, monkeypatch):
    """The port of the reference's ``test_scan_path_bit_identical``: the
    batched scan (plain version on the CPU) against the reference's
    ``lax.scan`` path and its event engine."""
    reference_lax_scan(monkeypatch)
    tr = _scan_traces()
    placement = "round_robin" if method == "baseline" else "affinity"
    cfg = dict(n_workers=n_workers, max_instances_per_fn=1, placement=placement)
    ev = jfleet._simulate_fleet_impl(tr, method, jsim.CostModel.paper_table2(),
                                     jfleet.FleetConfig(**cfg))
    jscan = jvec.simulate_fleet_vec(tr, method, jsim.CostModel.paper_table2(),
                                    jfleet.FleetConfig(**cfg), scan=True)
    assert jvec.SCAN_STATS["groups"] > 0
    got = tvec.simulate_fleet_vec(_port_traces(tr), method, tsim.CostModel.paper_table2(),
                                  tfleet.FleetConfig(**cfg), scan=True, device="cpu")
    assert tvec.SCAN_STATS["groups"] == jvec.SCAN_STATS["groups"]
    assert_same_fleet(ev, got, label=f"event/{method}")
    assert_same_fleet(jscan, got, label=f"lax.scan/{method}")


def test_scan_env_knob_runs_on_the_named_device(monkeypatch):
    tr = _port_traces(_scan_traces())
    monkeypatch.setenv("REPRO_FLEET_VEC_SCAN", "1")
    cfg = tfleet.FleetConfig(n_workers=1, max_instances_per_fn=1)
    r = tvec.simulate_fleet_vec(tr, "warmswap", tsim.CostModel.paper_table2(), cfg,
                                device="cpu")
    assert tvec.SCAN_STATS["groups"] > 0
    ref = tvec.simulate_fleet_vec(tr, "warmswap", tsim.CostModel.paper_table2(), cfg,
                                  scan=False)
    assert tvec.SCAN_STATS["groups"] == 0
    assert_same_fleet(ref, r)


def test_scan_without_a_card_raises(monkeypatch):
    """No silent fallback: with the scan on and no device named, the call
    wants the card and raises without one."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    tr = _port_traces(_scan_traces())
    cfg = tfleet.FleetConfig(n_workers=1, max_instances_per_fn=1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tvec.simulate_fleet_vec(tr, "warmswap", tsim.CostModel.paper_table2(), cfg,
                                scan=True)
    monkeypatch.setenv("REPRO_FLEET_VEC_SCAN", "1")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tvec.simulate_fleet_vec(tr, "warmswap", tsim.CostModel.paper_table2(), cfg)


def test_azure_scale_xl_cap1_scan_equals_numpy_and_reference():
    """Phase 19b of ``chip_smoke.py`` at a CPU size: the largest scenario,
    every group cap=1, the scan (plain) against the numpy solver and the
    reference."""
    path = os.path.join(ROOT, "benchmarks", "scenarios", "azure_scale_xl.json")
    trims = {"traces.kwargs.horizon_min": 30, "max_instances_per_fn": 1}
    t_scn = tscn.Scenario.from_file(path).with_overrides(trims)
    j_scn = jscn.Scenario.from_file(path).with_overrides(trims)
    traces = ttraces.TRACE_GENERATORS.build(t_scn.traces.name, **t_scn.traces.kwargs)
    cost = tsim.CostModel.paper_table2()
    fleet = tfleet.FleetConfig(n_workers=4, placement="affinity", max_instances_per_fn=1,
                               keep_alive_min=t_scn.keep_alive_min)
    for m in t_scn.methods:
        assert tvec.fast_path_reason(traces, m, cost, fleet) is None
    j = jscn.run(j_scn)
    plain = tscn.run(t_scn)
    for m in t_scn.methods:
        scan = tvec.simulate_fleet_vec(traces, m, cost, fleet, scan=True, device="cpu")
        assert tvec.SCAN_STATS["groups"] == len({t.fn_index for t in traces
                                                 if len(t.arrivals_min)})
        assert_same_fleet(plain.raw[m], scan, label=f"numpy/{m}")
        assert_same_fleet(j.raw[m], scan, label=f"reference/{m}")


# --------------------------------------------------- oracle, streams, costs
def test_golden_oracle_fixture():
    doc = json.load(open(os.path.join(DATA, "golden_oracle_small.json")))
    want = doc["expected"]
    traces = [ttraces.Trace(d["fn_index"], d["rate_per_min"],
                            np.array(d["arrivals_min"], np.float64),
                            image_id=d["image_id"]) for d in doc["traces"]]
    o = toracle.hindsight_floor(traces, doc["method"], tsim.CostModel(**doc["cost_kwargs"]))
    jo = joracle.hindsight_floor(traces, doc["method"], jsim.CostModel(**doc["cost_kwargs"]))
    assert (o.n_invocations, o.n_cold, o.n_warm) == \
        (want["n_invocations"], want["n_cold"], want["n_warm"])
    assert o.min_cold_s == want["min_cold_s"] and o.warm_s == want["warm_s"]
    assert o.total_latency_s == want["total_latency_s"] == jo.total_latency_s
    assert list(o.latency_samples_s) == want["latency_samples_s"]
    assert o.latency_percentiles() == want["latency_percentiles_s"]
    assert o.to_dict() == jo.to_dict()


def test_oracle_gap_report_matches_reference():
    tr = _scan_traces()
    cfg = dict(n_workers=2, max_instances_per_fn=2, placement="least_loaded")
    j_res = jfleet._simulate_fleet_impl(tr, "warmswap", jsim.CostModel.paper_table2(),
                                        jfleet.FleetConfig(**cfg))
    t_res = tfleet._simulate_fleet_impl(_port_traces(tr), "warmswap",
                                        tsim.CostModel.paper_table2(),
                                        tfleet.FleetConfig(**cfg))
    assert_same_fleet(j_res, t_res)
    jf = joracle.hindsight_floor(tr, "warmswap", jsim.CostModel.paper_table2())
    tf = toracle.hindsight_floor(_port_traces(tr), "warmswap",
                                 tsim.CostModel.paper_table2())
    assert tf.to_dict() == jf.to_dict()
    assert toracle.gap_report(tf, t_res) == joracle.gap_report(jf, j_res)


def test_azure_csv_stream_matches_reference_and_materialised():
    kw = dict(path=AZURE_CSV, n_functions=64, horizon_min=1440, seed=0,
              block_min=120.0, chunk_min=240.0)
    j = jtraces.TRACE_GENERATORS.build("azure_csv", stream=False, **kw)
    t_mem = ttraces.TRACE_GENERATORS.build("azure_csv", stream=False, **kw)
    assert len(t_mem) == len(j) > 0
    for a, b in zip(t_mem, j):
        assert (a.fn_index, a.image_id, a.rate_per_min) == (b.fn_index, b.image_id,
                                                            b.rate_per_min)
        assert _sha(a.arrivals_min) == _sha(b.arrivals_min)
    t_st = ttraces.TRACE_GENERATORS.build("azure_csv", stream=True, **kw)
    cost = tsim.CostModel.paper_table2()
    for m in ("warmswap", "baseline"):
        mem = tfleet._simulate_fleet_impl(t_mem, m, cost, tfleet.FleetConfig(n_workers=2))
        st = tfleet._simulate_fleet_impl(t_st, m, cost, tfleet.FleetConfig(n_workers=2))
        ref = jfleet._simulate_fleet_impl(j, m, jsim.CostModel.paper_table2(),
                                          jfleet.FleetConfig(n_workers=2))
        assert_same_fleet(mem, st, label=f"stream/{m}")
        assert_same_fleet(ref, st, label=f"reference/{m}")


@pytest.mark.parametrize("method", ["warmswap", "prebaking", "baseline"])
def test_degenerate_page_model_gives_back_scalar_costs(method):
    cost = tsim.CostModel.paper_table2()
    deg = tcm.PageCostModel.degenerate(cost)
    want = tsim.method_cold_latency_s(cost, method)
    assert want == jsim.method_cold_latency_s(jsim.CostModel.paper_table2(), method)
    for tier in ("local", "remote", "miss"):
        kw = {"image_bytes": cost.snapshot_bytes} if method == "prebaking" else {}
        got = deg.cold_latency_s(method, tier=tier, **kw)
        assert got == want
    jpage = jcm.PAGE_COST_MODELS.build("default", cost=jsim.CostModel.paper_table2())
    tpage = tcm.PAGE_COST_MODELS.build("default", cost=cost)
    assert tpage.dependency_loading_speedup() == jpage.dependency_loading_speedup()


def test_predicted_cold_latency_matches_reference():
    """``ColdStartOrchestrator.predicted_cold_latency_s`` on a small live
    image, priced by the paper's page model, equals the reference's."""
    preds = []
    for pool, reg, cs, wl, cm, sim in ((jpool, jreg, jcs, jwl, jcm, jsim),
                                       (tpool, treg, tcs, twl, tcm, tsim)):
        tmp = tempfile.mkdtemp()
        kw = {"device": "cpu"} if pool is tpool else {}
        mgr = pool.DependencyManager(disk_dir=tmp + "/pool", page_size=1 << 16, **kw)
        fr = reg.FunctionRegistry(store_dir=tmp + "/store")
        mgr.register_image("py-base", "py-base", wl.py_base_builder)
        w = wl.WORKLOADS["helloworld"]
        fr.register("helloworld", w.image_id, w.handler_builder, w.handler_fn)
        orch = cs.ColdStartOrchestrator(mgr, fr)
        page = cm.PAGE_COST_MODELS.build("default", cost=sim.CostModel.paper_table2())
        row = [orch.predicted_cold_latency_s("helloworld", page, m, tier)
               for m in ("warmswap", "baseline") for tier in ("local", "remote")]
        orch.cold_start_warmswap("helloworld")       # the image is live now
        assert mgr.live_image_bytes("py-base") > 0
        row += [orch.predicted_cold_latency_s("helloworld", page, m, tier, resident_pages=r)
                for m in ("warmswap", "prebaking", "baseline")
                for tier in ("local", "remote", "miss") for r in (0, 3)]
        preds.append(row)
    assert preds[0] == preds[1]
