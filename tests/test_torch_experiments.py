"""The port's experiments layer (``repro_torch.experiments``) against the JAX
package's (``repro.experiments``).

* The executor's and store's contracts, ported from tests/test_executor.py:
  serial and parallel stores byte-identical, resume after a kill, the store's
  schema and corruption checks, keys and derived seeds, the CLI's sweep,
  resume and report.
* The CLI's run / sweep / validate / list / ``--set``, ported from
  tests/test_scenario.py, and the store-key rule for the streaming kwargs,
  ported from tests/test_stream_equiv.py.
* Against the reference: store keys and ``point_seed``s of every shipped spec
  equal; one spec's store, serial and parallel, byte-equal to the
  reference's; the smoke tournament's report equal over the policies the
  reference defines (another test file registers a placement on the
  reference's registry at run time).
* The ``fleet_vec`` scan's device reaches every point, spawned workers
  included: on the CPU its plain version gives the numpy solver's store, and
  the ``cuda`` default raises without a card.
"""
from __future__ import annotations

import glob
import json
import math
import os

import pytest

from repro.core.keepalive import PREWARM_POLICIES as JAX_PREWARMS
from repro.core.scenario import Scenario as JaxScenario
from repro.experiments import executor as jexecutor
from repro.experiments.store import spec_key as jax_spec_key
from repro.experiments.tournament import run_tournament as jax_run_tournament
from repro.serving.scheduler import PLACEMENTS as JAX_PLACEMENTS
from repro_torch.core.registry import UnknownComponentError
from repro_torch.core.scenario import Scenario, run, validate_result
from repro_torch.experiments import main as cli_main
from repro_torch.experiments import parse_axis
from repro_torch.experiments.executor import (point_seed, resolve_points, run_sweep,
                                              summarize_store)
from repro_torch.experiments.store import (CorruptStoreError, ResultStore, StoreError,
                                           StoreSchemaError, spec_key)
from repro_torch.experiments.tournament import (TournamentCell, _grid_axes, pareto_front,
                                                run_tournament)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCENARIOS_DIR = os.path.join(ROOT, "benchmarks", "scenarios")
SPECS = sorted(os.path.basename(p)[:-5] for p in glob.glob(os.path.join(SCENARIOS_DIR,
                                                                         "*.json")))


def _spec_path(name):
    return os.path.join(SCENARIOS_DIR, f"{name}.json")


def _base() -> Scenario:
    # single-engine + tiny horizon: each point runs in milliseconds, and the
    # executor path (resolve -> run -> validate -> store) is fully exercised
    return Scenario(name="exec_base", engine="single",
                    methods=["warmswap", "prebaking"],
                    traces={"name": "azure",
                            "kwargs": {"n_functions": 3, "horizon_min": 300,
                                       "seed": 0}})


AXES = {"traces.kwargs.seed": [0, 1, 2]}
#: page_headline at smoke scale on the vectorized engine: every group cap=1,
#: so REPRO_FLEET_VEC_SCAN=1 sends every group to the fleet_scan path
SCAN_AXES = {"engine": ["fleet_vec"], "traces.kwargs.seed": [0, 1]}


def _reference_names(registry) -> list:
    """The entries the reference package defines: not those another test file
    registers on its registry at run time (tests/test_scenario.py adds a
    placement), which share this process when both files land on one
    worker."""
    return [n for n in registry.names()
            if registry.resolve(n).__module__.startswith("repro.")]


# ---------------------------------------------------------------------------------
# serial == parallel == the reference
# ---------------------------------------------------------------------------------

def test_serial_and_parallel_sweeps_bit_identical(tmp_path):
    p_serial = str(tmp_path / "serial.jsonl")
    p_par = str(tmp_path / "parallel.jsonl")
    p_ref = str(tmp_path / "reference.jsonl")
    rs = run_sweep(_base(), AXES, store_path=p_serial)
    rp = run_sweep(_base(), AXES, store_path=p_par, parallel=2)
    assert rs.n_run == rp.n_run == 3
    assert open(p_serial, "rb").read() == open(p_par, "rb").read()
    assert rs.results == rp.results
    # and the stored results round-trip through the store reader
    assert [r["result"] for r in ResultStore(p_serial).records()] == rs.results
    # the reference's executor writes the same bytes for the same grid
    jbase = JaxScenario.from_dict(_base().to_dict())
    jexecutor.run_sweep(jbase, AXES, store_path=p_ref)
    assert open(p_serial, "rb").read() == open(p_ref, "rb").read()


def test_results_in_grid_order_and_headline_through_executor(tmp_path):
    report = run_sweep(_base(), AXES, store_path=str(tmp_path / "s.jsonl"))
    names = [p.name for p in report.points]
    assert names == [f"exec_base[traces.kwargs.seed={s}]" for s in (0, 1, 2)]
    for result in report.results:
        # the summary key must exist and be in (0, 1): 1 shared image over 3
        # functions is not the 10-function headline
        assert 0.0 < result["summary"]["memory_saving_vs_prebaking"] < 1.0


# ---------------------------------------------------------------------------------
# resume
# ---------------------------------------------------------------------------------

def test_resume_after_kill_skips_completed_points(tmp_path):
    full = str(tmp_path / "full.jsonl")
    run_sweep(_base(), AXES, store_path=full)
    full_bytes = open(full, "rb").read()
    lines = full_bytes.split(b"\n")          # header, 3 records, trailing ""

    # a kill mid-append: header + first record committed, second record torn
    # halfway through its line
    killed = str(tmp_path / "killed.jsonl")
    with open(killed, "wb") as f:
        f.write(lines[0] + b"\n" + lines[1] + b"\n" + lines[2][: len(lines[2]) // 2])

    report = run_sweep(_base(), AXES, store_path=killed, resume=True)
    assert report.n_skipped == 1                 # the committed point
    assert report.n_run == 2                     # torn + missing recomputed
    # the repaired store holds exactly the full run's records
    assert ResultStore(killed).records() == ResultStore(full).records()
    again = run_sweep(_base(), AXES, store_path=killed, resume=True)
    assert again.n_run == 0 and again.n_skipped == 3
    assert again.results == report.results


def test_existing_store_without_resume_is_refused(tmp_path):
    path = str(tmp_path / "s.jsonl")
    run_sweep(_base(), AXES, store_path=path)
    with pytest.raises(StoreError, match="resume"):
        run_sweep(_base(), AXES, store_path=path)


def test_reference_store_resumes_in_the_port(tmp_path):
    """Either package reads the other's store: a store the reference wrote
    for two of three points is resumed by the port, which runs the third."""
    path = str(tmp_path / "s.jsonl")
    jbase = JaxScenario.from_dict(_base().to_dict())
    jexecutor.run_sweep(jbase, {"traces.kwargs.seed": [0, 1]}, store_path=path)
    report = run_sweep(_base(), AXES, store_path=path, resume=True)
    assert (report.n_skipped, report.n_run) == (2, 1)
    full = str(tmp_path / "full.jsonl")
    run_sweep(_base(), AXES, store_path=full)
    assert open(path, "rb").read() == open(full, "rb").read()


# ---------------------------------------------------------------------------------
# store integrity
# ---------------------------------------------------------------------------------

def test_store_rejects_store_schema_mismatch(tmp_path):
    path = str(tmp_path / "s.jsonl")
    with open(path, "w") as f:
        f.write('{"store_schema_version": 99, "result_schema_version": 1}\n')
    with pytest.raises(StoreSchemaError, match="store_schema_version"):
        ResultStore(path).records()


def test_store_rejects_future_result_schema(tmp_path):
    path = str(tmp_path / "s.jsonl")
    with open(path, "w") as f:
        f.write('{"store_schema_version": 1, "result_schema_version": 999}\n')
    with pytest.raises(StoreSchemaError, match="result_schema_version"):
        ResultStore(path).records()
    with pytest.raises(StoreSchemaError):
        run_sweep(_base(), AXES, store_path=path, resume=True)


def test_store_rejects_non_header_file(tmp_path):
    path = str(tmp_path / "s.jsonl")
    with open(path, "w") as f:
        f.write('{"not": "a store"}\n')
    with pytest.raises(StoreSchemaError, match="header"):
        ResultStore(path).records()


def test_store_rejects_corrupt_interior_line(tmp_path):
    path = str(tmp_path / "s.jsonl")
    run_sweep(_base(), AXES, store_path=path)
    lines = open(path, "rb").read().split(b"\n")
    lines[2] = lines[2][: len(lines[2]) // 2]    # damage a middle record
    with open(path, "wb") as f:
        f.write(b"\n".join(lines))
    with pytest.raises(CorruptStoreError, match="corrupt line"):
        ResultStore(path).records()


def test_torn_trailing_line_dropped_then_repaired_by_append(tmp_path):
    path = str(tmp_path / "s.jsonl")
    report = run_sweep(_base(), AXES, store_path=path)
    with open(path, "ab") as f:
        f.write(b'{"key": "half-written')          # no newline: torn
    store = ResultStore(path)
    assert [r["key"] for r in store.records()] == [p.key for p in report.points]
    assert store.torn_tail
    store.append("extra", report.results[0], name="extra")
    records = ResultStore(path).records()
    assert [r["key"] for r in records] == [p.key for p in report.points] + ["extra"]
    raw = open(path, "rb").read()
    assert b"half-written" not in raw and raw.endswith(b"\n")


# ---------------------------------------------------------------------------------
# keys and seeds
# ---------------------------------------------------------------------------------

def test_spec_key_is_content_hash_of_resolved_spec():
    points = resolve_points(_base(), AXES)
    assert len({p.key for p in points}) == 3
    assert all(p.key == spec_key(p.spec) for p in points)
    assert [p.key for p in resolve_points(_base(), AXES)] == [p.key for p in points]


def test_smoke_resolution_changes_the_key():
    base = _base()
    base.smoke_overrides = {"traces.kwargs.horizon_min": 100}
    full = resolve_points(base, {})
    smoke = resolve_points(base, {}, smoke=True)
    assert full[0].key != smoke[0].key
    assert smoke[0].spec["traces"]["kwargs"]["horizon_min"] == 100


def test_derived_seeds_deterministic_and_distinct():
    axes = {"keep_alive_min": [5.0, 10.0, 20.0]}
    pts = resolve_points(_base(), axes, derive_seeds=True)
    seeds = [p.spec["traces"]["kwargs"]["seed"] for p in pts]
    assert len(set(seeds)) == 3
    assert seeds == [p.spec["traces"]["kwargs"]["seed"]
                     for p in resolve_points(_base(), axes, derive_seeds=True)]
    spec = pts[0].spec
    reseeded = json.loads(json.dumps(spec))
    reseeded["traces"]["kwargs"]["seed"] = 12345
    assert point_seed(spec) == point_seed(reseeded)


@pytest.mark.parametrize("name", SPECS)
def test_keys_and_seeds_equal_the_reference(name):
    """Every shipped spec, resolved at full and smoke scale with derived
    seeds over a keep-alive axis: the same points, store keys and seeds as
    the reference's."""
    axes = {"keep_alive_min": [5.0, 15.0]}
    for smoke in (False, True):
        got = resolve_points(Scenario.from_file(_spec_path(name)), axes, smoke=smoke,
                             derive_seeds=True)
        want = jexecutor.resolve_points(JaxScenario.from_file(_spec_path(name)), axes,
                                        smoke=smoke, derive_seeds=True)
        assert [(p.index, p.key, p.spec) for p in got] == \
            [(p.index, p.key, p.spec) for p in want]
        assert [point_seed(p.spec) for p in got] == \
            [jexecutor.point_seed(p.spec) for p in want]
        assert [spec_key(p.spec) for p in got] == [jax_spec_key(p.spec) for p in want]


def test_stream_and_chunk_min_are_non_semantic_for_the_store():
    spec = Scenario.from_file(_spec_path("adversarial_bursts")).to_dict()
    variants = [dict(spec) for _ in range(3)]
    variants[1] = Scenario.from_dict(spec).with_overrides(
        {"traces.kwargs.stream": True}).to_dict()
    variants[2] = Scenario.from_dict(spec).with_overrides(
        {"traces.kwargs.stream": True, "traces.kwargs.chunk_min": 360.0}).to_dict()
    keys = {spec_key(v) for v in variants}
    seeds = {point_seed(v) for v in variants}
    assert len(keys) == 1, "stream/chunk_min must not change spec_key"
    assert len(seeds) == 1, "stream/chunk_min must not change point_seed"
    assert keys == {jax_spec_key(v) for v in variants}
    # block_min IS semantic (it keys the per-block RNG)
    semantic = Scenario.from_dict(spec).with_overrides(
        {"traces.kwargs.block_min": 60.0}).to_dict()
    assert spec_key(semantic) not in keys


# ---------------------------------------------------------------------------------
# CLI + report
# ---------------------------------------------------------------------------------

def test_cli_sweep_store_resume_and_report(tmp_path, capsys):
    spec_path = str(tmp_path / "base.json")
    with open(spec_path, "w") as f:
        f.write(_base().to_json())
    store_path = str(tmp_path / "cli.jsonl")
    assert cli_main(["sweep", spec_path, "--axis", "traces.kwargs.seed=0,1",
                     "--parallel", "2", "--store", store_path]) == 0
    assert cli_main(["sweep", spec_path, "--axis", "traces.kwargs.seed=0,1",
                     "--store", store_path, "--resume"]) == 0
    out = capsys.readouterr().out
    assert "memory_saving_vs_prebaking" in out
    report_out = str(tmp_path / "report.json")
    assert cli_main(["report", store_path, "--out", report_out]) == 0
    summary = json.load(open(report_out))
    assert summary["n_points"] == 2
    assert len(summary["results"]) == 2
    summary2 = summarize_store(store_path)
    assert [r["key"] for r in summary2["points"]] == [r["key"] for r in summary["points"]]
    assert summary2 == jexecutor.summarize_store(store_path)


def test_resume_requires_store(tmp_path):
    with pytest.raises(StoreError, match="resume"):
        run_sweep(_base(), AXES, resume=True)
    spec_path = str(tmp_path / "base.json")
    with open(spec_path, "w") as f:
        f.write(_base().to_json())
    with pytest.raises(ValueError, match="--resume needs --store"):
        cli_main(["sweep", spec_path, "--axis", "n_workers=1", "--resume"])


def test_cli_run_writes_schema_valid_result(tmp_path, capsys):
    out = tmp_path / "res.json"
    rc = cli_main(["run", _spec_path("degenerate"), "--smoke", "--out", str(out)])
    assert rc == 0
    result = json.load(open(out))
    validate_result(result)
    assert "memory_saving_vs_prebaking" in capsys.readouterr().out
    from repro.experiments import run_file as jax_run_file
    assert result == jax_run_file(_spec_path("degenerate"), smoke=True).to_dict()


def test_cli_sweep_and_validate_and_list(tmp_path, capsys):
    assert parse_axis("n_workers=1,4,16") == {"n_workers": [1, 4, 16]}
    assert parse_axis("max_instances_per_fn=none,2") == {"max_instances_per_fn": [None, 2]}
    assert parse_axis("placement.name=affinity,round_robin") == \
        {"placement.name": ["affinity", "round_robin"]}
    with pytest.raises(ValueError):
        parse_axis("no-equals-sign")

    out = tmp_path / "sweep.json"
    rc = cli_main(["sweep", _spec_path("degenerate"), "--smoke",
                   "--axis", "n_workers=1,2", "--out", str(out)])
    assert rc == 0
    cells = json.load(open(out))
    assert [c["scenario"]["n_workers"] for c in cells] == [1, 2]
    for c in cells:
        validate_result(c)

    assert cli_main(["validate", _spec_path("degenerate"), _spec_path("prewarm")]) == 0
    assert cli_main(["list"]) == 0
    text = capsys.readouterr().out
    assert "placement strategy" in text and "prewarm policy" in text
    assert "PyTorch" in text and "JAX" not in text

    bad = tmp_path / "bad.json"
    spec = Scenario.from_file(_spec_path("degenerate")).to_dict()
    spec["placement"]["name"] = "afinity"
    bad.write_text(json.dumps(spec))
    with pytest.raises(UnknownComponentError, match="affinity"):
        cli_main(["validate", str(bad)])
    with pytest.raises(ValueError, match="--set"):
        cli_main(["run", _spec_path("degenerate"), "--smoke", "--set", "n_workers"])


def test_cli_set_override(capsys):
    rc = cli_main(["run", _spec_path("degenerate"), "--smoke",
                   "--set", "methods=[\"warmswap\"]",
                   "--set", "traces.kwargs.n_functions=4"])
    assert rc == 0
    out = capsys.readouterr().out
    assert "warmswap" in out and "prebaking" not in out


def test_cli_smoke_runs_specs(capsys):
    assert cli_main(["smoke", _spec_path("degenerate"), _spec_path("multi_tenant")]) == 0
    out = capsys.readouterr().out
    assert out.count("ok: ") == 2 and "multi_tenant" in out


# ---------------------------------------------------------------------------------
# the fleet_vec scan's device
# ---------------------------------------------------------------------------------

def test_scan_device_reaches_every_worker(tmp_path, monkeypatch):
    """With ``REPRO_FLEET_VEC_SCAN=1`` every point's cap=1 groups go to the
    scan on the device the sweep names, spawned workers included: on the CPU
    the kernel's plain version, whose store equals the numpy solver's and the
    reference's byte for byte; the ``cuda`` default raises on a box without
    a card, in a worker as in process, and never falls back."""
    base = Scenario.from_file(_spec_path("page_headline"))
    numpy_store = str(tmp_path / "numpy.jsonl")
    run_sweep(base, SCAN_AXES, smoke=True, store_path=numpy_store)
    ref_store = str(tmp_path / "reference.jsonl")
    jexecutor.run_sweep(JaxScenario.from_file(_spec_path("page_headline")), SCAN_AXES,
                        smoke=True, store_path=ref_store)
    monkeypatch.setenv("REPRO_FLEET_VEC_SCAN", "1")
    from repro_torch.core import fleet_vec
    scan_store = str(tmp_path / "scan.jsonl")
    run_sweep(base, SCAN_AXES, smoke=True, store_path=scan_store, parallel=2,
              device="cpu")
    run_sweep(base, {"engine": ["fleet_vec"]}, smoke=True, device="cpu")
    assert fleet_vec.SCAN_STATS["groups"] > 0            # in process: the scan ran
    stores = [open(p, "rb").read() for p in (numpy_store, ref_store, scan_store)]
    assert stores[0] == stores[1] == stores[2]
    if not __import__("torch").cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            run_sweep(base, SCAN_AXES, smoke=True)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            run_sweep(base, SCAN_AXES, smoke=True, parallel=2)


# ---------------------------------------------------------------------------------
# tournament
# ---------------------------------------------------------------------------------

def _cell(p99, bm, cold, method="warmswap"):
    return TournamentCell(prewarm="none", placement="affinity", method=method,
                          total_latency_s=0.0, p99_s=p99, byte_minutes=bm, n_cold=cold,
                          n_warm=0, oracle_gap_total_s=0.0, oracle_gap_p99_s=0.0)


def test_pareto_front_flags_the_non_dominated_cells():
    cells = [_cell(1.0, 5.0, 3), _cell(2.0, 1.0, 3), _cell(2.0, 5.0, 3),
             _cell(1.0, 5.0, 3), _cell(0.5, 9.0, 9)]
    # cell 2 is beaten by 0 and 1; 0 and 3 tie (neither strictly better)
    assert pareto_front(cells) == [True, True, False, True, True]
    assert pareto_front([]) == []


def test_grid_axes_default_to_every_registered_policy():
    from repro_torch.core.keepalive import PREWARM_POLICIES
    from repro_torch.serving.scheduler import PLACEMENTS
    axes = _grid_axes(None, None)
    assert axes == {"prewarm.name": sorted(PREWARM_POLICIES.names()),
                    "placement.name": sorted(PLACEMENTS.names())}
    assert sorted(PREWARM_POLICIES.names()) == sorted(_reference_names(JAX_PREWARMS))
    assert _grid_axes(["none"], ["affinity"]) == {"prewarm.name": ["none"],
                                                  "placement.name": ["affinity"]}


def test_tournament_refuses_the_single_engine():
    with pytest.raises(ValueError, match="engine='single'"):
        run_tournament(_base())


def test_smoke_tournament_equals_the_reference(tmp_path, capsys):
    """The CLI's smoke tournament over every policy the port registers
    equals the reference's over every policy the reference defines; every
    method's min gaps are finite and >= 0 (the oracle's dominance)."""
    out = str(tmp_path / "tournament.json")
    assert cli_main(["tournament", _spec_path("tournament"), "--smoke", "--out", out]) == 0
    got = json.load(open(out))
    want = jax_run_tournament(JaxScenario.from_file(_spec_path("tournament")), smoke=True,
                              prewarms=sorted(_reference_names(JAX_PREWARMS)),
                              placements=sorted(_reference_names(JAX_PLACEMENTS)))
    assert got == json.loads(want.to_json())
    assert len(got["cells"]) == 36
    for gaps in got["min_gaps"].values():
        assert all(math.isfinite(v) and v >= 0 for k, v in gaps.items() if k != "n_cells")
    assert any(c["pareto"] for c in got["cells"])
    assert "min total gap" in capsys.readouterr().err


def test_run_file_matches_run():
    from repro_torch.experiments import run_file, sweep_file
    got = run_file(_spec_path("degenerate"), smoke=True).to_dict()
    assert got == run(Scenario.from_file(_spec_path("degenerate")), smoke=True).to_dict()
    cells = sweep_file(_spec_path("degenerate"), {"n_workers": [1, 2]}, smoke=True)
    assert [c.to_dict()["scenario"]["n_workers"] for c in cells] == [1, 2]
