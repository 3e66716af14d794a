"""Whole runs of the harness at a tiny size on the CPU, with the look for a
card skipped: a run is correct; a mix and a metric that only this test
adds are found by name; each fault planted under the timed path makes the
run incorrect; the fp8 control fails the limit the program passes."""
import json
import subprocess
import sys
import time

import pytest
import torch

from bench_port import control, guard, harness
from bench_port.conftest import HERE, write_bench

CPU = torch.device("cpu")
SEED = 2**31 + 101


def _run(bench, workload, seconds=0.6, trace=False):
    cell = harness.load_cell(workload, bench, bench.parent)
    return harness.run_cell(cell, SEED, seconds, trace, CPU, time.perf_counter())


def test_a_run_is_correct_and_reports_its_metrics(tiny_bench):
    r = _run(tiny_bench, "m.tail")
    assert r["correct"] and r["failed"] == 0 and r["attempted"] > 0
    assert set(r["metrics"]) == {"cold_start_p90_ms", "invocations_per_s", "setup_s"}
    assert list(r)[-1] == "checks"
    assert r["checks"]["restore_bytes_differing"]["value"] == 0
    t = _run(tiny_bench, "d.hot", trace=True)
    assert t["correct"] and "mfu_pct.warm" in t["metrics"]
    assert "breakdown" in t and t["device"]["window_s"] > 0


def test_a_mix_and_a_metric_added_as_files_are_found_by_name(tmp_path):
    source = "def read(ctx):\n    return float(len(ctx.invocations))\n"
    entry = {"name": "test_only.count", "unit": "invocations", "better": "higher",
             "source": "program_counter", "layer": "harness", "moves": "invocations_per_s",
             "workloads": ["t.only"]}
    bench = write_bench(tmp_path, [("test_only.count", source, entry)])
    (tmp_path / "traffic" / "test_only.json").write_text(json.dumps({
        "name": "test_only", "functions": 3,
        "prestart": True, "restore_policy": "no_pageserver",
        "lengths": {"kind": "lognormal", "median": 16, "sigma": 0.3, "min": 8,
                    "max": 32, "round_to": 8, "strata": 8}}))
    manifest = json.loads(bench.read_text())
    manifest["workloads"].append({"name": "t.only", "config": "tiny-dense",
                                  "traffic": "test_only", "chips": 1, "why": "test"})
    for m in manifest["end_to_end"] + manifest["per_layer"]:
        if m["name"] in ("invocations_per_s", "device.idle_pct"):
            m["workloads"].append("t.only")
    bench.write_text(json.dumps(manifest))
    r = _run(bench, "t.only", trace=True)
    assert r["correct"]
    assert r["metrics"]["test_only.count"]["value"] == r["attempted"]


def _stale(real):
    def make(cfg, outbox):
        inner, last = real(cfg, outbox), {}

        def handler(params, hw, request, execs):
            out = inner(params, hw, request, execs)
            prev, last["out"] = last.get("out"), out
            if prev is not None:
                outbox[request["id"]] = prev
                return prev
            return out
        return handler
    return make


def _forward_fault(kind):
    from repro_torch.models import transformer
    real = transformer.forward

    def forward(params, tokens, cfg, **kw):
        if kind == "half":
            tokens = tokens[:, : max(1, tokens.shape[1] // 2)]
        out = real(params, tokens, cfg, **kw)
        return out.roll(1, dims=-1) if kind == "altered" else out
    return forward


def _gather_fault():
    from repro_torch.core import migration
    real = migration.page_gather

    def page_gather(pool, ids):
        out = real(pool, ids)
        out.view(-1)[0] ^= 1
        return out
    return page_gather


@pytest.mark.parametrize("fault", ["state_unchanged", "half_prompt", "answer_altered",
                                   "restore_altered"])
def test_each_fault_under_the_timed_path_is_caught(tiny_bench, monkeypatch, fault):
    from repro_torch.core import migration
    from repro_torch.models import transformer
    if fault == "state_unchanged":
        monkeypatch.setattr(harness, "make_handler", _stale(harness.make_handler))
    elif fault == "half_prompt":
        monkeypatch.setattr(transformer, "forward", _forward_fault("half"))
    elif fault == "answer_altered":
        monkeypatch.setattr(transformer, "forward", _forward_fault("altered"))
    else:
        monkeypatch.setattr(migration, "page_gather", _gather_fault())
    r = _run(tiny_bench, "m.tail" if fault == "restore_altered" else "d.tail")
    assert r["attempted"] > 0 and not r["correct"], r["checks"]


def test_the_control_fails_the_limit_the_program_passes(tiny_bench):
    for workload in ("m.tail", "d.hot"):
        cell = harness.load_cell(workload, tiny_bench, tiny_bench.parent)
        limit = cell.config["limits"]["logit_rms_gap"]
        for seed in (1, 2, SEED):
            r = control.run(cell, seed, 0.6, CPU)
            assert r["attempted"] > 0 and not r["correct"], r["checks"]
            assert r["checks"]["logit_rms_gap"]["value"] > 2 * limit
            assert r["checks"]["answers_missing"]["value"] == 0


def test_the_sample_covers_every_length_group_and_function():
    lengths = list(range(8, 72, 1))
    groups = harness.loadgen.length_groups(lengths)
    invs = [harness.Invocation(i, i % 5, lengths[(7 * i) % 64], "warm" if i % 9 else "cold",
                               0.0) for i in range(300)]
    chosen = harness.sample(invs, SEED, groups)
    assert len(chosen) == harness.SAMPLE == len({v.index for v in chosen})
    assert {groups[v.length] for v in chosen} == set(groups.values())
    assert {v.fn for v in chosen} == set(range(5))
    assert max(v.length for v in chosen) == 71
    assert [v.index for v in harness.sample(invs, SEED, groups)] == [v.index for v in chosen]


def test_the_run_refuses_without_a_card_and_loads_no_jax():
    root = HERE.parent
    code = ("import sys, runpy; sys.argv = ['run.py', '--workload', 'falcon7b.longtail', "
            "'--seed', '1', '--seconds', '1']; "
            "import torch; torch.cuda.is_available = lambda: False; "
            "from bench_port import guard, harness, control; "
            "from repro_torch.core import coldstart; import repro_torch.models.transformer; "
            "print('FOUND', guard.forbidden(sys.modules)); "
            "runpy.run_path('bench_port/run.py', run_name='__main__')")
    p = subprocess.run([sys.executable, "-c", code], cwd=root, capture_output=True,
                       text=True, timeout=120,
                       env={"PYTHONPATH": f"{root}:{root / 'src'}", "PATH": "/usr/bin:/bin"})
    assert p.returncode == 3, p.stderr
    assert "FOUND []" in p.stdout and '"correct"' not in p.stdout


def test_the_guard_compares_whole_top_level_names():
    assert guard.forbidden(["repro_torch", "repro_torch.core.pool", "numpy"]) == []
    assert guard.forbidden(["repro.core.pool"]) == ["repro"]
    assert guard.forbidden(["jax._src.core", "jaxlib", "flax.linen"]) == ["flax", "jax",
                                                                           "jaxlib"]
    assert guard.forbidden(["reprox", "jaxtyping", "flaxen"]) == []
