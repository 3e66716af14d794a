"""BENCHMARK.json keeps to the benchmark's contract: names, units, keys and
cross-references, and every cell, configuration, mix and metric has its
file, found by its name."""
import importlib
import json
import re

import pytest

from bench_port.conftest import HERE

BENCH = json.loads((HERE.parent / "BENCHMARK.json").read_text())
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")
UNIT = re.compile(r"[A-Za-z0-9_/%.-]{1,16}")
METRIC_KEYS = {"name", "unit", "better", "source", "workloads"}
WIDTH = re.compile(r"_dim$|_rank$|hidden|intermediate|latent|state|proj|head|expan|"
                   r"experts_per_tok|size")


def _metrics():
    return [(m, "end_to_end") for m in BENCH["end_to_end"]] + [
        (m, "per_layer") for m in BENCH["per_layer"]]


def test_top_level_keys_and_command():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "bench_port/run.py"]
    assert BENCH["paths"] == ["bench_port"]
    rs = BENCH["run_seconds"]
    assert 1 <= rs <= 51 and (2 + 14 * 24) * (rs + 60) + 24 * 180 + 1200 <= 43200
    assert len((HERE.parent / "BENCHMARK.json").read_bytes()) <= 64 * 1024


@pytest.mark.parametrize("metric,kind", _metrics(), ids=lambda m: getattr(m, "get", str)("name"))
def test_metric_names_units_and_readers(metric, kind):
    extra = {"bound"} if kind == "end_to_end" else {"layer", "moves"}
    assert set(metric) <= METRIC_KEYS | extra and set(metric) >= (METRIC_KEYS | extra) - {
        "workloads"}
    assert NAME.fullmatch(metric["name"]) and UNIT.fullmatch(metric["unit"])
    assert metric["better"] in ("lower", "higher")
    assert (HERE / "metrics" / f"{metric['name']}.py").is_file()
    cells = {w["name"] for w in BENCH["workloads"]}
    assert set(metric.get("workloads", cells)) <= cells
    if kind == "end_to_end":
        assert metric["source"] in ("host_clock", "device_trace")
        assert 0.01 <= metric["bound"] <= 0.25
    else:
        assert metric["source"] in ("device_trace", "program_span", "program_counter",
                                    "host_clock")
        moved = {m["name"]: m for m in BENCH["end_to_end"]}[metric["moves"]]
        for w in metric["workloads"]:
            assert w in moved.get("workloads", cells)
        assert 1 <= len(metric["layer"]) <= 200 and "\n" not in metric["layer"]
        if metric["name"].endswith("_roofline") or "mfu" in metric["name"]:
            assert metric["unit"] == "%"


def test_cells_configs_and_mixes():
    names = [m["name"] for m, _ in _metrics()]
    assert len(names) == len(set(names))
    configs = {c["name"]: c for c in BENCH["configs"]}
    used = set()
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.fullmatch(w["name"]) and w["chips"] == 1 and len(w["why"]) <= 200
        assert (HERE / "traffic" / f"{w['traffic']}.json").is_file()
        used.add(w["config"])
        mine = [m for m, _ in _metrics() if w["name"] in m.get("workloads", [w["name"]])]
        e2e = {m["name"] for m in mine if m in BENCH["end_to_end"]}
        assert "setup_s" in e2e and len(e2e) >= 2
        assert any(m in BENCH["per_layer"] for m in mine)
    assert used == set(configs)
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("bench_port/") and len(c["reduced"]) <= 16
        for key in c["reduced"]:                 # a departure, never a width
            assert NAME.fullmatch(key) and not WIDTH.search(key), key
        data = json.loads((HERE.parent / c["file"]).read_text())
        assert data["name"] == c["name"] and data["source"] == c["source"]
        importlib.import_module(f"bench_port.reference.{data['family']}")
        assert data["limits"]["logit_rms_gap"] > 0
