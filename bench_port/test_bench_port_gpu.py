"""On the card, at each cell's own size, through whole runs of the harness:
the precision control put in the program's place makes ``correct`` false on
three seeds; and in a hot cell, one function's answers altered where they
are produced make ``correct`` false. Run there with

    python -m pytest -q -s -m gpu bench_port/test_bench_port_gpu.py
"""
import json
import time

import pytest
import torch

from bench_port import control, harness
from bench_port.conftest import HERE

BENCH = json.loads((HERE.parent / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCH["workloads"]]
HOT = [w["name"] for w in BENCH["workloads"] if w["traffic"] == "hot"]
SECONDS = 10.0


def _report(workload, seed, what, r):
    print(json.dumps({"workload": workload, "seed": seed, what: r["checks"],
                      "correct": r["correct"], "attempted": r["attempted"]}), flush=True)


@pytest.mark.gpu
@pytest.mark.parametrize("workload", CELLS)
def test_the_control_fails_at_the_cells_size(workload):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    cell = harness.load_cell(workload)
    for seed in (2**31 + 401, 2**31 + 402, 2**31 + 403):
        r = control.run(cell, seed, SECONDS, torch.device("cuda"))
        _report(workload, seed, "control", r)
        gap = r["checks"]["logit_rms_gap"]
        assert not r["correct"] and gap["value"] > gap["limit"]
        assert r["checks"]["answers_missing"]["value"] == 0


def _one_function_altered(real):
    """The handler with the answers of the first function it serves rolled
    by one class, where they are produced."""
    def make(cfg, outbox):
        inner, first = real(cfg, outbox), []

        def handler(params, hw, request, execs):
            out = inner(params, hw, request, execs)
            if not first:
                first.append(hw)
            if hw is first[0]:
                out = out.roll(1)
                outbox[request["id"]] = out
            return out
        return handler
    return make


@pytest.mark.gpu
@pytest.mark.parametrize("workload", HOT)
def test_one_functions_altered_answers_are_caught_at_the_cells_size(workload, monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    monkeypatch.setattr(harness, "make_handler", _one_function_altered(harness.make_handler))
    cell = harness.load_cell(workload)
    seed = 2**31 + 411
    r = harness.run_cell(cell, seed, SECONDS, False, torch.device("cuda"),
                         time.perf_counter())
    _report(workload, seed, "fault", r)
    gap = r["checks"]["logit_rms_gap"]
    assert r["attempted"] > 0 and not r["correct"] and gap["value"] > gap["limit"]
