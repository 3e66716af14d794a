"""The port's fleet examples against the reference's on the CPU:
``examples/fleet_sim_torch.py`` prints what ``examples/fleet_sim.py`` prints,
line for line, and ``examples/multi_tenant_fleet_torch.py``'s live replay and
twin count what the reference's count. (quickstart, train_small, serve_e2e:
tests/test_torch_examples.py.)"""
import re
import tempfile

import pytest
import torch

from tests._torch_parity import load_example, run_example

STORE_LINE = "executor sweep ("     # the one line that holds the temp store's path


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """The port's CPU ops on one thread: tier-1 runs six workers on a few
    cores, where each worker's full set of OpenMP threads fights the others'."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _temp_in_tmp_path(tmp_path, monkeypatch):
    """The examples' temp dirs (and fleet_sim's sweep store) go under the
    test's own directory."""
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))


def test_fleet_sim_prints_the_reference_line_for_line(tmp_path):
    """Every spec runs the event engines (host numpy, bit-identical to the
    reference): the stdout is equal bar the path of the sweep's temp store."""
    _, ref = run_example(load_example("fleet_sim"), [])
    out, lines = run_example(load_example("fleet_sim_torch"), ["--device", "cpu"])
    assert len(lines) == len(ref) > 30
    for mine, theirs in zip(lines, ref):
        if theirs.startswith(STORE_LINE):
            assert mine.startswith(STORE_LINE) and mine.endswith("/sweep.jsonl")
            assert mine.split(" -> ")[0] == theirs.split(" -> ")[0]
            continue
        assert mine == theirs
    assert out["store"].startswith(str(tmp_path))
    assert out["sweep_points"] == out["resumed_skipped"] == 2
    assert round(out["saving"] * 100) == 89


def _counts(lines):
    m = re.match(r"\[fleet\] (\d+) invocations over [\d.]+h: (\d+) cold \(.*\), "
                 r"(\d+) warm \(", lines[0])
    return tuple(int(g) for g in m.groups())


def test_multi_tenant_fleet_counts_what_the_reference_counts():
    """``--hours 1``: equal invocations, cold and warm starts (the live
    replay's equal the twin's), equal pool bytes and builds, an equal twin
    line."""
    _, ref = run_example(load_example("multi_tenant_fleet"), ["--hours", "1"])
    out, lines = run_example(load_example("multi_tenant_fleet_torch"),
                             ["--hours", "1", "--device", "cpu"])
    assert _counts(lines) == _counts(ref) == (
        out["invocations"], out["cold"], out["warm"])
    assert (out["cold"], out["warm"]) == (out["twin_cold"], out["twin_warm"])
    assert out["pool_bytes"] == 46_137_344 and out["builds"] == 1
    assert lines[1:] == ref[1:]          # pool memory, builds, the twin
