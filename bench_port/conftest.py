"""Test fixtures of the benchmark: tiny configurations of both reference
families, tiny traffic mixes and a manifest that names them, written to a
test's temporary folder (the benchmark's own files stay untouched), and the
``gpu`` marker of the tests that need the card."""
import json
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parent

TINY = {
    "tiny-mamba": {
        "name": "tiny-mamba", "family": "mamba1", "num_hidden_layers": 2,
        "hidden_size": 64, "intermediate_size": 128, "expand": 2, "state_size": 4,
        "conv_kernel": 4, "time_step_rank": 4, "time_step_min": 0.001,
        "time_step_max": 0.1, "vocab_size": 256, "layer_norm_epsilon": 1e-05,
        "tie_word_embeddings": False, "torch_dtype": "bfloat16", "live_instance_cap": 2,
        "limits": {"logit_rms_gap": 0.03, "answer_rms_gap_max": 0.08}},
    "tiny-dense": {
        "name": "tiny-dense", "family": "dense_gqa", "num_hidden_layers": 2,
        "hidden_size": 64, "intermediate_size": 128, "num_attention_heads": 4,
        "num_key_value_heads": 2, "head_dim": 16, "vocab_size": 256,
        "rms_norm_eps": 1e-05, "rope_theta": 10000.0, "sliding_window": 16,
        "tie_word_embeddings": False, "torch_dtype": "bfloat16", "live_instance_cap": 2,
        "limits": {"logit_rms_gap": 0.03, "answer_rms_gap_max": 0.08}},
}
LENGTHS = {"kind": "lognormal", "median": 24, "sigma": 0.5, "min": 8, "max": 48,
           "round_to": 4, "strata": 8}
MIXES = {
    "tinytail": {"name": "tinytail", "functions": 6, "prestart": False,
                 "restore_policy": "bulk", "lengths": LENGTHS},
    "tinyhot": {"name": "tinyhot", "functions": "cap", "prestart": True,
                "restore_policy": "bulk", "lengths": LENGTHS},
}
CELLS = {"m.tail": ("tiny-mamba", "tinytail"), "d.hot": ("tiny-dense", "tinyhot"),
         "d.tail": ("tiny-dense", "tinytail")}
#: the benchmark's cell each tiny cell stands for (its metrics follow)
STANDS_FOR = {"falcon7b.longtail": "m.tail", "danube3.hot": "d.hot"}


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA device; skips itself inside the test when "
        "there is none")


def write_bench(root: Path, extra_metrics=()) -> Path:
    """A manifest of the tiny cells under ``root``, with the benchmark's own
    metric readers copied beside any ``extra_metrics`` (name, source, entry);
    returns the manifest's path (``root`` is the data folder)."""
    (root / "configs").mkdir(parents=True)
    (root / "traffic").mkdir()
    (root / "metrics").mkdir()
    for name, c in TINY.items():
        (root / "configs" / f"{name}.json").write_text(json.dumps(c))
    for name, m in MIXES.items():
        (root / "traffic" / f"{name}.json").write_text(json.dumps(m))
    for f in (HERE / "metrics").glob("*.py"):
        (root / "metrics" / f.name).write_text(f.read_text())
    bench = json.loads((HERE.parent / "BENCHMARK.json").read_text())
    bench["configs"] = [{"name": n, "source": "test", "file": f"configs/{n}.json",
                         "reduced": [], "why": "test"} for n in TINY]
    bench["workloads"] = [{"name": w, "config": c, "traffic": t, "chips": 1, "why": "test"}
                          for w, (c, t) in CELLS.items()]
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m:
            m["workloads"] = [STANDS_FOR[w] for w in m["workloads"] if w in STANDS_FOR]
    for name, source, entry in extra_metrics:
        (root / "metrics" / f"{name}.py").write_text(source)
        bench["per_layer"].append(entry)
    path = root / "BENCHMARK.json"
    path.write_text(json.dumps(bench))
    return path


@pytest.fixture
def tiny_bench(tmp_path):
    return write_bench(tmp_path)
