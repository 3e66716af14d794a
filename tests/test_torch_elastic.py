"""Elastic restart on the port (tests/test_elastic.py's run on 8 gloo CPU
ranks): 4 steps on a 4 x 2 ("data", "model") mesh, a sharded checkpoint, a
restore re-sharded to 2 x 4 and 4 more steps, against 8 uninterrupted steps
on 4 x 2 (parameters and loss within 1e-3, the reference's bar); the
checkpoint the sharded port wrote restores in the reference's Checkpointer
to the same global arrays (qwen3; recurrentgemma's RG-LRU as well); the
training launcher's own ranks, on the multi-pod mesh too; and
``launch/cluster.py --role dryrun``.
"""
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.checkpoint import CheckpointConfig, Checkpointer
from repro.configs import get_reduced as jax_reduced
from repro.models.transformer import init_params as jax_init
from repro.optim import adamw_init as jax_adamw_init
from repro_torch.launch import cluster
from tests._torch_parity import elastic_rank, run_ranks

ROOT = os.path.join(os.path.dirname(__file__), "..")
OVERRIDES = dict(d_model=64, n_heads=4, n_kv_heads=2, d_ff=128)
TOL = 1e-3


def _flat(tree):
    return {jax.tree_util.keystr(k): np.asarray(v)
            for k, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _elastic(arch, tmp_path):
    """The elastic run of ``arch``: its checks, and the reference's
    parameters and rank 0's results."""
    jcfg = jax_reduced(arch, **OVERRIDES)
    params = jax_init(jax.random.PRNGKey(3), jcfg, jnp.float32)
    job = {"arch": arch, "overrides": OVERRIDES, "params": _flat(params),
           "dir": str(tmp_path / "ck")}
    out = run_ranks(elastic_rank, 8, job)[0]
    assert out["step"] == 4
    for key, want in out["ref"].items():
        assert float(np.abs(out["elastic"][key] - want).max()) < TOL, key
    assert abs(out["loss_ref"] - out["loss_el"]) < TOL
    return params, out


def test_elastic_restart_across_mesh_shapes(tmp_path):
    params, out = _elastic("qwen3_1_7b", tmp_path)
    # the reference's Checkpointer reads what the port's rank 0 wrote
    like = {"params": params, "opt_state": jax_adamw_init(params)}
    restored = Checkpointer(CheckpointConfig(str(tmp_path / "ck"))).restore(None, like)
    assert int(restored["__manifest__"]["step"]) == 4
    got = _flat(restored["params"])
    assert sorted(got) == sorted(out["saved"])
    for key, want in out["saved"].items():
        np.testing.assert_array_equal(got[key], want, err_msg=key)


def test_train_launcher_starts_its_own_ranks(tmp_path):
    """``python -m repro_torch.launch.train --model-axis 2`` with no process
    group starts two local ranks (gloo on the CPU) and trains on them."""
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch", "fnbench_tiny",
         "--steps", "2", "--batch", "2", "--seq", "32", "--model-axis", "2",
         "--device", "cpu", "--ckpt-dir", str(tmp_path / "ck"),
         "--log", str(tmp_path / "log.jsonl")],
        capture_output=True, text=True, timeout=240, cwd=ROOT,
        env={**os.environ, "PYTHONPATH": os.path.join(ROOT, "src")})
    assert out.returncode == 0, out.stderr[-3000:]
    assert "starting 2 local ranks" in out.stdout
    assert "backend gloo" in out.stdout
    with open(tmp_path / "log.jsonl") as f:
        assert [json.loads(line)["step"] for line in f] == [0, 1]


def test_train_launcher_runs_on_the_multi_pod_mesh(tmp_path):
    """``--pods 2 --model-axis 2`` starts four local ranks on a (2, 1, 2)
    ("pod", "data", "model") mesh: the batch of 2 splits over pod x data."""
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch", "fnbench_tiny",
         "--steps", "2", "--batch", "2", "--seq", "32", "--model-axis", "2", "--pods", "2",
         "--device", "cpu", "--ckpt-dir", str(tmp_path / "ck"),
         "--log", str(tmp_path / "log.jsonl")],
        capture_output=True, text=True, timeout=240, cwd=ROOT,
        env={**os.environ, "PYTHONPATH": os.path.join(ROOT, "src")})
    assert out.returncode == 0, out.stderr[-3000:]
    assert "starting 4 local ranks" in out.stdout
    assert "mesh pod=2 x data=1 x model=2" in out.stdout
    with open(tmp_path / "log.jsonl") as f:
        assert [json.loads(line)["step"] for line in f] == [0, 1]


def test_elastic_restart_of_the_rg_lru_across_mesh_shapes(tmp_path):
    """recurrentgemma's reduced config: 32 LRU channels, 16 a rank on 4 x 2
    (q and kv heads split), 8 on 2 x 4 (q heads split beside replicated kv
    heads)."""
    _elastic("recurrentgemma_2b", tmp_path)


def test_cluster_without_environment_is_one_process(monkeypatch, tmp_path):
    """No coordinator: one process; ``--role dryrun`` runs the dry run's
    cell in it, with no process group, and writes the cell's record."""
    for name in ("COORDINATOR_ADDRESS", "NUM_PROCESSES", "PROCESS_ID"):
        monkeypatch.delenv(name, raising=False)
    assert cluster.initialize_distributed("cpu") == (0, 1)
    with pytest.raises(SystemExit) as done:
        cluster.main(["--role", "dryrun", "--arch", "recurrentgemma_2b", "--shape",
                      "long_500k", "--mesh", "single", "--out", str(tmp_path)])
    assert done.value.code == 0
    with open(tmp_path / "recurrentgemma_2b__long_500k__single.json") as f:
        record = json.load(f)
    assert record["status"] == "ok" and record["chips"] == 256
    assert record["hlo_walk"]["flops_by_op"]["repro_torch.decode_attention"] > 0
