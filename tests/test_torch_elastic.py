"""Elastic restart on the port (tests/test_elastic.py's run on 8 gloo CPU
ranks): 4 steps on a 4 x 2 ("data", "model") mesh, a sharded checkpoint, a
restore re-sharded to 2 x 4 and 4 more steps, against 8 uninterrupted steps
on 4 x 2 (parameters and loss within 1e-3, the reference's bar); the
checkpoint the sharded port wrote restores in the reference's Checkpointer
to the same global arrays; and the training launcher's own ranks.
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
from repro_torch.configs import get_reduced
from repro_torch.launch import cluster
from repro_torch.models.sharding import Parallel
from tests._torch_parity import elastic_rank, run_ranks

ROOT = os.path.join(os.path.dirname(__file__), "..")
OVERRIDES = dict(d_model=64, n_heads=4, n_kv_heads=2, d_ff=128)
TOL = 1e-3


def _flat(tree):
    return {jax.tree_util.keystr(k): np.asarray(v)
            for k, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def test_elastic_restart_across_mesh_shapes(tmp_path):
    jcfg = jax_reduced("qwen3_1_7b", **OVERRIDES)
    params = jax_init(jax.random.PRNGKey(3), jcfg, jnp.float32)
    job = {"arch": "qwen3_1_7b", "overrides": OVERRIDES, "params": _flat(params),
           "dir": str(tmp_path / "ck")}
    out = run_ranks(elastic_rank, 8, job)[0]
    assert out["step"] == 4
    for key, want in out["ref"].items():
        assert float(np.abs(out["elastic"][key] - want).max()) < TOL, key
    assert abs(out["loss_ref"] - out["loss_el"]) < TOL

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


def test_cluster_without_environment_is_one_process(monkeypatch):
    for name in ("COORDINATOR_ADDRESS", "NUM_PROCESSES", "PROCESS_ID"):
        monkeypatch.delenv(name, raising=False)
    assert cluster.initialize_distributed("cpu") == (0, 1)
    with pytest.raises(NotImplementedError, match="ROADMAP.md queue 1, item 4"):
        cluster.main(["--role", "dryrun"])


class _Mesh:
    """A ("data", "model") mesh of 1 x 2 ranks, as much of one as
    ``Parallel.of`` reads before it refuses a family."""
    mesh_dim_names = ("data", "model")

    def size(self, dim):
        return (1, 2)[dim]


@pytest.mark.parametrize("arch", ["recurrentgemma_2b", "whisper_small", "internvl2_1b"])
def test_families_not_in_the_slice_raise_at_model_axis_2(arch):
    with pytest.raises(NotImplementedError, match="ROADMAP.md queue 1, item 4"):
        Parallel.of(_Mesh(), get_reduced(arch))
