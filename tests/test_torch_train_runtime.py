"""The port's training substrate against the JAX package: AdamW fed the same
gradients, the cosine schedule, int8 compression, the synthetic data
pipeline, checkpoints written by one package and restored by the other,
the supervisor's deterministic recovery, and the training launcher."""
import json
import os
import subprocess
import sys
import tempfile

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.checkpoint import CheckpointConfig as JaxCkptConfig, Checkpointer as JaxCheckpointer
from repro.configs import get_reduced as jax_reduced
from repro.data import DataConfig as JaxDataConfig, SyntheticTokenPipeline as JaxPipeline
from repro.models.transformer import init_params as jax_init
from repro.optim import (
    adamw_init as jax_adamw_init,
    adamw_update as jax_adamw_update,
    compress_gradients as jax_compress,
    cosine_schedule as jax_cosine,
)
from repro_torch.checkpoint import CheckpointConfig, Checkpointer, latest_step
from repro_torch.configs import get_reduced
from repro_torch.core.tree import TreeDef, flatten_with_keys, leaves
from repro_torch.data import DataConfig, SyntheticTokenPipeline, batch_to_torch
from repro_torch.kernels.build import KernelLaunchError
from repro_torch.models.api import make_train_step
from repro_torch.models.transformer import init_params
from repro_torch.optim import (
    adamw_init,
    adamw_update,
    compress_gradients,
    cosine_schedule,
    decompress_gradients,
    init_error_feedback,
)
from repro_torch.runtime import InjectedFailure, SupervisorConfig, TrainSupervisor
from tests._torch_parity import launcher_rank, run_ranks, to_f32, tree_to_torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _jax_params(arch="qwen3_1_7b", dtype=jnp.float32):
    return jax_init(jax.random.PRNGKey(0), jax_reduced(arch), dtype)


def _grads_like(params, seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda p: jnp.asarray(
        rng.standard_normal(p.shape).astype(np.float32) * scale), params)


def _jflat(tree):
    return {jax.tree_util.keystr(k): np.asarray(v)
            for k, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _tflat(tree):
    return {k: to_f32(v) if v.dtype.is_floating_point else v.numpy()
            for k, v in flatten_with_keys(tree)}


@pytest.mark.parametrize("grad_scale", [0.01, 10.0])   # under and over the clip norm
def test_adamw_update_matches_jax_on_the_same_gradients(grad_scale):
    """Three updates from the same gradients: parameters, moments, count and
    metrics within 1e-6 (compared apart from any gradient computation)."""
    jp = _jax_params()
    jo = jax_adamw_init(jp)
    tp = tree_to_torch(jp)
    to = adamw_init(tp)
    for step in range(3):
        jg = _grads_like(jp, seed=step, scale=grad_scale)
        lr = jax_cosine(step, peak_lr=3e-4, warmup_steps=2, total_steps=10)
        jp, jo, jm = jax_adamw_update(jg, jo, jp, lr)
        tp, to, tm = adamw_update(tree_to_torch(jg), to, tp,
                                  cosine_schedule(step, peak_lr=3e-4, warmup_steps=2,
                                                  total_steps=10))
    assert int(to["count"]) == int(jo["count"]) == 3 and to["count"].dtype == torch.int32
    for name in ("grad_norm", "clip_scale"):
        assert abs(float(tm[name]) - float(jm[name])) <= 1e-6 * max(1.0, float(jm[name]))
    for tree_t, tree_j in ((tp, jp), (to["mu"], jo["mu"]), (to["nu"], jo["nu"])):
        jf, tf = _jflat(tree_j), _tflat(tree_t)
        assert sorted(jf) == sorted(tf)
        for key in jf:
            np.testing.assert_allclose(tf[key], jf[key], atol=1e-6, rtol=0, err_msg=key)
    assert all(m.dtype == torch.float32 for m in leaves(to["mu"]))


def test_adamw_keeps_a_bf16_parameter_in_its_dtype_in_place():
    p = {"w": torch.ones((4,), dtype=torch.bfloat16)}
    ptr = p["w"].data_ptr()
    o = adamw_init(p)
    p2, o2, _ = adamw_update({"w": torch.full((4,), 0.5)}, o, p, 1e-2)
    assert p2["w"].dtype == torch.bfloat16 and p2["w"].data_ptr() == ptr
    assert o2["mu"]["w"].dtype == torch.float32 and float(p2["w"][0]) < 1.0


def test_cosine_schedule_matches_jax():
    for step in [0, 1, 5, 99, 100, 101, 2500, 9999, 10000, 12000]:
        kw = dict(peak_lr=3e-4, warmup_steps=100, total_steps=10_000)
        got = float(cosine_schedule(step, **kw))
        want = float(jax_cosine(step, **kw))
        assert abs(got - want) <= 1e-7 * max(1.0, abs(want)), step
    assert cosine_schedule(torch.tensor(3), peak_lr=1.0, warmup_steps=0,
                           total_steps=1).dtype == torch.float32


def test_compression_gives_the_reference_int8_codes():
    """Equal int8 codes, scales and residuals on a gradient tree of dicts
    (the model's leaves keyed by path: the reference's cannot take a tree
    with tuples, the next test)."""
    jp = _jflat(_jax_params())
    jg = _grads_like(jp, seed=9)
    jef = _grads_like(jp, seed=10, scale=1e-3)
    jc, jres = jax_compress(jg, jef)
    tc, tres = compress_gradients(tree_to_torch(jg), tree_to_torch(jef))
    tq, ts = dict(flatten_with_keys(tc["q"])), dict(flatten_with_keys(tc["scale"]))
    for key, q in _jflat(jc["q"]).items():
        assert tq[key].dtype == torch.int8 and np.array_equal(tq[key].numpy(), q), key
    for key, s in _jflat(jc["scale"]).items():
        assert abs(float(ts[key]) - float(s)) <= 1e-7 * float(s), key
    tr = _tflat(tres)
    for key, r in _jflat(jres).items():
        np.testing.assert_allclose(tr[key], r, atol=1e-6, rtol=0, err_msg=key)
    back = decompress_gradients(tc)
    assert all(float(z.abs().max()) == 0 for z in leaves(init_error_feedback(back)))


def test_reference_compression_fails_on_an_empty_subtree():
    """A fault of the reference, left as it is: ``compress_gradients`` picks
    its (q, scale, residual) triples with ``is_leaf=isinstance(t, tuple)``,
    which also matches the tuples of a model's tree (the pattern units
    ``unit``, the empty ``rem``), so it cannot compress the model's
    gradients. The port compresses the same tree."""
    jp = _jax_params()
    assert isinstance(jp["unit"], tuple) and jp["rem"] == ()
    jg = _grads_like(jp, seed=9)
    with pytest.raises(IndexError):
        jax_compress(jg, jax.tree.map(jnp.zeros_like, jg))
    tg = tree_to_torch(jg)
    tc, _ = compress_gradients(tg, init_error_feedback(tg))
    assert tc["q"]["rem"] == () and len(leaves(tc["q"])) == len(leaves(tg))


@pytest.mark.parametrize("arch", ["qwen3_1_7b", "whisper_small", "internvl2_1b"])
def test_batches_bitwise_equal_to_the_reference(arch):
    jdata = JaxDataConfig(global_batch=4, seq_len=32, seed=7)
    tdata = DataConfig(global_batch=4, seq_len=32, seed=7)
    cfg, jcfg = get_reduced(arch), jax_reduced(arch)
    for step, (host, hosts) in [(0, (0, 1)), (3, (1, 2)), (11, (0, 1))]:
        want = JaxPipeline.batch_at(jcfg, jdata, step, host, hosts)
        got = SyntheticTokenPipeline.batch_at(cfg, tdata, step, host, hosts)
        assert sorted(got) == sorted(want)
        for k in want:
            assert got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k]), k
    pipe = SyntheticTokenPipeline(cfg, tdata, start_step=2)
    try:
        step, batch = next(pipe)
        assert step == 2 and np.array_equal(batch["tokens"], JaxPipeline.batch_at(
            jcfg, jdata, 2)["tokens"])
    finally:
        pipe.close()
    tb = batch_to_torch(batch, "cpu")
    assert tb["tokens"].dtype == torch.int32


def _trees_for_checkpoint():
    """A parameter tree with a bf16 leaf, and an optimizer state with an
    int32 scalar count (built by JAX, carried over bit for bit)."""
    jp = _jax_params()
    jp = {**jp, "embed": {**jp["embed"], "tok": jp["embed"]["tok"].astype(jnp.bfloat16)}}
    jo = jax_adamw_init(jp)
    jo = {**jo, "count": jnp.asarray(7, jnp.int32)}
    return jp, jo


def _bits(a) -> bytes:
    if isinstance(a, torch.Tensor):
        t = a.detach()
        return (t.view(torch.int16) if t.dtype == torch.bfloat16 else t).numpy().tobytes()
    return np.asarray(a).tobytes()


def test_checkpoint_written_by_jax_restores_in_the_port_and_back():
    jp, jo = _trees_for_checkpoint()
    tp, to = tree_to_torch(jp), tree_to_torch(jo)
    with tempfile.TemporaryDirectory() as d:
        JaxCheckpointer(JaxCkptConfig(d, async_save=False)).save(
            3, {"params": jp, "opt_state": jo})
        got = Checkpointer(CheckpointConfig(d)).restore(None, {"params": tp,
                                                               "opt_state": to})
        assert got["__manifest__"]["step"] == 3
        for t, j in ((got["params"], jp), (got["opt_state"], jo)):
            for (key, leaf), jleaf in zip(flatten_with_keys(t), jax.tree.leaves(j)):
                assert leaf.device.type == "cpu" and _bits(leaf) == _bits(jleaf), key
        assert got["params"]["embed"]["tok"].dtype == torch.bfloat16
        assert got["opt_state"]["count"].dtype == torch.int32
    with tempfile.TemporaryDirectory() as d:
        ck = Checkpointer(CheckpointConfig(d, keep_last=2))
        for step in (1, 2, 5):
            ck.save(step, {"params": tp, "opt_state": to})
        ck.wait()
        assert sorted(os.listdir(d)) == ["step_2", "step_5"] and latest_step(d) == 5
        back = JaxCheckpointer(JaxCkptConfig(d)).restore(None, {"params": jp,
                                                                "opt_state": jo})
        for t, j in ((tp, back["params"]), (to, back["opt_state"])):
            for (key, leaf), jleaf in zip(flatten_with_keys(t), jax.tree.leaves(j)):
                assert _bits(leaf) == _bits(jleaf), key
        assert back["params"]["embed"]["tok"].dtype == ml_dtypes.bfloat16


def test_checkpoint_corruption_and_structure_mismatch_are_detected():
    jp, jo = _trees_for_checkpoint()
    tp = tree_to_torch(jp)
    with tempfile.TemporaryDirectory() as d:
        ck = Checkpointer(CheckpointConfig(d, async_save=False))
        ck.save(4, {"params": tp})
        with open(os.path.join(d, "step_4", "manifest.json")) as f:
            entry = json.load(f)["params"][0]
        path = os.path.join(d, "step_4", entry["file"])
        arr = np.load(path)
        arr.reshape(-1).view(np.uint8)[-1] ^= 1
        np.save(path, arr)
        with pytest.raises(IOError, match="crc"):
            ck.restore(4, {"params": tp})
        with pytest.raises(ValueError, match="structure"):
            ck.restore(4, {"params": {"other": tp["embed"]}})


def test_checkpoint_save_copies_before_returning():
    """The optimizer writes the parameters in place: what a save wrote is
    the state at the call, even if the tensor changes while the writer
    thread runs."""
    p = {"w": torch.zeros((1 << 16,))}
    with tempfile.TemporaryDirectory() as d:
        ck = Checkpointer(CheckpointConfig(d))
        ck.save(1, {"params": p})
        p["w"].add_(1.0)
        got = ck.restore(1, {"params": p})
        assert float(got["params"]["w"].abs().max()) == 0.0


def _supervised_run(fail: bool):
    cfg = get_reduced("qwen3_1_7b")
    data = DataConfig(global_batch=2, seq_len=16, seed=5)
    step_fn = make_train_step(cfg, remat="none", total_steps=20)
    with tempfile.TemporaryDirectory() as tmp:
        sup = TrainSupervisor(
            SupervisorConfig(checkpoint_every=4,
                             checkpoint=CheckpointConfig(tmp, async_save=False)),
            step_fn,
            lambda s: batch_to_torch(SyntheticTokenPipeline.batch_at(cfg, data, s), "cpu"))
        p = init_params(torch.Generator().manual_seed(9), cfg, torch.float32)
        o = adamw_init(p)
        fails = {6: InjectedFailure("node died"),
                 9: InjectedFailure("nan storm")} if fail else None
        p, o, hist = sup.run(p, o, 0, 12, fail_at=fails)
        return p, sup.restores, hist


def test_supervisor_failure_recovery_is_deterministic():
    """Port of tests/test_serving_ft.py's case: a run interrupted by failures
    ends with the same parameters as an uninterrupted one."""
    p_clean, r0, h0 = _supervised_run(False)
    p_faulty, r1, h1 = _supervised_run(True)
    assert r0 == 0 and r1 == 2
    assert [h["step"] for h in h0] == list(range(12))
    assert h1[-1]["loss"] == h0[-1]["loss"]
    for a, b in zip(leaves(p_clean), leaves(p_faulty)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-6)


def test_supervisor_reraises_kernel_launch_errors_at_once():
    calls = []

    def step(p, o, batch, s):
        calls.append(s)
        raise KernelLaunchError("flash_attention: CUDA error 1 at launch")

    with tempfile.TemporaryDirectory() as tmp:
        sup = TrainSupervisor(SupervisorConfig(checkpoint=CheckpointConfig(tmp)), step,
                              lambda s: {})
        p = {"w": torch.zeros(2)}
        with pytest.raises(KernelLaunchError):
            sup.run(p, adamw_init(p), 0, 3)
    assert calls == [0] and sup.restores == 0


def test_train_launcher_runs_on_the_cpu():
    with tempfile.TemporaryDirectory() as tmp:
        out = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.train", "--arch", "fnbench_tiny",
             "--steps", "3", "--device", "cpu", "--ckpt-dir", os.path.join(tmp, "ck"),
             "--log", os.path.join(tmp, "log.jsonl")],
            capture_output=True, text=True, timeout=300, cwd=ROOT,
            env={**os.environ, "PYTHONPATH": os.path.join(ROOT, "src")})
        assert out.returncode == 0, out.stderr
        assert "done: loss" in out.stdout
        with open(os.path.join(tmp, "log.jsonl")) as f:
            lines = [json.loads(line) for line in f]
        assert [m["step"] for m in lines] == [0, 1, 2]
        assert latest_step(os.path.join(tmp, "ck")) == 3
        # the same run on 2 gloo ranks as a 1 x 2 ("data", "model") mesh
        losses = run_ranks(launcher_rank, 2, [
            "--arch", "fnbench_tiny", "--steps", "3", "--model-axis", "2",
            "--device", "cpu", "--ckpt-dir", os.path.join(tmp, "ck2"),
            "--log", os.path.join(tmp, "log2.jsonl")])
    assert losses[0] == losses[1]
    assert np.abs(np.array(losses[0]) - [m["loss"] for m in lines]).max() <= 1e-5
