"""The port's sharding against the JAX package's.

Rules: ``param_pspecs``, ``opt_state_pspecs``, ``batch_pspecs`` and
``decode_state_pspecs`` equal the reference's leaf by leaf, for every config
id at full width (shapes only: ``jax.eval_shape`` on the reference's side,
meta tensors on the port's) and tp in {1, 2, 4, 8, 16}.

Execution: the four archs of tests/test_sharded_exec.py at its reduced
shapes on 8 gloo CPU ranks as a 2 x 4 ("data", "model") mesh (and moonshot
on 1 x 8, where its experts split by hidden width), recurrentgemma,
whisper and internvl2 on 2 x 4 and on 1 x 8 (where their 4 heads do not
divide the model axis), whisper on 2 x 2 (kv heads split: the cross keys
gathered for the state), and qwen3 on the 2 x 2 x 2 ("pod", "data",
"model") mesh, parameters (and stub frames or patches) from the reference's
init: one train step against the reference's single-device
step (loss within 1e-5, each gradient within 1e-4 of its tensor's largest
|entry|, the port's bars against JAX; parameters after the step within 1e-3,
the reference's sharded bar), every replicated leaf's gradient equal on all
ranks, and serve steps against the reference's (tokens equal, logits within
1e-3 of max |logit|). With 2 kv heads over 4 or 8 model ranks the decode
caches' positions are split over ``model``; qwen3 at batch 1 on a 2 x 2 mesh
splits them over ``data``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCH_IDS, get_config as jax_config, get_reduced as jax_reduced
from repro.data import DataConfig, SyntheticTokenPipeline
from repro.models import api as japi
from repro.models import sharding as jsh
from repro.models.api import loss_fn as jax_loss_fn
from repro.models.api import make_train_step as jax_train_step
from repro.models.transformer import decode_step as jax_decode_step
from repro.models.transformer import forward as jax_forward
from repro.models.transformer import init_decode_state as jax_init_state
from repro.models.transformer import init_params as jax_init
from repro.optim import adamw_init as jax_adamw_init
from repro_torch.configs import get_config
from repro_torch.core.tree import flatten_with_keys
from repro_torch.models import sharding as tsh
from tests._torch_parity import combine_rank, frontend, run_ranks, sharded_exec_rank

TPS = (1, 2, 4, 8, 16)
_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16, "int32": torch.int32}


def _norm(spec):
    """A spec as a tuple, one-name tuples as the name (JAX's normal form)."""
    return tuple(s[0] if isinstance(s, tuple) and len(s) == 1 else s for s in spec)


def _meta(tree):
    """A JAX shape tree as meta tensors, keyed by keystr."""
    return {jax.tree_util.keystr(k): torch.empty(v.shape, dtype=_DTYPES[str(v.dtype)],
                                                 device="meta")
            for k, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _jflat(specs):
    return {jax.tree_util.keystr(k): _norm(v) for k, v in
            jax.tree_util.tree_flatten_with_path(
                specs, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))[0]}


def _tflat(specs):
    return {k: _norm(v) for k, v in flatten_with_keys(specs)}


def _nest(flat):
    from repro_torch.core.tree import nest
    return nest(flat)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_rules_match_the_reference(arch, monkeypatch):
    monkeypatch.delenv("REPRO_PERF_BASELINE", raising=False)
    jcfg, cfg = jax_config(arch), get_config(arch)
    jparams = jax.eval_shape(lambda: jax_init(jax.random.PRNGKey(0), jcfg, jnp.float32))
    tparams = _nest(_meta(jparams))
    states = {B: jax.eval_shape(lambda B=B: jax_init_state(jcfg, B, 64, jnp.bfloat16))
              for B in (1, 4)}
    batch = {"tokens": torch.empty((4, 16), dtype=torch.int32, device="meta"),
             "frames": torch.empty((1, 8, 4), device="meta")}
    for tp in TPS:
        jp = jsh.param_pspecs(jcfg, jparams, tp)
        tp_specs = tsh.param_pspecs(cfg, tparams, tp)
        assert _tflat(tp_specs) == _jflat(jp), (arch, tp)
        jo = jsh.opt_state_pspecs(jcfg, None, jp)
        to = tsh.opt_state_pspecs(cfg, None, tp_specs)
        assert _tflat(to) == _jflat(jo), (arch, tp)
        for dp in (1, 2, 4):
            jb = jsh.batch_pspecs(jcfg, batch, ("data",), dp)
            tb = tsh.batch_pspecs(cfg, batch, ("data",), dp)
            assert {k: _norm(v) for k, v in tb.items()} == \
                {k: _norm(v) for k, v in jb.items()}
            for B, jstate in states.items():         # B=1 at dp>1: positions over data
                js = jsh.decode_state_pspecs(jcfg, jstate, ("data",), dp, tp, B)
                ts = tsh.decode_state_pspecs(cfg, _state_tree(jstate), ("data",), dp, tp, B)
                assert _tflat(ts) == _jflat(js), (arch, tp, dp, B)


def _state_tree(jstate):
    """The reference's decode-state shapes as meta tensors in the same
    containers (named tuples kept, so field paths spell ``.k_pos``)."""
    def conv(x):
        if isinstance(x, dict):
            return {k: conv(v) for k, v in x.items()}
        if isinstance(x, tuple) and hasattr(x, "_fields"):
            return type(x)(*(conv(v) for v in x))
        if isinstance(x, (tuple, list)):
            return type(x)(conv(v) for v in x)
        return torch.empty(x.shape, dtype=_DTYPES[str(x.dtype)], device="meta")
    return conv(jstate)


def test_partition_spec_is_one_leaf_of_a_tree():
    specs = {"a": tsh.P(None, "model"), "b": (tsh.P(), tsh.P(("data",), None))}
    assert [k for k, _ in flatten_with_keys(specs)] == ["['a']", "['b'][0]", "['b'][1]"]
    assert tsh.P("model", None) == ("model", None)
    assert tsh.sharded_mask(specs) == [True, False, False]


# ---------------------------------------------------------------------------------
# Sharded execution against the reference (tests/test_sharded_exec.py's runs)
# ---------------------------------------------------------------------------------

OVERRIDES = dict(d_model=64, n_heads=4, n_kv_heads=2, d_ff=128)
LOSS_TOL = 1e-5       # the port's bar against JAX (tests/test_torch_train.py)
GRAD_TOL = 1e-4       # of each gradient leaf's largest |entry|
PARAM_TOL = 1e-3      # after one step: tests/test_sharded_exec.py's bar
LOGIT_TOL = 1e-3      # of max |logit|
PROMPT, STEPS, STATE_LEN = 20, 4, 32   # the reduced 16-slot local rings wrap


def _flat(tree):
    return {jax.tree_util.keystr(k): np.asarray(v)
            for k, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _reference_decode(params, jcfg, prompt, steps, front=None):
    """The reference's logits: the prefill's last position (after the stub
    frontend's embeddings ``front``, if any), then each teacher-forced decode
    step's."""
    fe = japi.frontend_embeds_from_batch(front or {}, jcfg)
    logits, _, state = jax_forward(params, jnp.asarray(prompt), jcfg, make_state=True,
                                   frontend_embeds=None if fe is None else jnp.asarray(fe),
                                   state_len=STATE_LEN)
    out = [np.asarray(logits[:, -1, :jcfg.vocab_size])]
    for i in range(steps.shape[1]):
        lg, state = jax_decode_step(params, state, jnp.asarray(steps[:, i:i + 1]), jcfg)
        out.append(np.asarray(lg[:, :jcfg.vocab_size]))
    return out


def _reference_empty(params, jcfg, B):
    from repro.models.api import make_serve_step as jax_serve
    state = jax_init_state(jcfg, B, STATE_LEN, jnp.float32)
    tok, _ = jax.jit(jax_serve(jcfg))(params, state, jnp.zeros((B, 1), jnp.int32))
    return np.asarray(tok)


def _check_decode(got, want, what):
    for i, (a, b) in enumerate(zip(got, want)):
        a = a[:, :b.shape[-1]]
        err = float(np.abs(a - b).max())
        assert err <= LOGIT_TOL * float(np.abs(b).max()), (what, i, err)


@pytest.mark.parametrize("arch,mesh", [
    ("qwen3_1_7b", (2, 4)), ("gemma2_27b", (2, 4)), ("falcon_mamba_7b", (2, 4)),
    ("moonshot_v1_16b_a3b", (2, 4)),
    # 4 experts and 4 heads do not split over 8 ranks: each rank holds 1/8 of
    # every expert's hidden width, and attention is replicated
    ("moonshot_v1_16b_a3b", (1, 8)),
    # the RG-LRU's 32 channels split 8 a rank, its gates over the gathered width;
    # whisper's encoder and cross attention split their heads (the cross state
    # stays whole); internvl2's patches replicated over model
    ("recurrentgemma_2b", (2, 4)), ("whisper_small", (2, 4)), ("internvl2_1b", (2, 4)),
    # 2 kv heads split over model 2: whisper's cross keys gathered for the state
    ("whisper_small", (2, 2)),
    # 4 heads do not divide 8: attention replicated, the LRU at 4 channels a rank
    ("recurrentgemma_2b", (1, 8)), ("whisper_small", (1, 8)), ("internvl2_1b", (1, 8)),
    # the multi-pod mesh: data parallelism over pod x data
    ("qwen3_1_7b", (2, 2, 2))])
def test_sharded_train_and_serve_match_the_reference(arch, mesh):
    jcfg = jax_reduced(arch, **OVERRIDES)
    params = jax_init(jax.random.PRNGKey(0), jcfg, jnp.float32)
    data = DataConfig(global_batch=4, seq_len=16, seed=0)
    batch = SyntheticTokenPipeline.batch_at(jcfg, data, 0)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    (jloss, _), jgrads = jax.jit(jax.value_and_grad(
        lambda p: jax_loss_fn(p, jbatch, jcfg, remat="none"), has_aux=True))(params)
    p1, _, m1 = jax.jit(jax_train_step(jcfg, remat="none", total_steps=10))(
        params, jax_adamw_init(params), jbatch, jnp.int32(0))
    rng = np.random.default_rng(5)
    toks = rng.integers(0, jcfg.vocab_size, (4, PROMPT + STEPS)).astype(np.int32)
    prompt, steps = toks[:, :PROMPT], toks[:, PROMPT:]
    front = frontend(jcfg, 4, rng)
    want_decode = _reference_decode(params, jcfg, prompt, steps, front)
    want_empty = _reference_empty(params, jcfg, 4)

    job = {"arch": arch, "overrides": OVERRIDES, "mesh": mesh, "params": _flat(params),
           "train": batch,
           "decode": {"prompt": prompt, "steps": steps, "state_len": STATE_LEN,
                      "front": front},
           "empty": {"batch": 4, "state_len": STATE_LEN}}
    res = run_ranks(sharded_exec_rank, int(np.prod(mesh)), job)
    r0 = res[0]
    assert abs(r0["loss"] - float(jloss)) <= LOSS_TOL, (r0["loss"], float(jloss))
    assert abs(r0["step_loss"] - float(m1["loss"])) <= LOSS_TOL
    jg = _flat(jgrads)
    assert sorted(jg) == sorted(r0["grads"])
    for key, want in jg.items():
        err = float(np.abs(r0["grads"][key] - want).max())
        assert err <= GRAD_TOL * float(np.abs(want).max()), (key, err)
    for key, want in _flat(p1).items():
        assert float(np.abs(r0["params"][key] - want).max()) < PARAM_TOL, key
    for r in res[1:]:                      # replicated leaves: the same on every rank
        assert sorted(r["replicated_grads"]) == sorted(r0["replicated_grads"])
        for key, gr in r["replicated_grads"].items():
            np.testing.assert_array_equal(gr, r0["replicated_grads"][key], err_msg=key)
    # 2 kv heads split over model 2; over 4 or 8 ranks the cache's positions do
    assert r0["seq_axes"] == (None if jcfg.n_kv_heads % mesh[-1] == 0 else ("model",))
    _check_decode(r0["decode"], want_decode, arch)
    np.testing.assert_array_equal(r0["empty"], want_empty)


def test_batch_one_splits_cache_positions_over_data():
    """qwen3's reduced shapes at batch 1 on a 2 x 2 mesh: the batch cannot
    cover the data axis, so each data rank holds half of every cache's
    slots and the ranks' partial attention merges through the lse."""
    jcfg = jax_reduced("qwen3_1_7b", **OVERRIDES)
    params = jax_init(jax.random.PRNGKey(2), jcfg, jnp.float32)
    toks = np.random.default_rng(6).integers(0, jcfg.vocab_size,
                                            (1, PROMPT + STEPS)).astype(np.int32)
    prompt, steps = toks[:, :PROMPT], toks[:, PROMPT:]
    job = {"arch": "qwen3_1_7b", "overrides": OVERRIDES, "mesh": (2, 2),
           "params": _flat(params),
           "decode": {"prompt": prompt, "steps": steps, "state_len": STATE_LEN},
           "empty": {"batch": 1, "state_len": STATE_LEN}}
    r0 = run_ranks(sharded_exec_rank, 4, job)[0]
    assert r0["seq_axes"] == ("data",)
    _check_decode(r0["decode"], _reference_decode(params, jcfg, prompt, steps), "qwen3 B=1")
    np.testing.assert_array_equal(r0["empty"], _reference_empty(params, jcfg, 1))


def test_two_shard_combine_equals_the_unsplit_attention():
    """Two ranks each attend over half of a cache's slots and merge their
    (out, lse) with ``combine_attention``: equal to the plain attention over
    all slots within 1e-6, including a row whose live slots all lie on one
    rank (the other's all-invalid partial weighs 0) and a row with none."""
    out = run_ranks(combine_rank, 2)
    for r in out:
        assert r["err"] <= 1e-6, r
