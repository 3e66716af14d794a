"""The port's recurrent families (Mamba-1 SSM, RG-LRU hybrid) against the JAX
package on the CPU, on the same weights carried across as numpy or pages.

Tolerances: 1e-4 on fp32 outputs, states and logits between the packages (the
recurrence's bar, tests/test_kernels.py:77); the reference's own 2e-3 for
incremental decode against the full forward (tests/test_decode_consistency.py:24);
BF16_BOUND for bf16 logits, stated below.
"""
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced as jax_reduced
from repro.core.pages import paginate as jax_paginate
from repro.models import rglru as jrglru
from repro.models import ssm as jssm
from repro.models.transformer import (
    decode_step as jax_decode_step,
    forward as jax_forward,
    init_decode_state as jax_init_decode_state,
    init_params as jax_init,
)
from repro.serving import ServeConfig as JaxServeConfig
from repro.serving import ServingEngine as JaxEngine
from repro.serving import state_utils as jsu
from repro_torch.configs import get_reduced
from repro_torch.core.pages import PageTable, materialize, paginate, params_from_numpy
from repro_torch.core.tree import TreeDef, flatten_with_keys
from repro_torch.kernels import diag_recurrence_plain
from repro_torch.models import rglru as trglru
from repro_torch.models import ssm as tssm
from repro_torch.models.layers import padded_vocab
from repro_torch.models.transformer import (
    decode_step,
    forward,
    init_decode_state,
    init_params,
)
from repro_torch.serving import ServeConfig, ServingEngine
from repro_torch.serving import state_utils as tsu
from tests._torch_parity import pages_to_torch, to_f32, tree_to_torch

TOL = 1e-4
DECODE_TOL = 2e-3
# bf16 logits: every layer rounds its activations to bf16 (2^-8 relative) and
# the two packages round at other points (JAX keeps bf16 elementwise chains in
# bf16, PyTorch's CPU kernels compute them in fp32 and round once), so logits
# of magnitude ~2-4 move by a few bf16 ulps (2^-7 to 2^-6 each); the bound is
# the one tests/test_torch_models.py states for the dense family.
BF16_BOUND = 0.125
ARCHS = ["falcon_mamba_7b", "recurrentgemma_2b"]
# recurrentgemma at 8 layers: 2 units of (R, R, A) and 2 remainder layers (R, R),
# the shape of the published 26 = 8 x 3 + 2
CASES = {"falcon_mamba_7b": {}, "recurrentgemma_2b": {},
         "recurrentgemma_2b-rem": {"n_layers": 8}}
KEY = jax.random.PRNGKey(1)


def _cfgs(case):
    arch = case.split("-")[0]
    return jax_reduced(arch, **CASES[case]), get_reduced(arch, **CASES[case])


def _port_params(params):
    flat = {jax.tree_util.keystr(k): np.asarray(v)
            for k, v in jax.tree_util.tree_flatten_with_path(params)[0]}
    return params_from_numpy(flat)


def _jleaves(tree):
    return [(jax.tree_util.keystr(k), v)
            for k, v in jax.tree_util.tree_flatten_with_path(tree)[0]]


def _close(out, ref, tol=TOL):
    np.testing.assert_allclose(to_f32(out), to_f32(ref), atol=tol, rtol=tol)


def _assert_states_match(tst, jst):
    """Same keystr order, shapes and dtypes; values within TOL."""
    tl, jl = flatten_with_keys(tst), _jleaves(jst)
    assert [k for k, _ in tl] == [k for k, _ in jl]
    for (key, a), (_, b) in zip(tl, jl):
        assert tuple(a.shape) == tuple(b.shape), key
        assert str(a.dtype).split(".")[1] == str(b.dtype), key
        _close(a, b)


def _layer(params, family, unit=0):
    """One layer's block params of a JAX model, unstacked."""
    return jax.tree.map(lambda a: a[unit], params["unit"][0][family])


# ---------------------------------------------------------------------------------
# blocks
# ---------------------------------------------------------------------------------

def test_ssm_prefill_and_decode_match_jax():
    jcfg, cfg = _cfgs("falcon_mamba_7b")
    p = _layer(jax_init(KEY, jcfg, jnp.float32), "ssm")
    tp = tree_to_torch(p)
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 12, cfg.d_model)).astype(np.float32)
    ref, jst = jssm.ssm_prefill(p, jnp.asarray(x), jcfg, make_state=True)
    out, tst = tssm.ssm_prefill(tp, torch.from_numpy(x), cfg, make_state=True)
    _close(out, ref)
    _assert_states_match(tst, jst)
    for _ in range(3):
        xt = rng.standard_normal((2, 1, cfg.d_model)).astype(np.float32)
        ref, jst = jssm.ssm_decode(p, jnp.asarray(xt), jst, jcfg)
        out, tst = tssm.ssm_decode(tp, torch.from_numpy(xt), tst, cfg)
        _close(out, ref)
        _assert_states_match(tst, jst)


def test_rglru_prefill_and_decode_match_jax():
    jcfg, cfg = _cfgs("recurrentgemma_2b")
    p = _layer(jax_init(KEY, jcfg, jnp.float32), "rec")
    tp = tree_to_torch(p)
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 2, cfg.d_model)).astype(np.float32)  # shorter than the conv
    ref, jst = jrglru.rglru_prefill(p, jnp.asarray(x), jcfg, make_state=True)
    out, tst = trglru.rglru_prefill(tp, torch.from_numpy(x), cfg, make_state=True)
    _close(out, ref)
    _assert_states_match(tst, jst)
    for _ in range(3):
        xt = rng.standard_normal((2, 1, cfg.d_model)).astype(np.float32)
        ref, jst = jrglru.rglru_decode(p, jnp.asarray(xt), jst, jcfg)
        out, tst = trglru.rglru_decode(tp, torch.from_numpy(xt), tst, cfg)
        _close(out, ref)
        _assert_states_match(tst, jst)


def test_ssm_chunks_carry_the_state():
    """Chunked prefill (several recurrence calls, a short last chunk) equals
    one call over the whole sequence, outputs and state."""
    _, cfg = _cfgs("falcon_mamba_7b")
    tp = _layer(_port_params(jax_init(KEY, jax_reduced("falcon_mamba_7b"), jnp.float32)),
                "ssm")
    x = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (2, 21, cfg.d_model)).astype(np.float32))
    whole, ws = tssm.ssm_prefill(tp, x, cfg, make_state=True, chunk=256)
    cut, cs = tssm.ssm_prefill(tp, x, cfg, make_state=True, chunk=8)
    _close(cut, whole, 1e-5)
    _close(cs.h, ws.h, 1e-5)
    assert torch.equal(cs.conv, ws.conv)


def test_reference_ssm_state_decays_over_its_chunk_padding():
    """A reference fault (ROADMAP.md queue 3): the reference pads the last
    chunk with zero inputs, whose decay exp(dt*A) still applies to the
    carried state, so its state after S % chunk != 0 positions is not the
    state the outputs were computed with. The port's last chunk is short."""
    jcfg, cfg = _cfgs("falcon_mamba_7b")
    p = _layer(jax_init(KEY, jcfg, jnp.float32), "ssm")
    x = np.random.default_rng(3).standard_normal((1, 40, cfg.d_model)).astype(np.float32)
    _, padded = jssm.ssm_prefill(p, jnp.asarray(x), jcfg, make_state=True, chunk=16)
    _, exact = jssm.ssm_prefill(p, jnp.asarray(x), jcfg, make_state=True, chunk=40)
    _, port = tssm.ssm_prefill(tree_to_torch(p), torch.from_numpy(x), cfg,
                               make_state=True, chunk=16)
    assert float(jnp.abs(padded.h - exact.h).max()) > 1e-2
    _close(port.h, exact.h)


# ---------------------------------------------------------------------------------
# whole models
# ---------------------------------------------------------------------------------

@pytest.mark.parametrize("case", list(CASES))
def test_forward_state_and_decode_steps_match_jax(case):
    jcfg, cfg = _cfgs(case)
    params = jax_init(KEY, jcfg, jnp.float32)
    tparams = _port_params(params)
    B, S, K = 2, 20, 5
    toks = np.random.default_rng(4).integers(0, cfg.vocab_size, (B, S + K)).astype(np.int32)
    jl, _, jst = jax_forward(params, jnp.asarray(toks[:, :S]), jcfg, make_state=True,
                             state_len=S + K)
    tl, tst = forward(tparams, torch.from_numpy(toks[:, :S]), cfg, make_state=True,
                      state_len=S + K)
    _close(tl, jl)
    _assert_states_match(tst, jst)
    for i in range(K):
        tok = toks[:, S + i: S + i + 1]
        jlog, jst = jax_decode_step(params, jst, jnp.asarray(tok), jcfg)
        tlog, tst = decode_step(tparams, tst, torch.from_numpy(tok), cfg)
        _close(tlog, jlog)
    _assert_states_match(tst, jst)


@pytest.mark.parametrize("case", list(CASES))
def test_incremental_decode_matches_own_forward(case):
    """tests/test_decode_consistency.py:24 on the port: S+K exceeds the reduced
    window (16), so recurrentgemma's local ring wraps."""
    _, cfg = _cfgs(case)
    params = init_params(torch.Generator().manual_seed(1), cfg, torch.float32)
    B, S, K = 2, 20, 5
    toks = torch.from_numpy(np.random.default_rng(1).integers(0, cfg.vocab_size,
                                                              (B, S + K)))
    full = forward(params, toks, cfg)
    _, state = forward(params, toks[:, :S], cfg, make_state=True, state_len=S + K)
    for i in range(K):
        logits, state = decode_step(params, state, toks[:, S + i: S + i + 1], cfg)
    err = float((logits - full[:, S + K - 1]).abs().max())
    assert err < DECODE_TOL, f"{case}: decode diverged from forward by {err}"


@pytest.mark.parametrize("case", list(CASES))
def test_port_init_has_the_reference_layout(case):
    """Same TreeDef, keystr order, shapes and per-leaf dtypes as JAX's bf16
    init: the recurrence's own parameters stay fp32."""
    jcfg, cfg = _cfgs(case)
    tparams = init_params(torch.Generator().manual_seed(0), cfg, torch.bfloat16)
    jparams = jax.eval_shape(lambda: jax_init(jax.random.PRNGKey(0), jcfg, jnp.bfloat16))
    assert str(TreeDef.of(tparams)) == str(jax.tree_util.tree_structure(jparams))
    tl, jl = flatten_with_keys(tparams), _jleaves(jparams)
    assert [k for k, _ in tl] == [k for k, _ in jl]
    fp32 = set()
    for (key, t), (_, j) in zip(tl, jl):
        assert tuple(t.shape) == tuple(j.shape), key
        assert str(t.dtype).split(".")[1] == str(j.dtype), key
        if t.dtype == torch.float32:
            fp32.add(key.split("[")[-1])
    want = ({"'dt_bias']", "'A_log']", "'D']"} if case.startswith("falcon")
            else {"'b_a']", "'b_x']", "'lambda']"})
    assert fp32 == want
    assert all(torch.isfinite(t.float()).all() for _, t in tl)


@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_forward_on_jax_pages(arch):
    """A mixed bf16/fp32 image built and paged by JAX restores bit for bit in
    the port, re-pages to the same bytes, and runs the forward within the bf16
    bound (tokens agree where the reference's top-2 gap is wider than it)."""
    jcfg, cfg = jax_reduced(arch), get_reduced(arch)
    params = jax_init(jax.random.PRNGKey(0), jcfg, jnp.bfloat16)
    store, table, treedef = jax_paginate(params, page_size=1 << 14)
    tparams = materialize(pages_to_torch(store), PageTable.from_json(table.to_json()),
                          TreeDef.from_repr(str(treedef)))
    dtypes = {str(leaf.dtype) for _, leaf in flatten_with_keys(tparams)}
    assert dtypes == {"torch.bfloat16", "torch.float32"}
    tstore, ttable, _ = paginate(tparams, page_size=1 << 14)
    assert ttable.to_json() == table.to_json()
    assert np.array_equal(tstore.numpy(), np.asarray(store))
    tok = np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 24)).astype(np.int32)
    ref = np.asarray(jax_forward(params, jnp.asarray(tok), jcfg)[0], np.float32)
    out = to_f32(forward(tparams, torch.from_numpy(tok), cfg))
    assert out.shape == ref.shape
    assert np.abs(out - ref).max() <= BF16_BOUND
    top2 = np.sort(ref, axis=-1)[..., -2:]
    clear = (top2[..., 1] - top2[..., 0]) > 2 * BF16_BOUND
    assert clear.any()
    assert (out.argmax(-1) == ref.argmax(-1))[clear].all()


@pytest.mark.parametrize("case", list(CASES))
def test_forward_smoke(case):
    """tests/test_configs_smoke.py::test_forward_smoke and
    ::test_decode_state_shapes on the port."""
    jcfg, cfg = _cfgs(case)
    params = init_params(torch.Generator().manual_seed(0), cfg, torch.float32)
    toks = torch.from_numpy(np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 16)))
    logits, state = forward(params, toks, cfg, make_state=True)
    assert logits.shape == (2, 16, padded_vocab(cfg))
    assert not bool(torch.isnan(logits).any())
    assert int(state["pos"][0]) == 16
    st = init_decode_state(cfg, 2, 32, torch.float32)
    assert st["pos"].shape == (2,)
    assert [k for k, _ in flatten_with_keys(st)] == [k for k, _ in flatten_with_keys(state)]
    jst = jax.eval_shape(lambda: jax_init_decode_state(jcfg, 2, 32, jnp.float32))
    assert [tuple(v.shape) for _, v in flatten_with_keys(st)] == [
        tuple(v.shape) for _, v in _jleaves(jst)]


def test_plain_recurrence_path_equals_the_default_on_the_cpu():
    """``recurrence_fn`` reaches every recurrent layer: the plain version
    passed explicitly gives the default's logits bit for bit on the CPU, and
    a stand-in that counts its calls sees one per RG-LRU layer."""
    _, cfg = _cfgs("recurrentgemma_2b-rem")
    params = init_params(torch.Generator().manual_seed(2), cfg, torch.float32)
    toks = torch.from_numpy(np.random.default_rng(2).integers(0, cfg.vocab_size, (1, 12)))
    calls = []

    def counted(a, b, h0):
        calls.append(a.shape)
        return diag_recurrence_plain(a, b, h0)

    assert torch.equal(forward(params, toks, cfg, recurrence_fn=counted),
                       forward(params, toks, cfg))
    assert calls == [(1, 12, cfg.resolved_lru_width)] * 6


def test_recurrent_state_surgery_matches_the_reference():
    """Reset zeroes a slot's h and conv; splice and extract match JAX."""
    jcfg, cfg = _cfgs("recurrentgemma_2b-rem")
    params = jax_init(KEY, jcfg, jnp.float32)
    tparams = _port_params(params)
    rng = np.random.default_rng(5)
    batch = rng.integers(0, cfg.vocab_size, (3, 18)).astype(np.int32)
    one = rng.integers(0, cfg.vocab_size, (1, 7)).astype(np.int32)
    _, _, jb = jax_forward(params, jnp.asarray(batch), jcfg, make_state=True, state_len=24)
    _, _, js = jax_forward(params, jnp.asarray(one), jcfg, make_state=True, state_len=24)
    _, tb = forward(tparams, torch.from_numpy(batch), cfg, make_state=True, state_len=24)
    _, ts = forward(tparams, torch.from_numpy(one), cfg, make_state=True, state_len=24)
    tb = tsu.state_reset_slot(tb, 0)
    jb = jsu.state_reset_slot(jb, 0)
    leaves = dict(flatten_with_keys(tb))
    for key in ("['unit'][0].h", "['unit'][0].conv", "['rem'][1].h", "['rem'][1].conv"):
        slot0 = leaves[key][:, 0] if key.startswith("['unit']") else leaves[key][0]
        assert not slot0.any(), key
        assert leaves[key].any(), key
    tb = tsu.state_splice(tb, ts, 1)
    jb = jsu.state_splice(jb, js, 1)
    _assert_states_match(tb, jb)
    for slot in range(3):
        _assert_states_match(tsu.state_extract(tb, slot), jsu.state_extract(jb, slot))


def test_continuous_batching_tokens_equal_the_jax_engine():
    """Reduced recurrentgemma (with remainder layers) through both engines:
    greedy tokens equal token for token, kept logits within TOL."""
    jcfg, cfg = _cfgs("recurrentgemma_2b-rem")
    params = jax_init(jax.random.PRNGKey(0), jcfg, jnp.float32)
    scfg = dict(max_slots=3, max_seq_len=64, max_new_tokens=5)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, n) for n in (4, 9, 2, 21, 5)]
    jeng = JaxEngine(jcfg, params, JaxServeConfig(**scfg))
    teng = ServingEngine(cfg, _port_params(params), ServeConfig(**scfg, keep_logits=True))
    jids = [jeng.submit(p) for p in prompts]
    tids = [teng.submit(p) for p in prompts]
    jeng.run_until_done()
    teng.run_until_done()
    assert len(teng.completed) == len(prompts) and teng.steps == jeng.steps
    for jid, tid in zip(jids, tids):
        assert teng.completed[tid].tokens == jeng.completed[jid].tokens


def test_serve_launcher_runs_recurrentgemma_on_the_cpu(capsys, monkeypatch):
    from repro_torch.launch import serve
    monkeypatch.setattr(sys, "argv", [
        "serve", "--arch", "recurrentgemma_2b", "--reduced", "--device", "cpu",
        "--requests", "3", "--slots", "2", "--max-new", "4", "--max-seq", "48"])
    serve.main()
    out = capsys.readouterr().out
    assert "3 requests, 12 tokens" in out


def test_port_imports_no_jax(tmp_path):
    """Every module of the port imports with JAX made unimportable, and so
    does a spawned sweep worker: ``jax`` and ``repro`` on the path are
    packages that raise when imported, which the spawned workers inherit."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    for name in ("jax", "repro"):
        (tmp_path / name).mkdir()
        (tmp_path / name / "__init__.py").write_text(
            f"raise RuntimeError('{name} imported')\n")
    code = (
        "import sys, pkgutil, importlib\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['repro'] = None\n"
        "import repro_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.')]\n"
        "for n in names:\n"
        "    importlib.import_module(n)\n"
        "assert 'jax' not in [k for k, v in sys.modules.items() if v is not None]\n"
        "from repro_torch.core.scenario import Scenario\n"
        "from repro_torch.experiments.executor import run_sweep\n"
        "base = Scenario(name='w', engine='single', methods=['warmswap'], traces={\n"
        "    'name': 'azure', 'kwargs': {'n_functions': 2, 'horizon_min': 60, 'seed': 0}})\n"
        "rep = run_sweep(base, {'traces.kwargs.seed': [0, 1]}, parallel=2)\n"
        "assert rep.n_run == 2\n"
        "print(' '.join(names))\n")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(tmp_path), os.path.join(root, "src")]))
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=env, cwd=root, timeout=300)
    assert res.returncode == 0, res.stderr
    names = set(res.stdout.split())
    assert len(names) >= 40
    assert {"repro_torch.optim.adamw", "repro_torch.optim.schedule",
            "repro_torch.optim.compression", "repro_torch.data.pipeline",
            "repro_torch.checkpoint.checkpointer", "repro_torch.launch.train",
            "repro_torch.core.aot", "repro_torch.models.sharding",
            "repro_torch.launch.mesh", "repro_torch.launch.cluster",
            "repro_torch.core.scenario", "repro_torch.core.fleet_vec",
            "repro_torch.kernels.fleet_scan.ops", "repro_torch.experiments",
            "repro_torch.experiments.executor", "repro_torch.experiments.store",
            "repro_torch.experiments.tournament",
            "repro_torch.experiments.__main__"} <= names
