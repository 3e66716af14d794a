"""The port's decode path (prefill with state, decode_step, the decode state's
surgery) against the JAX package, on the same weights carried across as numpy.

Tolerances: 1e-4 on fp32 logits between the packages (as the forward in
tests/test_torch_models.py), and the reference's own 2e-3 for incremental
decode against the full forward (tests/test_decode_consistency.py:24).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced as jax_reduced
from repro.models.transformer import (
    decode_step as jax_decode_step,
    forward as jax_forward,
    init_params as jax_init,
)
from repro.serving import state_utils as jsu
from repro_torch.configs import get_reduced
from repro_torch.core.pages import params_from_numpy
from repro_torch.core.tree import flatten_with_keys
from repro_torch.models import layers as tlayers
from repro_torch.models.api import make_prefill_step, make_serve_step
from repro_torch.models.transformer import (
    decode_step,
    forward,
    init_decode_state,
    init_params,
)
from repro_torch.serving import state_utils as tsu
from tests._torch_parity import frontend, to_f32, to_torch

PARITY_TOL = 1e-4
DECODE_TOL = 2e-3
DENSE = ["qwen3_1_7b", "gemma2_27b", "h2o_danube3_4b", "qwen1_5_0_5b", "fnbench_tiny"]
RECURRENT = ["falcon_mamba_7b", "recurrentgemma_2b"]   # tests/test_torch_recurrent.py
# MoE (reduced: capacity factor 4.0, so no assignment is dropped), the
# encoder-decoder and the VLM, fed stub frames / patches
FAMILIES = ["granite_moe_3b_a800m", "moonshot_v1_16b_a3b", "whisper_small", "internvl2_1b"]
KEY = jax.random.PRNGKey(1)


def _port_params(params):
    """JAX params -> the port's, leaf for leaf, keyed by keystr."""
    flat = {jax.tree_util.keystr(k): np.asarray(v)
            for k, v in jax.tree_util.tree_flatten_with_path(params)[0]}
    return params_from_numpy(flat)


def _leaves(state):
    return [to_f32(leaf) for leaf in jax.tree_util.tree_leaves(state)]


def _tleaves(state):
    return [to_f32(leaf) for _, leaf in flatten_with_keys(state)]


@pytest.mark.parametrize("arch", DENSE[:4])
def test_prefill_state_and_decode_steps_match_jax(arch):
    """Reduced configs: gemma2 runs local/global layers whose 16-slot local
    ring wraps at S+K = 25, with both softcaps; h2o is all-local."""
    jcfg, cfg = jax_reduced(arch), get_reduced(arch)
    params = jax_init(KEY, jcfg, jnp.float32)
    tparams = _port_params(params)
    B, S, K = 2, 20, 5
    toks = np.random.default_rng(0).integers(0, cfg.vocab_size, (B, S + K)).astype(np.int32)
    jl, _, jst = jax_forward(params, jnp.asarray(toks[:, :S]), jcfg, make_state=True,
                             state_len=S + K)
    tl, tst = forward(tparams, torch.from_numpy(toks[:, :S]), cfg, make_state=True,
                      state_len=S + K)
    np.testing.assert_allclose(to_f32(tl), to_f32(jl), atol=PARITY_TOL, rtol=PARITY_TOL)
    assert [k for k, _ in flatten_with_keys(tst)] == [
        jax.tree_util.keystr(k) for k, _ in jax.tree_util.tree_flatten_with_path(jst)[0]]
    for a, b in zip(_tleaves(tst), _leaves(jst)):
        assert a.shape == b.shape
        np.testing.assert_allclose(a, b, atol=PARITY_TOL, rtol=PARITY_TOL)
    for i in range(K):
        tok = toks[:, S + i: S + i + 1]
        jlog, jst = jax_decode_step(params, jst, jnp.asarray(tok), jcfg)
        tlog, tst = decode_step(tparams, tst, torch.from_numpy(tok), cfg)
        np.testing.assert_allclose(to_f32(tlog), to_f32(jlog), atol=PARITY_TOL,
                                   rtol=PARITY_TOL)
    for a, b in zip(_tleaves(tst), _leaves(jst)):
        np.testing.assert_allclose(a, b, atol=PARITY_TOL, rtol=PARITY_TOL)


@pytest.mark.parametrize("arch", DENSE + FAMILIES)
def test_incremental_decode_matches_own_forward(arch):
    """tests/test_decode_consistency.py:24 on the port: S+K exceeds the reduced
    window (16), so the local rings wrap; whisper's decoder attends to its
    frames, internvl2's positions continue after its patches."""
    cfg = get_reduced(arch)
    params = init_params(torch.Generator().manual_seed(1), cfg, torch.float32)
    B, S, K = 2, 20, 5
    rng = np.random.default_rng(1)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, S + K)))
    fe = {k: torch.from_numpy(v) for k, v in frontend(cfg, B, rng).items()}
    fe = next(iter(fe.values()), None)
    full = forward(params, toks, cfg, frontend_embeds=fe)
    _, state = forward(params, toks[:, :S], cfg, frontend_embeds=fe, make_state=True,
                       state_len=full.shape[1])
    for i in range(K):
        logits, state = decode_step(params, state, toks[:, S + i: S + i + 1], cfg)
    err = float((logits - full[:, -1]).abs().max())
    assert err < DECODE_TOL, f"{arch}: decode diverged from forward by {err}"


@pytest.mark.parametrize("arch", FAMILIES)
def test_new_families_prefill_state_and_decode_steps_match_jax(arch):
    """The prefill's state and K decode steps against the reference's, on
    the same weights and stub embeddings (whisper's cross keys compared in
    the reference's layout)."""
    jcfg, cfg = jax_reduced(arch), get_reduced(arch)
    params = jax_init(KEY, jcfg, jnp.float32)
    tparams = _port_params(params)
    B, S, K = 2, 14, 5
    rng = np.random.default_rng(7)
    toks = rng.integers(0, cfg.vocab_size, (B, S + K)).astype(np.int32)
    fe = next(iter(frontend(cfg, B, rng).values()), None)
    state_len = S + K + (cfg.n_frontend_tokens if fe is not None and
                         not cfg.is_encoder_decoder else 0)
    _, _, jst = jax_forward(params, jnp.asarray(toks[:, :S]), jcfg, make_state=True,
                            frontend_embeds=None if fe is None else jnp.asarray(fe),
                            state_len=state_len)
    _, tst = forward(tparams, torch.from_numpy(toks[:, :S]), cfg, make_state=True,
                     frontend_embeds=None if fe is None else torch.from_numpy(fe),
                     state_len=state_len)
    for i in range(K):
        tok = toks[:, S + i: S + i + 1]
        jlog, jst = jax_decode_step(params, jst, jnp.asarray(tok), jcfg)
        tlog, tst = decode_step(tparams, tst, torch.from_numpy(tok), cfg)
        np.testing.assert_allclose(to_f32(tlog), to_f32(jlog), atol=PARITY_TOL,
                                   rtol=PARITY_TOL)
    for (key, a), b in zip(flatten_with_keys(tst), _leaves(jst)):
        a = to_f32(a)
        if key.startswith("['cross']"):
            a = a.swapaxes(2, 3)            # the reference keeps (.., Senc, Hkv, hd)
        np.testing.assert_allclose(a, b, atol=PARITY_TOL, rtol=PARITY_TOL, err_msg=key)


def test_decode_positions_advance_per_slot():
    """tests/test_decode_consistency.py:41 on the port."""
    cfg = get_reduced("qwen3_1_7b")
    params = init_params(torch.Generator().manual_seed(1), cfg, torch.float32)
    toks = torch.from_numpy(np.random.default_rng(2).integers(0, cfg.vocab_size, (3, 8)))
    _, state = forward(params, toks, cfg, make_state=True, state_len=32)
    assert state["pos"].shape == (3,) and state["pos"].dtype == torch.int32
    _, state = decode_step(params, state, torch.zeros((3, 1), dtype=torch.int64), cfg)
    assert state["pos"].tolist() == [9, 9, 9]


def test_prefill_logits_are_unchanged_by_make_state():
    """make_state only adds the caches: the logits are bitwise the plain
    forward's."""
    cfg = get_reduced("gemma2_27b")
    params = init_params(torch.Generator().manual_seed(3), cfg, torch.bfloat16)
    toks = torch.from_numpy(np.random.default_rng(3).integers(0, cfg.vocab_size, (2, 24)))
    logits, _ = forward(params, toks, cfg, make_state=True, state_len=40)
    assert torch.equal(logits, forward(params, toks, cfg))


def test_serve_steps_match_jax_argmax():
    jcfg, cfg = jax_reduced("qwen3_1_7b"), get_reduced("qwen3_1_7b")
    params = jax_init(KEY, jcfg, jnp.float32)
    tparams = _port_params(params)
    toks = np.random.default_rng(4).integers(0, cfg.vocab_size, (2, 12)).astype(np.int32)
    from repro.models.api import make_prefill_step as jpre, make_serve_step as jserve
    jtok, jst = jpre(jcfg, state_len=32)(params, {"tokens": jnp.asarray(toks)})
    ttok, tst = make_prefill_step(cfg, state_len=32)(
        tparams, {"tokens": torch.from_numpy(toks)})
    assert ttok.dtype == torch.int32 and ttok.tolist() == np.asarray(jtok).tolist()
    for _ in range(3):
        jtok, jst = jserve(jcfg)(params, jst, jtok[:, None])
        ttok, tst = make_serve_step(cfg)(tparams, tst, ttok[:, None])
        assert ttok.tolist() == np.asarray(jtok).tolist()


def test_state_utils_match_the_reference():
    """Reset, splice and extract on the same state in both packages."""
    jcfg, cfg = jax_reduced("gemma2_27b"), get_reduced("gemma2_27b")
    params = jax_init(KEY, jcfg, jnp.float32)
    tparams = _port_params(params)
    rng = np.random.default_rng(5)
    batch = rng.integers(0, cfg.vocab_size, (3, 18)).astype(np.int32)
    one = rng.integers(0, cfg.vocab_size, (1, 7)).astype(np.int32)
    _, _, jb = jax_forward(params, jnp.asarray(batch), jcfg, make_state=True, state_len=24)
    _, _, js = jax_forward(params, jnp.asarray(one), jcfg, make_state=True, state_len=24)
    _, tb = forward(tparams, torch.from_numpy(batch), cfg, make_state=True, state_len=24)
    _, ts = forward(tparams, torch.from_numpy(one), cfg, make_state=True, state_len=24)
    jb = jsu.state_reset_slot(jb, 0)
    tb = tsu.state_reset_slot(tb, 0)
    jb = jsu.state_splice(jb, js, 1)
    tb = tsu.state_splice(tb, ts, 1)
    for a, b in zip(_tleaves(tb), _leaves(jb)):
        np.testing.assert_allclose(a, b, atol=PARITY_TOL, rtol=PARITY_TOL)
    for slot in range(3):
        ext = tsu.state_extract(tb, slot)
        for a, b in zip(_tleaves(ext), _leaves(jsu.state_extract(jb, slot))):
            assert a.shape == b.shape
            np.testing.assert_allclose(a, b, atol=PARITY_TOL, rtol=PARITY_TOL)
    k_pos = dict(flatten_with_keys(tb))["['unit'][0].k_pos"]
    assert (k_pos[:, 0] == -1).all() and k_pos.dtype == torch.int32


def test_mixed_dtype_products_promote_like_jax():
    """An fp32 activation against a bf16 weight multiplies in fp32, as JAX's
    promotion does; same-dtype products are plain ``@``."""
    rng = np.random.default_rng(6)
    x = rng.standard_normal((3, 64)).astype(np.float32)
    w = jnp.asarray(rng.standard_normal((64, 32)), jnp.bfloat16)
    ref = jnp.asarray(x) @ w
    out = tlayers.matmul(torch.from_numpy(x), to_torch(w))
    assert out.dtype == torch.float32 and ref.dtype == jnp.float32
    np.testing.assert_allclose(to_f32(out), to_f32(ref), atol=1e-5, rtol=1e-5)
    xb = to_torch(jnp.asarray(x, jnp.bfloat16))
    assert torch.equal(tlayers.matmul(xb, to_torch(w)), xb @ to_torch(w))


def test_fp32_state_over_bf16_params_runs():
    """The combination that makes the reference's scan raise (ROADMAP.md queue
    3) runs in the port: activations promote to fp32 at the first layer."""
    cfg = get_reduced("qwen3_1_7b")
    params = init_params(torch.Generator().manual_seed(4), cfg, torch.bfloat16)
    state = init_decode_state(cfg, 2, 16, torch.float32)
    logits, state = decode_step(params, state, torch.zeros((2, 1), dtype=torch.int64), cfg)
    assert logits.dtype == torch.float32 and torch.isfinite(logits).all()
    assert state["pos"].tolist() == [1, 1]
