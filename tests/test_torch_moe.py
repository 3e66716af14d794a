"""The port's mixture-of-experts layer (``repro_torch.models.moe``) against the
JAX package's, on the same parameters carried across as numpy.

Tolerance: 1e-5 of the largest |output| (fp32; the two packages sum a token's
expert outputs in other orders), and the aux loss within 1e-5 relative.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced as jax_reduced
from repro.models import moe as jmoe
from repro.models.transformer import (
    decode_step as jax_decode_step,
    forward as jax_forward,
    init_params as jax_init,
)
from repro_torch.configs import get_reduced
from repro_torch.core.pages import params_from_numpy
from repro_torch.models import moe as tmoe
from repro_torch.models.transformer import decode_step, forward
from tests._torch_parity import to_f32, tree_to_torch

MOE_TOL = 1e-5
PARITY_TOL = 1e-4          # fp32 logits between the packages, as tests/test_torch_decode.py
GRANITE = "granite_moe_3b_a800m"


def _cfgs(arch, **over):
    return (dataclasses.replace(jax_reduced(arch), **over),
            dataclasses.replace(get_reduced(arch), **over))


def _drops(params, x, cfg, no_drop):
    """How many assignments of the largest expert load exceed the capacity
    (0: nothing is dropped)."""
    gates = torch.softmax(torch.from_numpy(x) @ params["router"], dim=-1)
    _, idx = tmoe.top_k(gates, cfg.top_k)
    C = tmoe.expert_capacity(cfg, x.shape[1], no_drop=no_drop)
    load = max(int(torch.bincount(row.reshape(-1), minlength=cfg.n_experts).max())
               for row in idx)
    return max(0, load - C)


@pytest.mark.parametrize("arch,over,no_drop,dropping", [
    (GRANITE, {}, False, False),                              # reduced: cf 4.0, 48 padded
    (GRANITE, {"capacity_factor": 1.25}, False, True),        # the full config's cf
    (GRANITE, {"capacity_factor": 1.25}, True, False),        # decode's no_drop
    (GRANITE, {"capacity_factor": 1.25, "expert_pad_to": 0}, False, True),   # E = 4
    ("moonshot_v1_16b_a3b", {"capacity_factor": 1.25}, False, True),
    (GRANITE, {"capacity_factor": 1.25, "mlp": "gelu"}, False, True),
    (GRANITE, {"capacity_factor": 1.25, "mlp": "geglu"}, False, True),
])
def test_moe_ffn_matches_reference(arch, over, no_drop, dropping):
    jcfg, cfg = _cfgs(arch, **over)
    assert cfg.n_experts_padded == jcfg.n_experts_padded
    params = jmoe.init_moe(jax.random.PRNGKey(0), jcfg, jnp.float32)
    tparams = tree_to_torch(params)
    assert {k: tuple(v.shape) for k, v in tparams.items()} == {
        k: tuple(v.shape) for k, v in tmoe.init_moe(torch.Generator().manual_seed(0),
                                                     cfg, torch.float32).items()}
    x = np.random.default_rng(0).standard_normal((2, 20, cfg.d_model)).astype(np.float32)
    assert (_drops(tparams, x, cfg, no_drop) > 0) == dropping
    ref, ref_aux = jmoe.moe_ffn(params, jnp.asarray(x), jcfg, no_drop=no_drop)
    out, aux = tmoe.moe_ffn(tparams, torch.from_numpy(x), cfg, no_drop=no_drop)
    ref = to_f32(ref)
    assert out.shape == ref.shape and out.dtype == torch.float32
    np.testing.assert_allclose(to_f32(out), ref, rtol=0, atol=MOE_TOL * np.abs(ref).max())
    np.testing.assert_allclose(float(aux), float(ref_aux), rtol=MOE_TOL)


@pytest.mark.parametrize("n_tokens", [1, 4, 8, 9, 20, 512, 2048])
@pytest.mark.parametrize("arch", [GRANITE, "moonshot_v1_16b_a3b"])
def test_expert_capacity_matches_reference(arch, n_tokens):
    from repro.configs import get_config as jax_config
    from repro_torch.configs import get_config
    for no_drop in (False, True):
        assert tmoe.expert_capacity(get_config(arch), n_tokens, no_drop=no_drop) == \
            jmoe.expert_capacity(jax_config(arch), n_tokens, no_drop=no_drop)


def test_top_k_breaks_ties_towards_the_lower_index():
    gates = np.array([[0.1, 0.3, 0.3, 0.2, 0.3, 0.0],
                      [0.25, 0.25, 0.25, 0.25, 0.0, 0.0],
                      [0.0, 0.0, 0.5, 0.0, 0.0, 0.5]], np.float32)
    for k in (1, 2, 3, 4):
        ref_w, ref_i = jax.lax.top_k(jnp.asarray(gates), k)
        w, i = tmoe.top_k(torch.from_numpy(gates), k)
        assert i.tolist() == np.asarray(ref_i).tolist()
        assert w.tolist() == np.asarray(ref_w).tolist()


def test_equal_gates_route_to_the_lower_expert_as_the_reference():
    """A router with a duplicated column gives every token exactly equal
    gates on experts 1 and 3: where only one of them makes the top k, both
    packages take expert 1, and where both do, 1 ranks first."""
    jcfg, cfg = _cfgs(GRANITE, capacity_factor=1.25)
    params = jmoe.init_moe(jax.random.PRNGKey(1), jcfg, jnp.float32)
    router = np.asarray(params["router"]).copy()
    router[:, 3] = router[:, 1]
    params = dict(params, router=jnp.asarray(router))
    x = np.random.default_rng(1).standard_normal((2, 20, cfg.d_model)).astype(np.float32)
    tparams = tree_to_torch(params)
    gates = torch.softmax(torch.from_numpy(x) @ tparams["router"], dim=-1)
    _, idx = tmoe.top_k(gates, cfg.top_k)
    assert torch.equal(gates[..., 1], gates[..., 3])
    picks = [row.tolist() for row in idx.reshape(-1, cfg.top_k)]
    assert any(1 in p and 3 not in p for p in picks)          # ties at the cut
    assert all(3 not in p or p.index(1) < p.index(3) for p in picks)
    ref, _ = jmoe.moe_ffn(params, jnp.asarray(x), jcfg)
    out, _ = tmoe.moe_ffn(tparams, torch.from_numpy(x), cfg)
    ref = to_f32(ref)
    np.testing.assert_allclose(to_f32(out), ref, rtol=0, atol=MOE_TOL * np.abs(ref).max())


def test_reference_moe_decode_departs_from_forward_under_capacity_drops():
    """A fault of the reference, pinned: the forward drops assignments past
    capacity, ranked by token, while decode routes with ``no_drop``, so at the
    full config's capacity factor 1.25 decode does not reproduce the forward
    (reduced granite, B=2, S=20, K=5, as tests/test_decode_consistency.py).
    The port reproduces the reference's numbers, departure included."""
    jcfg, cfg = _cfgs(GRANITE, capacity_factor=1.25)
    params = jax_init(jax.random.PRNGKey(1), jcfg, jnp.float32)
    flat = {jax.tree_util.keystr(k): np.asarray(v)
            for k, v in jax.tree_util.tree_flatten_with_path(params)[0]}
    tparams = params_from_numpy(flat)
    B, S, K = 2, 20, 5
    toks = np.random.default_rng(1).integers(0, cfg.vocab_size, (B, S + K)).astype(np.int32)
    jfull, _, _ = jax_forward(params, jnp.asarray(toks), jcfg)
    _, _, jst = jax_forward(params, jnp.asarray(toks[:, :S]), jcfg, make_state=True,
                            state_len=S + K)
    tfull = forward(tparams, torch.from_numpy(toks), cfg)
    _, tst = forward(tparams, torch.from_numpy(toks[:, :S]), cfg, make_state=True,
                     state_len=S + K)
    np.testing.assert_allclose(to_f32(tfull), to_f32(jfull), atol=PARITY_TOL,
                               rtol=PARITY_TOL)
    for i in range(K):
        tok = toks[:, S + i: S + i + 1]
        jlog, jst = jax_decode_step(params, jst, jnp.asarray(tok), jcfg)
        tlog, tst = decode_step(tparams, tst, torch.from_numpy(tok), cfg)
        np.testing.assert_allclose(to_f32(tlog), to_f32(jlog), atol=PARITY_TOL,
                                   rtol=PARITY_TOL)
    jdep = np.abs(to_f32(jlog) - to_f32(jfull)[:, -1]).max()
    tdep = np.abs(to_f32(tlog) - to_f32(tfull)[:, -1]).max()
    assert jdep > 0.1, f"the reference's decode now follows its forward ({jdep})"
    assert abs(tdep - jdep) <= PARITY_TOL * 10
