"""The port's training loss and gradients against the JAX package's, for
every config id at its reduced size, on the same parameters (built by JAX,
carried over as numpy) and the same batch; remat variants; and the
diagonal recurrence's reversed-time backward against autograd."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCH_IDS, get_reduced as jax_reduced
from repro.models.api import loss_fn as jax_loss_fn
from repro.models.transformer import init_params as jax_init
from repro_torch.configs import get_reduced
from repro_torch.core.tree import TreeDef, flatten_with_keys, leaves
from repro_torch.kernels.diag_recurrence import diag_recurrence, diag_recurrence_plain
from repro_torch.kernels.diag_recurrence.ops import diag_recurrence_backward
from repro_torch.models.api import loss_fn
from tests._torch_parity import frontend, to_f32, tree_to_torch

LOSS_TOL = 1e-5      # absolute, on a loss of about 6
GRAD_TOL = 1e-4      # of each gradient leaf's largest |entry|


def _batch(cfg, B=2, S=16, seed=0):
    """tests/test_configs_smoke.py's batch, as numpy."""
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)}
    batch.update({k: v * np.float32(0.02) for k, v in frontend(cfg, B, rng).items()})
    return batch


def _torch_loss_and_grads(params, batch, cfg, remat):
    live = [p.detach().requires_grad_(True) for p in leaves(params)]
    loss, parts = loss_fn(TreeDef.of(params).unflatten(live), batch, cfg, remat=remat)
    grads = torch.autograd.grad(loss, live, allow_unused=True, materialize_grads=True)
    keys = [k for k, _ in flatten_with_keys(params)]
    return loss.detach(), {k: v.detach() for k, v in parts.items()}, dict(zip(keys, grads))


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_loss_and_grads_match_jax(arch):
    jcfg = jax_reduced(arch)
    jparams = jax_init(jax.random.PRNGKey(0), jcfg, jnp.float32)
    batch = _batch(jcfg)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    (jloss, jparts), jgrads = jax.value_and_grad(
        lambda p: jax_loss_fn(p, jbatch, jcfg, remat="none"), has_aux=True)(jparams)

    cfg = get_reduced(arch)
    params = tree_to_torch(jparams)
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    loss, parts, grads = _torch_loss_and_grads(params, tbatch, cfg, "none")
    assert abs(float(loss) - float(jloss)) <= LOSS_TOL
    assert abs(float(parts["aux"]) - float(jparts["aux"])) <= LOSS_TOL
    jflat = {jax.tree_util.keystr(k): np.asarray(g)
             for k, g in jax.tree_util.tree_flatten_with_path(jgrads)[0]}
    assert sorted(jflat) == sorted(grads)
    for key, jg in jflat.items():
        g = to_f32(grads[key])
        assert g.shape == jg.shape, key
        bound = GRAD_TOL * float(np.abs(jg).max())
        assert float(np.abs(g - jg).max()) <= bound, (key, float(np.abs(g - jg).max()),
                                                      bound)


@pytest.mark.parametrize("arch", ["qwen3_1_7b", "recurrentgemma_2b", "whisper_small",
                                  "granite_moe_3b_a800m"])
def test_remat_matches_no_remat(arch):
    """``unit`` and ``dots`` recompute in the backward: loss and gradients
    equal to ``none`` within 1e-5."""
    cfg = get_reduced(arch)
    params = tree_to_torch(jax_init(jax.random.PRNGKey(0), jax_reduced(arch), jnp.float32))
    batch = {k: torch.from_numpy(v) for k, v in _batch(cfg, seed=3).items()}
    l0, _, g0 = _torch_loss_and_grads(params, batch, cfg, "none")
    for remat in ("unit", "dots"):
        l1, _, g1 = _torch_loss_and_grads(params, batch, cfg, remat)
        assert abs(float(l1) - float(l0)) <= 1e-5, remat
        for key, g in g0.items():
            assert float((g1[key] - g).abs().max()) <= 1e-5, (remat, key)


def test_remat_rejects_unknown_policy():
    cfg = get_reduced("qwen3_1_7b")
    params = tree_to_torch(jax_init(jax.random.PRNGKey(0), jax_reduced("qwen3_1_7b"),
                                    jnp.float32))
    batch = {k: torch.from_numpy(v) for k, v in _batch(cfg).items()}
    with pytest.raises(ValueError, match="remat"):
        loss_fn(params, batch, cfg, remat="everything")


@pytest.mark.parametrize("B,S,C", [(2, 9, 5), (1, 1, 3), (3, 40, 16)])
def test_diag_recurrence_backward_matches_autograd(B, S, C):
    """The reversed-time adjoint, run with the plain recurrence, against
    autograd through ``diag_recurrence_plain``: both outputs' gradients, one
    of them alone, and through the op (the CPU path's autograd)."""
    rng = np.random.default_rng(B * 100 + S)
    a, b, h0 = (torch.from_numpy(x.astype(np.float32)).requires_grad_(True) for x in
                (rng.uniform(0.3, 1.0, (B, S, C)), rng.standard_normal((B, S, C)),
                 rng.standard_normal((B, C))))
    g_all = torch.from_numpy(rng.standard_normal((B, S, C)).astype(np.float32))
    g_fin = torch.from_numpy(rng.standard_normal((B, C)).astype(np.float32))
    h_all, h_fin = diag_recurrence_plain(a, b, h0)
    for grads_out in ((g_all, g_fin), (g_all, torch.zeros_like(g_fin)),
                      (torch.zeros_like(g_all), g_fin)):
        ref = torch.autograd.grad((h_all, h_fin), (a, b, h0), grads_out,
                                  retain_graph=True)
        with torch.no_grad():
            got = diag_recurrence_backward(a, h0, h_all, *grads_out,
                                           diag_recurrence_plain)
        for r, g in zip(ref, got):
            np.testing.assert_allclose(g.numpy(), r.numpy(), atol=1e-5, rtol=1e-5)
    o_all, o_fin = diag_recurrence(a, b, h0)
    via_op = torch.autograd.grad((o_all, o_fin), (a, b, h0), (g_all, g_fin))
    ref = torch.autograd.grad((h_all, h_fin), (a, b, h0), (g_all, g_fin))
    for r, g in zip(ref, via_op):
        np.testing.assert_allclose(g.numpy(), r.numpy(), atol=1e-5, rtol=1e-5)
