"""The port's training loss and gradients against the JAX package's, for
every config id at its reduced size, on the same parameters (built by JAX,
carried over as numpy) and the same batch; remat variants; a bf16 train step
against the reference's; ZeRO-1 on gloo CPU ranks against the step with
whole moments; and the diagonal recurrence's reversed-time backward against
autograd."""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCH_IDS, get_reduced as jax_reduced
from repro.models import sharding as jsh
from repro.models.api import loss_fn as jax_loss_fn
from repro.models.api import make_train_step as jax_train_step
from repro.models.transformer import init_params as jax_init
from repro.optim import adamw_init as jax_adamw_init
from repro_torch.configs import get_reduced
from repro_torch.core.tree import TreeDef, flatten_with_keys, leaves
from repro_torch.kernels.diag_recurrence import diag_recurrence, diag_recurrence_plain
from repro_torch.kernels.diag_recurrence.ops import diag_recurrence_backward
from repro_torch.models.api import init_opt_state, loss_fn, make_train_step
from tests._torch_parity import frontend, run_ranks, to_f32, tree_to_torch, zero1_rank

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


@pytest.mark.parametrize("arch", ["qwen1_5_0_5b", "falcon_mamba_7b", "recurrentgemma_2b"])
def test_bf16_train_step_matches_jax(arch):
    """One train step in bf16 on the reference's bf16 parameters and the same
    batch: loss, its parts and ``grad_norm`` within the bf16 bar (2e-2,
    relative); each updated parameter within what one AdamW step in bf16
    allows: at the first step each element moves by lr * (g / (|g| + eps) +
    wd * p), so a gradient near 0 whose sign differs between the packages
    moves it up to 2 lr apart, and each package's rounding to bf16 adds at
    most one ulp (2^-7 of the magnitude)."""
    jcfg = jax_reduced(arch)
    jparams = jax_init(jax.random.PRNGKey(0), jcfg, jnp.bfloat16)
    tokens = np.random.default_rng(0).integers(0, jcfg.vocab_size, (2, 32)).astype(np.int32)
    opts = dict(remat="none", peak_lr=1e-3, warmup_steps=1, total_steps=10)
    jstep = jax.jit(jax_train_step(jcfg, **opts))
    jnew, _, jm = jstep(jparams, jax_adamw_init(jparams), {"tokens": jnp.asarray(tokens)}, 1)
    cfg = get_reduced(arch)
    params = tree_to_torch(jparams)
    old = {k: to_f32(v) for k, v in flatten_with_keys(params)}
    new, _, m = make_train_step(cfg, **opts)(params, init_opt_state(params, cfg),
                                             {"tokens": torch.from_numpy(tokens)}, 1)
    for key in ("loss", "ce", "aux", "grad_norm"):
        assert abs(float(m[key]) - float(jm[key])) <= 2e-2 * abs(float(jm[key])), key
    lr = float(m["lr"])
    jflat = {jax.tree_util.keystr(k): v for k, v in jax.tree_util.tree_flatten_with_path(jnew)[0]}
    for key, p in flatten_with_keys(new):
        assert str(p.dtype) == f"torch.{jflat[key].dtype}", key     # bf16, or fp32 leaves
        bound = 2 * lr + 2.0 ** -7 * (np.abs(old[key]) + 2 * lr)
        assert np.all(np.abs(to_f32(p) - to_f32(jflat[key])) <= bound), key
    assert any(not np.array_equal(to_f32(p), old[k]) for k, p in flatten_with_keys(new))


def _zero1_moment_bytes(arch, overrides, dtype, sizes) -> int:
    """The moments' bytes a rank holds under the reference's ZeRO-1 rule
    (``repro/launch/dryrun.py``'s ``zero1``: each leaf cut over 'data' on the
    first dim its spec leaves unsharded whose size the data axis divides),
    from the reference's parameter specs of the same config."""
    jcfg = jax_reduced(arch, **overrides)
    jp = jax.eval_shape(lambda: jax_init(jax.random.PRNGKey(0), jcfg, dtype))
    size = dict(zip(("pod", "data", "model")[-len(sizes):], sizes))
    specs = jax.tree_util.tree_leaves(jsh.param_pspecs(jcfg, jp, size["model"]),
                                      is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
    total = 0
    for leaf, spec in zip(jax.tree_util.tree_leaves(jp), specs):
        dims = list(spec) + [None] * (leaf.ndim - len(spec))
        for i, (d, sp) in enumerate(zip(leaf.shape, dims)):
            if sp is None and d % size["data"] == 0 and d >= size["data"]:
                dims[i] = "data"
                break
        cut = math.prod(size[a] for sp in dims if sp is not None
                        for a in ((sp,) if isinstance(sp, str) else sp))
        total += 2 * 4 * leaf.size // cut                # mu and nu, fp32
    return total


ZERO1_OVERRIDES = dict(d_model=64, n_heads=4, n_kv_heads=2, d_ff=128, head_dim=64,
                       n_layers=2)


@pytest.mark.parametrize("mesh", [(2, 2), (2, 2, 1)])
def test_zero1_step_is_bitwise_the_step_with_whole_moments(mesh):
    """Two train steps with ZeRO-1 moments on gloo CPU ranks (2 x 2 data x
    model; 2 x 2 x 1 pod x data x model, where the pods keep copies): the
    parameters, loss and ``grad_norm`` bitwise those of the same steps with
    whole moments, in fp32 and bf16, on every rank; each rank's moments hold
    the bytes the reference's rule gives; one more all_reduce a step."""
    job = {"arch": "qwen1_5_0_5b", "overrides": ZERO1_OVERRIDES, "mesh": mesh,
           "dtypes": ["float32", "bfloat16"], "steps": 2,
           "batch": np.random.default_rng(5).integers(0, 100, (4, 16)).astype(np.int32)}
    ranks = run_ranks(zero1_rank, math.prod(mesh), job)
    for rank in ranks:
        for name in job["dtypes"]:
            r = rank[name]
            assert r["params_equal"] and r["metrics_equal"] and r["params_moved"], name
            assert r["extra_calls"] == [1, 1]
            assert r["moment_bytes"][True] == _zero1_moment_bytes(
                "qwen1_5_0_5b", ZERO1_OVERRIDES, getattr(jnp, name), mesh)
            assert r["moment_bytes"][True] < r["moment_bytes"][False]
            assert all(math.isfinite(x) for x in r["loss"])


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
