"""The port's dense model (layers, attention_prefill, forward, prefill_logits)
against the JAX package on the same inputs and on JAX-built pages."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import workloads as jwl
from repro.core.pages import paginate as jax_paginate
from repro.models import attention as jattn
from repro.models import layers as jlayers
from repro.models.config import LOCAL_ATTN
from repro.models.transformer import forward as jax_forward, init_params as jax_init
from repro_torch.core import workloads as twl
from repro_torch.core.pages import PageTable, materialize
from repro_torch.core.tree import TreeDef, flatten_with_keys
from repro_torch.models import attention as tattn
from repro_torch.models import layers as tlayers
from repro_torch.models.config import ArchConfig as TorchArchConfig
from repro_torch.models.transformer import forward as torch_forward, init_params
from tests._torch_parity import pages_to_torch, to_f32, to_torch, tree_to_torch

FP32_LAYER_TOL = 2e-5
FP32_FORWARD_TOL = 1e-4
# bf16 logits: JAX rounds the attention probabilities to bf16 before the PV
# product (models/attention.py:107) and the port's kernel keeps them in fp32;
# every layer then rounds its activations to bf16 (2^-8 relative), so logits of
# magnitude ~5 move by a few bf16 ulps (0.03125 each at 4-8). Measured worst
# case 0.078 on model-medium; the bound is 4 ulps.
BF16_FORWARD_BOUND = 0.125

QKV_BIAS_CFG = dataclasses.replace(
    jwl.IMAGE_CONFIGS["model-tiny"], name="tiny-qkv-bias", n_layers=2, d_model=128,
    n_heads=2, n_kv_heads=2, d_ff=256, qkv_bias=True)


def _rng(seed=0):
    return np.random.default_rng(seed)


def _torch_cfg(cfg):
    return TorchArchConfig(**dataclasses.asdict(cfg))


# ---------------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------------

def test_rmsnorm_matches():
    rng = _rng()
    x = rng.standard_normal((2, 5, 48)).astype(np.float32) * 3
    scale = rng.standard_normal(48).astype(np.float32) * 0.1
    ref = jlayers.rmsnorm({"scale": jnp.asarray(scale)}, jnp.asarray(x), 1e-6)
    out = tlayers.rmsnorm({"scale": torch.from_numpy(scale)}, torch.from_numpy(x), 1e-6)
    np.testing.assert_allclose(to_f32(out), to_f32(ref), atol=FP32_LAYER_TOL,
                               rtol=FP32_LAYER_TOL)


@pytest.mark.parametrize("theta", [10_000.0, 1_000_000.0])
def test_rope_matches(theta):
    x = _rng(1).standard_normal((2, 37, 3, 64)).astype(np.float32)
    pos = np.arange(37, dtype=np.int32)
    ref = jlayers.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta)
    out = tlayers.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), theta)
    np.testing.assert_allclose(to_f32(out), to_f32(ref), atol=FP32_LAYER_TOL,
                               rtol=FP32_LAYER_TOL)


@pytest.mark.parametrize("kind", ["swiglu", "geglu", "gelu"])
def test_mlp_matches(kind):
    cfg = dataclasses.replace(jwl.IMAGE_CONFIGS["model-tiny"], mlp=kind)
    params = jlayers.init_mlp(jax.random.PRNGKey(0), cfg, jnp.float32)
    x = _rng(2).standard_normal((2, 9, cfg.d_model)).astype(np.float32)
    ref = jlayers.mlp(params, jnp.asarray(x), kind)
    out = tlayers.mlp(tree_to_torch(params), torch.from_numpy(x), kind)
    np.testing.assert_allclose(to_f32(out), to_f32(ref), atol=FP32_LAYER_TOL,
                               rtol=FP32_LAYER_TOL)


@pytest.mark.parametrize("final_cap", [None, 30.0])
def test_embed_and_tied_unembed_match(final_cap):
    cfg = dataclasses.replace(jwl.IMAGE_CONFIGS["model-tiny"],
                              final_logit_softcap=final_cap)
    params = jlayers.init_embedding(jax.random.PRNGKey(1), cfg, jnp.float32)
    tok = _rng(3).integers(0, cfg.vocab_size, (2, 11)).astype(np.int32)
    tparams, tcfg = tree_to_torch(params), _torch_cfg(cfg)
    assert tlayers.padded_vocab(tcfg) == jlayers.padded_vocab(cfg)
    jx = jlayers.embed_tokens(params, jnp.asarray(tok), cfg)
    tx = tlayers.embed_tokens(tparams, torch.from_numpy(tok), tcfg)
    assert np.array_equal(to_f32(tx), to_f32(jx))
    ref = jlayers.unembed(params, jx, cfg)
    out = tlayers.unembed(tparams, tx, tcfg)
    assert out.dtype == torch.float32
    np.testing.assert_allclose(to_f32(out), to_f32(ref), atol=FP32_LAYER_TOL,
                               rtol=FP32_LAYER_TOL)


def test_bf16_unembed_multiplies_in_bf16():
    cfg = jwl.IMAGE_CONFIGS["model-tiny"]
    params = jlayers.init_embedding(jax.random.PRNGKey(2), cfg, jnp.bfloat16)
    x = jnp.asarray(_rng(4).standard_normal((1, 3, cfg.d_model)), jnp.bfloat16)
    ref = jlayers.unembed(params, x, cfg)
    out = tlayers.unembed(tree_to_torch(params), to_torch(x), _torch_cfg(cfg))
    np.testing.assert_allclose(to_f32(out), to_f32(ref), atol=2e-2, rtol=2e-2)


# ---------------------------------------------------------------------------------
# attention_prefill
# ---------------------------------------------------------------------------------

ATTN_CASES = {
    "global": dict(),
    "local-window": dict(window=16, attn_pattern=(LOCAL_ATTN,)),
    "qkv-bias": dict(qkv_bias=True),
    "qk-norm": dict(qk_norm=True),
    "softcap": dict(attn_logit_softcap=20.0),
}


@pytest.mark.parametrize("case", list(ATTN_CASES))
def test_attention_prefill_matches(case):
    cfg = dataclasses.replace(jwl.IMAGE_CONFIGS["model-tiny"], d_model=128, n_heads=4,
                              n_kv_heads=2, **ATTN_CASES[case])
    ltype = cfg.attn_pattern[0]
    params = jattn.init_attention(jax.random.PRNGKey(3), cfg, jnp.float32)
    rng = _rng(5)
    params = {k: (v + jnp.asarray(rng.standard_normal(v.shape), jnp.float32) * 0.1
                  if k in ("bq", "bk", "bv", "q_norm", "k_norm") else v)
              for k, v in params.items()}
    S = 40
    x = rng.standard_normal((2, S, cfg.d_model)).astype(np.float32)
    pos = np.arange(S, dtype=np.int32)
    ref, _ = jattn.attention_prefill(params, jnp.asarray(x), cfg, ltype,
                                     jnp.asarray(pos), q_chunk=16)
    out = tattn.attention_prefill(tree_to_torch(params), torch.from_numpy(x),
                                  _torch_cfg(cfg), ltype, torch.from_numpy(pos))
    np.testing.assert_allclose(to_f32(out), to_f32(ref), atol=FP32_LAYER_TOL,
                               rtol=FP32_LAYER_TOL)


# ---------------------------------------------------------------------------------
# forward / prefill_logits on JAX-built pages
# ---------------------------------------------------------------------------------

def _restore(params, page_size=1 << 16):
    """JAX params -> JAX page store -> the port's params (the interchange path)."""
    store, table, treedef = jax_paginate(params, page_size=page_size)
    return materialize(pages_to_torch(store), PageTable.from_json(table.to_json()),
                       TreeDef.from_repr(str(treedef)))


def _bias_noise(params):
    rng = _rng(9)
    def f(path, leaf):
        if jax.tree_util.keystr(path).endswith(("['bq']", "['bk']", "['bv']")):
            return leaf + jnp.asarray(rng.standard_normal(leaf.shape) * 0.1, leaf.dtype)
        return leaf
    return jax.tree_util.tree_map_with_path(f, params)


FORWARD_CFGS = {"model-tiny": jwl.IMAGE_CONFIGS["model-tiny"],
                "model-small": jwl.IMAGE_CONFIGS["model-small"],
                "tiny-qkv-bias": QKV_BIAS_CFG}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", list(FORWARD_CFGS))
def test_forward_on_jax_pages(name, dtype):
    cfg = FORWARD_CFGS[name]
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    params = _bias_noise(jax_init(jax.random.PRNGKey(0), cfg, jdt))
    tok = _rng(1).integers(0, cfg.vocab_size, (2, 64)).astype(np.int32)
    ref = np.asarray(jax_forward(params, jnp.asarray(tok), cfg)[0], np.float32)
    out = to_f32(torch_forward(_restore(params), torch.from_numpy(tok),
                               _torch_cfg(cfg)))
    assert out.shape == ref.shape
    if dtype == "float32":
        np.testing.assert_allclose(out, ref, atol=FP32_FORWARD_TOL,
                                   rtol=FP32_FORWARD_TOL)
        return
    assert np.abs(out - ref).max() <= BF16_FORWARD_BOUND
    top2 = np.sort(ref, axis=-1)[..., -2:]
    clear = (top2[..., 1] - top2[..., 0]) > 2 * BF16_FORWARD_BOUND
    assert clear.any()
    assert (out.argmax(-1) == ref.argmax(-1))[clear].all()


@pytest.mark.parametrize("image_id", ["model-tiny", "model-small"])
def test_prefill_logits_and_classes_on_jax_pages(image_id):
    """The serving handler's prefill_logits and classes from the same pages."""
    params = jwl.model_params_builder(image_id)()
    jexec = jwl.make_model_executables(image_id)
    texec = twl.make_model_executables(image_id)
    tparams = _restore(params)
    req = jwl.default_request()
    assert np.array_equal(req["tokens"], twl.default_request()["tokens"])
    ref = np.asarray(jexec["prefill_logits"](params, jnp.asarray(req["tokens"])),
                     np.float32)
    out = to_f32(texec["prefill_logits"](tparams, torch.from_numpy(req["tokens"])))
    assert np.abs(out - ref).max() <= BF16_FORWARD_BOUND
    w = jwl.WORKLOADS["cnn_serving"] if image_id == "model-small" else \
        jwl.WORKLOADS["lr_serving"]
    hw = w.handler_builder()
    for k, v in twl.WORKLOADS[w.fn_id].handler_builder().items():
        assert np.array_equal(v, hw[k])
    scores = ref @ hw["w"] + hw["bias"]
    top2 = np.sort(scores, -1)[:, -2:]
    # |d score| <= |d logits| @ |w|: classes must agree where the gap is wider
    err = (np.abs(out - ref) @ np.abs(hw["w"])).max(-1)
    clear = (top2[:, 1] - top2[:, 0]) > 2 * err
    jcls = np.asarray(w.handler_fn(params, hw, req, jexec))
    tcls = twl.WORKLOADS[w.fn_id].handler_fn(tparams, hw, req, texec)
    assert np.array_equal(jcls[clear], tcls[clear])


def test_port_init_has_the_reference_layout():
    cfg = _torch_cfg(QKV_BIAS_CFG)
    gen = torch.Generator().manual_seed(0)
    tparams = init_params(gen, cfg, torch.bfloat16)
    jparams = jax.eval_shape(lambda: jax_init(jax.random.PRNGKey(0), QKV_BIAS_CFG,
                                              jnp.bfloat16))
    assert str(TreeDef.of(tparams)) == str(jax.tree_util.tree_structure(jparams))
    jl = jax.tree_util.tree_leaves(jparams)
    tl = [leaf for _, leaf in flatten_with_keys(tparams)]
    assert [tuple(a.shape) for a in jl] == [tuple(b.shape) for b in tl]
    assert all(b.dtype == torch.bfloat16 for b in tl)
    logits = torch_forward(tparams, torch.zeros((1, 8), dtype=torch.int64), cfg)
    assert logits.shape == (1, 8, 1024) and torch.isfinite(logits).all()
