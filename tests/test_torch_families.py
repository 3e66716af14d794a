"""The MoE, encoder-decoder and VLM families of the port against the JAX
package, at reduced size on the CPU: parameter layout, the parameters carried
across as pages, the forward, the decode state, whisper's encoder and cross
attention, the VLM's prepended patches, and the serve steps.

Tolerances: 2e-5 for one layer and 1e-4 for logits (fp32; as
tests/test_torch_models.py), exact for integer outputs.
"""
import pathlib
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced as jax_reduced
from repro.core.pages import paginate as jax_paginate
from repro.models import api as japi
from repro.models import attention as jattn
from repro.models import layers as jlayers
from repro.models.transformer import (
    encode as jax_encode,
    forward as jax_forward,
    init_params as jax_init,
)
from repro_torch.configs import ARCH_IDS, get_config, get_reduced
from repro_torch.core.pages import PageTable, materialize, params_from_numpy
from repro_torch.core.tree import TreeDef, flatten_with_keys
from repro_torch.kernels.decode_attention.ops import SHAPES, check_shape
from repro_torch.kernels.flash_attention.ops import plan
from repro_torch.models import api as tapi
from repro_torch.models import attention as tattn
from repro_torch.models import layers as tlayers
from repro_torch.models.transformer import (
    encode,
    forward,
    init_decode_state,
    init_params,
)
from tests._torch_parity import frontend, pages_to_torch, to_f32, tree_to_torch

LAYER_TOL = 2e-5
PARITY_TOL = 1e-4
FAMILIES = ["granite_moe_3b_a800m", "moonshot_v1_16b_a3b", "whisper_small", "internvl2_1b"]
KEY = jax.random.PRNGKey(3)


def _rng(seed=0):
    return np.random.default_rng(seed)


def _embeds(cfg, batch):
    fe = tapi.frontend_embeds_from_batch(batch, cfg)
    return None if fe is None else torch.from_numpy(fe)


def _jembeds(cfg, batch):
    fe = japi.frontend_embeds_from_batch(batch, cfg)
    return None if fe is None else jnp.asarray(fe)


def _from_pages(params):
    store, table, treedef = jax_paginate(params, page_size=4096)
    return materialize(pages_to_torch(store), PageTable.from_json(table.to_json()),
                       TreeDef.from_repr(str(treedef)))


def _state_leaves(state):
    """A port decode state's leaves in JAX's order and layout: ``cross``
    leaves back to the reference's (n_units, B, Senc, Hkv, hd)."""
    out = []
    for key, leaf in flatten_with_keys(state):
        a = to_f32(leaf)
        out.append((key, a.swapaxes(2, 3) if key.startswith("['cross']") else a))
    return out


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_kernel_planners_take_every_config(arch):
    """Both attention kernels are compiled for every config's head dim and
    group (H/Hkv), in both dtypes: a config the CPU runs also launches on the
    card (h2o-danube3's d=120, granite's g=3, internvl2's g=7)."""
    cfg = get_config(arch)
    if cfg.is_attention_free:
        return
    d, g = cfg.resolved_head_dim, cfg.n_heads // cfg.n_kv_heads
    for dtype in (torch.float32, torch.bfloat16):
        for causal in (True, False):
            assert plan(dtype, d, 2048, causal).n_q_tiles == 32
    check_shape(d, g)


def test_decode_shapes_match_the_compiled_list():
    """``ops.SHAPES`` is the list of (head dim, group) pairs the CUDA source
    instantiates, and ``check_shape`` refuses a pair outside it."""
    src = (pathlib.Path(__file__).resolve().parents[1] / "src" / "repro_torch" / "csrc"
           / "decode_attention.cu").read_text()
    body = re.search(r"#define DECODE_SHAPES\(X\)(.*?)\n\n", src, re.S).group(1)
    compiled = tuple((int(d), int(g)) for d, g in re.findall(r"X\((\d+), (\d+)\)", body))
    assert compiled == SHAPES
    with pytest.raises(ValueError, match="H/Hkv"):
        check_shape(64, 4)


@pytest.mark.parametrize("arch", FAMILIES)
def test_init_has_the_reference_layout(arch):
    jcfg, cfg = jax_reduced(arch), get_reduced(arch)
    tparams = init_params(torch.Generator().manual_seed(0), cfg, torch.bfloat16)
    jparams = jax.eval_shape(lambda: jax_init(KEY, jcfg, jnp.bfloat16))
    assert str(TreeDef.of(tparams)) == str(jax.tree_util.tree_structure(jparams))
    jl = jax.tree_util.tree_flatten_with_path(jparams)[0]
    tl = flatten_with_keys(tparams)
    assert [jax.tree_util.keystr(k) for k, _ in jl] == [k for k, _ in tl]
    assert [(tuple(a.shape), str(a.dtype)) for _, a in jl] == [
        (tuple(b.shape), str(b.dtype).replace("torch.", "")) for _, b in tl]
    leaves = dict(tl)
    if cfg.n_experts:
        assert leaves["['unit'][0]['moe']['w_gate']"].shape[1] == cfg.n_experts_padded
        assert leaves["['unit'][0]['moe']['router']"].dtype == torch.float32
    if cfg.is_encoder_decoder:
        assert "['enc']['attn']['wq']" in leaves and "['enc_norm']['scale']" in leaves
        assert "['unit'][0]['xattn']['wq']" in leaves
        assert "['unit'][0]['lnx']['scale']" in leaves


@pytest.mark.parametrize("arch", FAMILIES)
def test_forward_and_state_on_jax_pages_match(arch):
    """Parameters built by JAX, paginated by JAX, restored by the port: the
    forward's logits and the decode state's leaves agree."""
    jcfg, cfg = jax_reduced(arch), get_reduced(arch)
    params = jax_init(KEY, jcfg, jnp.float32)
    tparams = _from_pages(params)
    rng = _rng(1)
    B, S = 2, 12
    toks = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    batch = frontend(cfg, B, rng)
    jl, _, jst = jax_forward(params, jnp.asarray(toks), jcfg,
                             frontend_embeds=_jembeds(jcfg, batch), make_state=True,
                             state_len=24)
    tl, tst = forward(tparams, torch.from_numpy(toks), cfg,
                      frontend_embeds=_embeds(cfg, batch), make_state=True, state_len=24)
    F = cfg.n_frontend_tokens if cfg.frontend == "vision_patches" else 0
    assert tl.shape == (B, F + S, jl.shape[-1]) == jl.shape
    np.testing.assert_allclose(to_f32(tl), to_f32(jl), atol=PARITY_TOL, rtol=PARITY_TOL)
    jleaves = jax.tree_util.tree_flatten_with_path(jst)[0]
    tleaves = _state_leaves(tst)
    assert [k for k, _ in tleaves] == [jax.tree_util.keystr(k) for k, _ in jleaves]
    for (key, a), (_, b) in zip(tleaves, jleaves):
        assert a.shape == b.shape, key
        np.testing.assert_allclose(a, to_f32(b), atol=PARITY_TOL, rtol=PARITY_TOL,
                                   err_msg=key)
    empty = init_decode_state(cfg, B, 24, torch.float32)
    assert [(k, a.shape) for k, a in _state_leaves(empty)] == [
        (k, a.shape) for k, a in tleaves]


@pytest.mark.parametrize("d_model", [2, 64, 768])
def test_sinusoidal_positions_match(d_model):
    ref = jlayers.sinusoidal_positions(37, d_model)
    np.testing.assert_allclose(to_f32(tlayers.sinusoidal_positions(37, d_model)),
                               to_f32(ref), atol=LAYER_TOL, rtol=LAYER_TOL)
    for pos in (np.int32(5), np.array([0, 7, 36], np.int32)):
        ref = jlayers.sinusoidal_position_at(jnp.asarray(pos), d_model)
        out = tlayers.sinusoidal_position_at(torch.from_numpy(np.asarray(pos)), d_model)
        assert out.shape == ref.shape
        np.testing.assert_allclose(to_f32(out), to_f32(ref), atol=LAYER_TOL,
                                   rtol=LAYER_TOL)


def test_encoder_matches_jax():
    jcfg, cfg = jax_reduced("whisper_small"), get_reduced("whisper_small")
    params = jax_init(KEY, jcfg, jnp.float32)
    tparams = tree_to_torch(params)
    frames = frontend(cfg, 2, _rng(2))["frames"]
    ref = jax_encode(params, jnp.asarray(frames), jcfg)
    out = encode(tparams, torch.from_numpy(frames), cfg)
    assert out.shape == (2, cfg.n_enc_positions, cfg.d_model)
    np.testing.assert_allclose(to_f32(out), to_f32(ref), atol=LAYER_TOL, rtol=LAYER_TOL)


@pytest.mark.parametrize("Sq", [1, 5, 23])
def test_cross_attention_matches_jax(Sq):
    """Queries over Senc = 40 encoder positions (Sq != Sk, non-causal); one
    query goes through the decode core, several through the prefill core."""
    jcfg, cfg = jax_reduced("whisper_small"), get_reduced("whisper_small")
    params = jax_init(KEY, jcfg, jnp.float32)["unit"][0]["xattn"]
    params = jax.tree_util.tree_map(lambda a: a[0], params)          # unit 0
    tparams = tree_to_torch(params)
    rng = _rng(3)
    enc = rng.standard_normal((2, 40, cfg.d_model)).astype(np.float32)
    x = rng.standard_normal((2, Sq, cfg.d_model)).astype(np.float32)
    jk, jv = jattn.project_cross_kv(params, jnp.asarray(enc), jcfg)
    tk, tv = tattn.project_cross_kv(tparams, torch.from_numpy(enc), cfg)
    assert tk.shape == (2, cfg.n_kv_heads, 40, cfg.resolved_head_dim) and tk.is_contiguous()
    for a, b in ((tk, jk), (tv, jv)):
        np.testing.assert_allclose(to_f32(a).swapaxes(1, 2), to_f32(b), atol=LAYER_TOL,
                                   rtol=LAYER_TOL)
    ref = jattn.cross_attention(params, jnp.asarray(x), jk, jv, jcfg)
    if Sq == 1:
        out = tattn.cross_attention_decode(tparams, torch.from_numpy(x), tk, tv,
                                           torch.ones(40, dtype=torch.bool), cfg)
    else:
        out = tattn.cross_attention(tparams, torch.from_numpy(x), tk, tv, cfg)
    np.testing.assert_allclose(to_f32(out), to_f32(ref), atol=LAYER_TOL, rtol=LAYER_TOL)


def test_vlm_prepends_patches_and_positions_cover_them():
    """F = 4 patches ahead of the tokens: the patches change every logit,
    and the logits of the token positions match JAX's."""
    jcfg, cfg = jax_reduced("internvl2_1b"), get_reduced("internvl2_1b")
    assert cfg.n_frontend_tokens == 4
    params = jax_init(KEY, jcfg, jnp.float32)
    tparams = params_from_numpy({jax.tree_util.keystr(k): np.asarray(v) for k, v in
                                 jax.tree_util.tree_flatten_with_path(params)[0]})
    rng = _rng(4)
    toks = rng.integers(0, cfg.vocab_size, (1, 9))
    patches = frontend(cfg, 1, rng)["patches"]
    out = forward(tparams, torch.from_numpy(toks), cfg,
                  frontend_embeds=torch.from_numpy(patches))
    plain = forward(tparams, torch.from_numpy(toks), cfg)
    assert out.shape == (1, 13, plain.shape[-1]) and plain.shape[1] == 9
    assert not torch.allclose(out[:, 4:], plain, atol=1e-3)
    ref = jax_forward(params, jnp.asarray(toks), jcfg, frontend_embeds=jnp.asarray(patches))[0]
    np.testing.assert_allclose(to_f32(out), to_f32(ref), atol=PARITY_TOL, rtol=PARITY_TOL)


def test_whisper_forward_needs_frames():
    cfg = get_reduced("whisper_small")
    params = init_params(torch.Generator().manual_seed(0), cfg, torch.float32)
    with pytest.raises(ValueError, match="frontend_embeds"):
        forward(params, torch.zeros((1, 4), dtype=torch.int64), cfg)


@pytest.mark.parametrize("arch", FAMILIES)
def test_prefill_and_serve_steps_match_jax(arch):
    """api.make_prefill_step on a batch with the frontend's embeddings, then
    serve steps: the same greedy tokens as the reference's."""
    jcfg, cfg = jax_reduced(arch), get_reduced(arch)
    params = jax_init(KEY, jcfg, jnp.float32)
    tparams = tree_to_torch(params)
    rng = _rng(5)
    toks = rng.integers(0, cfg.vocab_size, (2, 10)).astype(np.int32)
    batch = {"tokens": toks, **frontend(cfg, 2, rng)}
    jtok, jst = japi.make_prefill_step(jcfg, state_len=32)(
        params, {k: jnp.asarray(v) for k, v in batch.items()})
    ttok, tst = tapi.make_prefill_step(cfg, state_len=32)(
        tparams, {k: torch.from_numpy(v) for k, v in batch.items()})
    assert ttok.dtype == torch.int32 and ttok.tolist() == np.asarray(jtok).tolist()
    for _ in range(3):
        jtok, jst = japi.make_serve_step(jcfg)(params, jst, jtok[:, None])
        ttok, tst = tapi.make_serve_step(cfg)(tparams, tst, ttok[:, None])
        assert ttok.tolist() == np.asarray(jtok).tolist()


def test_state_surgery_moves_whisper_cross_keys_like_the_reference():
    """Reset, splice and extract on whisper's decode state, whose ``cross``
    leaves carry the batch at axis 1 (serving/state_utils.py)."""
    from repro.serving import state_utils as jsu
    from repro_torch.serving import state_utils as tsu
    jcfg, cfg = jax_reduced("whisper_small"), get_reduced("whisper_small")
    params = jax_init(KEY, jcfg, jnp.float32)
    tparams = tree_to_torch(params)
    rng = _rng(6)
    toks = rng.integers(0, cfg.vocab_size, (3, 9)).astype(np.int32)
    one = rng.integers(0, cfg.vocab_size, (1, 9)).astype(np.int32)
    frames, frame = frontend(cfg, 3, rng)["frames"], frontend(cfg, 1, rng)["frames"]
    states = []
    for t, f in ((toks, frames), (one, frame)):
        _, _, js = jax_forward(params, jnp.asarray(t), jcfg, frontend_embeds=jnp.asarray(f),
                               make_state=True, state_len=16)
        _, ts = forward(tparams, torch.from_numpy(t), cfg, frontend_embeds=torch.from_numpy(f),
                        make_state=True, state_len=16)
        states.append((js, ts))
    (jb, tb), (js, ts) = states
    jb = jsu.state_splice(jsu.state_reset_slot(jb, 0), js, 1)
    tb = tsu.state_splice(tsu.state_reset_slot(tb, 0), ts, 1)
    for slot in (None, 0, 1, 2):
        j = jb if slot is None else jsu.state_extract(jb, slot)
        t = tb if slot is None else tsu.state_extract(tb, slot)
        jleaves = jax.tree_util.tree_flatten_with_path(j)[0]
        for (key, a), (_, b) in zip(_state_leaves(t), jleaves):
            assert a.shape == b.shape, key
            np.testing.assert_allclose(a, to_f32(b), atol=PARITY_TOL, rtol=PARITY_TOL,
                                       err_msg=key)
    assert float(tb["cross"]["k"][:, 0].abs().max()) == 0.0
