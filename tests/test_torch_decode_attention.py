"""The port's decode_attention (its plain version, which CPU tensors run)
against the JAX package: the kernel's jnp oracle, the Pallas kernel in
interpret mode, and the model's decode attention over a ring cache. The CUDA
kernel itself is checked in tests/test_torch_kernels_gpu.py.

Tolerances are the reference's (tests/test_kernels.py:22-23): 2e-5 for fp32
and 2e-2 for bf16, absolute and relative.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import decode_attention as jax_decode, decode_attention_ref
from repro.models import attention as jattn
from repro_torch.kernels import decode_attention, decode_attention_plain
from repro_torch.kernels.decode_attention.ops import SPLIT_ALIGN, plan_splits
from repro_torch.models import attention as tattn
from tests._torch_parity import to_f32, to_torch

ROWS = [  # (B, H, Hkv, S, d, softcap) as tests/test_kernels.py:50-54
    (2, 4, 2, 300, 64, None),
    (1, 8, 1, 512, 128, 50.0),
    (4, 2, 2, 64, 32, None),
    (2, 10, 1, 300, 256, None),                  # recurrentgemma-2b: d=256, g=10
    (1, 20, 2, 128, 256, 50.0),
]
TOL = {"float32": 2e-5, "bfloat16": 2e-2}
JNP = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}


def _qkv(B, H, Hkv, S, d, dtype, seed=7):
    rng = np.random.default_rng(seed)
    return [jnp.asarray(rng.standard_normal(shape), jnp.float32).astype(JNP[dtype])
            for shape in ((B, H, d), (B, Hkv, S, d), (B, Hkv, S, d))]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,H,Hkv,S,d,cap", ROWS)
def test_plain_matches_jax_kernel_and_oracle(B, H, Hkv, S, d, cap, dtype):
    q, k, v = _qkv(B, H, Hkv, S, d, dtype)
    valid = np.random.default_rng(3).random(S) < 0.7
    valid[0] = True
    valid = jnp.asarray(valid)
    out = decode_attention(to_torch(q), to_torch(k), to_torch(v), to_torch(valid),
                           softcap=cap)
    assert out.dtype == to_torch(q).dtype and out.shape == (B, H, d)
    kern = jax_decode(q, k, v, valid, softcap=cap, block_k=128, interpret=True)
    ref = decode_attention_ref(q, k, v, valid, softcap=cap)
    tol = TOL[dtype]
    np.testing.assert_allclose(to_f32(out), to_f32(kern), atol=tol, rtol=tol)
    np.testing.assert_allclose(to_f32(out), to_f32(ref), atol=tol, rtol=tol)
    plain = decode_attention_plain(to_torch(q), to_torch(k), to_torch(v),
                                   to_torch(valid), softcap=cap)
    assert torch.equal(out, plain)                       # CPU tensors -> plain


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_per_row_mask_matches_the_oracle_row_by_row(dtype):
    """A (B, S) mask is the (S,) contract applied to each batch row."""
    B, H, Hkv, S, d = 3, 4, 2, 96, 32
    q, k, v = _qkv(B, H, Hkv, S, d, dtype, seed=5)
    valid = np.random.default_rng(6).random((B, S)) < 0.5
    valid[:, 0] = True
    out = to_f32(decode_attention(to_torch(q), to_torch(k), to_torch(v),
                                  torch.from_numpy(valid), softcap=30.0))
    for b in range(B):
        ref = decode_attention_ref(q[b:b + 1], k[b:b + 1], v[b:b + 1],
                                   jnp.asarray(valid[b]), softcap=30.0)
        np.testing.assert_allclose(out[b:b + 1], to_f32(ref), atol=TOL[dtype],
                                   rtol=TOL[dtype])


@pytest.mark.parametrize("window,cap", [(None, None), (24, None), (24, 50.0)])
def test_matches_model_decode_attention_over_a_ring(window, cap):
    """Per-row ring positions (rows at different depths, one wrapped) with a
    window and softcap: the port's model decode attention and the kernel
    wrapper on its mask against ``repro.models.attention.decode_attention``."""
    B, H, Hkv, C, hd = 3, 4, 2, 32, 16
    rng = np.random.default_rng(8)
    q = rng.standard_normal((B, 1, H, hd)).astype(np.float32)
    k = rng.standard_normal((B, Hkv, C, hd)).astype(np.float32)
    v = rng.standard_normal((B, Hkv, C, hd)).astype(np.float32)
    pos = np.array([5, 31, 45], np.int32)               # row 2 has wrapped the ring
    k_pos = np.full((B, C), -1, np.int32)
    for b, p in enumerate(pos):
        written = np.arange(max(0, p + 1 - C), p + 1)
        k_pos[b, written % C] = written
    ref = jattn.decode_attention(
        jnp.asarray(q), jattn.KVCache(jnp.asarray(k), jnp.asarray(v), jnp.asarray(k_pos)),
        jnp.asarray(pos), window=window, attn_softcap=cap)
    cache = tattn.KVCache(torch.from_numpy(k), torch.from_numpy(v),
                          torch.from_numpy(k_pos))
    out = tattn.decode_attention(torch.from_numpy(q), cache, torch.from_numpy(pos),
                                 window=window, attn_softcap=cap)
    np.testing.assert_allclose(to_f32(out), to_f32(ref), atol=2e-5, rtol=2e-5)
    valid = tattn.decode_valid(cache.k_pos, torch.from_numpy(pos), window)
    assert valid.shape == (B, C) and valid.dtype == torch.bool
    direct = decode_attention(torch.from_numpy(q[:, 0]), cache.k, cache.v, valid,
                              softcap=cap)
    assert torch.equal(direct, out[:, 0])


def test_all_invalid_row_averages_v_over_the_cache():
    """Masked logits are the finite NEG_INF, so a row with no valid slot is the
    mean of v over its S slots (the oracle's answer), never NaN; the other
    rows are untouched by it."""
    B, H, Hkv, S, d = 2, 4, 2, 200, 32
    q, k, v = _qkv(B, H, Hkv, S, d, "float32", seed=9)
    valid = np.ones((B, S), bool)
    valid[1] = False
    out = to_f32(decode_attention(to_torch(q), to_torch(k), to_torch(v),
                                  torch.from_numpy(valid)))
    vmean = np.repeat(np.asarray(v)[1].mean(axis=1), H // Hkv, axis=0)   # (H, d)
    np.testing.assert_allclose(out[1], vmean, atol=2e-5, rtol=2e-5)
    ref = decode_attention_ref(q[1:], k[1:], v[1:], jnp.zeros((S,), bool))
    np.testing.assert_allclose(out[1:], to_f32(ref), atol=2e-5, rtol=2e-5)
    full = decode_attention_ref(q[:1], k[:1], v[:1], jnp.ones((S,), bool))
    np.testing.assert_allclose(out[:1], to_f32(full), atol=2e-5, rtol=2e-5)


def test_reference_kernel_counts_padded_slots_in_all_invalid_rows():
    """The Pallas kernel pads S to a multiple of block_k with zero slots that
    are also invalid; a row with no valid slot then averages v over the padded
    length, sum(v) / 256 here, where its oracle (and the port) give mean(v)
    over the 200 real slots. No model path reaches it: the new token's own
    slot is always valid."""
    B, H, Hkv, S, d = 1, 2, 1, 200, 32
    q, k, v = _qkv(B, H, Hkv, S, d, "float32", seed=2)
    valid = jnp.zeros((S,), bool)
    kern = to_f32(jax_decode(q, k, v, valid, block_k=128, interpret=True))
    vsum = np.asarray(v)[0, 0].sum(axis=0)
    np.testing.assert_allclose(kern[0, 0], vsum / 256, atol=2e-5, rtol=2e-5)
    out = to_f32(decode_attention(to_torch(q), to_torch(k), to_torch(v),
                                  to_torch(valid)))
    np.testing.assert_allclose(out[0, 0], vsum / S, atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("B,Hkv,S", [(4, 8, 4096), (1, 1, 64), (1, 8, 300),
                                     (8, 16, 65), (64, 8, 4096), (2, 2, 1)])
def test_split_plan_covers_the_cache(B, Hkv, S):
    n, split_len = plan_splits(B, Hkv, S, n_sms=132)
    assert split_len % SPLIT_ALIGN == 0
    assert (n - 1) * split_len < S <= n * split_len        # every slot, no empty split
    if B * Hkv < 132 and S >= 2 * SPLIT_ALIGN:
        assert n > 1                                       # a small batch is split
    assert B * Hkv * n <= 2 * 132 + B * Hkv


def test_wrapper_rejects_what_the_kernel_does_not_take():
    q, k, v = (to_torch(a) for a in _qkv(2, 4, 2, 16, 32, "float32"))
    with pytest.raises(ValueError):
        decode_attention(q, k, v, torch.ones(15, dtype=torch.bool))
    with pytest.raises(TypeError):
        decode_attention(q.bfloat16(), k, v, torch.ones(16, dtype=torch.bool))
    with pytest.raises(ValueError):
        decode_attention(q[:, :3], k, v, torch.ones(16, dtype=torch.bool))
