"""The port's flash_attention against the JAX kernel (interpret mode), its
jnp oracle and the model's blockwise path; the CUDA kernel itself is checked
in tests/test_torch_kernels_gpu.py."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import attention_ref, flash_attention as jax_flash
from repro.models.attention import blockwise_attention
from repro_torch.kernels import flash_attention, flash_attention_plain
from tests._torch_parity import to_f32, to_torch

ROWS = [  # (B, H, Hkv, S, d, causal, window, softcap) as tests/test_kernels.py:29-35
    (2, 4, 2, 256, 64, True, None, None),
    (1, 4, 4, 128, 64, True, 64, None),
    (2, 2, 1, 200, 32, True, None, 50.0),
    (1, 2, 2, 96, 128, False, None, None),
    (1, 8, 2, 320, 64, True, 100, 30.0),
    (1, 10, 1, 192, 256, True, 128, None),       # recurrentgemma-2b: d=256, g=10
]
TOL = {"float32": 2e-5, "bfloat16": 2e-2}   # the reference's bars (test_kernels.py:22-23)
JNP = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}


def _qkv(B, H, Hkv, S, d, dtype, seed=7):
    rng = np.random.default_rng(seed)
    return [jnp.asarray(rng.standard_normal(shape), jnp.float32).astype(JNP[dtype])
            for shape in ((B, H, S, d), (B, Hkv, S, d), (B, Hkv, S, d))]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,H,Hkv,S,d,causal,window,cap", ROWS)
def test_plain_matches_jax_kernel_and_oracle(B, H, Hkv, S, d, causal, window, cap,
                                            dtype):
    q, k, v = _qkv(B, H, Hkv, S, d, dtype)
    opts = dict(causal=causal, window=window, softcap=cap)
    out = flash_attention_plain(to_torch(q), to_torch(k), to_torch(v), **opts)
    assert out.dtype == to_torch(q).dtype
    kern = jax_flash(q, k, v, block_q=64, block_k=64, interpret=True, **opts)
    ref = attention_ref(q, k, v, **opts)
    tol = TOL[dtype]
    np.testing.assert_allclose(to_f32(out), to_f32(kern), atol=tol, rtol=tol)
    np.testing.assert_allclose(to_f32(out), to_f32(ref), atol=tol, rtol=tol)
    wrapped = flash_attention(to_torch(q), to_torch(k), to_torch(v), **opts)
    assert torch.equal(wrapped, out)                     # CPU tensors -> plain


def test_plain_matches_model_blockwise():
    """As tests/test_kernels.py:105-121: kernel semantics == the model's
    blockwise path."""
    B, H, Hkv, S, d = 2, 4, 2, 160, 32
    q, k, v = _qkv(B, H, Hkv, S, d, "float32", seed=3)
    out = flash_attention_plain(to_torch(q), to_torch(k), to_torch(v),
                                causal=True, window=48)
    pos = jnp.arange(S, dtype=jnp.int32)
    model = blockwise_attention(
        q.transpose(0, 2, 1, 3), k.transpose(0, 2, 1, 3), v.transpose(0, 2, 1, 3),
        q_positions=pos, k_positions=pos, causal=True, window=48,
        attn_softcap=None, q_chunk=64).transpose(0, 2, 1, 3)
    np.testing.assert_allclose(to_f32(out), to_f32(model), atol=2e-5, rtol=2e-5)


def test_all_masked_rows_are_finite_like_the_oracle():
    q, k, v = _qkv(1, 2, 2, 40, 32, "float32", seed=5)
    out = flash_attention_plain(to_torch(q), to_torch(k), to_torch(v),
                                causal=True, window=0)
    ref = attention_ref(q, k, v, causal=True, window=0)
    assert np.isfinite(to_f32(out)).all()
    np.testing.assert_allclose(to_f32(out), to_f32(ref), atol=2e-5, rtol=2e-5)


def test_wrapper_rejects_bad_inputs():
    q = torch.zeros((1, 4, 8, 32))
    with pytest.raises(ValueError):
        flash_attention(q, torch.zeros((1, 3, 8, 32)), torch.zeros((1, 3, 8, 32)))
    with pytest.raises(TypeError):
        flash_attention(q, q.double(), q.double())
    with pytest.raises(ValueError):
        flash_attention(q, q[:, :, :0], q[:, :, :0])




def test_reference_kernel_counts_padded_keys_in_all_masked_rows():
    """A known mismatch in the reference (ROADMAP.md queue 3): when every key
    of a row is masked and Sk is not a multiple of block_k, the Pallas kernel
    averages v over the zero-padded keys too (sum(v) / Sk_padded) while its
    oracle averages over Sk. The port follows the oracle."""
    q, k, v = _qkv(1, 2, 2, 70, 32, "float32", seed=0)
    kern = np.asarray(jax_flash(q, k, v, causal=True, window=0, block_q=64,
                                block_k=64, interpret=True))
    np.testing.assert_allclose(kern, np.asarray(v).sum(2, keepdims=True) / 128
                               * np.ones_like(kern), atol=1e-5)
    out = flash_attention_plain(to_torch(q), to_torch(k), to_torch(v),
                                causal=True, window=0)
    np.testing.assert_allclose(to_f32(out), np.asarray(v).mean(2, keepdims=True)
                               * np.ones_like(kern), atol=1e-5)
