"""The port's flash_attention against the JAX kernel (interpret mode), its
jnp oracle and the model's blockwise path; the launch planner; and an
emulation of the tensor-core route's rounding points against both. The CUDA
kernel itself is checked in tests/test_torch_kernels_gpu.py."""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import attention_ref, flash_attention as jax_flash
from repro.models.attention import blockwise_attention
from repro_torch.kernels import flash_attention, flash_attention_plain
from repro_torch.kernels.flash_attention.ops import (
    _flash_op,
    flash_attention_backward,
    flash_attention_backward_plain,
    BWD_ROUTES,
    BWD_ROWS,
    CORE_TILES,
    HEAD_DIMS,
    NEG_INF,
    ROUTES,
    TC_TILES,
    plan,
    q_tile_order,
)
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


# ---- the tensor-core route's numerics, emulated on the CPU -----------------------

def _kv_tile_range(p, q0, Sq, Sk, causal, window):
    """The kv tiles a q tile visits, with the kernel's skip rule."""
    skip = not (window is not None and (window < 1 or Sq > Sk))
    k_lo, k_hi = 0, Sk
    if skip:
        if causal:
            k_hi = min(Sk, q0 + p.block_q)
        if window is not None:
            k_lo = max(0, q0 - window + 1)
    return range((k_lo // p.block_k) * p.block_k, k_hi, p.block_k)


def tc_bf16_emulation(q, k, v, *, causal, window, softcap, scale=None):
    """The rounding points of the bf16 tensor-core kernel, in fp32 arithmetic:
    tiles of block_q x block_k from :func:`plan`, scores in fp32 from the bf16
    inputs, an online softmax (running max, fp32 denominator of the unrounded
    p), P rounded to bf16 before P.V, fp32 accumulation, the finite NEG_INF
    for masked keys, l clamped to 1e-30, one rounding of the output to bf16."""
    B, H, Sq, d = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    g = H // Hkv
    p = plan(torch.bfloat16, d, Sq, causal)
    scale = scale if scale is not None else 1.0 / np.sqrt(d)
    kf = k.float().repeat_interleave(g, dim=1)
    vf = v.float().repeat_interleave(g, dim=1)
    out = torch.empty((B, H, Sq, d))
    for qt in q_tile_order(p):
        q0 = qt * p.block_q
        qi = torch.arange(q0, min(Sq, q0 + p.block_q))[:, None]
        qf = q[:, :, q0: q0 + p.block_q].float()
        m = torch.full((B, H, qi.shape[0], 1), NEG_INF)
        l = torch.zeros_like(m)
        acc = torch.zeros((B, H, qi.shape[0], d))
        for kt in _kv_tile_range(p, q0, Sq, Sk, causal, window):
            kj = torch.arange(kt, min(Sk, kt + p.block_k))[None, :]
            s = (qf @ kf[:, :, kt: kt + p.block_k].transpose(-1, -2)) * scale
            if softcap is not None:
                s = softcap * torch.tanh(s / softcap)
            ok = torch.ones_like(kj <= qi)
            if causal:
                ok &= kj <= qi
            if window is not None:
                ok &= (qi - kj) < window
            s = torch.where(ok, s, torch.full_like(s, NEG_INF))
            m_new = torch.maximum(m, s.amax(-1, keepdim=True))
            alpha = torch.exp(m - m_new)
            pr = torch.exp(s - m_new)
            l = alpha * l + pr.sum(-1, keepdim=True)
            acc = alpha * acc + pr.bfloat16().float() @ vf[:, :, kt: kt + p.block_k]
            m = m_new
        out[:, :, q0: q0 + p.block_q] = acc / l.clamp_min(1e-30)
    return out.bfloat16()


def _bf16_case(B, H, Hkv, Sq, Sk, d, seed):
    rng = np.random.default_rng(seed)
    return [jnp.asarray(rng.standard_normal(shape), jnp.float32).astype(jnp.bfloat16)
            for shape in ((B, H, Sq, d), (B, Hkv, Sk, d), (B, Hkv, Sk, d))]


def _check_emulation(q, k, v, with_kernel=True, **opts):
    emu = tc_bf16_emulation(to_torch(q), to_torch(k), to_torch(v), **opts)
    assert torch.isfinite(emu.float()).all()
    tol = TOL["bfloat16"]
    np.testing.assert_allclose(to_f32(emu), to_f32(attention_ref(q, k, v, **opts)),
                               atol=tol, rtol=tol)
    if with_kernel:
        kern = jax_flash(q, k, v, block_q=64, block_k=64, interpret=True, **opts)
        np.testing.assert_allclose(to_f32(emu), to_f32(kern), atol=tol, rtol=tol)


@pytest.mark.parametrize("B,H,Hkv,S,d,causal,window,cap", ROWS)
def test_tc_bf16_numerics_fit_the_bf16_bar(B, H, Hkv, S, d, causal, window, cap):
    """Rounding P to bf16 before P.V keeps the route inside 2e-2 of the JAX
    kernel and of its oracle over the reference's sweep (and d=256, g=10)."""
    q, k, v = _bf16_case(B, H, Hkv, S, S, d, seed=11)
    _check_emulation(q, k, v, causal=causal, window=window, softcap=cap)


@pytest.mark.parametrize("Sq,Sk,d,causal,window", [
    (100, 150, 64, True, None),       # causal over absolute indices, Sq < Sk
    (150, 100, 64, True, None),       # Sq > Sk: the last rows see every key
    (90, 140, 256, True, 60),         # d=256 with a window and Sq != Sk
    (130, 64, 32, False, 40),         # window with Sq > Sk: no tile skipped, last
                                      # rows all masked (Sk needs no padding)
])
def test_tc_bf16_numerics_with_sq_ne_sk(Sq, Sk, d, causal, window):
    q, k, v = _bf16_case(1, 4, 2, Sq, Sk, d, seed=12)
    _check_emulation(q, k, v, causal=causal, window=window, softcap=None)


@pytest.mark.parametrize("S,d,with_kernel", [(128, 64, True), (70, 64, False),
                                             (96, 256, False)])
def test_tc_bf16_numerics_all_masked_rows(S, d, with_kernel):
    """window=0 masks every key of every row: the route averages v over the Sk
    keys as the oracle does (the JAX kernel agrees where Sk needs no padding;
    ROADMAP.md queue 3)."""
    q, k, v = _bf16_case(1, 2, 2, S, S, d, seed=13)
    _check_emulation(q, k, v, with_kernel=with_kernel, causal=True, window=0,
                     softcap=None)


# ---- the launch planner ------------------------------------------------------------

@pytest.mark.parametrize("d", HEAD_DIMS)
def test_plan_routes_by_dtype(d):
    """bf16 goes to the tensor cores at every head dim, fp32 to CUDA cores."""
    tc = plan(torch.bfloat16, d, 300, True)
    assert tc.route == "tc_bf16" and (tc.block_q, tc.block_k) == TC_TILES
    assert tc.block_q % 16 == 0 and tc.block_k % 16 == 0    # 16 rows per warp, k16 steps
    core = plan(torch.float32, d, 300, True)
    assert core.route == "cuda_core" and (core.block_q, core.block_k) == CORE_TILES
    assert set(ROUTES) == {"tc_bf16", "cuda_core"}
    with pytest.raises(TypeError):
        plan(torch.float16, d, 300, True)
    with pytest.raises(ValueError):
        plan(torch.bfloat16, d + 1, 300, True)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("Sq,causal", [(2048, True), (64, True), (1, True),
                                       (333, False), (2000, True)])
def test_q_tile_order_is_a_heavy_first_permutation(dtype, Sq, causal):
    p = plan(dtype, 64, Sq, causal)
    order = q_tile_order(p)
    assert p.n_q_tiles == -(-Sq // p.block_q)
    assert sorted(order) == list(range(p.n_q_tiles))
    work = [len(_kv_tile_range(p, t * p.block_q, Sq, Sq, causal, None)) for t in order]
    if causal:
        assert p.heavy_first and work == sorted(work, reverse=True)
    else:
        assert not p.heavy_first and order == list(range(p.n_q_tiles))


def test_cpu_calls_count_no_route():
    before = dict(flash_attention.launches_by_route)
    q = torch.zeros((1, 2, 8, 32), dtype=torch.bfloat16)
    flash_attention(q, q, q)
    assert flash_attention.launches_by_route == before



# (B, H, Hkv, Sq, Sk, d, causal, window, softcap): the backward's cases
GRAD_ROWS = [
    (2, 4, 2, 40, 40, 16, True, None, None),
    (1, 4, 1, 33, 33, 32, True, 8, 30.0),        # GQA g=4, window, softcap
    (1, 2, 2, 20, 50, 24, False, None, None),    # cross attention, Sq < Sk
    (1, 2, 1, 50, 20, 16, True, None, 5.0),      # Sq > Sk, causal
    (1, 2, 2, 18, 18, 16, True, 0, None),        # every key masked
    (1, 2, 1, 30, 12, 16, True, 4, None),        # Sq > Sk with a window: rows with no key
]


def _exact(t):
    return t


def _emulated_backward(q, k, v, dout, causal, window, softcap, fwd=None, mm=torch.matmul,
                       rnd=_exact):
    """The backward kernels' algorithm (csrc/flash_attention.cu) in fp32
    tensor ops: lse from the op's forward, D = rowsum(dO * O), P = exp(s - lse)
    (1/Sk in a row whose keys are all masked), dS = P (dP - D) (1 - tanh^2)
    where the logit was not masked, dV = P^T dO and dK = scale dS^T Q summed
    over the group's heads, dQ = scale dS K. ``fwd``: the forward's (O, lse)
    where another forward gave them; ``mm``: the matrix product the kernels'
    units compute; ``rnd``: the rounding of P and dS before their products."""
    B, H, Sq, d = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    g, scale = H // Hkv, 1.0 / math.sqrt(d)
    out, lse = fwd or _flash_op(q, k, v, causal, window, softcap, scale, True)
    assert lse.shape == (B, H, Sq) and lse.dtype == torch.float32
    qg = q.reshape(B, Hkv, g, Sq, d)
    og = dout.reshape(B, Hkv, g, Sq, d)
    kt, vt = k[:, :, None].transpose(-1, -2), v[:, :, None].transpose(-1, -2)
    x = mm(qg, kt) * scale
    t = torch.tanh(x / softcap) if softcap else None
    if softcap:
        x = softcap * t
    qi, ki = torch.arange(Sq)[:, None], torch.arange(Sk)[None, :]
    vis = torch.ones((Sq, Sk), dtype=torch.bool)
    if causal:
        vis &= ki <= qi
    if window is not None:
        vis &= (qi - ki) < window
    lse = lse.reshape(B, Hkv, g, Sq, 1)
    s = torch.where(vis, x, torch.full_like(x, NEG_INF))
    p = torch.where(lse < -1e38, torch.full_like(s, 1.0 / Sk), torch.exp(s - lse))
    delta = (dout * out).sum(-1).reshape(B, Hkv, g, Sq, 1)
    dp = mm(og, vt)
    ds = p * (dp - delta) * ((1 - t * t) if softcap else 1.0)
    ds = torch.where(vis & (lse > -1e38), ds, torch.zeros_like(ds))
    p, ds = rnd(p), rnd(ds)
    dq = scale * mm(ds, k[:, :, None]).reshape(B, H, Sq, d)
    dk = scale * mm(ds.transpose(-1, -2), qg).sum(2)
    dv = mm(p.transpose(-1, -2), og).sum(2)
    return dq, dk, dv


def _tf32(x):
    """``cvt.rna.tf32.f32``: x rounded to 10 mantissa bits, to nearest, ties
    away from zero (the low 13 bits of the fp32 pattern cleared)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _tf32x3_mm(a, b):
    """The fp32 route's products (3xTF32): each operand split into hi =
    tf32(x) and lo = tf32(x - hi); lo.hi + hi.lo, then hi.hi, summed in fp32
    (the dropped lo.lo is below 2^-22 of a product)."""
    ah, bh = _tf32(a), _tf32(b)
    al, bl = _tf32(a - ah), _tf32(b - bh)
    return (al @ bh + ah @ bl) + ah @ bh


def _emulated_tf32x3_backward(q, k, v, dout, causal, window, softcap):
    """The backward kernels on fp32 (``E`` = float): every product of
    :func:`_emulated_backward` on the tensor cores as three TF32 products."""
    return _emulated_backward(q, k, v, dout, causal, window, softcap, mm=_tf32x3_mm)


def _grad_case(B, H, Hkv, Sq, Sk, d, causal, window, cap):
    """fp32 q, k, v, dout from a seed of the shape, and JAX's gradient of its
    oracle ``attention_ref`` at them."""
    rng = np.random.default_rng(B * 1000 + Sq * 10 + Sk)
    arrays = [rng.standard_normal(s).astype(np.float32) for s in
              ((B, H, Sq, d), (B, Hkv, Sk, d), (B, Hkv, Sk, d), (B, H, Sq, d))]
    opts = dict(causal=causal, window=window, softcap=cap)
    _, vjp = jax.vjp(lambda *t: attention_ref(*t, **opts), *map(jnp.asarray, arrays[:3]))
    want = [np.asarray(g) for g in vjp(jnp.asarray(arrays[3]))]
    return [torch.from_numpy(a) for a in arrays], opts, want


@pytest.mark.parametrize("B,H,Hkv,Sq,Sk,d,causal,window,cap", GRAD_ROWS)
def test_backward_algorithm_matches_autograd_and_jax(B, H, Hkv, Sq, Sk, d, causal, window,
                                                     cap):
    """The algorithm the CUDA backward runs (emulated in exact fp32), the
    op's CPU backward (autograd through the plain version) and JAX's
    gradient of its oracle ``attention_ref`` agree: each of dq, dk, dv within
    1e-4 of its largest |entry|."""
    (q, k, v, dout), opts, want = _grad_case(B, H, Hkv, Sq, Sk, d, causal, window, cap)
    qkv = [t.clone().requires_grad_(True) for t in (q, k, v)]
    through_op = torch.autograd.grad(flash_attention(*qkv, **opts), qkv, dout)
    emulated = _emulated_backward(q, k, v, dout, causal, window, cap)
    plain = flash_attention_backward(q, k, v, None, None, dout, **opts)
    for name, w, *gots in zip("qkv", want, through_op, emulated, plain):
        bound = 1e-4 * max(float(np.abs(w).max()), 1e-30)
        for got in gots:
            assert float(np.abs(to_f32(got) - w).max()) <= bound, name


@pytest.mark.parametrize("B,H,Hkv,Sq,Sk,d,causal,window,cap", GRAD_ROWS + [
    (1, 4, 2, 256, 256, 128, True, None, 50.0),  # qwen3's d=128, g=2, a long reduction
    (1, 2, 1, 160, 160, 256, True, 64, None),    # recurrentgemma's d=256 with a window
])
def test_tf32x3_backward_matches_jax_grad(B, H, Hkv, Sq, Sk, d, causal, window, cap):
    """The fp32 route's numerics (3xTF32 products, emulated) keep the fp32
    bar: each of dq, dk, dv within 1e-4 of its largest |entry| of JAX's
    gradient of ``attention_ref``. One TF32 product alone would not (checked
    at the same bar, it must miss it somewhere in dq, dk or dv)."""
    (q, k, v, dout), opts, want = _grad_case(B, H, Hkv, Sq, Sk, d, causal, window, cap)
    got = _emulated_tf32x3_backward(q, k, v, dout, causal, window, cap)
    for name, w, g in zip("qkv", want, got):
        assert torch.isfinite(g).all(), name
        bound = 1e-4 * max(float(np.abs(w).max()), 1e-30)
        assert float(np.abs(to_f32(g) - w).max()) <= bound, name
    one = _emulated_backward(q, k, v, dout, causal, window, cap,
                             mm=lambda a, b: _tf32(a) @ _tf32(b))
    misses = [float(np.abs(to_f32(g) - w).max()) / max(float(np.abs(w).max()), 1e-30)
              for w, g in zip(want, one)]
    assert max(misses) > 1e-4, misses


def _emulated_bf16_backward(q, k, v, dout, causal, window, softcap):
    """The backward kernels on bf16 (csrc/flash_attention.cu, ``E`` =
    bf16): products of the bf16 q, k, v, O and dO on the tensor cores with
    fp32 sums (:func:`_emulated_backward` on them widened, D from the bf16
    O, lse from the bf16 forward), P and dS rounded to bf16 before their
    products, each gradient rounded to bf16 once."""
    out, lse = _flash_op(q, k, v, causal, window, softcap, 1.0 / math.sqrt(q.shape[3]), True)
    assert out.dtype == torch.bfloat16
    grads = _emulated_backward(*(t.float() for t in (q, k, v, dout)), causal, window,
                               softcap, fwd=(out.float(), lse),
                               rnd=lambda t: t.bfloat16().float())
    return [g.to(torch.bfloat16) for g in grads]


# (B, H, Hkv, S, d, causal, window, softcap): bf16 gradients against JAX's
BF16_GRAD_ROWS = [
    (2, 4, 2, 64, 64, True, None, None),         # qwen1.5's training attention, small
    (1, 4, 1, 48, 32, True, 16, 30.0),           # GQA g=4, window, softcap
    (1, 2, 2, 40, 64, False, None, None),        # non-causal
]


@pytest.mark.parametrize("B,H,Hkv,S,d,causal,window,cap", BF16_GRAD_ROWS)
def test_bf16_backward_matches_jax_grad_of_the_reference_attention(B, H, Hkv, S, d, causal,
                                                                   window, cap):
    """bf16 q, k, v and dO: the op's CPU backward (the plain version, every
    product in fp32, gradients rounded to bf16 once), the bf16 kernels'
    algorithm (emulated) and ``jax.vjp`` through the reference's bf16
    ``blockwise_attention`` (the model path XLA differentiates), each of dq,
    dk, dv within the bf16 bar 2e-2 of its largest |entry|."""
    rng = np.random.default_rng(S * 10 + d)
    arrays = [jnp.asarray(rng.standard_normal(s), jnp.float32).astype(jnp.bfloat16)
              for s in ((B, H, S, d), (B, Hkv, S, d), (B, Hkv, S, d), (B, H, S, d))]
    pos = jnp.arange(S, dtype=jnp.int32)

    def model(q, k, v):
        t = lambda x: x.transpose(0, 2, 1, 3)
        return t(blockwise_attention(t(q), t(k), t(v), q_positions=pos, k_positions=pos,
                                     causal=causal, window=window, attn_softcap=cap,
                                     q_chunk=16))

    _, vjp = jax.vjp(model, *arrays[:3])
    want = [to_f32(g) for g in vjp(arrays[3])]
    q, k, v, dout = (to_torch(a) for a in arrays)
    assert q.dtype == torch.bfloat16
    opts = dict(causal=causal, window=window, softcap=cap)
    qkv = [t.clone().requires_grad_(True) for t in (q, k, v)]
    through_op = torch.autograd.grad(flash_attention(*qkv, **opts), qkv, dout)
    plain = flash_attention_backward(q, k, v, None, None, dout, **opts)
    emulated = _emulated_bf16_backward(q, k, v, dout, causal, window, cap)
    for name, w, *gots in zip("qkv", want, through_op, plain, emulated):
        bound = TOL["bfloat16"] * float(np.abs(w).max())
        for got in gots:
            assert got.dtype == torch.bfloat16
            assert float(np.abs(to_f32(got) - w).max()) <= bound, name


def test_backward_routes_by_dtype_and_cpu_calls_count_none():
    """The backward's route is its dtype's (bf16 on mma.sync, fp32 as
    3xTF32), counted per route; a CPU call runs the plain version and counts
    no launch. Its grid check uses the kernels' resident rows (16 a warp)."""
    assert BWD_ROUTES == {torch.float32: "tc_tf32x3", torch.bfloat16: "tc_bf16"}
    assert set(flash_attention_backward.launches_by_route) == set(BWD_ROUTES.values())
    assert BWD_ROWS % 16 == 0
    before = (flash_attention_backward.launches,
              dict(flash_attention_backward.launches_by_route))
    for dtype in BWD_ROUTES:
        q = torch.randn(1, 2, 8, 32).to(dtype)
        dq, dk, dv = flash_attention_backward(q, q, q, None, None, q)
        assert dq.dtype == dtype and dk.shape == q.shape
    assert (flash_attention_backward.launches,
            flash_attention_backward.launches_by_route) == before


def test_backward_bounds_are_those_of_the_units_each_route_runs_on():
    """The bounds phase 6 states for the backward at qwen1.5-0.5b's training
    shape (B4 H16 S1024 d64, causal): five products of 2*d flops per pair;
    bf16 at 989 TFLOP/s; fp32 as three TF32 products a product at 494.7
    TFLOP/s (0.130 ms), with the CUDA cores' 67 TFLOP/s (0.321 ms) beside."""
    from repro_torch.kernels.sweep import PEAK_FLOPS, bound_ms, flash_backward_work
    with torch.device("meta"):
        q = torch.empty(4, 16, 1024, 64)
        qb = q.to(torch.bfloat16)
    moved, ops = flash_backward_work(q, q, True, None)
    assert ops == 10 * 64 * 4 * 16 * (1024 * 1025 // 2)
    assert PEAK_FLOPS["tf32"] == 494.7e12
    tf32, core = bound_ms(moved, 3 * ops, "tf32"), bound_ms(moved, ops, torch.float32)
    assert tf32[1] == core[1] == "operations"
    assert round(tf32[0], 3) == 0.130 and round(core[0], 4) == 0.3208
    moved_b, ops_b = flash_backward_work(qb, qb, True, None)
    assert ops_b == ops and 2 * moved_b == moved + 4 * 4 * 16 * 1024   # lse stays fp32
    assert round(bound_ms(moved_b, ops_b, torch.bfloat16)[0], 4) == 0.0217


def test_backward_fake_takes_bf16():
    """On meta tensors (the dry run's trace) a bf16 forward keeps its lse and
    the backward's fake gives bf16 gradients; no dtype other than fp32 and
    bf16 passes."""
    with torch.device("meta"):
        q = torch.empty(1, 4, 16, 64, dtype=torch.bfloat16, requires_grad=True)
        k = torch.empty(1, 2, 16, 64, dtype=torch.bfloat16, requires_grad=True)
        out = flash_attention(q, k, k)
        dq, dk = torch.autograd.grad(out.sum(), (q, k))
    assert dq.dtype == dk.dtype == torch.bfloat16 and dq.shape == q.shape
    with torch.device("meta"):
        h = torch.empty(1, 2, 8, 64, dtype=torch.float16)
        with pytest.raises(TypeError, match="float32 or bfloat16"):
            flash_attention_backward(h, h, h, h, torch.empty(1, 2, 8), h)


def test_forward_writes_lse_only_when_a_gradient_will_be_taken():
    """with_lse follows grad mode and requires_grad; the op's fake gives the
    same shapes without computing."""
    q, k, v = (torch.randn(s) for s in ((1, 2, 8, 16), (1, 1, 8, 16), (1, 1, 8, 16)))
    _, lse = _flash_op(q, k, v, True, None, None, 0.25, False)
    assert lse.numel() == 0
    out, lse = _flash_op(q, k, v, True, None, None, 0.25, True)
    s = torch.einsum("bhqd,bhkd->bhqk", q, k.expand(1, 2, 8, 16)) * 0.25
    s = s.masked_fill(~torch.ones(8, 8, dtype=torch.bool).tril(), NEG_INF)
    np.testing.assert_allclose(lse.numpy(), torch.logsumexp(s, -1).numpy(), rtol=1e-6)
    with torch.device("meta"):
        fq, fk = torch.empty(2, 4, 5, 32), torch.empty(2, 2, 7, 32)
        fo, fl = _flash_op(fq, fk, fk, False, None, None, 0.1, True)
    assert fo.shape == fq.shape and fl.shape == (2, 4, 5) and fl.device.type == "meta"
    qr = q.clone().requires_grad_(True)
    assert flash_attention(qr, k, v).grad_fn is not None
    with torch.no_grad():
        assert flash_attention(qr, k, v).grad_fn is None
    assert torch.equal(flash_attention_backward_plain(q, k, v, q)[0],
                       flash_attention_backward(q, k, v, None, None, q)[0])
