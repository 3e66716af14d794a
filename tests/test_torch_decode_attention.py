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
from repro_torch.kernels.decode_attention.ops import (NEG_INF, TILE, plan_splits,
                                                      split_range)
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


@pytest.fixture(autouse=True)
def _pinned_numerics():
    """Each test holds fp32 results to 2e-5, so it pins the process-wide
    precision state those depend on, which another test file sharing the
    xdist worker may have changed, and restores it after: full-precision
    fp32 products in torch and JAX, no x64 in JAX. (Reduced-precision torch
    products move these rows 50x past the bar; the plain version's result is
    bit for bit the same at any torch thread count, so threads stay as the
    worker has them.)"""
    import jax
    saved = (torch.get_float32_matmul_precision(),
             jax.config.jax_default_matmul_precision, jax.config.jax_enable_x64)
    torch.set_float32_matmul_precision("highest")
    jax.config.update("jax_default_matmul_precision", None)
    jax.config.update("jax_enable_x64", False)
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(saved[0])
        jax.config.update("jax_default_matmul_precision", saved[1])
        jax.config.update("jax_enable_x64", saved[2])


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
    """The plan fills the card in one wave (two blocks per SM here), gives no
    row more splits than tiles, splits a small batch, and its shares of a
    row's whole extent cover every slot."""
    n = plan_splits(B, Hkv, S, n_sms=132, blocks_per_sm=2)
    assert 1 <= n <= -(-S // TILE)
    assert B * Hkv * n <= max(B * Hkv, 2 * 132)
    if 2 * B * Hkv <= 2 * 132 and S >= 2 * TILE:
        assert n > 1                                       # a small batch is split
    slots = [j for sp in range(n) for j in range(*split_range(0, S - 1, sp, n))]
    assert slots == list(range(S))


@pytest.mark.parametrize("n_splits", [1, 2, 3, 7, 8, 33, 200])
def test_split_range_covers_the_extent_exactly_once(n_splits):
    """For every extent [lo, hi], the shares are whole tiles but the last, in
    order, disjoint, and cover [lo, hi] exactly once; split 0 starts at lo and
    is never empty; later splits may be empty."""
    rng = np.random.default_rng(n_splits)
    extents = [(0, 0), (5, 5), (0, 4095), (17, 2111), (3000, 4095), (0, 31), (31, 32)]
    extents += [tuple(sorted(rng.integers(0, 5000, 2))) for _ in range(20)]
    for lo, hi in extents:
        ranges = [split_range(int(lo), int(hi), sp, n_splits) for sp in range(n_splits)]
        assert ranges[0][0] == lo and ranges[0][1] > lo
        slots = [j for s0, s1 in ranges for j in range(s0, s1)]
        assert slots == list(range(lo, hi + 1))
        for s0, s1 in ranges:
            assert s0 <= s1 and (s1 == hi + 1 or (s1 - s0) % TILE == 0)


def _weight(m, mn):
    """exp(m - mn), a -inf max (an empty state) weighing exactly 0."""
    return torch.where(m == -torch.inf, torch.zeros_like(m), torch.exp(m - mn))


def _emulate_split_kernel(q, k, v, valid, n_splits, softcap=None):
    """The CUDA kernel's algorithm in fp32 PyTorch: each (b, kv head) row's
    live extent from its mask, split_range shares of it, tiles of TILE slots
    (all-invalid tiles skipped unless the extent is dense or the row has no
    valid slot), the online softmax per tile, one partial state per split
    (m = -inf, l = 0, acc = 0 when empty), and the combine."""
    B, H, d = q.shape
    Hkv, S = k.shape[1], k.shape[2]
    g = H // Hkv
    scale = 1.0 / np.sqrt(d)
    mask = valid.bool().expand(B, S) if valid.dim() == 1 else valid.bool()
    qf = q.float().reshape(B, Hkv, g, d)
    kf, vf = k.float(), v.float()
    out = torch.empty((B, Hkv, g, d))
    for b in range(B):
        row = mask[b]
        idx = torch.nonzero(row).flatten()
        row_any = len(idx) > 0
        lo, hi = (int(idx[0]), int(idx[-1])) if row_any else (0, S - 1)
        dense = not row_any or len(idx) == hi - lo + 1
        for h in range(Hkv):
            states = []
            for sp in range(n_splits):
                s0, s1 = split_range(lo, hi, sp, n_splits)
                m = torch.full((g,), -torch.inf)
                l, acc = torch.zeros(g), torch.zeros((g, d))
                for ts in range(s0, s1, TILE):
                    te = min(ts + TILE, s1)
                    if not dense and not bool(row[ts:te].any()):
                        continue
                    s = qf[b, h] @ kf[b, h, ts:te].T * scale
                    if softcap is not None:
                        s = softcap * torch.tanh(s / softcap)
                    ok = row[ts:te] if row_any else torch.zeros(te - ts, dtype=torch.bool)
                    s = torch.where(ok, s, torch.full_like(s, NEG_INF))
                    m_new = torch.maximum(m, s.max(-1).values)
                    alpha = _weight(m, m_new)
                    p = torch.exp(s - m_new[:, None])
                    l = l * alpha + p.sum(-1)
                    acc = acc * alpha[:, None] + p @ vf[b, h, ts:te]
                    m = m_new
                states.append((m, l, acc))
            m, l, acc = states[0]
            assert bool(torch.isfinite(m).all())                 # split 0 is never empty
            for mo, lo_, ao in states[1:]:
                mn = torch.maximum(m, mo)
                wa, wb = _weight(m, mn), _weight(mo, mn)
                l, acc, m = l * wa + lo_ * wb, acc * wa[:, None] + ao * wb[:, None], mn
            out[b, h] = acc / torch.clamp(l, min=1e-30)[:, None]
    return out.reshape(B, H, d).to(q.dtype)


def _extent_masks(B, S, rng):
    """(name, (B, S) bool mask) for the masks the device-side extent meets."""
    ring = np.zeros((B, S), bool)
    for b in range(B):                                    # rows at other depths
        ring[b, :int(rng.integers(1, S))] = True
    wrapped = np.zeros((B, S), bool)
    wrapped[:, :40] = True                                # the ring's head...
    wrapped[:, S - 70:] = True                            # ...and its tail
    short = np.zeros((B, S), bool)
    short[:, 3:9] = True                                  # extent << S
    holes = rng.random((B, S)) < 0.3                      # invalid slots inside
    holes[:, 100:180] = False                             # whole tiles of them
    holes[:, 0] = True
    empty = ring.copy()
    empty[-1] = False                                     # a row with no valid slot
    return [("ring", ring), ("wrapped", wrapped), ("short-prefix", short),
            ("holes", holes), ("row-empty", empty)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n_splits", [1, 3, 8])
def test_split_emulation_matches_jax_kernel_and_oracle(n_splits, dtype):
    """The kernel's split-and-merge over the device-side extent, emulated,
    against decode_attention_pallas (interpret mode) and decode_attention_ref,
    row by row (the reference takes an (S,) mask); S is a multiple of block_k,
    so the reference kernel pads nothing and agrees on an all-invalid row."""
    B, H, Hkv, S, d = 3, 4, 2, 256, 32
    q, k, v = _qkv(B, H, Hkv, S, d, dtype, seed=21)
    rng = np.random.default_rng(22)
    tol = TOL[dtype]
    shared = np.random.default_rng(23).random(S) < 0.5
    shared[7] = True
    cases = [("shared", shared)] + _extent_masks(B, S, rng)
    for name, valid in cases:
        out = to_f32(_emulate_split_kernel(to_torch(q), to_torch(k), to_torch(v),
                                           torch.from_numpy(valid), n_splits, softcap=30.0))
        rows = valid if valid.ndim == 2 else np.broadcast_to(valid, (B, S))
        for b in range(B):
            args = (q[b:b + 1], k[b:b + 1], v[b:b + 1], jnp.asarray(rows[b]))
            kern = jax_decode(*args, softcap=30.0, block_k=128, interpret=True)
            ref = decode_attention_ref(*args, softcap=30.0)
            for other in (kern, ref):
                np.testing.assert_allclose(out[b:b + 1], to_f32(other), atol=tol, rtol=tol,
                                           err_msg=f"mask {name}, row {b}")


def test_split_emulation_with_empty_splits_at_model_shapes():
    """More splits than tiles of a short extent (empty shares write m = -inf,
    l = 0, acc = 0) at recurrentgemma's d=256, g=10 and qwen3's d=128, g=2,
    against the oracle."""
    rng = np.random.default_rng(31)
    for (B, H, Hkv, S, d) in [(2, 10, 1, 160, 256), (2, 4, 2, 200, 128)]:
        q, k, v = _qkv(B, H, Hkv, S, d, "float32", seed=B * S)
        valid = np.zeros((B, S), bool)
        valid[0, 10:50] = True
        valid[1, :int(rng.integers(60, S))] = True
        out = to_f32(_emulate_split_kernel(to_torch(q), to_torch(k), to_torch(v),
                                           torch.from_numpy(valid), n_splits=9))
        for b in range(B):
            ref = decode_attention_ref(q[b:b + 1], k[b:b + 1], v[b:b + 1],
                                       jnp.asarray(valid[b]))
            np.testing.assert_allclose(out[b:b + 1], to_f32(ref), atol=2e-5, rtol=2e-5)


def test_wrapper_rejects_what_the_kernel_does_not_take():
    q, k, v = (to_torch(a) for a in _qkv(2, 4, 2, 16, 32, "float32"))
    with pytest.raises(ValueError):
        decode_attention(q, k, v, torch.ones(15, dtype=torch.bool))
    with pytest.raises(TypeError):
        decode_attention(q.bfloat16(), k, v, torch.ones(16, dtype=torch.bool))
    with pytest.raises(ValueError):
        decode_attention(q[:, :3], k, v, torch.ones(16, dtype=torch.bool))


@pytest.mark.parametrize("shared", [True, False])
def test_timing_yardstick_counts_valid_slots_and_exceeds_l2(shared):
    """The bound chip_smoke.py and the sweep time against counts only the valid
    K/V rows, for (S,) and (B, S) masks; a cold rotation moves at least 4 L2
    sizes before an input comes round again."""
    from repro_torch.kernels.sweep import (HBM_BYTES_PER_S, L2_SPAN, bound_ms, cold_copies,
                                           decode_work)
    B, H, Hkv, S, d = 2, 8, 2, 64, 32
    q = torch.zeros(B, H, d)
    k = torch.zeros(B, Hkv, S, d)
    fill = torch.tensor([40, 40]) if shared else torch.tensor([10, 40])
    valid = torch.arange(S)[None, :] < fill[:, None]
    if shared:
        valid = valid[0]
    moved, ops = decode_work(q, k, valid)
    n_valid = int(fill.sum())
    assert moved == 2 * n_valid * Hkv * d * 4 + 2 * B * H * d * 4 + valid.numel()
    assert ops == 4 * n_valid * H * d
    assert bound_ms(moved, ops, torch.float32) == (moved / HBM_BYTES_PER_S * 1e3, "bytes")
    copies = cold_copies(object, moved, 50 << 20)
    assert len(copies) * moved >= L2_SPAN * (50 << 20)
    assert len(set(map(id, copies))) == len(copies)


def _ref_lse(q, k, valid, cap):
    """The reference oracle's scores (decode_attention/ref.py) for one row's
    (S,) mask, reduced by logsumexp: (B, H)."""
    import jax
    B, H, d = q.shape
    Hkv, S = k.shape[1], k.shape[2]
    s = jnp.einsum("bhgd,bhsd->bhgs", q.reshape(B, Hkv, H // Hkv, d).astype(jnp.float32),
                   k.astype(jnp.float32)) / np.sqrt(d)
    if cap is not None:
        s = cap * jnp.tanh(s / cap)
    s = jnp.where(valid[None, None, None, :], s, NEG_INF)
    return np.asarray(jax.nn.logsumexp(s, axis=-1)).reshape(B, H)


@pytest.mark.parametrize("cap", [None, 50.0])
def test_plain_lse_matches_the_reference_math(cap):
    """``return_lse``: the output is unchanged, and lse is the logsumexp of
    the oracle's masked scores, row by row; a row with no valid slot gives
    about NEG_INF (-2e38), far below any live row."""
    B, H, Hkv, S, d = 3, 4, 2, 96, 32
    q, k, v = _qkv(B, H, Hkv, S, d, "float32", seed=21)
    valid = np.random.default_rng(2).random((B, S)) < 0.5
    valid[2] = False                                       # all invalid
    out, lse = decode_attention_plain(to_torch(q), to_torch(k), to_torch(v),
                                      torch.from_numpy(valid), softcap=cap,
                                      return_lse=True)
    assert lse.dtype == torch.float32 and lse.shape == (B, H)
    assert torch.equal(out, decode_attention_plain(to_torch(q), to_torch(k), to_torch(v),
                                                   torch.from_numpy(valid), softcap=cap))
    for b in range(B):
        want = _ref_lse(q[b:b + 1], k[b:b + 1], jnp.asarray(valid[b]), cap)
        np.testing.assert_allclose(lse[b:b + 1].numpy(), want, rtol=2e-6, atol=2e-5)
        ref = decode_attention_ref(q[b:b + 1], k[b:b + 1], v[b:b + 1],
                                   jnp.asarray(valid[b]), softcap=cap)
        np.testing.assert_allclose(to_f32(out[b:b + 1]), to_f32(ref), atol=2e-5, rtol=2e-5)
    assert float(lse[2].max()) < -1e38 and float(lse[:2].min()) > -1e3
