"""The port's diagonal recurrence (``kernels/diag_recurrence``, plain version on
the CPU) and causal convolution (``models/recurrence.py``) against the JAX
package on the same numpy inputs.

The recurrence is held to the reference's 1e-4 (tests/test_kernels.py:77);
the reference's Pallas kernel runs in interpret mode, as its own tests run it
on the CPU. The convolutions are fp32 products in another order: 1e-5.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.diag_recurrence import diag_recurrence as jax_kernel
from repro.kernels.diag_recurrence import diag_recurrence_ref
from repro.models import recurrence as jrec
from repro_torch.kernels import diag_recurrence, diag_recurrence_plain
from repro_torch.kernels.diag_recurrence.ops import U, plan_recurrence
from repro_torch.models import recurrence as trec
from tests._torch_parity import to_f32

TOL = 1e-4
CONV_TOL = 1e-5
SWEEP = [  # (B, S, C, chunk, block_c): tests/test_kernels.py:68-70
    (2, 100, 64, 32, 64), (1, 256, 32, 64, 16), (3, 17, 130, 8, 64), (1, 64, 2048, 16, 512)]


def _inputs(seed, shape_a, shape_h, lo=0.5):
    rng = np.random.default_rng(seed)
    a = rng.uniform(lo, 1.0, shape_a).astype(np.float32)
    b = rng.standard_normal(shape_a).astype(np.float32)
    h0 = rng.standard_normal(shape_h).astype(np.float32)
    return a, b, h0


def _close(out, ref, tol=TOL):
    np.testing.assert_allclose(to_f32(out), to_f32(ref), atol=tol, rtol=tol)


@pytest.mark.parametrize("B,S,C,chunk,block_c", SWEEP)
def test_plain_matches_jax_ref_kernel_and_model_scan(B, S, C, chunk, block_c):
    a, b, h0 = _inputs(B * S + C, (B, S, C), (B, C))
    out_all, out_final = diag_recurrence(*(torch.from_numpy(x) for x in (a, b, h0)))
    assert out_all.shape == (B, S, C) and out_final.shape == (B, C)
    assert out_all.dtype == torch.float32
    ja, jb, jh = jnp.asarray(a), jnp.asarray(b), jnp.asarray(h0)
    refs = [diag_recurrence_ref(ja, jb, jh),
            jax_kernel(ja, jb, jh, chunk=chunk, block_c=block_c, interpret=True),
            jrec.chunked_diag_recurrence(ja, jb, jh, chunk=chunk)]
    for ref_all, ref_final in refs:
        _close(out_all, ref_all)
        _close(out_final, ref_final)
    assert torch.equal(out_final, out_all[:, -1])


def test_chunked_recurrence_flattens_channel_dims():
    """(B, S, d_inner, N) inputs, as the SSM passes them, against the
    reference's chunked scan on the same 4-D layout."""
    a, b, h0 = _inputs(5, (2, 40, 6, 4), (2, 6, 4), lo=0.3)
    out_all, out_final = trec.chunked_diag_recurrence(
        *(torch.from_numpy(x) for x in (a, b, h0)))
    ref_all, ref_final = jrec.chunked_diag_recurrence(
        jnp.asarray(a), jnp.asarray(b), jnp.asarray(h0), chunk=16)
    assert out_all.shape == (2, 40, 6, 4) and out_final.shape == (2, 6, 4)
    _close(out_all, ref_all)
    _close(out_final, ref_final)


@pytest.mark.parametrize("B,S,C,chunk,block_c", SWEEP)
def test_splitting_the_sequence_with_the_carry_changes_nothing(B, S, C, chunk, block_c):
    a, b, h0 = (torch.from_numpy(x) for x in _inputs(7 + S, (B, S, C), (B, C)))
    whole_all, whole_final = diag_recurrence(a, b, h0)
    cut = S // 2
    first_all, carry = diag_recurrence(a[:, :cut].contiguous(), b[:, :cut].contiguous(), h0)
    second_all, final = diag_recurrence(a[:, cut:].contiguous(), b[:, cut:].contiguous(),
                                        carry)
    _close(torch.cat([first_all, second_all], 1), whole_all)
    _close(final, whole_final)


def test_cpu_route_runs_the_plain_version_and_counts_no_launch():
    a, b, h0 = (torch.from_numpy(x) for x in _inputs(9, (2, 12, 8), (2, 8)))
    before = diag_recurrence.launches
    out = diag_recurrence(a, b, h0)
    ref = diag_recurrence_plain(a, b, h0)
    assert diag_recurrence.launches == before
    assert all(torch.equal(x, y) for x, y in zip(out, ref))
    empty_all, h = diag_recurrence(a[:, :0], b[:, :0], h0)
    assert empty_all.shape == (2, 0, 8) and torch.equal(h, h0)
    assert h.data_ptr() != h0.data_ptr()


@pytest.mark.parametrize("bad", ["shape", "h0", "dtype"])
def test_wrapper_rejects_what_the_kernel_does_not_take(bad):
    a, b, h0 = (torch.from_numpy(x) for x in _inputs(11, (2, 12, 8), (2, 8)))
    if bad == "shape":
        with pytest.raises(ValueError):
            diag_recurrence(a, b[:, :5], h0)
    elif bad == "h0":
        with pytest.raises(ValueError):
            diag_recurrence(a, b, h0[:, :3])
    else:
        with pytest.raises(TypeError):
            diag_recurrence(a, b.double(), h0)


def _chunked_emulation(a, b, h0, chunk):
    """The chunked route's two passes in fp32 PyTorch, each product and sum
    rounded on its own as the kernel rounds them: the summary folds each chunk
    from zero into (product of a, end state); the apply pass composes the
    carry-in from h0 over the earlier chunks in order, then runs the chunk."""
    B, S, C = a.shape
    starts = range(0, S, chunk)
    prod, state = [], []
    for r0 in starts:
        p, h = torch.ones((B, C)), torch.zeros((B, C))
        for t in range(r0, min(S, r0 + chunk)):
            h = a[:, t] * h + b[:, t]
            p = p * a[:, t]
        prod.append(p)
        state.append(h)
    h_all = torch.empty_like(a)
    for kc, r0 in enumerate(starts):
        h = h0.clone()
        for j in range(kc):
            h = prod[j] * h + state[j]
        for t in range(r0, min(S, r0 + chunk)):
            h = a[:, t] * h + b[:, t]
            h_all[:, t] = h
    return h_all, h


CHUNKED = [  # (B, S, C, chunk, a_low, a_high)
    (2, 100, 64, 16, 0.5, 1.0),          # ragged last chunk
    (1, 5, 32, 8, 0.5, 1.0),             # S shorter than one chunk
    (3, 67, 130, 8, 0.5, 1.0),           # ragged channels, many chunks
    (1, 96, 48, 24, 0.0, 1e-3),          # a near 0: products underflow to 0
]


@pytest.mark.parametrize("B,S,C,chunk,lo,hi", CHUNKED)
def test_chunked_emulation_matches_jax(B, S, C, chunk, lo, hi):
    rng = np.random.default_rng(B + S + C)
    a = rng.uniform(lo, hi, (B, S, C)).astype(np.float32)
    b = rng.standard_normal((B, S, C)).astype(np.float32)
    h0 = rng.standard_normal((B, C)).astype(np.float32)          # h0 != 0
    out_all, out_final = _chunked_emulation(*(torch.from_numpy(x) for x in (a, b, h0)),
                                            chunk)
    assert torch.isfinite(out_all).all() and torch.equal(out_final, out_all[:, -1])
    ja, jb, jh = jnp.asarray(a), jnp.asarray(b), jnp.asarray(h0)
    refs = [diag_recurrence_ref(ja, jb, jh),
            jax_kernel(ja, jb, jh, chunk=chunk, block_c=64, interpret=True),
            jrec.chunked_diag_recurrence(ja, jb, jh, chunk=chunk)]
    for ref_all, ref_final in refs:
        _close(out_all, ref_all)
        _close(out_final, ref_final)
    if hi < 1e-2:                                                # products underflowed
        p = torch.from_numpy(a[:, :chunk]).prod(1)
        assert torch.equal(p, torch.zeros_like(p))


@pytest.mark.parametrize("B,S,C,route", [
    (1, 256, 131072, "sequential"),     # falcon-mamba-7b, one SSM chunk
    (1, 512, 2560, "chunked"),          # recurrentgemma-2b RG-LRU prefill
    (1, 2048, 2560, "chunked"),
    (1, 1000, 2560, "chunked"),
    (4, 64, 131072, "sequential"),
    (1, 8, 2560, "sequential"),         # one load group: too short to cut
])
def test_plan_recurrence_routes(B, S, C, route):
    p = plan_recurrence(B, S, C, n_sms=132)
    assert p.route == route
    if route == "chunked":
        assert p.chunk % U == 0 and 2 <= p.n_chunks <= 64
        assert (p.n_chunks - 1) * p.chunk < S <= p.n_chunks * p.chunk
        assert B * C * p.n_chunks >= 132 * 128                  # fills the card
    else:
        assert (p.chunk, p.n_chunks) == (S, 1)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("S", [1, 3, 19])
def test_causal_conv1d_matches_jax(S, dtype):
    rng = np.random.default_rng(S)
    x = rng.standard_normal((2, S, 24)).astype(np.float32)
    w = rng.standard_normal((24, 4)).astype(np.float32)
    bias = rng.standard_normal(24).astype(np.float32)
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    jx, jw, jb = (jnp.asarray(v, jdt) for v in (x, w, bias))
    tx, tw, tb = (torch.from_numpy(np.array(v, np.float32)).to(tdt) for v in (jx, jw, jb))
    ref = jrec.causal_conv1d(jx, jw, jb)
    out = trec.causal_conv1d(tx, tw, tb)
    assert out.dtype == tdt and out.shape == (2, S, 24)
    tol = CONV_TOL if dtype == "float32" else 2 ** -7
    _close(out, ref, tol)
    _close(trec.causal_conv1d(tx, tw), jrec.causal_conv1d(jx, jw), tol)


def test_causal_conv1d_step_matches_jax_and_the_full_conv():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 9, 16)).astype(np.float32)
    w = rng.standard_normal((16, 4)).astype(np.float32)
    bias = rng.standard_normal(16).astype(np.float32)
    full = trec.causal_conv1d(*(torch.from_numpy(v) for v in (x, w, bias)))
    state, jstate = torch.zeros((2, 3, 16)), jnp.zeros((2, 3, 16))
    for t in range(9):
        xt = x[:, t:t + 1]
        out, state = trec.causal_conv1d_step(torch.from_numpy(xt), state,
                                             torch.from_numpy(w), torch.from_numpy(bias))
        ref, jstate = jrec.causal_conv1d_step(jnp.asarray(xt), jstate, jnp.asarray(w),
                                              jnp.asarray(bias))
        _close(out, ref, CONV_TOL)
        _close(state, jstate, CONV_TOL)
        _close(out[:, 0], full[:, t], CONV_TOL)
    tail = trec.conv_tail(torch.from_numpy(x), 4)
    assert torch.equal(tail, torch.from_numpy(x[:, -3:]))
    short = trec.conv_tail(torch.from_numpy(x[:, :2]), 4)
    assert torch.equal(short[:, 0], torch.zeros(2, 16))
    assert torch.equal(short[:, 1:], torch.from_numpy(x[:, :2]))
