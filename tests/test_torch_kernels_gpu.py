"""The CUDA kernels against their plain versions on the card.

Every test here needs a CUDA device and skips itself without one. The file
imports neither JAX nor the JAX package, so it also runs where only PyTorch
is installed:

    PYTHONPATH=src python -m pytest -q --noconftest -m gpu tests/test_torch_kernels_gpu.py
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import (
    decode_attention,
    decode_attention_plain,
    diag_recurrence,
    diag_recurrence_plain,
    flash_attention,
    flash_attention_plain,
    fleet_scan,
    fleet_scan_plain,
    page_gather,
    page_gather_plain,
)
from repro_torch.kernels.decode_attention.ops import launch_splits
from repro_torch.kernels.diag_recurrence.ops import plan_recurrence
from repro_torch.kernels.flash_attention.ops import (
    flash_attention_backward,
    flash_attention_backward_plain,
)
from repro_torch.kernels.fleet_scan.ops import SEGMENT, WARMUP
from _torch_parity import scan_cases, scan_consts, scan_csr  # tests/, on sys.path

FLASH_ROWS = [  # (B, H, Hkv, S, d, causal, window, softcap): tests/test_kernels.py:29-35
    (2, 4, 2, 256, 64, True, None, None),
    (1, 4, 4, 128, 64, True, 64, None),
    (2, 2, 1, 200, 32, True, None, 50.0),
    (1, 2, 2, 96, 128, False, None, None),
    (1, 8, 2, 320, 64, True, 100, 30.0),
    (1, 16, 16, 2048, 64, True, None, None),      # qwen1.5-0.5b prefill
    (1, 2, 2, 70, 64, True, 0, None),             # every key masked
    (1, 10, 1, 2048, 256, True, 2048, None),      # recurrentgemma-2b local layer
    (2, 10, 1, 300, 256, True, 100, 30.0),
    (1, 16, 8, 2048, 128, True, None, None),      # qwen3-1.7b prefill
    (2, 8, 2, 333, 128, True, None, 50.0),
    (1, 4, 2, 517, 256, True, 200, None),
    (1, 32, 8, 4608, 120, True, 4096, None),      # h2o-danube3-4b: d=120, g=4, window
    (2, 8, 2, 300, 120, True, 100, 30.0),
    (1, 24, 8, 2048, 64, True, None, None),       # granite-moe-3b: g=3
    (1, 14, 2, 320, 64, True, None, None),        # internvl2-1b: g=7, 256 patches + 64
    (1, 12, 12, 1500, 64, False, None, None),     # whisper-small encoder, non-causal
]
DECODE_ROWS = [  # (B, H, Hkv, S, d, softcap): tests/test_kernels.py:50-54
    (2, 4, 2, 300, 64, None),
    (1, 8, 1, 512, 128, 50.0),
    (4, 2, 2, 64, 32, None),
    (4, 16, 8, 4096, 128, None),                  # qwen3-1.7b decode, 4 slots
    (4, 10, 1, 2048, 256, None),                  # recurrentgemma-2b decode, 4 slots
    (2, 20, 2, 300, 256, 50.0),
    (4, 32, 8, 4096, 120, None),                  # h2o-danube3-4b decode: d=120, g=4
    (2, 21, 3, 300, 120, 50.0),                   # d=120, g=7
    (4, 24, 8, 4096, 64, None),                   # granite-moe-3b decode: g=3
    (2, 14, 2, 2048, 64, None),                   # internvl2-1b decode: g=7
    (2, 12, 12, 1500, 64, None),                  # whisper-small cross attention
]
RECURRENCE_ROWS = [  # (B, S, C): tests/test_kernels.py:68-70, then the model shapes
    (2, 100, 64), (1, 256, 32), (3, 17, 130), (1, 64, 2048),
    (1, 2048, 2560),                              # recurrentgemma-2b RG-LRU prefill
    (1, 256, 131072),                             # falcon-mamba-7b, one SSM chunk
]
TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


def _gather_and_compare(pool, ids, dev):
    for ids_in in (ids, ids.to(dev)):
        before = page_gather.launches
        out = page_gather(pool, ids_in)
        torch.cuda.synchronize()
        assert page_gather.launches == before + 1
        ref = page_gather_plain(pool, ids.to(dev))
        assert out.dtype == ref.dtype and out.shape == ref.shape
        assert torch.equal(out.view(torch.uint8), ref.view(torch.uint8))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.int32, torch.bfloat16,
                                   torch.uint8])
def test_page_gather_kernel_bitwise_equals_plain(dtype):
    dev = _card()
    rng = np.random.default_rng(1)
    for P, E, K in [(64, 256, 20), (16, 128, 16), (8, 512, 1), (9, 4003, 5)]:
        pool = torch.from_numpy(rng.standard_normal((P, E)) * 10).to(dtype).to(dev)
        ids = torch.from_numpy(rng.integers(0, P, (K,), dtype=np.int32))
        _gather_and_compare(pool, ids, dev)


@pytest.mark.gpu
def test_page_gather_bulk_edges_bitwise():
    """Rows of 4 MiB + 16 B (a last bulk item of 16 B), rows shorter than one
    bulk item, rows with a byte tail, an unaligned view of the pool, and
    repeated ids."""
    dev = _card()
    gen = torch.Generator(device="cpu").manual_seed(2)
    for P, E in [(6, 4 * 2**20 + 16), (40, 48), (33, 1000), (5, 2**15 + 7)]:
        pool = torch.randint(0, 256, (P, E), dtype=torch.uint8, generator=gen).to(dev)
        ids = torch.cat([torch.randperm(P, generator=gen),
                         torch.randint(0, P, (7,), generator=gen)]).to(torch.int32)
        _gather_and_compare(pool, ids, dev)
    flat = torch.randint(0, 256, (1 + 12 * 4096,), dtype=torch.uint8, generator=gen)
    view = flat.to(dev)[1:].view(12, 4096)               # base 1 byte off alignment
    assert view.is_contiguous() and view.data_ptr() % 16
    _gather_and_compare(view, torch.tensor([3, 3, 0, 11, 5, 3], dtype=torch.int32), dev)
    f32 = torch.randn((1 + 8 * 1024,), generator=gen).to(dev)[1:].view(8, 1024)
    _gather_and_compare(f32, torch.tensor([7, 0, 7, 2], dtype=torch.int32), dev)


@pytest.mark.gpu
def test_page_gather_back_to_back_host_ids():
    """Short host id lists ride in the launch parameters, long ones go
    through pinned memory: back-to-back calls with other id lists, none
    synchronized, still gather their own rows."""
    dev = _card()
    gen = torch.Generator(device="cpu").manual_seed(4)
    pool = torch.randint(0, 256, (64, 2**16), dtype=torch.uint8, generator=gen).to(dev)
    sizes = [*torch.randint(1, 64, (20,), generator=gen).tolist(), 960, 961, 2000, 5]
    id_lists = [torch.randint(0, 64, (n,), generator=gen, dtype=torch.int32)
                for n in sizes]
    outs = [page_gather(pool, ids) for ids in id_lists]
    torch.cuda.synchronize()
    for ids, out in zip(id_lists, outs):
        assert torch.equal(out, pool[ids.long().to(dev)])


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_kernel_matches_plain(dtype):
    dev = _card()
    rng = np.random.default_rng(7)
    tol = TOL[dtype]
    for (B, H, Hkv, S, d, causal, window, cap) in FLASH_ROWS:
        q, k, v = (torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
                   .to(dtype).to(dev)
                   for shape in ((B, H, S, d), (B, Hkv, S, d), (B, Hkv, S, d)))
        opts = dict(causal=causal, window=window, softcap=cap)
        before = flash_attention.launches
        route = "tc_bf16" if dtype == torch.bfloat16 else "cuda_core"
        on_route = flash_attention.launches_by_route[route]
        out = flash_attention(q, k, v, **opts)
        torch.cuda.synchronize()
        assert flash_attention.launches == before + 1
        assert flash_attention.launches_by_route[route] == on_route + 1
        ref = flash_attention_plain(q, k, v, **opts)
        assert out.dtype == dtype and torch.isfinite(out.float()).all()
        np.testing.assert_allclose(out.float().cpu().numpy(), ref.float().cpu().numpy(),
                                   atol=tol, rtol=tol)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_kernel_ragged_and_all_masked(dtype):
    """Sq != Sk (causal compares absolute indices), and rows whose keys are all
    masked (window 0), which average v over the Sk keys as the plain version."""
    dev = _card()
    gen = torch.Generator(device="cpu").manual_seed(5)
    tol = TOL[dtype]
    for (B, H, Hkv, Sq, Sk, d, causal, window) in [
            (1, 4, 2, 100, 150, 64, True, None), (1, 4, 2, 150, 100, 64, True, None),
            (1, 2, 2, 70, 70, 64, True, 0), (1, 2, 1, 90, 130, 256, True, 0),
            (2, 4, 4, 33, 200, 128, False, 50),
            (1, 12, 12, 64, 1500, 64, False, None),    # whisper cross prefill
            (1, 4, 2, 70, 200, 120, False, None), (1, 4, 1, 150, 100, 120, True, 0)]:
        q, k, v = (torch.randn(shape, generator=gen).to(dtype).to(dev)
                   for shape in ((B, H, Sq, d), (B, Hkv, Sk, d), (B, Hkv, Sk, d)))
        out = flash_attention(q, k, v, causal=causal, window=window)
        ref = flash_attention_plain(q, k, v, causal=causal, window=window)
        torch.cuda.synchronize()
        assert torch.isfinite(out.float()).all()
        np.testing.assert_allclose(out.float().cpu().numpy(), ref.float().cpu().numpy(),
                                   atol=tol, rtol=tol)


def _decode_masks(rng, B, S):
    """An (S,) mask, a (B, S) ring mask with a window, one with an
    all-invalid row, and an all-valid one (cross attention)."""
    shared = rng.random(S) < 0.7
    shared[0] = True
    k_pos = np.full((B, S), -1)
    for b in range(B):
        n = int(rng.integers(1, 3 * S // 2))          # some rows wrap the ring
        pos = np.arange(max(0, n - S), n)
        k_pos[b, pos % S] = pos
    now = k_pos.max(1, keepdims=True)
    ring = (k_pos >= 0) & (k_pos <= now) & (now - k_pos < max(S // 3, 1))
    empty = ring.copy()
    empty[-1] = False
    return [shared, ring, empty, np.ones((B, S), bool)]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_attention_kernel_matches_plain(dtype):
    dev = _card()
    rng = np.random.default_rng(11)
    tol = TOL[dtype]
    for (B, H, Hkv, S, d, cap) in DECODE_ROWS:
        q, k, v = (torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
                   .to(dtype).to(dev)
                   for shape in ((B, H, d), (B, Hkv, S, d), (B, Hkv, S, d)))
        for valid in _decode_masks(rng, B, S):
            valid = torch.from_numpy(valid).to(dev)
            before = decode_attention.launches
            out = decode_attention(q, k, v, valid, softcap=cap)
            torch.cuda.synchronize()
            assert decode_attention.launches == before + 1
            ref = decode_attention_plain(q, k, v, valid, softcap=cap)
            assert out.dtype == dtype and torch.isfinite(out.float()).all()
            np.testing.assert_allclose(out.float().cpu().numpy(),
                                       ref.float().cpu().numpy(), atol=tol, rtol=tol)


def _extent_masks(B, S, rng):
    """A short filled prefix in a long cache, a wrapped ring (valid at both
    ends), one with whole invalid tiles inside its extent, and an all-invalid
    row."""
    short = np.zeros((B, S), bool)
    for b in range(B):
        short[b, :int(rng.integers(1, 40))] = True
    wrapped = np.zeros((B, S), bool)
    wrapped[:, :S // 5] = True
    wrapped[:, S - S // 3:] = True
    holes = rng.random((B, S)) < 0.4
    holes[:, 64:320] = False
    holes[:, 0] = True
    empty = short.copy()
    empty[0] = False
    return [("short-prefix", short), ("wrapped", wrapped), ("holes", holes),
            ("row-empty", empty)]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_attention_live_extent_and_any_split_count(dtype):
    """The device-side extent on the masks it must get right, through the
    planner's split count and through others (1, and more splits than the
    extent has tiles: empty shares)."""
    dev = _card()
    rng = np.random.default_rng(12)
    tol = TOL[dtype]
    for (B, H, Hkv, S, d, cap) in [(4, 16, 8, 4096, 128, None), (4, 10, 1, 2048, 256, None),
                                   (2, 4, 2, 1000, 64, 30.0), (4, 32, 8, 4096, 120, None),
                                   (2, 6, 2, 1000, 64, None), (2, 14, 2, 1000, 64, None)]:
        q, k, v = (torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
                   .to(dtype).to(dev)
                   for shape in ((B, H, d), (B, Hkv, S, d), (B, Hkv, S, d)))
        for name, valid in _extent_masks(B, S, rng):
            valid = torch.from_numpy(valid).to(dev)
            ref = decode_attention_plain(q, k, v, valid, softcap=cap)
            outs = [decode_attention(q, k, v, valid, softcap=cap)]
            outs += [launch_splits(q, k, v, valid, n, softcap=cap) for n in (1, 5, 64)]
            torch.cuda.synchronize()
            for out in outs:
                assert out.dtype == dtype and torch.isfinite(out.float()).all(), name
                np.testing.assert_allclose(out.float().cpu().numpy(),
                                           ref.float().cpu().numpy(), atol=tol, rtol=tol,
                                           err_msg=name)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_attention_lse_matches_plain(dtype):
    """``return_lse``: each head's logsumexp from the one-split kernel and
    from the merge of several splits, against the plain version (about
    NEG_INF for the all-invalid row); the output unchanged by asking."""
    dev = _card()
    rng = np.random.default_rng(13)
    for (B, H, Hkv, S, d, cap) in [(4, 16, 8, 4096, 128, None), (2, 4, 2, 1000, 64, 30.0),
                                   (2, 10, 1, 2048, 256, None)]:
        q, k, v = (torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
                   .to(dtype).to(dev)
                   for shape in ((B, H, d), (B, Hkv, S, d), (B, Hkv, S, d)))
        for name, valid in _extent_masks(B, S, rng):
            valid = torch.from_numpy(valid).to(dev)
            ref, ref_lse = decode_attention_plain(q, k, v, valid, softcap=cap,
                                                  return_lse=True)
            runs = [decode_attention(q, k, v, valid, softcap=cap, return_lse=True)]
            runs += [launch_splits(q, k, v, valid, n, softcap=cap, return_lse=True)
                     for n in (1, 5, 64)]
            torch.cuda.synchronize()
            for out, lse in runs:
                assert lse.dtype == torch.float32 and lse.shape == (B, H), name
                np.testing.assert_allclose(out.float().cpu().numpy(),
                                           ref.float().cpu().numpy(), atol=TOL[dtype],
                                           rtol=TOL[dtype], err_msg=name)
                np.testing.assert_allclose(lse.cpu().numpy(), ref_lse.cpu().numpy(),
                                           atol=1e-4, rtol=1e-5, err_msg=name)


@pytest.mark.gpu
def test_diag_recurrence_routes_match_plain_and_are_counted():
    """The planner's route at the model shapes: sequential bitwise equal to
    the plain version, chunked within 1e-4 (a near 0 included: underflowing
    products stay finite); each launch counted under its route."""
    dev = _card()
    rng = np.random.default_rng(14)
    n_sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for (B, S, C, lo) in [(1, 256, 131072, 0.5), (1, 512, 2560, 0.5), (1, 2048, 2560, 0.5),
                          (1, 1000, 2560, 0.0), (2, 333, 1000, 0.5)]:
        a = torch.from_numpy(rng.uniform(lo, 1.0, (B, S, C)).astype(np.float32)).to(dev)
        b = torch.from_numpy(rng.standard_normal((B, S, C)).astype(np.float32)).to(dev)
        h0 = torch.from_numpy(rng.standard_normal((B, C)).astype(np.float32)).to(dev)
        route = plan_recurrence(B, S, C, n_sms).route
        before = dict(diag_recurrence.launches_by_route)
        h_all, h_final = diag_recurrence(a, b, h0)
        torch.cuda.synchronize()
        after = diag_recurrence.launches_by_route
        assert after[route] == before[route] + 1
        assert sum(after.values()) == sum(before.values()) + 1
        ref_all, ref_final = diag_recurrence_plain(a, b, h0)
        assert torch.isfinite(h_all).all() and torch.equal(h_final, h_all[:, -1])
        if route == "sequential":
            assert torch.equal(h_all, ref_all) and torch.equal(h_final, ref_final)
        np.testing.assert_allclose(h_all.cpu().numpy(), ref_all.cpu().numpy(),
                                   atol=1e-4, rtol=1e-4)
    assert plan_recurrence(1, 2048, 2560, n_sms).route == "chunked"
    assert plan_recurrence(1, 256, 131072, n_sms).route == "sequential"


@pytest.mark.gpu
def test_diag_recurrence_kernel_matches_plain():
    """The kernel rounds as the plain version's ``a * h + b`` does: the two
    agree within the recurrence's 1e-4 (bit for bit by design)."""
    dev = _card()
    rng = np.random.default_rng(13)
    for (B, S, C) in RECURRENCE_ROWS:
        a = torch.from_numpy(rng.uniform(0.5, 1.0, (B, S, C)).astype(np.float32)).to(dev)
        b = torch.from_numpy(rng.standard_normal((B, S, C)).astype(np.float32)).to(dev)
        h0 = torch.from_numpy(rng.standard_normal((B, C)).astype(np.float32)).to(dev)
        before = diag_recurrence.launches
        h_all, h_final = diag_recurrence(a, b, h0)
        torch.cuda.synchronize()
        assert diag_recurrence.launches == before + 1
        ref_all, ref_final = diag_recurrence_plain(a, b, h0)
        assert h_all.shape == (B, S, C) and h_final.shape == (B, C)
        np.testing.assert_allclose(h_all.cpu().numpy(), ref_all.cpu().numpy(),
                                   atol=1e-4, rtol=1e-4)
        assert torch.equal(h_final, h_all[:, -1])
        np.testing.assert_allclose(h_final.cpu().numpy(), ref_final.cpu().numpy(),
                                   atol=1e-4, rtol=1e-4)


# (B, H, Hkv, Sq, Sk, d, causal, window, softcap): the backward's cases, fp32
FLASH_GRAD_ROWS = [
    (1, 16, 16, 256, 256, 64, True, None, None),     # qwen1.5-0.5b's heads
    (2, 8, 2, 200, 200, 128, True, 50, 30.0),        # GQA, window, softcap
    (1, 4, 1, 130, 130, 256, True, 64, None),        # recurrentgemma's d=256, g=4
    (1, 4, 2, 70, 300, 120, False, None, None),      # d=120, Sq != Sk (cross)
    (1, 2, 2, 70, 70, 32, True, 0, None),            # every key masked
    (1, 4, 2, 150, 100, 64, True, None, 50.0),       # Sq > Sk, causal
]
GRAD_TOL = 1e-4     # of the largest |gradient| in each of dq, dk, dv


@pytest.mark.gpu
def test_flash_attention_backward_matches_plain():
    """The backward kernels against torch.autograd.grad through the plain
    version: dq, dk, dv each within 1e-4 of its largest |entry|, reached
    through autograd (one forward with the rows' log-sum-exp, one backward
    launch, counted, on the 3xTF32 tensor-core route) and through the
    wrapper directly."""
    dev = _card()
    gen = torch.Generator(device="cpu").manual_seed(21)
    for (B, H, Hkv, Sq, Sk, d, causal, window, cap) in FLASH_GRAD_ROWS:
        q, k, v = (torch.randn(shape, generator=gen).to(dev).requires_grad_(True)
                   for shape in ((B, H, Sq, d), (B, Hkv, Sk, d), (B, Hkv, Sk, d)))
        dout = torch.randn((B, H, Sq, d), generator=gen).to(dev)
        opts = dict(causal=causal, window=window, softcap=cap)
        fwd, bwd = flash_attention.launches, flash_attention_backward.launches
        by_route = dict(flash_attention_backward.launches_by_route)
        out = flash_attention(q, k, v, **opts)
        grads = torch.autograd.grad(out, (q, k, v), dout)
        torch.cuda.synchronize()
        assert flash_attention.launches == fwd + 1
        assert flash_attention_backward.launches == bwd + 1
        assert flash_attention_backward.launches_by_route == {
            **by_route, "tc_tf32x3": by_route["tc_tf32x3"] + 1}
        ref = flash_attention_backward_plain(q, k, v, dout, **opts)
        for name, g, r in zip("qkv", grads, ref):
            assert torch.isfinite(g).all(), name
            bound = GRAD_TOL * float(r.abs().max())
            assert float((g - r).abs().max()) <= bound, (name, (B, H, Hkv, Sq, Sk, d))


@pytest.mark.gpu
def test_flash_attention_backward_is_reproducible_and_bf16_raises():
    """No atomics: two backwards give equal bits, in fp32 and in bf16. What
    the kernels do not take still raises: a float16 forward that needs a
    gradient, and a backward whose dout is not the inputs' dtype."""
    dev = _card()
    gen = torch.Generator(device="cpu").manual_seed(22)
    q, k, v = (torch.randn(s, generator=gen).to(dev) for s in
               ((1, 8, 333, 64), (1, 2, 333, 64), (1, 2, 333, 64)))
    dout = torch.randn(q.shape, generator=gen).to(dev)
    for dtype in (torch.float32, torch.bfloat16):
        qkv = [t.to(dtype).requires_grad_(True) for t in (q, k, v)]
        out = flash_attention(*qkv)
        g1 = torch.autograd.grad(out, qkv, dout.to(dtype), retain_graph=True)
        g2 = torch.autograd.grad(out, qkv, dout.to(dtype))
        assert all(g.dtype == dtype for g in g1)
        assert all(torch.equal(a, b) for a, b in zip(g1, g2)), dtype
    qh, kh, vh = (t.detach().to(torch.float16) for t in (q, k, v))
    with pytest.raises(TypeError):
        flash_attention(qh.requires_grad_(True), kh, vh)
    qb, kb, vb = (t.detach().to(torch.bfloat16) for t in (q, k, v))
    lse = torch.zeros(q.shape[:3], device=dev)
    with pytest.raises(TypeError):
        flash_attention_backward(qb, kb, vb, qb, lse, dout)
    with torch.no_grad():                        # serving's bf16 forward still runs
        assert flash_attention(qb, kb, vb).dtype == torch.bfloat16


BF16_GRAD_TOL = 2e-2    # of the largest |gradient| in each of dq, dk, dv: bf16's bar


@pytest.mark.gpu
def test_flash_attention_bf16_backward_matches_plain():
    """bf16 on the card: the tensor-core forward's rows' log-sum-exp against
    the plain one (fp32 logits of the same bf16 inputs; a row whose keys are
    all masked below -1e38 in both), and the bf16 backward kernels (products
    on the tensor cores, P and dS rounded to bf16) against
    torch.autograd.grad through the plain version (products in fp32,
    gradients rounded to bf16 once): dq, dk, dv in bf16, each within 2e-2 of
    its largest |entry|, reached through autograd (one launch each way,
    counted, the backward's on the tc_bf16 route) and through the wrapper,
    bitwise alike."""
    from repro_torch.kernels.flash_attention.ops import _flash_op, _plain_scores
    dev = _card()
    gen = torch.Generator(device="cpu").manual_seed(23)
    for (B, H, Hkv, Sq, Sk, d, causal, window, cap) in FLASH_GRAD_ROWS + [
            (4, 16, 16, 1024, 1024, 64, True, None, None),       # qwen1.5's training shape
            (2, 10, 1, 640, 640, 256, True, 256, None),          # d=256, g=10, window
            (2, 16, 8, 512, 512, 128, True, None, None)]:        # qwen3's d=128, GQA 16/8
        q, k, v = (torch.randn(shape, generator=gen).to(dev, torch.bfloat16)
                   for shape in ((B, H, Sq, d), (B, Hkv, Sk, d), (B, Hkv, Sk, d)))
        dout = torch.randn((B, H, Sq, d), generator=gen).to(dev, torch.bfloat16)
        opts = dict(causal=causal, window=window, softcap=cap)
        _, lse = _flash_op(q, k, v, causal, window, cap, d ** -0.5, True)
        want = torch.logsumexp(_plain_scores(q, k, causal, window, cap, None), -1)
        want = want.reshape(lse.shape)
        masked = want < -1e38
        assert torch.equal(lse < -1e38, masked)
        live = (lse - want)[~masked]
        assert live.numel() == 0 or float(live.abs().max()) <= 1e-4
        qkv = [t.clone().requires_grad_(True) for t in (q, k, v)]
        fwd, bwd = flash_attention.launches, flash_attention_backward.launches
        by_route = dict(flash_attention_backward.launches_by_route)
        grads = torch.autograd.grad(flash_attention(*qkv, **opts), qkv, dout)
        torch.cuda.synchronize()
        assert flash_attention.launches == fwd + 1
        assert flash_attention_backward.launches == bwd + 1
        assert flash_attention_backward.launches_by_route == {
            **by_route, "tc_bf16": by_route["tc_bf16"] + 1}
        out, lse = _flash_op(q, k, v, causal, window, cap, d ** -0.5, True)
        direct = flash_attention_backward(q, k, v, out, lse, dout, **opts)
        ref = flash_attention_backward_plain(q, k, v, dout, **opts)
        for name, g, g2, r in zip("qkv", grads, direct, ref):
            assert g.dtype == torch.bfloat16 and torch.equal(g, g2), name
            assert torch.isfinite(g).all(), name
            bound = BF16_GRAD_TOL * float(r.float().abs().max())
            assert float((g.float() - r.float()).abs().max()) <= bound, (
                name, (B, H, Hkv, Sq, Sk, d))


@pytest.mark.gpu
def test_kernels_without_backward_refuse_grad():
    """decode_attention and page_gather have no backward on the card: a CUDA
    input that requires a gradient raises while grad mode is on, and runs
    under no_grad."""
    dev = _card()
    q = torch.randn((2, 4, 64), device=dev)
    kc = torch.randn((2, 2, 64, 64), device=dev)
    valid = torch.ones(64, dtype=torch.bool, device=dev)
    with pytest.raises(RuntimeError, match="no backward"):
        decode_attention(q.clone().requires_grad_(True), kc, kc.clone(), valid)
    pool = torch.randn((8, 256), device=dev, requires_grad=True)
    with pytest.raises(RuntimeError, match="no backward"):
        page_gather(pool, torch.tensor([1, 3], dtype=torch.int32))
    with torch.no_grad():
        decode_attention(q.clone().requires_grad_(True), kc, kc.clone(), valid)
        page_gather(pool, torch.tensor([1, 3], dtype=torch.int32))


@pytest.mark.gpu
def test_diag_recurrence_backward_on_both_routes():
    """The reversed-time backward launches the kernel (counted as a backward
    launch, on the route the planner picks for the shape) and agrees with
    autograd through the plain loop within 1e-4 of each gradient's largest
    entry, on the sequential and the chunked route."""
    dev = _card()
    rng = np.random.default_rng(23)
    n_sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for (B, S, C) in [(1, 64, 32768), (1, 300, 2560)]:
        a, b, h0 = (torch.from_numpy(x.astype(np.float32)).to(dev).requires_grad_(True)
                    for x in (rng.uniform(0.5, 1.0, (B, S, C)),
                              rng.standard_normal((B, S, C)), rng.standard_normal((B, C))))
        g_all = torch.from_numpy(rng.standard_normal((B, S, C)).astype(np.float32)).to(dev)
        g_fin = torch.from_numpy(rng.standard_normal((B, C)).astype(np.float32)).to(dev)
        route = plan_recurrence(B, S, C, n_sms).route
        before = dict(diag_recurrence.launches_by_pass)
        h_all, h_fin = diag_recurrence(a, b, h0)
        grads = torch.autograd.grad((h_all, h_fin), (a, b, h0), (g_all, g_fin))
        torch.cuda.synchronize()
        assert diag_recurrence.launches_by_pass["backward"] == before["backward"] + 1
        r_all, r_fin = diag_recurrence_plain(a, b, h0)
        ref = torch.autograd.grad((r_all, r_fin), (a, b, h0), (g_all, g_fin))
        for name, g, r in zip(("a", "b", "h0"), grads, ref):
            bound = 1e-4 * float(r.abs().max())
            assert float((g - r).abs().max()) <= bound, (name, route)


@pytest.mark.gpu
def test_fleet_scan_kernel_bitwise_equals_plain():
    """Every group of a CSR batch, at lengths around the reference's pad
    buckets, under a tight and a loose keep-alive: all six outputs bitwise."""
    dev = _card()
    rng = np.random.default_rng(3)
    lengths = [1, 2, 63, 64, 65, 128, 1000, 5]
    groups = [np.cumsum(np.where(rng.random(n) < 0.1, rng.exponential(20.0, n),
                                 rng.exponential(0.03, n))) for n in lengths]
    offsets = torch.from_numpy(np.r_[0, np.cumsum(lengths)].astype(np.int64))
    t = torch.from_numpy(np.concatenate(groups))
    for ka in (0.02, 15.0):
        consts = (2.0, 1.39, 2.0 / 60.0, 1.39 / 60.0, ka)
        before = fleet_scan.launches
        got = fleet_scan(t.to(dev), offsets.to(dev), *consts)
        torch.cuda.synchronize()
        assert fleet_scan.launches == before + 1
        want = fleet_scan_plain(t, offsets, *consts)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and torch.equal(g.cpu(), w)
        n_cold, n_queued = int(want[4].sum()), int(want[5].sum())
        assert n_cold > len(lengths) and n_queued > 0 and n_cold + n_queued < len(t), \
            "a branch of the recursion went untested"


@pytest.mark.gpu
@pytest.mark.parametrize("case", list(scan_cases(SEGMENT, WARMUP)))
def test_fleet_scan_segments_bitwise_equal_plain(case):
    """The segmented kernel on the CPU model test's batches (lengths around a
    segment, groups shorter than the warm-up, a group queued throughout, a
    segment boundary inside a burst), at the batch's own segment and warm-up,
    at the defaults, and at W = 0 with segments of 4: all six outputs bitwise
    the plain version's, one counted call each, and pass 2's rewrites where
    guessed carries must be wrong."""
    dev = _card()
    groups, ka, segment, warmup = scan_cases(SEGMENT, WARMUP)[case]
    t, offsets = scan_csr(groups)
    consts = scan_consts(ka)
    want = fleet_scan_plain(t, offsets, *consts)
    repaired = {}
    for cut in ((segment, warmup), (SEGMENT, WARMUP), (4, 0)):
        before = fleet_scan.launches
        got = fleet_scan(t.to(dev), offsets.to(dev), *consts, segment=cut[0], warmup=cut[1])
        torch.cuda.synchronize()
        assert fleet_scan.launches == before + 1
        last = fleet_scan.last
        assert last["launches"] >= 1 + last["rounds"] and last["rounds"] >= 1
        for name, g, w in zip(("sample", "wait", "start", "exp2", "cold", "queued"),
                              got, want):
            assert g.dtype == w.dtype and torch.equal(g.cpu(), w), (case, cut, name)
        repaired[cut] = last["repaired"]
    if case in ("all_queued", "w0_small_S", "busy_boundary", "defaults"):
        assert repaired[(segment, warmup)] > 0, repaired
    assert repaired[(4, 0)] > 0, repaired
