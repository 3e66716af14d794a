"""The ``fleet_scan`` kernel's plain version against the JAX package's
``lax.scan`` (``repro.core.fleet_vec._get_scan_fn`` / ``_solve_group_scan``)
and its numpy solver (``_solve_group``).

Tolerance: bit identity on all six outputs and on the per-group
``(n_cold, n_warm_imm, n_disp, recs)`` tuples. Lengths 63, 64, 65 and 128
straddle the reference's power-of-two pad buckets (at least 64).

One exception, in the reference: XLA on the CPU contracts the lax.scan's
``(start - t) * 60.0 + svc`` into one fused multiply-add, so a queued
arrival's latency sample can differ from the numpy solver's (and the event
engine's) in its last bit. The port rounds each operation as the numpy
solver does: its samples are held bitwise to ``_solve_group``, and where the
lax.scan's differ, they are shown to be exactly the fused rounding.
"""
from fractions import Fraction

import numpy as np
import pytest
import torch

import repro.core.fleet_vec as jvec
from repro_torch.core import fleet_vec as tvec
from repro_torch.kernels.fleet_scan import fleet_scan, fleet_scan_plain
from tests._torch_parity import reference_lax_scan

LENGTHS = [1, 2, 63, 64, 65, 128]
#: keep-alives (minutes): tight (most arrivals cold) and loose (warm, queued)
KEEP_ALIVE = {"tight": 0.02, "loose": 15.0}
WARM_S, COLD_S = 2.0, 1.39       # a warm service longer than the mean gap: queues form


def _group(rng, L):
    """Bursts of gaps under a warm service, and one gap in ten long enough to
    outlive a keep-alive: cold, queued and warm arrivals all occur."""
    gaps = np.where(rng.random(L) < 0.1, rng.exponential(20.0, L), rng.exponential(0.03, L))
    return np.cumsum(gaps)


def _consts(ka):
    return WARM_S, COLD_S, WARM_S / 60.0, COLD_S / 60.0, ka


def _reference(fn, t_g, ka):
    pad = 1 << max(6, int(len(t_g) - 1).bit_length())
    tp = np.full(pad, np.inf)
    tp[:len(t_g)] = t_g
    return [np.asarray(a)[:len(t_g)] for a in fn(tp, *_consts(ka))]


def _csr(groups):
    offsets = np.zeros(len(groups) + 1, np.int64)
    np.cumsum([len(g) for g in groups], out=offsets[1:])
    return torch.from_numpy(np.concatenate(groups)), torch.from_numpy(offsets)


def _numpy_solver(t_g, ka):
    """The reference's numpy solver on one cap=1 group: (samples, waits)."""
    samples, waits = np.full(len(t_g), np.nan), np.full(len(t_g), np.nan)
    jvec._solve_group(t_g, np.arange(len(t_g)), 1, WARM_S, COLD_S, ka, samples,
                      waits, False)
    return samples, waits


@pytest.mark.parametrize("ka", list(KEEP_ALIVE))
@pytest.mark.parametrize("L", LENGTHS)
def test_plain_equals_reference_lax_scan(L, ka, monkeypatch):
    fn = reference_lax_scan(monkeypatch)
    t_g = _group(np.random.default_rng(L), L)
    ka_min = KEEP_ALIVE[ka]
    j_sample, j_wait, j_start, j_cold, j_queued, j_exp2 = _reference(fn, t_g, ka_min)
    sample, wait, start, exp2, cold, queued = (
        o.numpy() for o in fleet_scan_plain(*_csr([t_g]), *_consts(ka_min)))
    for got, want in ((wait, j_wait), (start, j_start), (exp2, j_exp2)):
        assert got.dtype == want.dtype == np.float64
        assert got.tobytes() == want.tobytes()
    assert np.array_equal(cold.astype(bool), j_cold)
    assert np.array_equal(queued.astype(bool), j_queued)
    n_samples, n_waits = _numpy_solver(t_g, ka_min)
    assert sample.tobytes() == n_samples.tobytes()
    assert wait.tobytes() == n_waits.tobytes()
    svc = np.where(cold.astype(bool), COLD_S, WARM_S)
    for i in np.flatnonzero(sample != j_sample):    # the lax.scan's fused rounding
        fused = float(Fraction(float(start[i] - t_g[i])) * 60 + Fraction(float(svc[i])))
        assert j_sample[i] == fused, i
    if L >= 63:
        n_cold, n_queued = int(cold.sum()), int(queued.sum())
        assert n_cold > 1 and n_queued > 0, "a branch of the recursion went untested"
        if ka == "loose":
            assert L - n_cold - n_queued > 0, "no arrival found its instance warm"


@pytest.mark.parametrize("ka", list(KEEP_ALIVE))
def test_one_batch_equals_each_group_alone(ka, monkeypatch):
    """All groups in one CSR batch give the reference's per-group solver
    tuples (``_solve_group_scan``), its waits, and its numpy solver's
    samples, group by group."""
    reference_lax_scan(monkeypatch)
    rng = np.random.default_rng(7)
    groups = [_group(rng, L) for L in LENGTHS + [5, 300]]
    t_all = np.concatenate(groups)
    n = len(t_all)
    # the engine's layout: order2 lists arrival indices group after group
    order2 = rng.permutation(n)
    all_t = np.empty(n)
    all_t[order2] = t_all
    segs = np.split(order2, np.cumsum([len(g) for g in groups])[:-1])
    ka_min = KEEP_ALIVE[ka]
    j_samples, j_waits = np.full(n, np.nan), np.full(n, np.nan)
    want = [jvec._solve_group_scan(all_t[s], s.tolist(), *_consts(ka_min)[:4], ka_min,
                                   j_samples, j_waits) for s in segs]
    t_samples, t_waits = np.full(n, np.nan), np.full(n, np.nan)
    got = tvec._solve_groups_scan(all_t, order2, segs, WARM_S, COLD_S, ka_min,
                                  t_samples, t_waits, torch.device("cpu"))
    assert got == want
    assert j_waits.tobytes() == t_waits.tobytes()
    n_samples = np.full(n, np.nan)
    for s in segs:
        n_samples[s] = _numpy_solver(all_t[s], ka_min)[0]
    assert n_samples.tobytes() == t_samples.tobytes()


def test_wrapper_runs_the_plain_version_on_cpu_tensors():
    t, offsets = _csr([_group(np.random.default_rng(0), L) for L in (3, 70)])
    before = fleet_scan.launches
    got = fleet_scan(t, offsets, *_consts(15.0))
    want = fleet_scan_plain(t, offsets, *_consts(15.0))
    assert fleet_scan.launches == before
    assert [g.dtype for g in got] == [torch.float64] * 4 + [torch.uint8] * 2
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_wrapper_refuses_other_types():
    t, offsets = _csr([np.arange(4.0)])
    with pytest.raises(TypeError, match="float64"):
        fleet_scan(t.float(), offsets, *_consts(15.0))
    with pytest.raises(TypeError, match="int64"):
        fleet_scan(t, offsets.int(), *_consts(15.0))
    for bad in ([0, 3], [1, 4], [0, 3, 2, 4]):
        with pytest.raises(ValueError, match="offsets"):
            fleet_scan(t, torch.tensor(bad), *_consts(15.0))
