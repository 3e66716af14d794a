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
from hypothesis import given, settings
from hypothesis import strategies as st

from repro_torch.kernels.fleet_scan import fleet_scan, fleet_scan_plain
from repro_torch.kernels.fleet_scan.ops import SEGMENT, WARMUP, segment_prefix
from tests._torch_parity import (SCAN_SERVICE, queued_group, reference_lax_scan, scan_cases,
                                 scan_consts, scan_csr, scan_group)

LENGTHS = [1, 2, 63, 64, 65, 128]
#: keep-alives (minutes): tight (most arrivals cold) and loose (warm, queued)
KEEP_ALIVE = {"tight": 0.02, "loose": 15.0}
WARM_S, COLD_S = SCAN_SERVICE    # a warm service longer than the mean gap: queues form


def _reference(fn, t_g, ka):
    pad = 1 << max(6, int(len(t_g) - 1).bit_length())
    tp = np.full(pad, np.inf)
    tp[:len(t_g)] = t_g
    return [np.asarray(a)[:len(t_g)] for a in fn(tp, *scan_consts(ka))]


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
    t_g = scan_group(np.random.default_rng(L), L)
    ka_min = KEEP_ALIVE[ka]
    j_sample, j_wait, j_start, j_cold, j_queued, j_exp2 = _reference(fn, t_g, ka_min)
    sample, wait, start, exp2, cold, queued = (
        o.numpy() for o in fleet_scan_plain(*scan_csr([t_g]), *scan_consts(ka_min)))
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
    groups = [scan_group(rng, L) for L in LENGTHS + [5, 300]]
    t_all = np.concatenate(groups)
    n = len(t_all)
    # the engine's layout: order2 lists arrival indices group after group
    order2 = rng.permutation(n)
    all_t = np.empty(n)
    all_t[order2] = t_all
    segs = np.split(order2, np.cumsum([len(g) for g in groups])[:-1])
    ka_min = KEEP_ALIVE[ka]
    j_samples, j_waits = np.full(n, np.nan), np.full(n, np.nan)
    want = [jvec._solve_group_scan(all_t[s], s.tolist(), *scan_consts(ka_min)[:4], ka_min,
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
    t, offsets = scan_csr([scan_group(np.random.default_rng(0), L) for L in (3, 70)])
    before = fleet_scan.launches
    got = fleet_scan(t, offsets, *scan_consts(15.0))
    want = fleet_scan_plain(t, offsets, *scan_consts(15.0))
    assert fleet_scan.launches == before
    assert [g.dtype for g in got] == [torch.float64] * 4 + [torch.uint8] * 2
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_wrapper_refuses_other_types():
    t, offsets = scan_csr([np.arange(4.0)])
    with pytest.raises(TypeError, match="float64"):
        fleet_scan(t.float(), offsets, *scan_consts(15.0))
    with pytest.raises(TypeError, match="int64"):
        fleet_scan(t, offsets.int(), *scan_consts(15.0))
    for bad in ([0, 3], [1, 4], [0, 3, 2, 4]):
        with pytest.raises(ValueError, match="offsets"):
            fleet_scan(t, torch.tensor(bad), *scan_consts(15.0))


# ---------------------------------------------------------------------------------
# The card's two-pass design, modelled step by step in numpy
# ---------------------------------------------------------------------------------

def _step(carry, ti, warm_s, cold_s, wm, cold60, ka):
    """One arrival of the recursion on Python floats (each operation rounded
    to nearest on its own, as the kernel's intrinsics round)."""
    alive, free, exp = carry
    alive2 = alive and exp >= ti
    q = alive2 and free > ti
    st_ = free if q else ti
    w = (st_ - ti) * 60.0
    s = w + (warm_s if alive2 else cold_s)
    f2 = st_ + (wm if alive2 else cold60)
    e2 = f2 + ka
    return (True, f2, e2), (s, w, st_, e2, 0 if alive2 else 1, 1 if q else 0)


def _bits(x: float) -> bytes:
    return np.float64(x).tobytes()


def _two_pass_model(t, offsets, consts, segment, warmup):
    """The kernel's algorithm (``csrc/fleet_scan.cu``), one segment at a time
    where the card runs one thread a segment: pass 1 from a true or guessed
    carry after ``warmup`` warm-up arrivals, then rounds of pass 2 that each
    read a snapshot of the exit carries taken before them. Returns the six
    outputs and ``{"rounds", "repaired", "merged", "ran_off"}``."""
    wm, ka = consts[2], consts[4]
    t = t.tolist()
    n = len(t)
    seg_lo, seg_glo = [], []                 # segment j: [seg_lo[j], seg_lo[j + 1])
    for glo, ghi in zip(offsets[:-1].tolist(), offsets[1:].tolist()):
        for lo in range(glo, ghi, segment):
            seg_lo.append(lo)
            seg_glo.append(glo)
    seg_lo.append(n)
    n_seg = len(seg_glo)
    out = [[0.0] * n for _ in range(4)] + [[0] * n for _ in range(2)]
    entry, exits = [0.0] * n_seg, [0.0] * n_seg
    for j in range(n_seg):                                     # pass 1
        lo, hi, glo = seg_lo[j], seg_lo[j + 1], seg_glo[j]
        carry, w0 = (False, 0.0, 0.0), lo - warmup
        if w0 - 1 >= glo:
            free = t[w0 - 1] + wm                  # arrival w0 - 1 warm, not queued
            carry = (True, free, free + ka)
        else:
            w0 = glo
        for i in range(w0, lo):
            carry, _ = _step(carry, t[i], *consts)
        entry[j] = carry[1]
        for i in range(lo, hi):
            carry, o = _step(carry, t[i], *consts)
            for a in range(6):
                out[a][i] = o[a]
        exits[j] = carry[1]
    stats = {"rounds": 0, "repaired": 0, "merged": 0, "ran_off": 0}
    changed = [1] * n_seg
    while True:                                                # pass 2
        stats["rounds"] += 1
        snap, snap_changed = list(exits), changed
        changed = [0] * n_seg
        for j in range(n_seg):
            lo, hi, glo = seg_lo[j], seg_lo[j + 1], seg_glo[j]
            if lo == glo or not snap_changed[j - 1]:
                continue
            x = snap[j - 1]
            if _bits(x) == _bits(entry[j]):
                continue
            entry[j] = x
            carry = (True, x, x + ka)
            for i in range(lo, hi):
                before = out[2][i] + (consts[3] if out[4][i] else wm)
                carry, o = _step(carry, t[i], *consts)
                for a in range(6):
                    out[a][i] = o[a]
                stats["repaired"] += 1
                if _bits(carry[1]) == _bits(before):
                    stats["merged"] += 1
                    break
            else:
                stats["ran_off"] += 1
                exits[j] = carry[1]
                changed[j] = int(j + 1 < n_seg and seg_glo[j + 1] == glo)
        if not any(changed):
            break
    return (*(np.array(o, np.float64) for o in out[:4]),
            *(np.array(o, np.uint8) for o in out[4:])), stats


def _hold_to_plain(groups, ka, segment, warmup):
    t, offsets = scan_csr(groups)
    consts = scan_consts(ka)
    got, stats = _two_pass_model(t.numpy(), offsets.numpy(), consts, segment, warmup)
    want = fleet_scan_plain(t, offsets, *consts)
    for name, g, w in zip(("sample", "wait", "start", "exp2", "cold", "queued"), got, want):
        assert g.dtype == w.numpy().dtype and g.tobytes() == w.numpy().tobytes(), name
    return stats, want


@pytest.mark.parametrize("case", list(scan_cases(SEGMENT, WARMUP)))
def test_two_pass_model_equals_plain_bitwise(case):
    """The segmented design's algorithm (guessed carries, repair rounds on
    snapshots) gives the plain version's bits on all six outputs. This holds
    the algorithm on the CPU; the kernel itself is held to the plain version
    on the card only (``tests/test_torch_kernels_gpu.py``, ``chip_smoke.py``
    phase 19a), at the same batches."""
    groups, ka, segment, warmup = scan_cases(SEGMENT, WARMUP)[case]
    stats, want = _hold_to_plain(groups, ka, segment, warmup)
    n_queued = int(want[5].sum())
    if case == "all_queued":                 # every segment after the first reruns whole
        assert int(want[5][:200].sum()) == 199
        assert stats["rounds"] >= 200 // segment and stats["ran_off"] >= 200 // segment
        assert stats["repaired"] >= 200 - segment
    elif case == "w0_small_S":               # every kind of round and rerun runs
        assert stats["rounds"] > 1 and stats["merged"] > 0 and stats["ran_off"] > 0
    elif case == "busy_boundary":            # guessed wrong inside a burst, merged after it
        assert stats["repaired"] > 0 and stats["merged"] > 0 and stats["ran_off"] == 0
    elif case == "defaults":
        assert stats["repaired"] > 0
    if case != "around_S_tight":
        assert n_queued > 0


@given(st.integers(0, 2 ** 31 - 1), st.lists(st.integers(1, 60), min_size=1, max_size=6),
       st.integers(1, 12), st.integers(0, 6), st.sampled_from([0.02, 15.0]),
       st.booleans())
@settings(max_examples=40, deadline=None, derandomize=True)
def test_two_pass_model_on_drawn_batches(seed, lengths, segment, warmup, ka, busy):
    """Drawn batches (a fixed seed): group lengths, segment, warm-up,
    keep-alive and how busy the groups run, the model bitwise the plain
    version."""
    rng = np.random.default_rng(seed)
    groups = [queued_group(rng, n) if busy and i % 2 else scan_group(rng, n)
              for i, n in enumerate(lengths)]
    _hold_to_plain(groups, ka, segment, warmup)


def test_segment_prefix_counts_each_group():
    """Group g owns segments seg_first[g] .. seg_first[g + 1] - 1; an empty
    group owns none."""
    _, offsets = scan_csr([np.arange(float(n)) for n in (5, 0, 8, 1, 4)])
    assert segment_prefix(offsets, 4).tolist() == [0, 2, 2, 4, 5, 6]
    assert segment_prefix(offsets, 1).tolist() == [0, 5, 5, 13, 14, 18]
    assert segment_prefix(offsets[:1], 4).tolist() == [0]


def test_wrapper_refuses_a_bad_cut():
    t, offsets = scan_csr([np.arange(4.0)])
    for bad in ({"segment": 0}, {"segment": 2.0}, {"warmup": -1}, {"warmup": True}):
        with pytest.raises(ValueError, match="segment|warmup"):
            fleet_scan(t, offsets, *scan_consts(15.0), **bad)
