"""Vectorized batch fleet engine, bit-identical to the event engine.

Port of ``repro.core.fleet_vec``. ``engine="fleet_vec"`` is a batch
reformulation of the discrete-event drain in :mod:`repro_torch.core.fleet`:
arrivals are decomposed into independent ``(worker, function)`` streams, each
solved on flat numpy arrays, with an optional scan path
(``REPRO_FLEET_VEC_SCAN=1`` or ``scan=True``) for ``cap=1`` groups. Where the
reference runs that path as one jitted ``jax.lax.scan`` per group, the port
gathers every group of the call into one CSR batch and solves them all in one
launch of the CUDA kernel ``fleet_scan`` (``kernels/fleet_scan``), on
``device`` (``cuda`` unless the caller passes ``"cpu"``, where the kernel's
plain version runs). The contract is **bit identity**, not approximation:
per-request latency/wait sample arrays, every counter, and every FP
accumulation are reproduced exactly (sha256-equal sample buffers — the
differential suite in ``tests/test_fleet_equiv.py`` enforces it across
placement x caps x page model x prewarm configs for the reference, and
``tests/test_torch_simulation.py`` holds the port to the reference).

Why decomposition is sound (the static-routing theorem)
-------------------------------------------------------
Inside the fast-path domain (below), every invocation of a function routes
to a statically known worker, so per-function streams never interact:

* single worker: trivially static;
* ``affinity`` + warmswap/prebaking: the provider setup phase
  (:func:`repro_torch.core.fleet._seed_home_residents`, shared with the event
  engine) makes exactly one worker hold the function's resident key. The
  placement chain then keeps all activity there by induction: warm
  instances only ever exist on the home worker, and the residency signal
  (boolean ``holds`` or, under the page model, a *strictly* cheaper local
  transfer) picks the home for every cold start;
* ``round_robin`` + baseline: the rotation is a pure function of the
  arrival index, and baseline holds nothing, so no ledger state feeds back.

Everything outside the domain — non-trivial pre-warm policies (spawn events
read fleet-wide load), bounded cluster caches (evictions are global),
load-coupled placements, degenerate page models (cost ties fall through to
the load signal), setup phases that overflow worker pool capacity — falls
back to :func:`repro_torch.core.fleet._simulate_fleet_impl` verbatim, so the
engine is *always* exact; the fast path is a JIT-style bailout design.
:func:`fast_path_reason` reports why a config fell back (``None`` = fast).

Within one group the solver alternates two regimes:

* **vectorized warm runs** — while every arrival is warm-served, the engine
  serves the idle instance with minimum ``(busy_until, creation pos)``;
  since each service pushes a *monotonically increasing* value
  ``t + warm_s/60``, the service heap drains FIFO and the served
  ``busy_until`` sequence is exactly the sorted merge of the current
  instance states with the shifted arrival stream. One ``np.sort`` +
  two comparisons validate an arbitrarily long run (windowed, geometrically
  grown); survivors' identities resolve by walking pop chains backward;
* **scalar steps** — cold starts, queue joins, FIFO dispatches and
  keep-alive prunes replay the event engine's exact arithmetic one arrival
  at a time (identical FP expression shapes: ``(start - req_t) * 60.0``,
  ``start + svc_s / 60.0``, ``busy_until + keep_alive``).

Full window semantics and the equivalence contract live in
docs/SIMULATION.md ("Vectorized engine").
"""
from __future__ import annotations

import os
from collections import deque
from typing import Dict, List, Optional, Union

import numpy as np
import torch

from repro_torch.core.fleet import (FleetConfig, FleetResult, _make_policy,
                              _seed_home_residents, _simulate_fleet_impl,
                              _Worker)
from repro_torch.core.keepalive import PrewarmPolicy
from repro_torch.core.pool import ClusterImageCache
from repro_torch.core.sanitize import FleetSanitizer, sanitize_enabled
from repro_torch.core.simulator import CostModel, method_cold_latency_s
from repro_torch.core.trace_stream import TraceStream
from repro_torch.core.traces import Trace
from repro_torch.device import DeviceLike, resolve_device

#: Diagnostics for the optional scan path: how many groups the last
#: ``simulate_fleet_vec`` call solved via scan (tests assert it engaged).
SCAN_STATS = {"groups": 0}


def _scan_enabled() -> bool:
    return os.environ.get("REPRO_FLEET_VEC_SCAN", "") == "1"


# --------------------------------------------------------------------- setup
def _build_setup(traces: List[Trace], method: str, cost: CostModel,
                 fleet: FleetConfig):
    """Replicate the event engine's provider setup phase on the *real*
    ledger/cluster objects (so capacities, peaks and eviction counters are
    authoritative), via the shared :func:`_seed_home_residents` helper."""
    workers = [_Worker(i, fleet.worker_capacity_bytes)
               for i in range(fleet.n_workers)]
    fn_image = {t.fn_index: t.image_id for t in traces}
    images = sorted({t.image_id for t in traces})
    page = fleet.page_cost

    def _cluster_evict(key: str) -> None:
        for w in workers:
            w.ledger.evict(key)
    cluster = (ClusterImageCache(fleet.shared_cache_bytes,
                                 on_evict=_cluster_evict)
               if page is not None else None)

    def resident_bytes_of(key: str) -> int:
        return cost.snapshot_bytes if key.startswith("snap:") else cost.image_bytes

    def admit(w: _Worker, key: str) -> None:
        nbytes = resident_bytes_of(key)
        for victim in w.ledger.admit(key, nbytes, now=0.0):
            if cluster is not None:
                cluster.worker_evicted(w.idx, victim)
        if cluster is not None:
            cluster.admit(key, nbytes, w.idx, now=0.0)
            cluster.touch(key, 0.0)

    _seed_home_residents(method, workers, fn_image, images, admit)
    return workers, fn_image, images, cluster


def _setup_capacity_binds(workers: List[_Worker], method: str,
                          fn_image: Dict[int, int], images: List[int],
                          cluster) -> bool:
    """True when the bounded worker pools could not hold the full provider
    setup — residency would then evolve at cold starts (revives, evictions)
    and the static-routing theorem no longer applies."""
    if any(w.ledger.evictions for w in workers):
        return True
    if cluster is not None and (cluster.evictions or cluster.rejected):
        return True
    rank = {img: i for i, img in enumerate(images)}
    n = len(workers)
    for fn, img in fn_image.items():
        key = f"img:{img}" if method == "warmswap" else f"snap:{fn}"
        if method != "baseline" and not workers[rank[img] % n].ledger.holds(key):
            return True
    return False


# --------------------------------------------------------------- domain guard
def fast_path_reason(traces: Union[List[Trace], TraceStream], method: str,
                     cost: CostModel,
                     fleet: Optional[FleetConfig] = None) -> Optional[str]:
    """Why this config needs the event-engine fallback; ``None`` = the
    vectorized fast path is provably bit-identical. Raises the same
    validation errors as the event engine (bad worker counts, shared cache
    without a page model, unknown placement/policy keys). A
    :class:`~repro_torch.core.trace_stream.TraceStream` always falls back: the
    event engine consumes its chunks natively."""
    fleet = fleet if fleet is not None else FleetConfig()
    if fleet.n_workers < 1:
        raise ValueError(f"n_workers must be >= 1, got {fleet.n_workers}")
    if fleet.shared_cache_bytes is not None and fleet.page_cost is None:
        raise ValueError("shared_cache_bytes bounds the page-model cluster "
                         "tier; set FleetConfig.page_cost to enable it")
    if isinstance(fleet.placement, str):
        from repro_torch.serving.scheduler import PLACEMENTS
        PLACEMENTS.build(fleet.placement)   # unknown-key parity with the engine
    if isinstance(traces, TraceStream):
        # The static-routing theorem needs the full function->image map and
        # the provider setup phase up front; a stream only reveals arrivals
        # chunk by chunk, so routing cannot be statically known from a
        # stream prefix. The event engine consumes chunks natively.
        return ("streamed traces: routing cannot be statically known from "
                "a stream prefix")
    if fleet.disruption is not None and fleet.disruption.events:
        if fleet.disruption.n_workers != fleet.n_workers:
            raise ValueError(
                f"disruption schedule was built for "
                f"{fleet.disruption.n_workers} worker(s) but the fleet has "
                f"{fleet.n_workers}; rebuild it with the fleet's shape")
        return ("fleet disruption schedule: worker churn and eviction "
                "storms couple all request streams")
    policy = _make_policy(fleet)
    if type(policy) is not PrewarmPolicy:
        return "non-trivial pre-warm policy: spawn placement reads fleet load"
    if fleet.shared_cache_bytes is not None:
        return "bounded cluster-shared cache: evictions couple all workers"
    page = fleet.page_cost
    if fleet.n_workers > 1:
        if not isinstance(fleet.placement, str):
            return "custom placement callable: routing not statically known"
        if fleet.placement == "affinity" and method in ("warmswap", "prebaking"):
            if page is not None:
                nbytes = (cost.image_bytes if method == "warmswap"
                          else cost.snapshot_bytes)
                local = page.transfer_blocking_s("local", image_bytes=nbytes)
                if not (local < page.transfer_blocking_s("remote",
                                                         image_bytes=nbytes)
                        and local < page.transfer_blocking_s("miss",
                                                             image_bytes=nbytes)):
                    return ("page model does not strictly favor the home "
                            "worker: placement ties break on fleet load")
        elif fleet.placement == "round_robin" and method == "baseline":
            pass                            # rotation is arrival-index-static
        else:
            return (f"placement {fleet.placement!r} with method {method!r} "
                    f"routes by fleet-wide load")
    if fleet.worker_capacity_bytes is not None and method != "baseline":
        workers, fn_image, images, cluster = _build_setup(traces, method,
                                                          cost, fleet)
        if _setup_capacity_binds(workers, method, fn_image, images, cluster):
            return ("worker pool capacity binds during provider setup: "
                    "residency evolves at cold starts")
    return None


# ------------------------------------------------------------------ cap=1 scan
def _solve_groups_scan(all_t: np.ndarray, order2: np.ndarray, segs: list,
                       warm_s: float, cold_s: float, ka: float,
                       samples: np.ndarray, waits: np.ndarray,
                       device: torch.device) -> list:
    """Every cap=1 group of a call in one ``fleet_scan`` launch: each group
    is the Lindley recursion on a single rotating instance (queued requests
    chain through the carried ``free`` time in FIFO order). ``segs`` splits
    ``order2``, so the CSR batch is ``all_t[order2]`` cut at the segment
    sizes. Returns one ``(n_cold, n_warm_imm, n_disp, recs)`` tuple per
    segment, as the scalar/vector solver returns for it."""
    from repro_torch.kernels.fleet_scan import fleet_scan

    wm = warm_s / 60.0
    cold60 = cold_s / 60.0
    sizes = np.fromiter((len(seg) for seg in segs), np.int64, len(segs))
    offsets = np.zeros(len(segs) + 1, np.int64)
    np.cumsum(sizes, out=offsets[1:])
    t_cat = all_t[order2]
    outs = fleet_scan(torch.from_numpy(t_cat).to(device),
                      torch.from_numpy(offsets).to(device),
                      warm_s, cold_s, wm, cold60, ka)
    sample, wait, start, exp2, cold, queued = (o.cpu().numpy() for o in outs)
    samples[order2] = sample
    waits[order2] = wait
    cold = cold.astype(bool)
    queued = queued.astype(bool)
    # Every group opens with a cold start, so a tenure (cold .. next cold - 1)
    # never crosses a group boundary: one pass over the batch finds them all.
    n = len(t_cat)
    cpos = np.flatnonzero(cold)
    last = np.r_[cpos[1:] - 1, n - 1]
    recs_all = list(zip(exp2[last].tolist(), start[last].tolist(),
                        np.where(queued[last], 0, 2).tolist(),
                        order2[last].tolist(), t_cat[cpos].tolist(),
                        order2[cpos].tolist()))
    cuts = np.searchsorted(cpos, offsets).tolist()
    n_disp = np.add.reduceat(queued.astype(np.int64), offsets[:-1])
    out = []
    for g in range(len(segs)):
        nc = cuts[g + 1] - cuts[g]
        nd = int(n_disp[g])
        out.append((nc, int(sizes[g]) - nc - nd, nd,
                    recs_all[cuts[g]:cuts[g + 1]]))
    # Diagnostics counter, reset per simulate_fleet_vec call; never feeds
    # results.  # repro-lint: allow[module-mutable]
    SCAN_STATS["groups"] += len(segs)
    return out


# --------------------------------------------------------------- group solver
def _solve_group(t_g: np.ndarray, g_idx: np.ndarray, cap: Optional[int],
                 warm_s: float, cold_s: float, ka: float,
                 samples: np.ndarray, waits: np.ndarray):
    """Solve one independent ``(worker, fn)`` stream.

    Returns ``(n_cold, n_warm_imm, n_disp, recs)`` where ``recs`` holds one
    tuple per instance lifetime:
    ``(final_expires, sk_time, sk_kind, sk_idx, created_t, created_idx)``
    (``sk_*`` keys the instance's last service — the event engine's expiry
    push order — so residency can be re-accumulated in exact retire order).
    """
    wm = warm_s / 60.0
    cold60 = cold_s / 60.0
    L = len(t_g)
    tl = t_g.tolist()
    gl = g_idx.tolist()
    # live instances, creation order (list position is the engine's
    # tie-break pos): [busy_until, created, expires, sk_t, sk_k, sk_i, cidx]
    B: List[list] = []
    recs: List[tuple] = []
    pending: deque = deque()                      # FIFO queue: (req_t, req_idx)
    n_cold = n_warm = n_disp = 0
    i = 0
    streak = 0          # consecutive immediate-warm serves; long streaks hand
                        # off to the vectorized run (short ones stay scalar —
                        # the numpy window overhead would dominate them)

    def flush(inst: list) -> None:
        recs.append((inst[2], inst[3], inst[4], inst[5], inst[1], inst[6]))

    while i < L:
        t_i = tl[i]
        if streak >= 24 and not pending and B:
            bu0 = B[0][0]
            for inst in B:
                if inst[0] < bu0:
                    bu0 = inst[0]
            if bu0 <= t_i and bu0 + ka >= t_i:
                # ---- vectorized warm run: serving the min-(busy_until, pos)
                # instance pushes monotone values t+wm, so the service heap
                # drains FIFO: the m-th served busy_until is the m-th order
                # statistic of {current states} u {t[i..i+m-1] + wm}. Later
                # pushes can never undercut earlier pops, so sorting the
                # whole window is safe; validate in geometrically grown
                # windows until the first non-warm arrival breaks the run.
                k = len(B)
                border = sorted(range(k), key=lambda j: (B[j][0], j))
                b_vals = np.array([B[j][0] for j in border])
                win, R = 256, -1
                while R < 0:
                    c = min(win, L - i)
                    cand = np.concatenate([b_vals, t_g[i:i + c - 1] + wm]) \
                        if c > 1 else b_vals
                    P = np.sort(cand, kind="stable")[:c]
                    a = t_g[i:i + c]
                    bad = np.flatnonzero(~((P <= a) & (P + ka >= a)))
                    if bad.size:
                        R = int(bad[0])
                    elif c == L - i:
                        R = c
                    else:
                        win *= 8
                if R > 0:
                    g = g_idx[i:i + R]
                    samples[g] = warm_s
                    waits[g] = 0.0
                    n_warm += R
                    # survivors: last k candidates; walk pop chains back to
                    # the original instance each final state belongs to
                    cand = np.concatenate([b_vals, t_g[i:i + R] + wm])
                    A = np.argsort(cand, kind="stable").tolist()
                    for c in A[R:]:
                        final = c
                        while c >= k:
                            c = A[c - k]
                        if final >= k:            # else: never served in run
                            j = final - k
                            inst = B[border[c]]
                            tm = tl[i + j]
                            inst[0] = tm + wm
                            inst[2] = inst[0] + ka
                            inst[3], inst[4], inst[5] = tm, 2, gl[i + j]
                    i += R
                    streak = 0
                    continue
        # -------- scalar step: exact event-engine replay for one arrival
        # 1. INSTANCE_FREE events at or before t dispatch the FIFO queue
        #    (while requests wait, no instance ever idles, so these strictly
        #    precede any prune)
        if pending:
            while pending:
                jm = 0
                for j in range(1, len(B)):
                    if B[j][0] < B[jm][0]:
                        jm = j
                inst = B[jm]
                ev_t = inst[0]
                if ev_t > t_i:
                    break
                req_t, ridx = pending.popleft()
                wait_s = (ev_t - req_t) * 60.0
                samples[ridx] = wait_s + warm_s
                waits[ridx] = wait_s
                inst[0] = ev_t + wm
                inst[2] = inst[0] + ka
                inst[3], inst[4], inst[5] = ev_t, 0, ridx
                n_disp += 1
        # 2+3. one fused scan: the min-(busy_until, pos) instance also has
        # the min keep-alive expiry (expires == busy_until + ka throughout),
        # so pruning is needed iff ITS expiry passed strictly before t (an
        # expiry AT t ranks after the arrival and stays alive); otherwise it
        # is directly the engine's idle pick (strict-min busy_until in
        # creation order) when free
        best = -1
        if B:
            best = 0
            for j in range(1, len(B)):
                if B[j][0] < B[best][0]:
                    best = j
            if B[best][2] < t_i:
                for inst in B:
                    if inst[2] < t_i:
                        flush(inst)
                B = [inst for inst in B if inst[2] >= t_i]
                best = -1
                for j, inst in enumerate(B):
                    if best < 0 or inst[0] < B[best][0]:
                        best = j
            if best >= 0 and B[best][0] > t_i:
                best = -1                        # everyone busy
        gi = gl[i]
        if best >= 0:
            inst = B[best]
            inst[0] = t_i + wm
            inst[2] = inst[0] + ka
            inst[3], inst[4], inst[5] = t_i, 2, gi
            samples[gi] = warm_s
            waits[gi] = 0.0
            n_warm += 1
            streak += 1
        elif B and cap is not None and len(B) >= cap:
            pending.append((t_i, gi))
            streak = 0
        else:
            bu = t_i + cold60
            samples[gi] = cold_s                 # == 0.0 wait + cold_s
            waits[gi] = 0.0
            B.append([bu, t_i, bu + ka, t_i, 2, gi, gi])
            n_cold += 1
            streak = 0
        i += 1
    # drain the queue past the last arrival (the event heap drains fully),
    # then account every surviving instance's final lifetime
    while pending:
        jm = 0
        for j in range(1, len(B)):
            if B[j][0] < B[jm][0]:
                jm = j
        inst = B[jm]
        ev_t = inst[0]
        req_t, ridx = pending.popleft()
        wait_s = (ev_t - req_t) * 60.0
        samples[ridx] = wait_s + warm_s
        waits[ridx] = wait_s
        inst[0] = ev_t + wm
        inst[2] = inst[0] + ka
        inst[3], inst[4], inst[5] = ev_t, 0, ridx
        n_disp += 1
    for inst in B:
        flush(inst)
    return n_cold, n_warm, n_disp, recs


# -------------------------------------------------------------------- engine
def _simulate_fleet_vec_impl(traces: List[Trace], method: str,
                             cost: CostModel, fleet: FleetConfig,
                             use_scan: bool,
                             sanitizer: Optional["FleetSanitizer"] = None,
                             device: DeviceLike = None) -> FleetResult:
    # the scan covers cap=1 groups only; other caps ignore the switch, as in
    # the reference. Resolved first, so a missing card raises before any work.
    scan_dev = (resolve_device(device)
                if use_scan and fleet.max_instances_per_fn == 1 else None)
    san = sanitizer
    if san is None and sanitize_enabled():
        san = FleetSanitizer("fleet_vec", method)
    workers, fn_image, images, cluster = _build_setup(traces, method, cost,
                                                      fleet)
    page = fleet.page_cost
    policy = _make_policy(fleet)
    idle_bytes = {"warmswap": cost.metadata_bytes,
                  "prebaking": cost.snapshot_bytes,
                  "baseline": cost.image_bytes}[method]
    ka = policy.keep_alive_min(0, image_bytes=idle_bytes)
    warm_s = cost.warm_s
    cap = fleet.max_instances_per_fn
    n_workers = fleet.n_workers
    # cold latency is constant across the fast-path domain: residency never
    # changes after setup, so warmswap/prebaking always cold-start from the
    # local tier and baseline always rebuilds from source
    if page is None:
        cold_s = method_cold_latency_s(cost, method)
    elif method == "baseline":
        cold_s = page.cold_latency_s("baseline")
    elif method == "warmswap":
        cold_s = page.cold_latency_s("warmswap", tier="local")
    else:
        cold_s = page.cold_latency_s("prebaking", tier="local",
                                     image_bytes=cost.snapshot_bytes)

    res = FleetResult(method=method, n_invocations=0, n_cold=0, n_warm=0,
                      total_latency_s=0.0, memory_bytes=0,
                      n_workers=n_workers)
    fleet_bytes = 0
    for w in workers:
        fleet_bytes += w.ledger.used_bytes()
        if method == "warmswap":
            fleet_bytes += len(w.metadata_fns) * cost.metadata_bytes
    res.memory_bytes = fleet_bytes           # static after setup (in-domain)

    # merged arrival stream: same construction as the event engine
    all_t = np.concatenate([t.arrivals_min for t in traces]) if traces else \
        np.empty((0,))
    all_fn = np.concatenate([np.full(len(t.arrivals_min), t.fn_index, np.int64)
                             for t in traces]) if traces else np.empty((0,), np.int64)
    order = np.argsort(all_t, kind="stable")
    all_t, all_fn = all_t[order], all_fn[order]
    n_req = len(all_t)
    horizon = float(all_t[-1]) if n_req else 0.0
    res.horizon_min = horizon
    samples = np.full(n_req, np.nan)
    waits = np.full(n_req, np.nan)

    # (worker, fn) group decomposition in merged-arrival order
    rank = {img: r for r, img in enumerate(images)}
    rr = n_workers > 1 and isinstance(fleet.placement, str) \
        and fleet.placement == "round_robin"
    if n_req:
        if rr:
            gkey = all_fn * n_workers + (np.arange(n_req, dtype=np.int64)
                                         % n_workers)
        else:
            gkey = all_fn
        order2 = np.argsort(gkey, kind="stable")
        gs = gkey[order2]
        segs = np.split(order2, np.flatnonzero(np.diff(gs)) + 1)
    else:
        segs = []

    n_cold_c = n_warm_c = n_disp_c = 0
    worker_recs: List[List[tuple]] = [[] for _ in workers]
    fn_recs: Dict[int, List[tuple]] = {}
    served = [0] * n_workers
    solved = (_solve_groups_scan(all_t, order2, segs, warm_s, cold_s, ka,
                                 samples, waits, scan_dev)
              if scan_dev is not None and segs else None)
    for s_i, seg in enumerate(segs):
        fn = int(all_fn[seg[0]])
        if n_workers == 1:
            wk = 0
        elif rr:
            wk = int(gkey[seg[0]]) % n_workers
        else:
            wk = rank[fn_image[fn]] % n_workers
        nc, nw, nd, recs = (solved[s_i] if solved is not None else
                            _solve_group(all_t[seg], seg, cap, warm_s, cold_s,
                                         ka, samples, waits))
        n_cold_c += nc
        n_warm_c += nw + nd
        n_disp_c += nd
        served[wk] += len(seg)
        worker_recs[wk].extend(recs)
        fn_recs.setdefault(fn, []).extend(recs)

    if n_req and np.isnan(samples).any():
        raise RuntimeError("fleet engine dropped requests: unfilled latency "
                           "samples after the event loop drained")
    res.latency_samples_s = samples
    res.queue_wait_s = waits
    res.sample_fn = all_fn
    res.n_invocations = n_req
    res.n_cold = n_cold_c
    res.n_warm = n_warm_c
    res.total_latency_s = float(samples.sum())
    res.n_queued = int((waits > 0).sum())
    res.queue_delay_s = float(waits.sum())
    # placement counters reconstruct exactly: every immediately-warm arrival
    # is a warm hit; every other arrival (cold or queued) found the resident
    # key in the chosen worker's pool for warmswap/prebaking (setup seeded
    # it; in-domain it never leaves), and never for baseline
    res.placement_warm_hits = n_warm_c - n_disp_c
    res.placement_pool_hits = 0 if method == "baseline" else \
        n_cold_c + n_disp_c
    if page is not None:
        if method == "baseline":
            res.pages_transferred = n_cold_c * page.image_pages()
        else:
            res.cache_local_hits = n_cold_c
    # peak concurrent instances of any single function: at each cold start
    # (in merged order), alive = instances created so far minus those whose
    # keep-alive expired strictly before it (an expiry AT the arrival time
    # ranks after the arrival and still counts)
    max_conc = 1
    for recs in fn_recs.values():
        m = len(recs)
        cidx = np.array([r[5] for r in recs], np.int64)
        o = np.argsort(cidx, kind="stable")
        created_t = np.array([r[4] for r in recs])[o]
        expires = np.sort(np.array([r[0] for r in recs]), kind="stable")
        alive = np.arange(1, m + 1) - np.searchsorted(expires, created_t,
                                                      side="left")
        mc = int(alive.max())
        if mc > max_conc:
            max_conc = mc
    res.max_concurrent_instances = max_conc
    fns = np.array(sorted({t.fn_index for t in traces}), np.int64)
    slots = np.searchsorted(fns, all_fn)
    lat_sums = np.bincount(slots, weights=samples, minlength=len(fns)) \
        if n_req else np.zeros(len(fns))
    inv_counts = np.bincount(slots, minlength=len(fns)) \
        if n_req else np.zeros(len(fns), np.int64)
    res.per_fn_latency = {int(f): float(s) for f, s in zip(fns, lat_sums)}
    res.per_fn_invocations = {int(f): int(c) for f, c in zip(fns, inv_counts)}
    res.evictions = sum(w.ledger.evictions for w in workers)
    # residency re-accumulates in the engine's retire order — keep-alive
    # expiry heap order, i.e. (expires, last-service seq) per worker — so
    # the FP sum is bit-identical, not just algebraically equal
    for w, recs in zip(workers, worker_recs):
        recs.sort()
        for r in recs:
            w.instance_min += max(0.0, min(r[0], horizon) - r[4])
        w.n_served = served[w.idx]
    res.instance_resident_min = sum(w.instance_min for w in workers)
    if cluster is not None:
        res.shared_cache_peak_bytes = cluster.peak_bytes
        res.shared_cache_evictions = cluster.evictions
    res.per_worker = [{
        "worker": w.idx,
        "served": w.n_served,
        "pool_bytes": w.ledger.used_bytes(),
        "resident": sorted(w.ledger.entries.keys()),
        "metadata_fns": len(w.metadata_fns),
        "evictions": w.ledger.evictions,
        "instance_min": w.instance_min,
    } for w in workers]
    if san is not None:
        san.check_samples(samples, waits)
        san.check_books(workers, cluster)
        san.check_counters(res)
    return res


def simulate_fleet_vec(traces: Union[List[Trace], TraceStream], method: str,
                       cost: CostModel,
                       fleet: Optional[FleetConfig] = None,
                       scan: Optional[bool] = None,
                       sanitizer: Optional["FleetSanitizer"] = None,
                       device: DeviceLike = None) -> FleetResult:
    """Drop-in replacement for :func:`repro_torch.core.fleet.simulate_fleet` with
    identical results (bit-for-bit). Configs outside the vectorizable domain
    (see :func:`fast_path_reason`) run the event engine verbatim. ``scan``
    forces the batched ``fleet_scan`` path on/off (default: the
    ``REPRO_FLEET_VEC_SCAN=1`` env knob; cap=1 groups only). With the scan
    on, the batch runs on ``device``: ``cuda`` unless the caller passes
    ``"cpu"`` (the kernel's plain version); with no card the call raises
    rather than fall back to the numpy solver. ``sanitizer``
    threads a :class:`repro_torch.core.sanitize.FleetSanitizer` through whichever
    engine runs (built automatically under ``REPRO_SANITIZE=1``)."""
    fleet = fleet if fleet is not None else FleetConfig()
    SCAN_STATS["groups"] = 0      # repro-lint: allow[module-mutable]
    if fast_path_reason(traces, method, cost, fleet) is not None:
        return _simulate_fleet_impl(traces, method, cost, fleet,
                                    sanitizer=sanitizer)
    use_scan = _scan_enabled() if scan is None else scan
    return _simulate_fleet_vec_impl(traces, method, cost, fleet, use_scan,
                                    sanitizer=sanitizer, device=device)
