"""Multi-worker fleet simulation with concurrency (beyond paper Fig. 7).

Port of ``repro.core.fleet``: the same code with the imports pointed at the
port, so every sample, counter and float sum is bit-identical.

``simulator.simulate()`` is the paper-faithful single-worker model: one instance
per function, an always-resident shared image, static memory accounting. This
module generalizes it into the regime the paper's fleet-level claims actually
live in:

  * **concurrency** — an arrival that finds every instance of its function busy
    spawns a *new* cold/warm instance instead of being serialized;
  * **queueing** — with ``max_instances_per_fn`` set, an at-cap arrival joins a
    per-worker FIFO queue and is dispatched by the instance-free event of the
    next completing instance; its latency = queue delay + warm cost, so tail
    latency under contention is queue-accurate (P99 > mean once requests wait);
  * **N worker nodes** — each with its own Dependency-Manager pool, modeled by
    the same :class:`~repro_torch.core.pool.CapacityLedger` the real manager uses
    (capacity + LRU + refcounts), so images get evicted and revived under
    memory pressure exactly like the live pool;
  * **placement** — invocations are routed by
    :func:`repro_torch.serving.scheduler.place_invocation`: warm-instance affinity,
    then image-affinity (the pool already holds the live image), then
    least-loaded *including queue depth*; round-robin and plain least-loaded
    are available as controls;
  * **pluggable pre-warm policies** (:mod:`repro_torch.core.keepalive`) — fixed
    keep-alive (paper §4.5), histogram-adaptive keep-alive, SPES-style
    predictive pre-warming, and byte-minute-budgeted keep-alive, comparable
    under identical placement. Policies see completion events
    (``on_completion``) and the bytes an idle instance pins, not just
    arrival times;
  * **page-granular cold starts** (``FleetConfig.page_cost``,
    :mod:`repro_torch.core.costmodel`) — cold latency = scalar base + blocking page
    transfer, priced by image pages, link bandwidth, the BULK fault/stream
    mix, and which tier serves the pages: the worker's own pool, a peer
    worker via the **cluster-shared image cache**
    (:class:`repro_torch.core.pool.ClusterImageCache` — each image is fetched from
    source once, then shared fleet-wide), or the source store. Placement
    ranks workers by that transfer cost (``place_invocation(start_cost=...)``).
    The full contract lives in docs/SIMULATION.md.

The engine is a discrete-event simulation (``core/events.py``): one heap of
typed events (instance-free, pre-warm spawn, keep-alive expiry) merged against
the vectorized, pre-sorted arrival stream. Invariants the engine maintains:

  * ``busy_until`` is monotone per instance — a request never starts before
    the previous one on the same instance completed;
  * residency accounting clamps instance lifetimes to the trace horizon
    (the last arrival time), so ``instance_resident_min`` never counts
    keep-alive time the trace window cannot observe;
  * pre-warm spawns scheduled past the horizon are drained and accounted as
    ``prewarm_dropped`` rather than silently lost.

Degenerate case: ``n_workers=1``, unlimited capacity, ``max_instances_per_fn=1``
reproduces ``simulate()`` — including the ~88 % memory-saving headline at
sharing degree 10 (verified in tests/test_fleet.py).
"""
from __future__ import annotations

import copy
from collections import deque
from dataclasses import dataclass, field
from typing import Callable, Deque, Dict, List, Optional, Tuple, Union

import numpy as np

from repro_torch.core.costmodel import PageCostModel
from repro_torch.core.disruption import DisruptionSchedule
from repro_torch.core.events import EventKind, EventQueue
from repro_torch.core.keepalive import PREWARM_POLICIES, PrewarmPolicy
from repro_torch.core.pool import CapacityLedger, ClusterImageCache
from repro_torch.core.sanitize import FleetSanitizer, sanitize_enabled
from repro_torch.core.simulator import (CostModel, latency_percentiles,
                                  method_cold_latency_s)
from repro_torch.core.trace_stream import TraceStream
from repro_torch.core.traces import Trace

# EventKind ranks as plain ints: the hot loop compares and pushes these
# without paying an enum construction or comparison per event
_FREE = int(EventKind.INSTANCE_FREE)
_SPAWN = int(EventKind.PREWARM_SPAWN)
_ARRIVAL = int(EventKind.ARRIVAL)
_EXPIRY = int(EventKind.KEEPALIVE_EXPIRY)
_FAIL = int(EventKind.WORKER_FAIL)
_RECOVER = int(EventKind.WORKER_RECOVER)
_FLUSH = int(EventKind.CACHE_FLUSH)


@dataclass
class FleetConfig:
    """Fleet-simulation knobs (times in minutes, sizes in bytes).

    ``page_cost`` switches the engine from scalar cold-start pricing to the
    page-granular model: cold latency becomes a function of image pages, link
    bandwidth, the BULK fault/stream mix, and where the pages come from — the
    worker's own pool (local), a peer worker via the cluster-shared image
    cache (remote), or the source store (miss). ``shared_cache_bytes`` bounds
    that cluster tier; it requires ``page_cost``.
    ``PageCostModel.degenerate(cost)`` (zero per-request latency, infinite
    bandwidth) reproduces the scalar engine's numbers exactly in the
    degenerate configuration — see docs/SIMULATION.md.
    """
    n_workers: int = 1
    placement: Union[str, Callable] = "affinity"
                                           # a serving/scheduler.PLACEMENTS key
                                           # ('affinity' | 'least_loaded' |
                                           # 'round_robin' | any registered
                                           # strategy) or a ready strategy
                                           # callable (workers, ctx) -> worker
    max_instances_per_fn: Optional[int] = None   # None = unbounded concurrency.
                                                 # The cap (and its FIFO queue) is
                                                 # per WORKER: with n_workers=1,
                                                 # cap=1 is simulate()'s serialized
                                                 # model; with several workers,
                                                 # placement may spawn on another
                                                 # worker instead of queueing
    worker_capacity_bytes: Optional[int] = None  # per-worker pool capacity
    prewarm: Union[str, PrewarmPolicy] = "none"  # policy name or ready instance
    keep_alive_min: float = 15.0                 # window for the 'none' policy
    page_cost: Optional[PageCostModel] = None    # page-granular cold pricing
    shared_cache_bytes: Optional[int] = None     # cluster-shared image tier
                                                 # capacity (distinct images);
                                                 # None = unbounded; needs
                                                 # page_cost
    disruption: Optional[DisruptionSchedule] = None
                                                 # worker churn / preemption /
                                                 # eviction-storm schedule
                                                 # (core/disruption.py); its
                                                 # n_workers must match


@dataclass(slots=True)
class _Instance:
    fn: int
    busy_until: float        # minutes; monotone — only ever advanced
    expires: float           # minutes (keep-alive expiry)
    created: float = 0.0
    prewarmed: bool = False
    gen: int = 0             # expiry generation: stale expiry events carry an
                             #   older gen and are dropped on arrival
    killed: bool = False     # worker died: pending free/expiry events for
                             #   this instance are stale and must be ignored
    cur_idx: int = -1        # request index currently (or last) served —
    cur_req_t: float = 0.0   #   and its original arrival time, so a worker
                             #   failure can requeue the in-flight request


class _Worker:
    __slots__ = ("idx", "ledger", "instances", "queues", "metadata_fns",
                 "n_served", "instance_min", "in_flight", "queued_now",
                 "failed")

    def __init__(self, idx: int, capacity_bytes: Optional[int]):
        self.idx = idx
        self.ledger = CapacityLedger(capacity_bytes)
        self.instances: Dict[int, List[_Instance]] = {}
        self.queues: Dict[int, Deque[Tuple[float, int]]] = {}  # fn -> (t, req idx)
        self.metadata_fns: set = set()
        self.failed = False          # down due to a disruption worker_fail
        self.n_served = 0
        self.instance_min = 0.0      # total warm-instance residency (minutes)
        self.in_flight = 0           # requests currently executing; maintained
                                     #   incrementally (begin_service +1,
                                     #   INSTANCE_FREE -1) so placement's load
                                     #   signal is O(1) per decision
        self.queued_now = 0          # requests waiting in self.queues

    def alive(self, fn: int) -> List[_Instance]:
        """Instances of ``fn``; expiry events (not reads) prune this list."""
        return self.instances.get(fn, [])

    def idle_instance(self, fn: int, t: float) -> Optional[_Instance]:
        """The idle instance of ``fn`` with the earliest previous completion,
        or ``None``. Valid at the current simulation time only (events up to
        ``t`` must have been processed)."""
        best = None
        for inst in self.instances.get(fn, ()):
            if inst.busy_until <= t and (best is None
                                         or inst.busy_until < best.busy_until):
                best = inst
        return best

    def load(self, t: float = 0.0) -> int:
        """In-flight requests on this worker. O(1): the engine maintains the
        count incrementally, which equals the number of busy instances at the
        current simulation time (completion events at or before now have
        already fired — the heap ranks ``INSTANCE_FREE`` ahead of arrivals)."""
        return self.in_flight

    def queue_depth(self) -> int:
        return self.queued_now


@dataclass
class FleetResult:
    """One ``simulate_fleet`` run's outputs. Units: latencies/waits in
    seconds, memory in bytes, residency in instance-minutes, migration
    volume in pages; per-field semantics in the inline comments."""
    method: str
    n_invocations: int
    n_cold: int
    n_warm: int
    total_latency_s: float
    memory_bytes: int                    # PEAK fleet-wide resident bytes
    per_fn_latency: Dict[int, float] = field(default_factory=dict)
    per_fn_invocations: Dict[int, int] = field(default_factory=dict)
    n_workers: int = 1
    pool_misses: int = 0                 # cold starts that paid an image revive
    evictions: int = 0
    prewarm_spawns: int = 0
    prewarm_hits: int = 0
    prewarm_dropped: int = 0             # spawn events past the trace horizon
    max_concurrent_instances: int = 1    # peak instances of any SINGLE function
                                         #   (>1 means arrivals overlapped)
    placement_warm_hits: int = 0         # routed to a worker with an idle warm inst
    placement_pool_hits: int = 0         # routed by image residency
    instance_resident_min: float = 0.0   # warm instance-minutes across the fleet,
                                         #   clamped to the trace horizon
    n_queued: int = 0                    # requests that waited for an instance
    queue_delay_s: float = 0.0           # total time requests spent queued
    horizon_min: float = 0.0             # last arrival time (residency clamp)
    cache_local_hits: int = 0            # page-model cold starts served from
                                         #   the worker's own pool (memcpy)
    cache_remote_hits: int = 0           # ... from a peer worker's pool (DCN)
    cache_misses: int = 0                # ... from the source store (fetched
                                         #   once into the shared tier)
    shared_cache_peak_bytes: int = 0     # distinct-image bytes in the cluster
                                         #   tier, high-water mark
    shared_cache_evictions: int = 0      # cluster-wide capacity evictions
    worker_failures: int = 0             # disruption worker_fail events applied
    worker_recoveries: int = 0           # disruption worker_recover events
    cache_flushes: int = 0               # disruption cache_flush storms applied
    requeued: int = 0                    # requests re-submitted by failures
                                         #   (in-flight + queued on the dead
                                         #   worker); under disruption,
                                         #   n_cold + n_warm counts SERVICE
                                         #   STARTS and can exceed
                                         #   n_invocations by up to this
    pages_transferred: int = 0           # pages moved over the NETWORK (remote
                                         #   + source links; local memcpy not
                                         #   counted) by page-model cold starts
    latency_samples_s: np.ndarray = field(
        default_factory=lambda: np.empty(0))   # per request, merged-arrival order
    queue_wait_s: np.ndarray = field(
        default_factory=lambda: np.empty(0))   # per request, merged-arrival order
    sample_fn: np.ndarray = field(
        default_factory=lambda: np.empty(0, np.int64))  # fn index per sample
    per_worker: List[Dict] = field(default_factory=list)

    @property
    def avg_latency_s(self) -> float:
        return self.total_latency_s / max(self.n_invocations, 1)

    def latency_percentiles(self) -> Dict[str, float]:
        """P50/P95/P99 (+ mean/max) over the per-request latency samples."""
        return latency_percentiles(self.latency_samples_s)


def _make_policy(cfg: FleetConfig) -> PrewarmPolicy:
    if isinstance(cfg.prewarm, PrewarmPolicy):
        # copy: policies accumulate arrival history, and reusing the caller's
        # instance across runs would leak state between simulations
        return copy.deepcopy(cfg.prewarm)
    if cfg.prewarm == "none":
        return PrewarmPolicy(keep_alive_min=cfg.keep_alive_min)
    return PREWARM_POLICIES.build(cfg.prewarm)


def _seed_home_residents(method: str, workers: List["_Worker"],
                         fn_image: Dict[int, int], images: List[int],
                         admit: Callable[["_Worker", str], None]) -> None:
    """Provider pre-build phase (paper Fig. 4b), shared by the event engine
    and the vectorized engine (``core/fleet_vec.py``) so home-worker seeding
    can never drift between them: WarmSwap builds each live image once on its
    home worker (image rank modulo fleet size) and registers every function's
    metadata there; Prebaking snapshots every function upfront on the same
    home; Baseline holds nothing. ``admit`` is the engine's resident-admission
    hook (worker pool + cluster tier at t=0)."""
    if method == "warmswap":
        for rank, img in enumerate(images):
            admit(workers[rank % len(workers)], f"img:{img}")
        for fn, img in fn_image.items():
            home = workers[images.index(img) % len(workers)]
            home.metadata_fns.add(fn)
    elif method == "prebaking":
        for fn, img in fn_image.items():
            home = workers[images.index(img) % len(workers)]
            admit(home, f"snap:{fn}")


def simulate_fleet(
    traces: List[Trace],
    method: str,                       # 'warmswap' | 'prebaking' | 'baseline'
    cost: CostModel,
    fleet: Optional[FleetConfig] = None,
) -> FleetResult:
    """Discrete-event fleet simulation (see the module docstring).

    Thin wrapper over the declarative entry point
    (:func:`repro_torch.core.scenario.run` with ``engine='fleet'``): the engine
    body is :func:`_simulate_fleet_impl`, and this signature survives for
    callers that already hold resolved components. New code should build a
    :class:`~repro_torch.core.scenario.Scenario` instead.

    Args:
        traces: per-function arrival traces (times in minutes).
        method: ``'warmswap' | 'prebaking' | 'baseline'``.
        cost: scalar cost model (latencies in seconds, sizes in bytes).
        fleet: :class:`FleetConfig`; ``fleet.page_cost`` switches cold starts
            to the page-granular model with a cluster-shared image cache.

    Returns:
        A :class:`FleetResult`: counts, latency samples (seconds),
        peak resident memory (bytes), queueing/placement/pool stats, and —
        under the page model — shared-cache hit tiers and network page volume.
    """
    # deferred: scenario imports this module (the engine impl lives here)
    from repro_torch.core.scenario import RunOverrides, Scenario, run
    result = run(Scenario(engine="fleet", methods=[method]),
                 overrides=RunOverrides(traces=traces, cost=cost, fleet=fleet))
    return result.raw[method]


def _simulate_fleet_impl(
    traces: Union[List[Trace], TraceStream],
    method: str,
    cost: CostModel,
    fleet: Optional[FleetConfig] = None,
    sanitizer: Optional["FleetSanitizer"] = None,
) -> FleetResult:
    """The discrete-event engine body behind :func:`simulate_fleet` (same
    contract); called by :func:`repro_torch.core.scenario.run`. ``sanitizer``
    threads a :class:`repro_torch.core.sanitize.FleetSanitizer` through the run
    (built automatically under ``REPRO_SANITIZE=1``); its checks are
    assertions only, so a sanitized run returns bit-identical results.

    ``traces`` may be a :class:`~repro_torch.core.trace_stream.TraceStream`: the
    engine then consumes arrival chunks as they are produced (peak arrival
    residency = one chunk) and returns results bit-identical to running the
    stream's ``materialize()`` list (docs/TRACES.md). Disruption schedules
    require a materialized trace (the schedule is built against the horizon,
    which a stream only knows at the end)."""
    fleet = fleet if fleet is not None else FleetConfig()
    san = sanitizer
    if san is None and sanitize_enabled():
        san = FleetSanitizer("fleet", method)
    if fleet.n_workers < 1:
        raise ValueError(f"n_workers must be >= 1, got {fleet.n_workers}")
    if fleet.shared_cache_bytes is not None and fleet.page_cost is None:
        raise ValueError("shared_cache_bytes bounds the page-model cluster "
                         "tier; set FleetConfig.page_cost to enable it")
    is_stream = isinstance(traces, TraceStream)
    disruption = fleet.disruption
    if is_stream and disruption is not None:
        raise ValueError(
            "disruption schedules are built against the trace horizon, which "
            "a stream only knows after its last chunk; materialize the trace "
            "(stream=false) to combine disruption with this workload")
    if disruption is not None and disruption.n_workers != fleet.n_workers:
        raise ValueError(
            f"disruption schedule was built for "
            f"{disruption.n_workers} worker(s) but the fleet has "
            f"{fleet.n_workers}; rebuild it with the fleet's shape")
    # deferred: repro_torch.serving pulls in the model/engine stack, which a
    # simulation-only import of repro.core should not pay for
    from repro_torch.serving.scheduler import (PLACEMENTS, PlacementContext,
                                         place_invocation)
    strategy = (PLACEMENTS.build(fleet.placement)
                if isinstance(fleet.placement, str) else fleet.placement)
    policy = _make_policy(fleet)
    cold_base = method_cold_latency_s(cost, method)
    page = fleet.page_cost
    # bytes an IDLE instance of this method pins — what byte-aware keep-alive
    # policies reason about: warmswap idles on per-fn metadata only (the
    # image is shared), prebaking on its private snapshot, baseline on its
    # privately initialized dependencies
    idle_bytes = {"warmswap": cost.metadata_bytes,
                  "prebaking": cost.snapshot_bytes,
                  "baseline": cost.image_bytes}[method]
    cap = fleet.max_instances_per_fn
    workers = [_Worker(i, fleet.worker_capacity_bytes)
               for i in range(fleet.n_workers)]
    # placement only ever routes over the LIVE workers; rebound (not mutated)
    # by the worker_fail / worker_recover handlers, so the fair-weather path
    # never pays a per-arrival liveness scan
    live = workers
    orphans: List[Tuple[float, int, int]] = []   # (req_t, idx, fn) waiting for
                                                 #   ANY worker to come back
    # streams expose per-function metadata (rates/images — bounded by fleet
    # size) upfront; only the arrival arrays stay chunked
    trace_meta = traces.meta_traces() if is_stream else traces
    fn_image = {t.fn_index: t.image_id for t in trace_meta}
    images = sorted({t.image_id for t in trace_meta})

    # Cluster-shared image tier (page model only): one ledger of distinct
    # resident images + who holds them. A cluster-capacity eviction drops the
    # image from every worker pool (the tier IS the union of worker pools).
    def _cluster_evict(key: str) -> None:
        for w in workers:
            w.ledger.evict(key)
    cluster = (ClusterImageCache(fleet.shared_cache_bytes,
                                 on_evict=_cluster_evict)
               if page is not None else None)

    def resident_bytes_of(key: str) -> int:
        return cost.snapshot_bytes if key.startswith("snap:") else cost.image_bytes

    def admit_resident(w: _Worker, key: str, t: float) -> None:
        """Admit ``key`` into ``w``'s pool AND the cluster tier, propagating
        any LRU evictions the worker pool makes to the cluster holder sets."""
        nbytes = resident_bytes_of(key)
        for victim in w.ledger.admit(key, nbytes, now=t):
            if cluster is not None:
                cluster.worker_evicted(w.idx, victim)
        if cluster is not None:
            cluster.admit(key, nbytes, w.idx, now=t)
            cluster.touch(key, t)

    res = FleetResult(method=method, n_invocations=0, n_cold=0, n_warm=0,
                      total_latency_s=0.0, memory_bytes=0,
                      n_workers=fleet.n_workers)

    def resident_key(fn: int) -> str:
        """What must be resident in a worker pool to cold-start ``fn`` fast."""
        return (f"img:{fn_image[fn]}" if method == "warmswap"
                else f"snap:{fn}")

    def fleet_bytes() -> int:
        total = 0
        for w in workers:
            total += w.ledger.used_bytes()
            if method == "warmswap":
                total += len(w.metadata_fns) * cost.metadata_bytes
        return total

    def note_peak() -> None:
        res.memory_bytes = max(res.memory_bytes, fleet_bytes())

    # ---------------------------------------------------------------- setup phase
    # Provider pre-builds residents on home workers (paper Fig. 4b): WarmSwap
    # builds each live image once; Prebaking snapshots every function upfront
    # (the paper keeps prebaked snapshots in RAM, §4.5). Baseline holds nothing.
    _seed_home_residents(method, workers, fn_image, images,
                         lambda w, key: admit_resident(w, key, 0.0))
    note_peak()

    # ------------------------------------------------------------- arrival stream
    # Vectorized merge of the per-function arrival arrays; arrivals never enter
    # the event heap — the main loop merges this stream against the heap head.
    # A TraceStream skips this materialization entirely: the loop below pulls
    # one chunk at a time (each chunk is already merged in this same order),
    # so peak arrival residency is one chunk, not the trace.
    if is_stream:
        all_t = np.empty((0,))
        all_fn = np.empty((0,), np.int64)
        n_req = 0
        # finalized to the true last arrival when the stream is exhausted.
        # Unfinalized reads are safe: the clamps below (`min(..., horizon)`,
        # `t > horizon`) can only bind at times past the last arrival, and any
        # event firing while chunks remain is <= the next arrival <= horizon.
        horizon = float("inf")
    else:
        all_t = np.concatenate([t.arrivals_min for t in traces]) if traces \
            else np.empty((0,))
        all_fn = np.concatenate(
            [np.full(len(t.arrivals_min), t.fn_index, np.int64)
             for t in traces]) if traces else np.empty((0,), np.int64)
        order = np.argsort(all_t, kind="stable")
        all_t, all_fn = all_t[order], all_fn[order]
        n_req = len(all_t)
        horizon = float(all_t[-1]) if n_req else 0.0
    # preallocated per-request buffers, filled in place by begin_service; an
    # unfilled (NaN) slot after the loop drains is an engine bug and raises.
    # Streamed runs grow them geometrically as chunks arrive (a request's
    # buffer slot exists before its arrival is processed, so queued requests
    # from earlier chunks always land inside the current capacity).
    samples = np.full(n_req, np.nan)
    waits = np.full(n_req, np.nan)
    events = EventQueue()
    push = events.push
    # Disruption events enter the heap up front at ranks > every fair-weather
    # kind (events.py): at equal timestamps a failure strikes only after the
    # arrivals/completions of that instant resolve.
    if disruption is not None:
        _KIND_INT = {"worker_fail": _FAIL, "worker_recover": _RECOVER,
                     "cache_flush": _FLUSH}
        for dev in disruption.events:
            push(dev.t_min, _KIND_INT[dev.kind], dev.worker)
    arrival_seq = 0                   # round-robin rotates per ARRIVAL; queued
                                       #   requests must not stall the rotation
    # hot-loop counters (folded into ``res`` after the loop): locals are
    # cheaper than dataclass attribute updates at millions of requests
    n_cold_c = n_warm_c = 0
    pw_hits = pp_hits = 0              # placement warm / pool-residency hits
    max_conc = 1
    warm_s = cost.warm_s
    # the base "none" policy has no arrival/completion state worth feeding and
    # a constant keep-alive window — skip its callbacks entirely (subclasses,
    # even ones that override nothing, take the full path)
    trivial_policy = type(policy) is PrewarmPolicy
    fixed_ka = policy.keep_alive_min(0, image_bytes=idle_bytes)

    def tier_of(w: _Worker, key: str) -> str:
        """Where ``key``'s pages would come from for a cold start on ``w``
        (page model): this worker's pool, a peer via the shared tier, or the
        source store. Pure read — no hit/miss counters move. The worker
        ledger is consulted first: an image the bounded shared tier rejected
        (oversized) can still be resident locally."""
        if w.ledger.holds(key):
            return "local"
        return cluster.classify(key, w.idx)

    def start_cost_s(w: _Worker, key: str) -> float:
        """Placement's bandwidth-aware estimate: blocking transfer seconds a
        cold start of this image would pay on ``w`` (the scalar base is the
        same everywhere, so only the transfer term ranks workers)."""
        return page.transfer_blocking_s(tier_of(w, key),
                                        image_bytes=resident_bytes_of(key))

    # One PlacementContext per decision *kind*, built once and mutated in
    # place per arrival (fn / t_min / arrival_seq are plain attribute writes);
    # the signal closures read the current decision through ``cur``. Under the
    # page model the residency signal is the bandwidth/residency-aware
    # transfer-cost estimate (local beats remote beats source-miss); otherwise
    # it is boolean pool residency. Strategies ignore what they don't rank by.
    cur = [0, 0.0, ""]                     # fn, t (minutes), resident key
    warm_cache: Dict[int, _Instance] = {}  # worker idx -> idle inst found by
                                           #   the has_warm scan this decision

    def _load_signal(w: _Worker) -> int:
        return w.in_flight

    def _queue_signal(w: _Worker) -> int:
        return w.queued_now

    def _has_warm_signal(w: _Worker) -> bool:
        inst = w.idle_instance(cur[0], cur[1])
        if inst is None:
            return False
        warm_cache[w.idx] = inst
        return True

    def _residency_signals() -> Dict:
        if page is not None and method != "baseline":
            return {"start_cost": lambda w: start_cost_s(w, cur[2])}
        return {"holds_image": lambda w: w.ledger.holds(cur[2])}

    ctx = PlacementContext(load=_load_signal, queue_depth=_queue_signal,
                           has_warm=_has_warm_signal, **_residency_signals())
    single_worker = len(workers) == 1

    def pick_worker(fn: int, t: float) -> Tuple[_Worker, str,
                                                Optional[_Instance]]:
        """The placement decision for one arrival: the chosen worker, the
        resident key its cold start would need, and its idle warm instance
        (``None`` when a cold start / queue wait is due). With one worker
        every strategy must return it, so the strategy call is skipped."""
        nonlocal pw_hits, pp_hits
        key = resident_key(fn)
        if single_worker:
            w = workers[0]
            inst = w.idle_instance(fn, t)
        else:
            cur[0], cur[1], cur[2] = fn, t, key
            warm_cache.clear()
            ctx.fn, ctx.t_min, ctx.arrival_seq = fn, t, arrival_seq
            w = strategy(live, ctx)
            inst = warm_cache.get(w.idx)
            if inst is None:               # strategy may ignore the warm scan
                inst = w.idle_instance(fn, t)
        if inst is not None:
            pw_hits += 1
        elif w.ledger.holds(key):
            pp_hits += 1
        return w, key, inst

    def cold_start(w: _Worker, fn: int, key: str, t: float) -> float:
        """Admit what the cold start needs into the worker pool (and, under
        the page model, the cluster-shared tier); return its latency in
        seconds. ``key`` is the resident key ``pick_worker`` already derived."""
        if page is not None:
            lat = cold_start_paged(w, fn, key, t)
        else:
            lat = cold_base
            if method == "warmswap":
                if not w.ledger.holds(key):
                    lat += cost.image_revive_s    # disk-tier revive / rebuild
                    res.pool_misses += 1
                w.ledger.admit(key, cost.image_bytes, now=t)
                if fn not in w.metadata_fns:
                    w.metadata_fns.add(fn)
            elif method == "prebaking":
                if not w.ledger.holds(key):
                    # snapshot was evicted: fall back to a from-scratch start
                    # and re-snapshot the result
                    lat = method_cold_latency_s(cost, "baseline")
                    res.pool_misses += 1
                w.ledger.admit(key, cost.snapshot_bytes, now=t)
        w.ledger.touch(key, t)
        if cluster is not None:
            cluster.touch(key, t)
        note_peak()
        return lat

    def cold_start_paged(w: _Worker, fn: int, key: str, t: float) -> float:
        """Page-granular cold start: latency = scalar base + blocking page
        transfer from wherever the image's pages are (worker pool / peer via
        the cluster-shared cache / source store). The fetched image becomes
        resident on ``w`` and in the shared tier, so the cluster pays each
        source fetch once. Network page volume (remote + source tiers) is
        accounted in ``pages_transferred``."""
        if method == "baseline":
            # nothing is ever cached: the full payload streams from source
            res.pages_transferred += page.image_pages()
            return page.cold_latency_s("baseline")
        # classify via the worker ledger first: an image the bounded shared
        # tier rejected (oversized) can still be resident locally
        tier = tier_of(w, key)
        cluster.count(tier)
        if tier == "local":
            res.cache_local_hits += 1
        elif tier == "remote":
            res.cache_remote_hits += 1
            res.pool_misses += 1
        else:
            res.cache_misses += 1
            res.pool_misses += 1
        if method == "warmswap":
            lat = page.cold_latency_s("warmswap", tier=tier)
            if tier != "local":
                res.pages_transferred += page.image_pages()
        else:                          # prebaking
            if tier == "miss":
                # no pool anywhere holds this function's snapshot: rebuild
                # from scratch (priced as a baseline start) and re-snapshot
                lat = page.cold_latency_s("baseline")
                res.pages_transferred += page.image_pages()
            else:
                lat = page.cold_latency_s(
                    "prebaking", tier=tier, image_bytes=cost.snapshot_bytes)
                if tier != "local":
                    res.pages_transferred += page.n_pages(cost.snapshot_bytes)
        admit_resident(w, key, t)
        if method == "warmswap" and fn not in w.metadata_fns:
            w.metadata_fns.add(fn)
        return lat

    # streamed runs rebind samples/waits (geometric growth) and horizon (set
    # once the last chunk lands); the closures below MUST see the rebound
    # values — that is the growth/finalization design, not a stale capture.
    # repro-lint: allow[stale-capture]
    def begin_service(w: _Worker, inst: _Instance, start: float, svc_s: float,
                      req_t: float, idx: int) -> None:
        """Run one request on ``inst`` starting at ``start`` (>= its previous
        ``busy_until`` by construction, so busy_until only ever advances).
        Per-request totals (latency sums, queue counts, per-function
        breakdowns) are NOT accumulated here — they are vectorized over the
        preallocated ``samples``/``waits`` buffers after the loop drains."""
        wait_s = (start - req_t) * 60.0
        busy_until = start + svc_s / 60.0
        if san is not None:
            san.check_service(start=start, req_t=req_t,
                              prev_busy=inst.busy_until,
                              busy_until=busy_until, worker=w.idx,
                              fn=inst.fn)
        inst.busy_until = busy_until
        expires = busy_until + (fixed_ka if trivial_policy
                                else policy.keep_alive_min(
                                    inst.fn, image_bytes=idle_bytes))
        inst.expires = expires
        inst.gen += 1
        inst.cur_idx = idx
        inst.cur_req_t = req_t
        push(busy_until, _FREE, (w, inst))
        push(expires, _EXPIRY, (w, inst, inst.gen))
        w.n_served += 1
        w.in_flight += 1
        samples[idx] = wait_s + svc_s
        waits[idx] = wait_s

    # repro-lint: allow[stale-capture]
    def retire(w: _Worker, inst: _Instance) -> None:
        """Keep-alive expired: remove the instance, account its residency
        clamped to the trace horizon."""
        insts = w.instances.get(inst.fn)
        if insts is not None and inst in insts:
            insts.remove(inst)
        w.instance_min += max(0.0, min(inst.expires, horizon) - inst.created)

    # repro-lint: allow[stale-capture]
    def spawn_prewarm(t: float, fn: int, expire_at: float) -> None:
        if t > horizon:
            # scheduled past the last arrival: drained, accounted, not spawned
            res.prewarm_dropped += 1
            return
        for w in workers:
            if w.alive(fn):
                return                 # something is already warm; don't double-spawn
        if not live:
            # every worker is down: account the spawn as dropped, like a
            # past-horizon spawn, rather than silently losing it
            res.prewarm_dropped += 1
            return
        # pre-warm spawns always use affinity-shaped placement (no instance
        # is warm yet, so only the residency/transfer signal discriminates);
        # spawns are rare, so this context is built fresh rather than shared
        cur[2] = key = resident_key(fn)
        w = place_invocation(live, PlacementContext(
            load=_load_signal, queue_depth=_queue_signal,
            fn=fn, t_min=t, arrival_seq=arrival_seq, **_residency_signals()))
        if method != "baseline":
            admit_resident(w, key, t)
            if method == "warmswap":
                w.metadata_fns.add(fn)
            note_peak()
        inst = _Instance(fn, busy_until=t, expires=expire_at, created=t,
                         prewarmed=True)
        w.instances.setdefault(fn, []).append(inst)
        events.push(expire_at, EventKind.KEEPALIVE_EXPIRY, (w, inst, inst.gen))
        res.prewarm_spawns += 1

    def handle_arrival(t: float, fn: int, idx: int) -> None:
        nonlocal arrival_seq, n_cold_c, n_warm_c, max_conc
        if not trivial_policy:
            policy.on_arrival(fn, t)
        if not live:
            # every worker is down: park the request; the next
            # worker_recover event re-dispatches it (wait accrues from t)
            orphans.append((t, idx, fn))
            arrival_seq += 1
            return
        w, key, inst = pick_worker(fn, t)
        arrival_seq += 1
        if inst is not None:
            n_warm_c += 1
            if inst.prewarmed:
                res.prewarm_hits += 1
                inst.prewarmed = False
            begin_service(w, inst, t, warm_s, t, idx)
        else:
            alive = w.instances.get(fn)
            if alive and cap is not None and len(alive) >= cap:
                # at the instance cap: join this worker's FIFO queue; the next
                # instance-free event dispatches it (latency = wait + warm cost)
                w.queues.setdefault(fn, deque()).append((t, idx))
                w.queued_now += 1
            else:
                svc = cold_start(w, fn, key, t)
                n_cold_c += 1
                inst = _Instance(fn, busy_until=t, expires=t, created=t)
                if alive is None:
                    w.instances[fn] = [inst]
                else:
                    alive.append(inst)
                n_alive = sum(len(ww.alive(fn)) for ww in workers)
                if n_alive > max_conc:
                    max_conc = n_alive
                begin_service(w, inst, t, svc, t, idx)
        if not trivial_policy:
            window = policy.prewarm_after(fn, t)
            if window is not None:
                push(window[0], _SPAWN, (fn, window[1]))

    def redispatch(t: float, req_t: float, fn: int, idx: int) -> None:
        """Re-submit a request displaced by a worker failure at time ``t``,
        keeping its ORIGINAL arrival time ``req_t`` so the time lost to the
        failure lands in its queue wait (``begin_service`` overwrites the
        request's sample slot). Mirrors ``handle_arrival``'s dispatch, but a
        re-dispatch is not an arrival: the policy sees no new arrival and
        the round-robin rotation does not advance."""
        nonlocal n_cold_c, n_warm_c, max_conc
        if not live:
            orphans.append((req_t, idx, fn))
            return
        w, key, inst = pick_worker(fn, t)
        if inst is not None:
            n_warm_c += 1
            if inst.prewarmed:
                res.prewarm_hits += 1
                inst.prewarmed = False
            begin_service(w, inst, t, warm_s, req_t, idx)
            return
        alive = w.instances.get(fn)
        if alive and cap is not None and len(alive) >= cap:
            w.queues.setdefault(fn, deque()).append((req_t, idx))
            w.queued_now += 1
            return
        svc = cold_start(w, fn, key, t)
        n_cold_c += 1
        inst = _Instance(fn, busy_until=t, expires=t, created=t)
        if alive is None:
            w.instances[fn] = [inst]
        else:
            alive.append(inst)
        n_alive = sum(len(ww.alive(fn)) for ww in workers)
        if n_alive > max_conc:
            max_conc = n_alive
        begin_service(w, inst, t, svc, req_t, idx)

    # repro-lint: allow[stale-capture]
    def fail_worker(t: float, w_idx: int) -> None:
        nonlocal live
        w = workers[w_idx]
        if w.failed:
            return
        w.failed = True
        live = [ww for ww in workers if not ww.failed]
        res.worker_failures += 1
        # Displaced requests: the worker's in-flight requests plus its queue,
        # re-dispatched in (original arrival time, request index) order — a
        # deterministic total order, since request indices are unique.
        pending: List[Tuple[float, int, int]] = []
        for insts in w.instances.values():
            for inst in insts:
                inst.killed = True     # pending free/expiry events are stale
                w.instance_min += max(0.0, min(t, horizon) - inst.created)
                if inst.busy_until > t and inst.cur_idx >= 0:
                    pending.append((inst.cur_req_t, inst.cur_idx, inst.fn))
        for fn, q in w.queues.items():
            for req_t, idx in q:
                pending.append((req_t, idx, fn))
        w.instances.clear()
        w.queues.clear()
        w.in_flight = 0
        w.queued_now = 0
        # the pool dies with the worker (propagated to the cluster tier — the
        # shared tier is the union of worker pools); a recovered worker
        # re-warms through the normal cold-start path
        for key in list(w.ledger.entries):
            w.ledger.evict(key)
            if cluster is not None:
                cluster.worker_evicted(w.idx, key)
        w.metadata_fns.clear()
        pending.sort()
        res.requeued += len(pending)
        for req_t, idx, fn in pending:
            redispatch(t, req_t, fn, idx)

    def recover_worker(t: float, w_idx: int) -> None:
        nonlocal live
        w = workers[w_idx]
        if not w.failed:
            return
        w.failed = False
        live = [ww for ww in workers if not ww.failed]
        res.worker_recoveries += 1
        if orphans:
            drain = sorted(orphans)
            orphans.clear()
            for req_t, idx, fn in drain:
                redispatch(t, req_t, fn, idx)

    def flush_caches(t: float) -> None:
        """Shared-image eviction storm: every pool resident leaves every
        worker (and, via the holder sets, the cluster tier). Warm instances
        keep running — a cache eviction does not kill containers — so only
        subsequent cold starts feel it (revive / remote / source miss)."""
        res.cache_flushes += 1
        for w in workers:
            for key in list(w.ledger.entries):
                w.ledger.evict(key)
                if cluster is not None:
                    cluster.worker_evicted(w.idx, key)

    def handle_event(ev_t: float, kind: int, payload) -> None:
        nonlocal n_warm_c
        if kind == _FREE:
            w, inst = payload
            if inst.killed:
                return                 # the worker died mid-service
            w.in_flight -= 1
            if not trivial_policy:
                policy.on_completion(inst.fn, ev_t)
            q = w.queues.get(inst.fn)
            if q:
                req_t, idx = q.popleft()
                w.queued_now -= 1
                n_warm_c += 1
                begin_service(w, inst, ev_t, warm_s, req_t, idx)
        elif kind == _SPAWN:
            fn, expire_at = payload
            spawn_prewarm(ev_t, fn, expire_at)
        elif kind == _EXPIRY:
            w, inst, gen = payload
            if inst.gen == gen and not inst.killed:
                retire(w, inst)        # else: superseded or worker died
        elif kind == _FAIL:
            fail_worker(ev_t, payload)
        elif kind == _RECOVER:
            recover_worker(ev_t, payload)
        else:                          # CACHE_FLUSH
            flush_caches(ev_t)

    # ---------------------------------------------------------------- event loop
    # Merge the pre-sorted arrival stream against the event-heap head. The
    # arrival arrays are materialized as plain Python lists once — float/int
    # extraction per numpy element is several times slower at millions of
    # requests — and the heap head is compared field-wise (no tuple builds).
    # Chunked runs feed the same loop one chunk at a time: the next chunk is
    # fetched BEFORE any heap event later than the current chunk fires, so
    # the event/arrival interleaving is identical to the materialized run.
    all_t_list = all_t.tolist()
    all_fn_list = all_fn.tolist()
    heap = events.heap
    pop = events.pop_raw
    i = 0
    base = 0                      # global index of the current chunk's start
    n_cur = n_req
    fn_parts: List[np.ndarray] = []
    chunk_iter = traces.chunks() if is_stream else None
    draining = chunk_iter is None  # True once no further arrivals can appear
    last_t = 0.0
    while True:
        if i >= n_cur and not draining:
            chunk = next(chunk_iter, None)
            if chunk is None:
                draining = True
                n_req = base + n_cur
                # the stream is exhausted: the horizon (last arrival) is now
                # known, exactly as the materialized path computed it upfront
                horizon = last_t if n_req else 0.0
            else:
                base += n_cur
                all_t_list = chunk.t_min.tolist()
                all_fn_list = chunk.fn.tolist()
                n_cur = len(all_t_list)
                i = 0
                last_t = all_t_list[-1]
                fn_parts.append(chunk.fn)
                need = base + n_cur
                if need > len(samples):
                    grown = np.full(max(need, 2 * len(samples)), np.nan)
                    grown[:len(samples)] = samples
                    samples = grown
                    grown = np.full(len(samples), np.nan)
                    grown[:len(waits)] = waits
                    waits = grown
            continue
        if heap:
            head = heap[0]
            if (i >= n_cur or head[0] < all_t_list[i]
                    or (head[0] == all_t_list[i] and head[1] <= _ARRIVAL)):
                ev = pop()
                if san is not None and san.check_event(ev[0], ev[1], ev[2]):
                    san.check_books(workers, cluster)
                handle_event(ev[0], ev[1], ev[3])
                continue
        elif i >= n_cur:
            break
        handle_arrival(all_t_list[i], all_fn_list[i], base + i)
        i += 1
    if is_stream:
        samples = samples[:n_req]
        waits = waits[:n_req]
        all_fn = (np.concatenate(fn_parts) if fn_parts
                  else np.empty((0,), np.int64))
    res.horizon_min = horizon

    if orphans:
        raise RuntimeError(
            f"{len(orphans)} request(s) were still orphaned when the event "
            f"loop drained: the disruption schedule leaves every worker "
            f"failed with no recovery before the end of the trace")
    if n_req and np.isnan(samples).any():
        raise RuntimeError("fleet engine dropped requests: unfilled latency "
                           "samples after the event loop drained")
    res.latency_samples_s = samples
    res.queue_wait_s = waits
    res.sample_fn = all_fn
    # ------------------------------------------------- vectorized projections
    # Totals, queue stats, and per-function breakdowns from the sample
    # buffers in a few numpy passes instead of per-request accumulation.
    res.n_invocations = n_req
    res.n_cold = n_cold_c
    res.n_warm = n_warm_c
    res.total_latency_s = float(samples.sum())
    res.n_queued = int((waits > 0).sum())
    res.queue_delay_s = float(waits.sum())
    res.placement_warm_hits = pw_hits
    res.placement_pool_hits = pp_hits
    res.max_concurrent_instances = max_conc
    fns = np.array(sorted({t.fn_index for t in trace_meta}), np.int64)
    slots = np.searchsorted(fns, all_fn)
    lat_sums = np.bincount(slots, weights=samples, minlength=len(fns)) \
        if n_req else np.zeros(len(fns))
    inv_counts = np.bincount(slots, minlength=len(fns)) \
        if n_req else np.zeros(len(fns), np.int64)
    res.per_fn_latency = {int(f): float(s) for f, s in zip(fns, lat_sums)}
    res.per_fn_invocations = {int(f): int(c) for f, c in zip(fns, inv_counts)}
    res.evictions = sum(w.ledger.evictions for w in workers)
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
