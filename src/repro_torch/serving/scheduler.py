"""Fleet-level request scheduling: placement + straggler mitigation (port of
``repro.serving.scheduler``; pure Python, copied so the port never imports the
JAX package).

Placement (``place_invocation``) is image-affinity routing: prefer a worker that
already has a warm instance, then one whose Dependency-Manager pool holds the
needed live image (migration is a local memcpy there), then least-loaded. The
same function drives both the live :class:`FleetScheduler` and the discrete-event
fleet simulator (``repro_torch.core.fleet``), so simulated placement decisions
match what the serving layer would do.

Straggler mitigation routes requests across serving replicas, tracking
per-replica EWMA step latency. A replica whose in-flight request exceeds
``straggler_factor``x its EWMA is flagged; flagged work is re-dispatched to the
fastest healthy replica (backup-request strategy), and repeatedly-flagged
replicas are quarantined and replaced through the WarmSwap pool (fast re-warm —
the recovery path fault_tolerance.py measures).
"""
from __future__ import annotations

import collections
from dataclasses import dataclass, replace
from typing import Callable, Dict, Iterable, List, Optional, Sequence

from repro_torch.core.registry import Registry

#: Name -> placement-strategy factory. A built strategy is a callable
#: ``strategy(workers, context: PlacementContext) -> worker``; the fleet
#: engine (and scenario specs / the experiments CLI) address strategies by
#: key, so new strategies plug in with ``@PLACEMENTS.register("name")``
#: without touching the engine.
PLACEMENTS = Registry("placement strategy")


@dataclass
class PlacementContext:
    """Everything a placement strategy may consult for one invocation.

    All signals are callables over a single worker (so strategies only pay
    for what they read); optional ones are ``None`` when the caller has no
    such signal. ``arrival_seq`` is the index of this arrival in the merged
    stream — stateless strategies like round-robin rotate on it.
    """
    load: Callable                           # worker -> in-flight requests
    has_warm: Optional[Callable] = None      # worker -> idle warm instance?
    holds_image: Optional[Callable] = None   # worker -> pool holds the image?
    queue_depth: Optional[Callable] = None   # worker -> queued (not running)
    start_cost: Optional[Callable] = None    # worker -> est. transfer seconds
    fn: Optional[int] = None                 # function index (informational)
    t_min: float = 0.0                       # arrival time (minutes)
    arrival_seq: int = 0                     # position in the arrival stream


def place_invocation(
    workers: Sequence,
    context: Optional[PlacementContext] = None,
    *,
    load: Optional[Callable] = None,
    has_warm: Optional[Callable] = None,
    holds_image: Optional[Callable] = None,
    queue_depth: Optional[Callable] = None,
    start_cost: Optional[Callable] = None,
):
    """Image-affinity placement over ``workers`` (any hashable ids).

    Priority: (1) a worker with a warm idle instance of the function,
    (2a) with ``start_cost`` — the worker with the cheapest estimated
    cold-start transfer (seconds: 0-ish where the image is hot in the local
    pool, a network transfer where a peer holds it, a source fetch where
    nobody does — the bandwidth/residency-aware ranking the page-granular
    cost model feeds), ties broken by load;
    (2b) without it — a worker whose pool already holds the live dependency
    image (the boolean residency special case);
    (3) the least-loaded worker.

    ``queue_depth`` (requests waiting for an instance, not yet running) adds
    to the load — a worker with a deep queue is as bad as one with that many
    in-flight requests. Ties break on position in ``workers``, so placement
    is deterministic and worker ids never need to be orderable.

    Args:
        workers: candidate workers (any hashable ids).
        context: a :class:`PlacementContext` bundling all signals — the
            preferred calling convention.
        load / has_warm / holds_image / queue_depth / start_cost:
            **deprecated** keyword form (one callable per signal, same
            semantics as the context fields). Kept as a back-compat shim;
            pass a ``PlacementContext`` instead. Mixing both forms raises.

    Returns:
        The chosen worker, or ``None`` when ``workers`` is empty.
    """
    if context is None:
        if load is None:
            raise TypeError("place_invocation needs a PlacementContext "
                            "(or, deprecated, a load= callable)")
        context = PlacementContext(load=load, has_warm=has_warm,
                                   holds_image=holds_image,
                                   queue_depth=queue_depth,
                                   start_cost=start_cost)
    elif any(s is not None for s in (load, has_warm, holds_image,
                                     queue_depth, start_cost)):
        raise TypeError("pass signals via PlacementContext OR the deprecated "
                        "kwargs, not both")
    if not workers:
        return None
    # Single-pass selection with first-minimum tie-breaks (== the historical
    # ``min`` over ``(signal, position)`` keys, without building a rank dict
    # and per-worker key tuples — this is the fleet engine's hottest call).
    load, queue_depth = context.load, context.queue_depth
    has_warm, start_cost = context.has_warm, context.start_cost

    def eff_load(w):
        return load(w) + queue_depth(w) if queue_depth is not None else load(w)

    if has_warm is not None:
        best = None
        best_load = 0
        for w in workers:
            if has_warm(w):
                l = eff_load(w)
                if best is None or l < best_load:
                    best, best_load = w, l
        if best is not None:
            return best
    if start_cost is not None:
        best = workers[0]
        best_cost, best_load = start_cost(best), eff_load(best)
        for w in workers[1:]:
            c = start_cost(w)
            if c > best_cost:
                continue
            l = eff_load(w)
            if c < best_cost or l < best_load:
                best, best_cost, best_load = w, c, l
        return best
    if context.holds_image is not None:
        holds_image = context.holds_image
        best = None
        best_load = 0
        for w in workers:
            if holds_image(w):
                l = eff_load(w)
                if best is None or l < best_load:
                    best, best_load = w, l
        if best is not None:
            return best
    best = workers[0]
    best_load = eff_load(best)
    for w in workers[1:]:
        l = eff_load(w)
        if l < best_load:
            best, best_load = w, l
    return best


@PLACEMENTS.register("affinity")
def _affinity_strategy():
    """Warm-instance, then image/transfer-cost affinity, then least-loaded —
    the full :func:`place_invocation` priority chain."""
    def place(workers, ctx: PlacementContext):
        return place_invocation(workers, ctx)
    return place


@PLACEMENTS.register("least_loaded")
def _least_loaded_strategy():
    """Load (in-flight + queue depth) only: ignores warmth and residency."""
    def place(workers, ctx: PlacementContext):
        return place_invocation(workers, replace(
            ctx, has_warm=None, holds_image=None, start_cost=None))
    return place


@PLACEMENTS.register("round_robin")
def _round_robin_strategy():
    """Rotate on the arrival sequence number, blind to every other signal."""
    def place(workers, ctx: PlacementContext):
        return workers[ctx.arrival_seq % len(workers)] if workers else None
    return place


@dataclass
class ReplicaHealth:
    ewma_s: float = 0.0
    n: int = 0
    flags: int = 0
    quarantined: bool = False

    def observe(self, dt: float, alpha: float = 0.2) -> None:
        self.ewma_s = dt if self.n == 0 else (1 - alpha) * self.ewma_s + alpha * dt
        self.n += 1


@dataclass
class SchedulerConfig:
    straggler_factor: float = 3.0
    min_observations: int = 5
    quarantine_after_flags: int = 3


class FleetScheduler:
    """Dispatch + straggler handling over a set of named replicas."""

    def __init__(self, cfg: Optional[SchedulerConfig] = None):
        # fresh config per scheduler: a shared default instance would leak
        # threshold mutations across schedulers
        self.cfg = cfg if cfg is not None else SchedulerConfig()
        self.health: Dict[str, ReplicaHealth] = {}
        self.dispatch_log: List[tuple] = []

    def register_replica(self, name: str) -> None:
        self.health.setdefault(name, ReplicaHealth())

    def remove_replica(self, name: str) -> None:
        self.health.pop(name, None)

    def healthy(self) -> List[str]:
        return [n for n, h in self.health.items() if not h.quarantined]

    def pick(self) -> Optional[str]:
        """Least-loaded-ish: lowest EWMA among healthy replicas."""
        h = self.healthy()
        if not h:
            return None
        return min(h, key=lambda n: (self.health[n].ewma_s, n))

    def pick_affine(self, image_id: str,
                    residency: Dict[str, Iterable[str]]) -> Optional[str]:
        """Placement that prefers healthy replicas whose pool holds ``image_id``
        (``residency``: replica -> live image ids), then lowest EWMA."""
        return place_invocation(self.healthy(), PlacementContext(
            load=lambda n: self.health[n].ewma_s,
            holds_image=lambda n: image_id in residency.get(n, ()),
        ))

    def observe(self, name: str, dt: float) -> bool:
        """Record a completed unit of work; returns True if it was a straggler."""
        rh = self.health[name]
        is_straggler = (rh.n >= self.cfg.min_observations and
                        dt > self.cfg.straggler_factor * max(rh.ewma_s, 1e-9))
        rh.observe(dt)
        if is_straggler:
            rh.flags += 1
            if rh.flags >= self.cfg.quarantine_after_flags:
                rh.quarantined = True
        return is_straggler

    def run(self, work: List[Callable[[], float]],
            execute: Callable[[str, Callable], float]) -> Dict[str, int]:
        """Dispatch work items; re-dispatch stragglers once to the best other
        replica. ``execute(replica, item)`` returns measured seconds."""
        counts: Dict[str, int] = collections.Counter()
        for item in work:
            name = self.pick()
            if name is None:
                raise RuntimeError("no healthy replicas")
            dt = execute(name, item)
            counts[name] += 1
            if self.observe(name, dt):
                backup = self.pick()
                if backup is not None and backup != name:
                    dt2 = execute(backup, item)          # backup request
                    self.observe(backup, dt2)
                    counts[backup] += 1
                    self.dispatch_log.append(("redispatch", name, backup))
        return dict(counts)
