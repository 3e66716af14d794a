"""Fleet-disruption schedules: worker churn, preemption waves, eviction storms.

Port of ``repro.core.disruption``: the same code with the imports pointed at the
port, so every sample, counter and float sum is bit-identical.

The fleet engine (``core/fleet.py``) is, by default, a fair-weather model:
workers never die and resident images are only evicted by capacity pressure.
This module supplies the foul weather as **data** — a
:class:`DisruptionSchedule` is a frozen, pre-computed list of timed events
the engine merges into its heap at setup (at ranks *after* every
fair-weather kind at the same instant; see ``core/events.py``):

  * ``worker_fail``    — the worker dies: every instance on it is killed,
    its in-flight and queued requests are re-queued (original arrival times
    preserved, so the lost time shows up as queue wait), and its pool is
    dropped (propagating to the cluster-shared tier);
  * ``worker_recover`` — the worker returns with an *empty* pool; re-warming
    happens on demand through the normal cold-start path (the pool-backed
    recovery story of ``runtime/fault_tolerance.py`` — see
    ``replay_disruption`` there, which replays these same schedules against
    a live ``ReplicaSet``);
  * ``cache_flush``    — a shared-image eviction storm: every resident image
    and snapshot is evicted from every worker pool and from the
    cluster-shared tier. Warm instances keep running (a cache eviction does
    not kill containers); subsequent cold starts pay the revive/miss price.

Schedules are **registry-pluggable** (``DISRUPTIONS``): a scenario spec names
one by key (``"disruption": {"name": "churn", "kwargs": {...}}``) and the
runtime injects the fleet shape (``n_workers``, ``horizon_min``) when
building it, so one spec scales with its own ``smoke_overrides``. Every
schedule is a pure function of its kwargs — seeded generators use
``np.random.default_rng`` — which keeps the determinism contract
(docs/SIMULATION.md) intact.

Normative semantics (event ordering, requeue accounting, counter meanings)
live in docs/SIMULATION.md, "Oracle and disruption semantics".
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.registry import Registry

#: Valid :class:`DisruptionEvent` kinds, in documentation order.
EVENT_KINDS = ("worker_fail", "worker_recover", "cache_flush")

#: Name -> schedule factory. Factories take the runtime-injected fleet shape
#: (``n_workers``, ``horizon_min``) plus their own kwargs and return a
#: :class:`DisruptionSchedule`.
DISRUPTIONS = Registry("disruption")


@dataclass(frozen=True)
class DisruptionEvent:
    """One timed disruption: ``kind`` at ``t_min`` against ``worker``
    (ignored — conventionally ``-1`` — for fleet-wide ``cache_flush``)."""
    t_min: float
    kind: str
    worker: int = -1

    def __post_init__(self) -> None:
        if self.kind not in EVENT_KINDS:
            raise ValueError(f"unknown disruption event kind {self.kind!r} "
                             f"(choose from {list(EVENT_KINDS)})")
        if self.t_min < 0:
            raise ValueError(f"disruption event time must be >= 0, "
                             f"got {self.t_min}")


@dataclass(frozen=True)
class DisruptionSchedule:
    """A frozen, time-sorted event list the fleet engine replays.

    ``name`` records which registry component produced it (diagnostics only).
    Construction sorts events by time (stable, so same-instant events keep
    their authored order) and validates worker indices against ``n_workers``.
    """
    events: Tuple[DisruptionEvent, ...]
    n_workers: int
    name: str = "custom"

    def __init__(self, events: Sequence[DisruptionEvent], n_workers: int,
                 name: str = "custom"):
        for ev in events:
            if ev.kind != "cache_flush" and not (0 <= ev.worker < n_workers):
                raise ValueError(
                    f"disruption event targets worker {ev.worker} but the "
                    f"fleet has {n_workers} worker(s)")
        object.__setattr__(self, "events",
                           tuple(sorted(events, key=lambda e: e.t_min)))
        object.__setattr__(self, "n_workers", int(n_workers))
        object.__setattr__(self, "name", name)

    def __len__(self) -> int:
        return len(self.events)

    def __bool__(self) -> bool:
        return bool(self.events)


@DISRUPTIONS.register("churn")
def churn(n_workers: int, horizon_min: float, seed: int = 0,
          mean_uptime_min: float = 720.0, downtime_min: float = 10.0,
          max_failures: int = 64) -> DisruptionSchedule:
    """Random worker churn: each failure hits a uniformly drawn worker after
    an exponentially distributed uptime, and the worker recovers
    ``downtime_min`` later (recoveries past the horizon still fire — residency
    is clamped by the engine). At most ``max_failures`` failures are drawn,
    and a worker that is still down cannot fail again."""
    if n_workers < 1:
        raise ValueError(f"n_workers must be >= 1, got {n_workers}")
    if mean_uptime_min <= 0 or downtime_min < 0:
        raise ValueError("mean_uptime_min must be > 0 and downtime_min >= 0")
    rng = np.random.default_rng(seed)
    events: List[DisruptionEvent] = []
    down_until = np.zeros(n_workers)
    t = 0.0
    for _ in range(max_failures):
        t += float(rng.exponential(mean_uptime_min))
        if t >= horizon_min:
            break
        w = int(rng.integers(0, n_workers))
        if t < down_until[w]:
            continue                       # still recovering; skip this draw
        events.append(DisruptionEvent(t, "worker_fail", w))
        events.append(DisruptionEvent(t + downtime_min, "worker_recover", w))
        down_until[w] = t + downtime_min
    return DisruptionSchedule(events, n_workers, name="churn")


@DISRUPTIONS.register("preempt")
def preempt(n_workers: int, horizon_min: float, at_min: float = 0.0,
            at_frac: Optional[float] = 0.5, workers: Optional[List[int]] = None,
            kill_frac: float = 0.5,
            downtime_min: float = 30.0) -> DisruptionSchedule:
    """A spot-preemption wave: at one instant a block of workers is killed
    together and recovers ``downtime_min`` later. The instant is
    ``at_frac * horizon_min`` when ``at_frac`` is given, else ``at_min``;
    the victims are ``workers`` when given, else the first
    ``ceil(kill_frac * n_workers)`` workers (at least one)."""
    if n_workers < 1:
        raise ValueError(f"n_workers must be >= 1, got {n_workers}")
    if not 0.0 < kill_frac <= 1.0:
        raise ValueError(f"kill_frac must be in (0, 1], got {kill_frac}")
    t = at_frac * horizon_min if at_frac is not None else at_min
    victims = (list(workers) if workers is not None
               else list(range(max(1, int(np.ceil(kill_frac * n_workers))))))
    events = []
    for w in victims:
        events.append(DisruptionEvent(t, "worker_fail", int(w)))
        events.append(DisruptionEvent(t + downtime_min, "worker_recover",
                                      int(w)))
    return DisruptionSchedule(events, n_workers, name="preempt")


@DISRUPTIONS.register("storm")
def storm(n_workers: int, horizon_min: float, first_at_min: float = 0.0,
          first_at_frac: Optional[float] = 0.25,
          period_min: Optional[float] = None,
          count: int = 1) -> DisruptionSchedule:
    """Shared-image eviction storms: ``count`` fleet-wide cache flushes,
    the first at ``first_at_frac * horizon_min`` (or ``first_at_min`` when
    ``first_at_frac`` is ``None``), then every ``period_min`` (default:
    evenly spaced over the remaining horizon)."""
    if n_workers < 1:
        raise ValueError(f"n_workers must be >= 1, got {n_workers}")
    if count < 1:
        raise ValueError(f"count must be >= 1, got {count}")
    t0 = (first_at_frac * horizon_min if first_at_frac is not None
          else first_at_min)
    if period_min is None:
        period_min = (max(horizon_min - t0, 0.0) / count) or 1.0
    if period_min <= 0:
        raise ValueError(f"period_min must be > 0, got {period_min}")
    events = [DisruptionEvent(t0 + i * period_min, "cache_flush")
              for i in range(count)]
    return DisruptionSchedule(events, n_workers, name="storm")
