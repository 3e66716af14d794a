"""Fault tolerance, serving half: pool-based replica recovery.

Port of the serving side of ``repro.runtime.fault_tolerance``:
:class:`ReplicaSet` keeps N replicas fronted by the straggler-aware
``FleetScheduler``; ``kill()`` simulates node failure and ``recover()``
re-warms the replacement from the WarmSwap dependency pool, the paper's
cold-start result wearing its fault-tolerance hat. ``replay_disruption``
replays a simulator disruption schedule against a live set; it reads only
``schedule.events[*].kind`` and ``.worker``, so it needs no copy of the
simulator's schedule types. The training supervisor comes with the training
slice.
"""
from __future__ import annotations

import threading
import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, List

from repro_torch.serving.scheduler import FleetScheduler


@dataclass
class RecoveryEvent:
    replica: str
    method: str
    seconds: float


class ReplicaSet:
    """A set of serving replicas with pool-backed replacement."""

    def __init__(self, manager, image_id: str, cfg, make_engine: Callable,
                 n_replicas: int = 2):
        self.manager = manager
        self.image_id = image_id
        self.cfg = cfg
        self.make_engine = make_engine
        self.scheduler = FleetScheduler()
        # kill()/recover() may race with a supervisor thread driving _spawn;
        # membership and the recovery log are lock-guarded (repro-lint
        # verifies the discipline statically — see docs/ANALYSIS.md).
        self._lock = threading.Lock()
        self.replicas: Dict[str, Any] = {}       # guarded-by: _lock
        self.events: List[RecoveryEvent] = []    # guarded-by: _lock
        for i in range(n_replicas):
            self._spawn(f"replica-{i}", method="warmswap")

    def _spawn(self, name: str, method: str) -> float:
        # Engine bring-up (build/restore + compile) happens outside the lock:
        # it is the slow path being measured and touches no shared state.
        t0 = time.perf_counter()
        engine = self.make_engine(self.manager, self.image_id,
                                  self.cfg, method)
        dt = time.perf_counter() - t0
        with self._lock:
            self.replicas[name] = engine
            self.scheduler.register_replica(name)
            self.events.append(RecoveryEvent(name, method, dt))
        return dt

    def kill(self, name: str) -> None:
        """Simulated node failure."""
        with self._lock:
            self.replicas.pop(name, None)
            self.scheduler.remove_replica(name)

    def recover(self, name: str, method: str = "warmswap") -> float:
        """Replace a failed replica; returns bring-up seconds. 'warmswap' re-warms
        from the dependency pool; 'baseline' cold-loads + recompiles."""
        return self._spawn(name, method=method)


def replay_disruption(replicas: ReplicaSet, schedule,
                      method: str = "warmswap") -> List[RecoveryEvent]:
    """Replay a simulator disruption schedule against a live :class:`ReplicaSet`.

    This is the bridge between the fleet simulator's foul-weather axes
    (``core/disruption.py``) and the runtime recovery story measured here:
    the same :class:`~repro.core.disruption.DisruptionSchedule` a
    ``FleetConfig`` replays as timed events is applied to real replicas —
    worker ``i`` maps to ``"replica-{i}"`` — so the simulated churn scenario
    and the live pool-backed recovery claim share one schedule artifact.

    Events are applied in schedule order (already time-sorted), collapsed to
    their effects: ``worker_fail`` kills the replica, ``worker_recover``
    re-warms it via ``recover(..., method)``, and ``cache_flush`` is a
    no-op here (the live pool has no fleet-wide eviction hook; the
    simulator prices that axis). Wall-clock timing is *not* reproduced —
    only the event sequence is.

    Returns the :class:`RecoveryEvent` list for the recoveries this replay
    itself triggered (bring-up seconds per re-warm), in order.
    """
    before = len(replicas.events)
    for ev in schedule.events:
        name = f"replica-{ev.worker}"
        if ev.kind == "worker_fail":
            replicas.kill(name)
        elif ev.kind == "worker_recover":
            replicas.recover(name, method=method)
        # cache_flush: no live-pool analogue; simulator-only axis
    with replicas._lock:
        return list(replicas.events[before:])
