"""Fault tolerance: supervised training, failure injection, pool-based
replica recovery (port of ``repro.runtime.fault_tolerance``).

Training side, :class:`TrainSupervisor`: periodic async checkpoints, an
anchor checkpoint at the start, rollback and resume on a non-finite loss or
an injected failure, with deterministic data replay (the batches are a pure
function of the step). A :class:`~repro_torch.kernels.build.KernelLaunchError`
is re-raised at once: a kernel that does not build or launch fails the same
way on every retry.

Serving side: :class:`ReplicaSet` keeps N replicas fronted by the
straggler-aware ``FleetScheduler``; ``kill()`` simulates node failure and
``recover()`` re-warms the replacement from the WarmSwap dependency pool, the
paper's cold-start result wearing its fault-tolerance hat.
``replay_disruption`` replays a simulator disruption schedule against a live
set; it reads only ``schedule.events[*].kind`` and ``.worker``, so it needs
no copy of the simulator's schedule types.
"""
from __future__ import annotations

import math
import threading
import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional

from repro_torch.checkpoint import CheckpointConfig, Checkpointer
from repro_torch.core.tree import TreeDef, leaves
from repro_torch.kernels.build import KernelLaunchError
from repro_torch.serving.scheduler import FleetScheduler


@dataclass
class SupervisorConfig:
    checkpoint_every: int = 20
    max_retries: int = 3
    checkpoint: Optional[CheckpointConfig] = None


class InjectedFailure(RuntimeError):
    pass


def on_devices_of(restored: Any, current: Any) -> Any:
    """The restored (CPU) tree with each leaf moved to the device of the
    matching leaf of ``current``."""
    return TreeDef.of(restored).unflatten(
        [r.to(c.device) for r, c in zip(leaves(restored), leaves(current))])


class TrainSupervisor:
    """Wraps a step function with checkpoint, rollback and NaN recovery."""

    def __init__(self, cfg: SupervisorConfig,
                 train_step: Callable,                      # (p, o, batch, step) -> (p, o, m)
                 batch_at: Callable[[int], Dict[str, Any]],   # deterministic data access
                 ckpt: Optional[Checkpointer] = None):        # else one from cfg.checkpoint
        self.cfg = cfg
        self.train_step = train_step
        self.batch_at = batch_at
        if ckpt is None and cfg.checkpoint:
            ckpt = Checkpointer(cfg.checkpoint)
        self.ckpt = ckpt
        self.restores = 0
        self.failures_seen = 0

    @staticmethod
    def _bad(metrics: Dict[str, Any]) -> bool:
        loss = float(metrics.get("loss", 0.0))
        return math.isnan(loss) or math.isinf(loss)

    def run(self, params: Any, opt_state: Any, start_step: int, n_steps: int, *,
            fail_at: Optional[Dict[int, BaseException]] = None,
            on_metrics: Optional[Callable[[int, Dict], None]] = None):
        """Runs steps ``[start_step, start_step + n_steps)`` with recovery.
        Returns ``(params, opt_state, history)``. The step may update the
        parameters in place: a rollback replaces them with the checkpoint's,
        on the devices the parameters were on."""
        fail_at = dict(fail_at or {})
        history: List[Dict[str, Any]] = []
        step = start_step
        end = start_step + n_steps
        retries = 0
        if self.ckpt is not None and self.ckpt.latest() is None:
            # anchor: a failure before the first periodic save can still roll
            # back to the run's starting state
            self.ckpt.save(start_step, {"params": params, "opt_state": opt_state})
            self.ckpt.wait()
        while step < end:
            try:
                if step in fail_at:
                    exc = fail_at.pop(step)
                    self.failures_seen += 1
                    raise exc
                batch = self.batch_at(step)
                params, opt_state, metrics = self.train_step(params, opt_state, batch,
                                                             step)
                m = {k: float(v) for k, v in metrics.items()}
                if self._bad(m):
                    raise InjectedFailure(f"non-finite loss at step {step}")
                m["step"] = step
                history.append(m)
                if on_metrics:
                    on_metrics(step, m)
                if self.ckpt and (step + 1) % self.cfg.checkpoint_every == 0:
                    self.ckpt.save(step + 1, {"params": params, "opt_state": opt_state})
                step += 1
                retries = 0
            except KernelLaunchError:
                raise
            except (InjectedFailure, FloatingPointError, RuntimeError) as e:
                retries += 1
                if retries > self.cfg.max_retries or self.ckpt is None:
                    raise
                restored = self.ckpt.restore(None, {"params": params,
                                                    "opt_state": opt_state})
                if restored is None:
                    raise RuntimeError("failure before the first checkpoint") from e
                params = on_devices_of(restored["params"], params)
                opt_state = on_devices_of(restored["opt_state"], opt_state)
                step = int(restored["__manifest__"]["step"])
                self.restores += 1
        if self.ckpt:
            self.ckpt.save(step, {"params": params, "opt_state": opt_state})
            self.ckpt.wait()
        return params, opt_state, history


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
