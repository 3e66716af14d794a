"""Cold-start orchestration with per-phase timers (port of ``repro.core.coldstart``).

Three start paths, matching the paper's evaluation:

  * ``baseline``  — traditional cold start: boot the runtime, then *dependency
    initialization from scratch*: read the per-function checkpoint from disk,
    rebuild the parameter tree on the device, and run the first forward
    (``dependency_compile``: PyTorch has no XLA compile, so this phase is the
    warm-up forward that the JAX package spends compiling).
  * ``warmswap``  — metadata transfer from the Dependency Manager
    (*communication*), live-migrate the shared pre-initialized image
    (*migration*: page faults / bulk stream through ``page_gather``), attach
    the image's executables.
  * ``prebaking`` — restore the function's own full snapshot (base + handler,
    one per function) from device memory; no sharing.

Every phase is wall-clock measured around real work and ends in a device
synchronisation where the JAX package blocks until ready.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch import spans
from repro_torch.core import workloads as wl
from repro_torch.core.migration import LinkModel, RestorePolicy
from repro_torch.core.pages import materialize
from repro_torch.core.pool import DependencyManager
from repro_torch.core.registry import FunctionRegistry, FunctionSpec
from repro_torch.device import synchronize


@dataclass
class PhaseTimes:
    network: float = 0.0
    container: float = 0.0
    boot: float = 0.0
    communication: float = 0.0      # warmswap: metadata transfer
    migration: float = 0.0          # warmswap: page restore until params usable
    dependency_init: float = 0.0    # baseline: disk load + tree rebuild + warm-up
    dependency_load: float = 0.0    #   ... of which: load + deserialize
    dependency_compile: float = 0.0 #   ... of which: first (warm-up) forward
    handler_import: float = 0.0     # per-function head weights + handler setup
    execution: float = 0.0          # first request

    @property
    def total(self) -> float:
        return (self.network + self.container + self.boot + self.communication +
                self.migration + self.dependency_init + self.handler_import +
                self.execution)

    def as_dict(self) -> Dict[str, float]:
        d = {k: getattr(self, k) for k in (
            "network", "container", "boot", "communication", "migration",
            "dependency_init", "dependency_load", "dependency_compile",
            "handler_import", "execution")}
        d["total"] = self.total
        return d


@dataclass
class ColdStartConfig:
    policy: RestorePolicy = RestorePolicy.BULK
    link: LinkModel = field(default_factory=LinkModel)
    network_s: float = 0.0
    container_s: float = 0.0


class FunctionInstance:
    """A live 'container': params + handler + executables, kept warm until evicted."""

    def __init__(self, spec: FunctionSpec, params: Any, handler_weights: Dict,
                 execs: Dict[str, Any]):
        self.spec = spec
        self.params = params
        self.handler_weights = handler_weights
        self.execs = execs
        # Live-side instance age for keep-alive.  # repro-lint: allow[wall-clock]
        self.started_at = time.monotonic()

    def invoke(self, request: Any):
        """``(result, seconds)``: the handler on ``request``, synchronised.
        Its span ``instance.invoke`` opens an invocation unless the caller is
        inside one (a cold start's first request)."""
        with spans.invocation(), spans.phase("instance.invoke") as ph:
            result = self.spec.handler_fn(self.params, self.handler_weights, request,
                                          self.execs)
            if isinstance(result, torch.Tensor):
                synchronize(result.device)
        return result, ph.seconds


class ColdStartOrchestrator:
    """Runs the three start paths on the manager's device (``cuda`` unless the
    manager was made with ``device="cpu"``)."""

    def __init__(self, manager: DependencyManager, registry: FunctionRegistry,
                 cfg: Optional[ColdStartConfig] = None):
        self.manager = manager
        self.registry = registry
        self.device = manager.device
        self.cfg = cfg if cfg is not None else ColdStartConfig()
        # Prebaking store: per-function full snapshots in device memory
        self._prebaked: Dict[str, Dict[str, Any]] = {}

    # ------------------------------------------------------------------ helpers
    def predicted_cold_latency_s(self, fn_id: str, model,
                                 method: str = "warmswap",
                                 tier: str = "local",
                                 resident_pages: int = 0) -> float:
        """Price a cold start of ``fn_id`` with the page-granular model
        (``core/costmodel.PageCostModel``) using the *real* registered
        image's size, so simulated-vs-measured comparisons share one payload.

        Args:
            fn_id: registered function id.
            model: a :class:`~repro_torch.core.costmodel.PageCostModel`.
            method: ``'warmswap' | 'prebaking' | 'baseline'``.
            tier: where the pages would come from (``'local' | 'remote' |
                'miss'`` — see the cost-model docstring).
            resident_pages: pages already present container-side.

        Returns:
            Predicted cold-start latency in seconds. Compare against the
            measured ``PhaseTimes.total`` of the same start path to judge the
            model's calibration on this machine.

        A prediction never materializes state: the real image size is used
        when the image is already live in the pool, otherwise the model's
        configured default — building or reviving the image here would pay
        (and pool-admit) the very cost being estimated.
        """
        spec = self.registry.get(fn_id)
        # None -> the model's configured default (cost.image_bytes)
        image_bytes = self.manager.live_image_bytes(spec.image_id)
        return model.cold_latency_s(method, tier=tier,
                                    resident_pages=resident_pages,
                                    image_bytes=image_bytes)

    def _boot(self) -> float:
        """Runtime boot: device ready + dispatch path warm."""
        with spans.phase("coldstart.boot") as ph:
            torch.zeros((8,), device=self.device) + 1
            synchronize(self.device)
        return ph.seconds

    def _first_request(self, spec: FunctionSpec):
        w = wl.WORKLOADS.get(spec.fn_id)
        if w is not None:
            return w.request_builder()
        if spec.image_id in wl.IMAGE_CONFIGS:   # custom tenant on a model image
            return wl.default_request()
        return {}

    # ------------------------------------------------------------------ baseline
    def cold_start_baseline(self, fn_id: str):
        spec = self.registry.get(fn_id)
        t = PhaseTimes(network=self.cfg.network_s, container=self.cfg.container_s)
        t.boot = self._boot()

        t0 = time.perf_counter()
        params = None
        if spec.checkpoint_path:
            img = self.manager._ensure_live(spec.image_id)    # structure reference
            leaves = []
            with np.load(spec.checkpoint_path) as data:       # real disk IO
                for i in range(len(img.metadata.page_table.tree_order)):
                    if f"p{i}:bf16" in data:
                        raw = torch.from_numpy(data[f"p{i}:bf16"].view(np.int16))
                        leaf = raw.view(torch.bfloat16)
                    else:
                        leaf = torch.from_numpy(data[f"p{i}"])
                    leaves.append(leaf.to(self.device))
            params = img.treedef.unflatten(leaves)
        elif spec.image_id in wl.IMAGE_CONFIGS or spec.image_id == "py-base":
            # no uploaded checkpoint: initialize dependencies from scratch
            if spec.image_id == "py-base":
                params = wl.py_base_builder()
            else:
                params = wl.model_params_builder(spec.image_id, device=self.device)()
        synchronize(self.device)
        t.dependency_load = time.perf_counter() - t0
        # fresh closures + first forward (PyTorch's counterpart of the compile)
        t1 = time.perf_counter()
        execs = {}
        if spec.image_id in wl.IMAGE_CONFIGS:
            execs = wl.make_model_executables(spec.image_id)
            wl.warm_executables(execs, params, spec.image_id)
        t.dependency_compile = time.perf_counter() - t1
        t.dependency_init = time.perf_counter() - t0

        t0 = time.perf_counter()
        hw = spec.handler_builder()
        t.handler_import = time.perf_counter() - t0

        inst = FunctionInstance(spec, params, hw, execs)
        _, t.execution = inst.invoke(self._first_request(spec))
        return inst, t

    # ------------------------------------------------------------------ warmswap
    def cold_start_warmswap(self, fn_id: str,
                            policy: Optional[RestorePolicy] = None):
        """``(instance, PhaseTimes)``; the root span ``coldstart`` of a fresh
        invocation holds one span a phase, ``coldstart.<phase>``."""
        with spans.invocation(), spans.span("coldstart"):
            return self._warmswap(fn_id, policy)

    def _warmswap(self, fn_id: str, policy: Optional[RestorePolicy]):
        spec = self.registry.get(fn_id)
        policy = policy or self.cfg.policy
        t = PhaseTimes(network=self.cfg.network_s, container=self.cfg.container_s)
        t.boot = self._boot()

        # communication: metadata transfer + page-server attach
        with spans.phase("coldstart.communication") as ph:
            restored = self.manager.request_migration(spec.image_id, policy,
                                                      self.cfg.link)
        t.communication = ph.seconds

        # migration: restore params; touch leaves in layer order
        with spans.phase("coldstart.migration") as ph:
            w = wl.WORKLOADS.get(fn_id)
            touch = w.touch_keys if w is not None and w.touch_keys else None
            if policy == RestorePolicy.LAZY and touch is not None:
                params = {k: restored.fault(k) for k in touch}    # partial residency
            else:
                for key in restored.metadata.page_table.order[:1]:
                    restored.fault(key)                           # first fault
                params = restored.as_pytree()
            execs = self.manager.executables_for(spec.image_id)
            synchronize(self.device)
        t.migration = ph.seconds

        with spans.phase("coldstart.handler_import") as ph:
            hw = spec.handler_builder()
        t.handler_import = ph.seconds

        inst = FunctionInstance(spec, params, hw, execs)
        inst.migration_stats = restored.stats                 # type: ignore[attr-defined]
        with spans.span("coldstart.execution"):
            _, t.execution = inst.invoke(self._first_request(spec))
        with spans.span("coldstart.release"):
            self.manager.release(spec.image_id)
        return inst, t

    # ------------------------------------------------------------------ prebaking
    def prebake(self, fn_id: str) -> None:
        """Snapshot the *whole* warm function (base + handler) — one per function."""
        spec = self.registry.get(fn_id)
        img = self.manager._ensure_live(spec.image_id)
        hw = spec.handler_builder()
        self._prebaked[fn_id] = {
            "store": img.store.clone(),                       # full private copy
            "table": img.metadata.page_table,
            "treedef": img.treedef,
            "handler": {k: np.array(v) for k, v in hw.items()},
            "execs": img.executables,
        }

    def prebaked_bytes(self) -> int:
        return sum(s["store"].numel() + sum(v.nbytes for v in s["handler"].values())
                   for s in self._prebaked.values())

    def cold_start_prebaked(self, fn_id: str):
        spec = self.registry.get(fn_id)
        snap = self._prebaked[fn_id]
        t = PhaseTimes(network=self.cfg.network_s, container=self.cfg.container_s)
        t.boot = self._boot()
        t0 = time.perf_counter()
        params = materialize(snap["store"].clone(), snap["table"], snap["treedef"])
        synchronize(self.device)
        t.migration = time.perf_counter() - t0
        inst = FunctionInstance(spec, params, snap["handler"], snap["execs"])
        _, t.execution = inst.invoke(self._first_request(spec))
        return inst, t
