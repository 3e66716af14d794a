"""Declarative scenario API: one serializable spec, one ``run()`` entry point.

Port of ``repro.core.scenario``: the same code with the imports pointed at the
port, so every sample, counter and float sum is bit-identical.

The paper's argument is comparative — WarmSwap vs Prebaking vs Baseline under
identical skewed fleets — so the experiment surface here is *data*, not
call-site code. A :class:`Scenario` names every moving part of a simulation
by **string key into a component registry** (trace source, cost model,
page-cost model, keep-alive/pre-warm policy, placement strategy) plus plain
JSON-typed knobs (fleet shape, caps, cache bounds), round-trips losslessly
to/from JSON, and runs through a single :func:`run` returning a unified,
schema-versioned :class:`Result`.

Registries a scenario draws from (all ``repro_torch.core.registry.Registry``
instances; unknown keys fail with did-you-mean suggestions):

  ===================  ======================================  =============
  spec field           registry                                built-in keys
  ===================  ======================================  =============
  ``traces``           ``traces.TRACE_GENERATORS``             azure, fleet,
                                                               azure_csv
  ``cost``             ``simulator.COST_MODELS``               paper_table2,
                                                               scalar
  ``page_cost``        ``costmodel.PAGE_COST_MODELS``          default,
                                                               degenerate
  ``prewarm``          ``keepalive.PREWARM_POLICIES``          none,
                                                               histogram,
                                                               spes, bytes
  ``placement``        ``serving.scheduler.PLACEMENTS``        affinity,
                                                               least_loaded,
                                                               round_robin
  ``disruption``       ``disruption.DISRUPTIONS``              churn, preempt,
                                                               storm
  ===================  ======================================  =============

The legacy imperative surface is preserved as thin wrappers: both
``simulator.simulate()`` and ``fleet.simulate_fleet()`` route through
:func:`run` (via :class:`RunOverrides`, which carries already-resolved
components), so the degenerate-equivalence contract — including the 88 %
memory-saving headline and the 2.2–3.2× dependency-loading band — holds
through the declarative path by construction (asserted in
``tests/test_scenario.py``).

CLI: ``python -m repro_torch.experiments run scenario.json`` /
``... sweep scenario.json --axis n_workers=1,4,16``; shipped specs live in
``benchmarks/scenarios/`` and load in both packages. Schema reference:
``docs/API.md``.
"""
from __future__ import annotations

import dataclasses
import functools
import itertools
import json
import math
from dataclasses import dataclass, field
from typing import Any, Dict, List, Mapping, Optional, Sequence

from repro_torch.core.costmodel import PAGE_COST_MODELS, PageCostModel
from repro_torch.core.disruption import DISRUPTIONS
from repro_torch.core.keepalive import PREWARM_POLICIES, KeepAlivePolicy
from repro_torch.core.registry import did_you_mean as _did_you_mean
from repro_torch.core.simulator import (COST_MODELS, CostModel,
                                  memory_saving_fraction, quartile_latencies)
from repro_torch.core.trace_stream import NON_SEMANTIC_TRACE_KWARGS, TraceStream
from repro_torch.core.traces import TRACE_GENERATORS, Trace
from repro_torch.device import DeviceLike

#: Version of the :class:`Scenario` JSON schema this build reads and writes.
SCHEMA_VERSION = 1
#: Version of the :class:`Result` dict schema this build emits.
RESULT_SCHEMA_VERSION = 1

#: The paper's three start methods — the only valid ``Scenario.methods``.
METHODS = ("warmswap", "prebaking", "baseline")
#: Valid ``Scenario.engine`` values. ``fleet_vec`` is the vectorized batch
#: engine (``core/fleet_vec.py``) — bit-identical results to ``fleet``, with
#: an exact event-engine fallback outside its fast-path domain.
ENGINES = ("single", "fleet", "fleet_vec")


@dataclass
class ComponentSpec:
    """One pluggable component: a registry key plus per-component kwargs.

    In JSON a component is either a bare string (``"histogram"``) or an
    object (``{"name": "histogram", "kwargs": {"percentile": 95}}``).
    ``kwargs`` values must be JSON types; they are passed verbatim to the
    registered factory.
    """
    name: str
    kwargs: Dict[str, Any] = field(default_factory=dict)

    @classmethod
    def coerce(cls, value: Any, field_name: str = "component") -> "ComponentSpec":
        """A :class:`ComponentSpec` from a spec string / dict / instance."""
        if isinstance(value, ComponentSpec):
            return value
        if isinstance(value, str):
            return cls(name=value)
        if isinstance(value, Mapping):
            unknown = set(value) - {"name", "kwargs"}
            if unknown:
                raise ValueError(
                    f"unknown key(s) {sorted(unknown)} in {field_name} spec "
                    f"(a component is a string or "
                    f"{{'name': ..., 'kwargs': {{...}}}})")
            if "name" not in value:
                raise ValueError(f"{field_name} spec needs a 'name'")
            return cls(name=value["name"], kwargs=dict(value.get("kwargs") or {}))
        raise TypeError(f"{field_name} spec must be a string or dict, "
                        f"got {type(value).__name__}")

    def to_dict(self) -> Dict[str, Any]:
        return {"name": self.name, "kwargs": dict(self.kwargs)}


def _default_methods() -> List[str]:
    return list(METHODS)


@dataclass
class Scenario:
    """A complete, serializable description of one simulation experiment.

    Times are minutes, sizes bytes (the repo-wide simulation units,
    docs/SIMULATION.md). Every component field is a :class:`ComponentSpec`
    (in JSON: a string key or ``{"name", "kwargs"}``); plain fields are
    JSON scalars. ``smoke_overrides`` maps dotted paths into this spec to
    replacement values, applied by ``run(..., smoke=True)`` and the CLI's
    ``--smoke`` so one checked-in spec serves both CI and full-scale runs.
    """
    name: str = "scenario"
    description: str = ""
    schema_version: int = SCHEMA_VERSION
    engine: str = "fleet"                    # 'fleet' | 'fleet_vec' | 'single'
    methods: List[str] = field(default_factory=_default_methods)
    traces: ComponentSpec = field(
        default_factory=lambda: ComponentSpec("azure", {"n_functions": 10}))
    cost: ComponentSpec = field(
        default_factory=lambda: ComponentSpec("paper_table2"))
    page_cost: Optional[ComponentSpec] = None
    prewarm: ComponentSpec = field(
        default_factory=lambda: ComponentSpec("none"))
    placement: ComponentSpec = field(
        default_factory=lambda: ComponentSpec("affinity"))
    n_workers: int = 1
    max_instances_per_fn: Optional[int] = None
    worker_capacity_bytes: Optional[int] = None
    shared_cache_bytes: Optional[int] = None
    disruption: Optional[ComponentSpec] = None   # churn | preempt | storm
    keep_alive_min: float = 15.0
    shared_images: int = 1                   # single-engine memory model
    smoke_overrides: Dict[str, Any] = field(default_factory=dict)

    # ------------------------------------------------------------- validation
    def __post_init__(self) -> None:
        for f in ("traces", "cost", "prewarm", "placement"):
            setattr(self, f, ComponentSpec.coerce(getattr(self, f), f))
        if self.page_cost is not None:
            self.page_cost = ComponentSpec.coerce(self.page_cost, "page_cost")
        if self.disruption is not None:
            self.disruption = ComponentSpec.coerce(self.disruption,
                                                   "disruption")
        self.methods = list(self.methods)
        if self.engine not in ENGINES:
            raise ValueError(f"unknown engine: {self.engine!r} (choose from "
                             f"{list(ENGINES)})"
                             + _did_you_mean(self.engine, ENGINES))
        for m in self.methods:
            if m not in METHODS:
                raise ValueError(f"unknown method: {m!r} (choose from "
                                 f"{list(METHODS)})" + _did_you_mean(m, METHODS))
        if not self.methods:
            raise ValueError("scenario needs at least one method")
        if self.engine == "single":
            # the single-worker engine has no fleet shape: accepting these at
            # non-default values would silently simulate something else
            ignored = [name for name, is_default in (
                ("n_workers", self.n_workers == 1),
                ("max_instances_per_fn", self.max_instances_per_fn is None),
                ("worker_capacity_bytes", self.worker_capacity_bytes is None),
                ("shared_cache_bytes", self.shared_cache_bytes is None),
                ("disruption", self.disruption is None),
                ("placement", self.placement == ComponentSpec("affinity")),
                ("prewarm", self.prewarm == ComponentSpec("none")),
            ) if not is_default]
            if ignored:
                raise ValueError(
                    f"engine='single' has no fleet shape; field(s) {ignored} "
                    f"would be silently ignored — remove them or use "
                    f"engine='fleet'")
        elif self.shared_images != 1:
            # ...and the fleet engine derives image counts from the traces
            raise ValueError(
                "shared_images parameterizes the single-engine memory model "
                "and is ignored by engine='fleet' (image sharing comes from "
                "the trace generator's n_images there) — remove it or use "
                "engine='single'")
        # strict loading: unknown component keys fail at construction, with
        # did-you-mean (placement's registry lives behind the repro_torch.serving
        # import and is checked by validate_components() / run() instead)
        TRACE_GENERATORS.resolve(self.traces.name)
        COST_MODELS.resolve(self.cost.name)
        if self.page_cost is not None:
            PAGE_COST_MODELS.resolve(self.page_cost.name)
        if self.disruption is not None:
            DISRUPTIONS.resolve(self.disruption.name)
        PREWARM_POLICIES.resolve(self.prewarm.name)

    def validate_components(self) -> None:
        """Resolve every component key against its registry (raises
        :class:`~repro_torch.core.registry.UnknownComponentError` with did-you-mean
        on failure). Construction already checks all but ``placement``, whose
        registry needs the ``repro_torch.serving`` import; the CLI's ``validate``
        command and :func:`run` both call this."""
        from repro_torch.serving.scheduler import PLACEMENTS
        PLACEMENTS.resolve(self.placement.name)

    # ---------------------------------------------------------- serialization
    def to_dict(self) -> Dict[str, Any]:
        """A plain JSON-typed dict; ``from_dict`` of it is identity."""
        d: Dict[str, Any] = {}
        for f in dataclasses.fields(self):
            v = getattr(self, f.name)
            if isinstance(v, ComponentSpec):
                v = v.to_dict()
            elif isinstance(v, (list, tuple)):
                v = list(v)
            elif isinstance(v, dict):
                v = dict(v)
            d[f.name] = v
        return d

    @classmethod
    def from_dict(cls, d: Mapping[str, Any]) -> "Scenario":
        """Build and validate a scenario from a JSON-shaped dict.

        Rejects unknown top-level keys (with did-you-mean suggestions) and
        specs written by a *newer* schema than this build understands.
        """
        if not isinstance(d, Mapping):
            raise TypeError(f"scenario spec must be a dict, "
                            f"got {type(d).__name__}")
        known = {f.name for f in dataclasses.fields(cls)}
        for key in d:
            if key not in known:
                raise ValueError(f"unknown scenario field: {key!r}"
                                 + _did_you_mean(key, known))
        version = d.get("schema_version", SCHEMA_VERSION)
        if not isinstance(version, int) or version < 1:
            raise ValueError(f"schema_version must be a positive integer, "
                             f"got {version!r}")
        if version > SCHEMA_VERSION:
            raise ValueError(
                f"scenario schema_version {version} is newer than this build "
                f"supports (<= {SCHEMA_VERSION}); update the repo or re-export "
                f"the spec")
        return cls(**dict(d))

    def to_json(self, indent: int = 1) -> str:
        return json.dumps(self.to_dict(), indent=indent)

    @classmethod
    def from_json(cls, text: str) -> "Scenario":
        return cls.from_dict(json.loads(text))

    @classmethod
    def from_file(cls, path: str) -> "Scenario":
        with open(path) as f:
            return cls.from_dict(json.load(f))

    # -------------------------------------------------------------- overrides
    def with_overrides(self, overrides: Mapping[str, Any]) -> "Scenario":
        """A new scenario with dotted-path overrides applied to the spec dict
        (e.g. ``{"traces.kwargs.horizon_min": 1440, "n_workers": 4}``) and
        re-validated. The base scenario is untouched."""
        d = self.to_dict()
        for path, value in overrides.items():
            _set_path(d, path, value)
        return Scenario.from_dict(d)

    def smoke_scaled(self) -> "Scenario":
        """This scenario with its own ``smoke_overrides`` applied (identity
        when none are declared)."""
        if not self.smoke_overrides:
            return self
        return self.with_overrides(self.smoke_overrides)


def _set_path(d: Dict[str, Any], path: str, value: Any) -> None:
    """Set ``d[a][b][c] = value`` for ``path`` ``'a.b.c'``, creating
    intermediate dicts as needed."""
    parts = path.split(".")
    node = d
    for p in parts[:-1]:
        nxt = node.get(p)
        if not isinstance(nxt, dict):
            nxt = {}
            node[p] = nxt
        node = nxt
    node[parts[-1]] = value


def sweep(base: Scenario, axes: Mapping[str, Sequence[Any]]) -> List[Scenario]:
    """Expand grid ``axes`` over ``base`` into one scenario per grid cell.

    Axis keys are dotted paths into the spec dict (``"n_workers"``,
    ``"traces.kwargs.n_images"``, ``"placement.name"``); values are the
    points along that axis. The grid is the cartesian product in the axes'
    given order, and each expanded scenario's name records its coordinates
    (``base[n_workers=4,placement.name=affinity]``).

    Returns:
        One validated :class:`Scenario` per cell; ``base`` is untouched.
    """
    if not axes:
        return [base]
    keys = list(axes)
    out = []
    for values in itertools.product(*(axes[k] for k in keys)):
        coords = dict(zip(keys, values))
        label = ",".join(f"{k}={v}" for k, v in coords.items())
        scn = base.with_overrides(coords)
        scn.name = f"{base.name}[{label}]"
        out.append(scn)
    return out


# -------------------------------------------------------------------------------
# The unified result schema
# -------------------------------------------------------------------------------

@dataclass
class MethodResult:
    """One method's outcomes in engine-independent shape (latencies in
    seconds, memory in bytes, residency in instance-minutes). Fields the
    single-worker engine cannot produce (pool/cache/pre-warm counters) hold
    their zero defaults there."""
    method: str
    n_invocations: int
    n_cold: int
    n_warm: int
    total_latency_s: float
    avg_latency_s: float
    latency_percentiles_s: Dict[str, float]
    quartile_latency_s: Dict[str, float]
    memory_bytes: int
    n_queued: int = 0
    queue_delay_s: float = 0.0
    pool_misses: int = 0
    evictions: int = 0
    prewarm_spawns: int = 0
    prewarm_hits: int = 0
    prewarm_dropped: int = 0
    max_concurrent_instances: int = 1
    instance_resident_min: float = 0.0
    cache_hits: Dict[str, int] = field(
        default_factory=lambda: {"local": 0, "remote": 0, "miss": 0})
    pages_transferred: int = 0
    shared_cache_peak_bytes: int = 0
    shared_cache_evictions: int = 0
    placement_warm_hits: int = 0
    placement_pool_hits: int = 0
    requeued: int = 0
    worker_failures: int = 0
    worker_recoveries: int = 0
    cache_flushes: int = 0

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)


@dataclass
class Result:
    """One :func:`run`'s outputs: the spec echo, per-method unified results,
    and cross-method summary numbers. ``raw`` keeps the engine-native
    ``SimResult`` / ``FleetResult`` objects (latency sample arrays included)
    and ``traces`` the resolved arrival traces, for callers that need them
    (e.g. per-quartile percentile breakdowns); neither is serialized.

    ``methods`` is computed lazily from ``raw`` on first access: the unified
    projection pays a percentile pass over every latency sample, which the
    legacy ``simulate()``/``simulate_fleet()`` wrappers (which only read
    ``raw``) should not be charged for."""
    scenario: Dict[str, Any]
    engine: str
    summary: Dict[str, float]
    result_schema_version: int = RESULT_SCHEMA_VERSION
    raw: Dict[str, Any] = field(default_factory=dict, repr=False)
    traces: List[Trace] = field(default_factory=list, repr=False)
    _methods: Optional[Dict[str, MethodResult]] = field(default=None,
                                                        repr=False)

    @property
    def methods(self) -> Dict[str, MethodResult]:
        if self._methods is None:
            self._methods = {m: _method_result(r, self.traces)
                             for m, r in self.raw.items()}
        return self._methods

    def to_dict(self) -> Dict[str, Any]:
        return {
            "result_schema_version": self.result_schema_version,
            "scenario": self.scenario,
            "engine": self.engine,
            "methods": {m: r.to_dict() for m, r in self.methods.items()},
            "summary": dict(self.summary),
        }

    def to_json(self, indent: int = 1) -> str:
        return json.dumps(self.to_dict(), indent=indent)


#: Keys every serialized per-method result must carry (subset of
#: :class:`MethodResult`; checked by :func:`validate_result`).
_REQUIRED_METHOD_KEYS = ("method", "n_invocations", "n_cold", "n_warm",
                         "total_latency_s", "avg_latency_s",
                         "latency_percentiles_s", "memory_bytes")


def validate_result(d: Mapping[str, Any]) -> Mapping[str, Any]:
    """Validate a serialized :class:`Result` dict (CI's scenario smoke job
    runs every checked-in spec through this). Raises ``ValueError`` on a
    missing key, a future result schema, an unknown method, or a non-finite/
    negative latency; returns ``d`` unchanged when valid."""
    for key in ("result_schema_version", "scenario", "engine", "methods",
                "summary"):
        if key not in d:
            raise ValueError(f"result is missing {key!r}")
    version = d["result_schema_version"]
    if not isinstance(version, int) or version > RESULT_SCHEMA_VERSION:
        raise ValueError(f"unsupported result_schema_version {version!r} "
                         f"(<= {RESULT_SCHEMA_VERSION})")
    if not d["methods"]:
        raise ValueError("result has no methods")
    for m, mr in d["methods"].items():
        if m not in METHODS:
            raise ValueError(f"unknown method in result: {m!r}")
        for key in _REQUIRED_METHOD_KEYS:
            if key not in mr:
                raise ValueError(f"method {m!r} result is missing {key!r}")
        lats = [mr["total_latency_s"], mr["avg_latency_s"],
                mr.get("queue_delay_s", 0.0),
                *mr["latency_percentiles_s"].values()]
        for v in lats:
            if not math.isfinite(v) or v < 0:
                raise ValueError(f"method {m!r} has a non-finite or negative "
                                 f"latency: {v!r}")
    return d


# -------------------------------------------------------------------------------
# The one entry point
# -------------------------------------------------------------------------------

@dataclass
class RunOverrides:
    """Already-resolved components that bypass registry construction.

    This is how the legacy wrappers (``simulate()`` / ``simulate_fleet()``)
    route through :func:`run` with the live objects their callers handed
    them — including non-serializable ones (policy instances, a fully
    configured ``FleetConfig``). Any field left ``None`` is built from the
    scenario spec as usual.
    """
    traces: Optional[Union[List[Trace], TraceStream]] = None
    cost: Optional[CostModel] = None
    page_cost: Optional[PageCostModel] = None
    keep_alive: Optional[KeepAlivePolicy] = None   # single engine only
    fleet: Optional["FleetConfig"] = None          # fleet engine only


def _method_result(r, traces: List[Trace]) -> MethodResult:
    """Project a ``SimResult`` or ``FleetResult`` onto the unified schema."""
    is_fleet = hasattr(r, "pool_misses")
    return MethodResult(
        method=r.method,
        n_invocations=r.n_invocations,
        n_cold=r.n_cold,
        n_warm=r.n_warm,
        total_latency_s=float(r.total_latency_s),
        avg_latency_s=float(r.avg_latency_s),
        latency_percentiles_s=r.latency_percentiles(),
        quartile_latency_s=quartile_latencies(traces, r),
        memory_bytes=int(r.memory_bytes),
        n_queued=r.n_queued,
        queue_delay_s=float(r.queue_delay_s),
        pool_misses=r.pool_misses if is_fleet else 0,
        evictions=r.evictions if is_fleet else 0,
        prewarm_spawns=r.prewarm_spawns if is_fleet else 0,
        prewarm_hits=r.prewarm_hits if is_fleet else 0,
        prewarm_dropped=r.prewarm_dropped if is_fleet else 0,
        max_concurrent_instances=(r.max_concurrent_instances
                                  if is_fleet else 1),
        instance_resident_min=(float(r.instance_resident_min)
                               if is_fleet else 0.0),
        cache_hits=({"local": r.cache_local_hits,
                     "remote": r.cache_remote_hits,
                     "miss": r.cache_misses} if is_fleet
                    else {"local": 0, "remote": 0, "miss": 0}),
        pages_transferred=r.pages_transferred if is_fleet else 0,
        shared_cache_peak_bytes=(r.shared_cache_peak_bytes
                                 if is_fleet else 0),
        shared_cache_evictions=(r.shared_cache_evictions
                                if is_fleet else 0),
        placement_warm_hits=r.placement_warm_hits if is_fleet else 0,
        placement_pool_hits=r.placement_pool_hits if is_fleet else 0,
        requeued=r.requeued if is_fleet else 0,
        worker_failures=r.worker_failures if is_fleet else 0,
        worker_recoveries=r.worker_recoveries if is_fleet else 0,
        cache_flushes=r.cache_flushes if is_fleet else 0,
    )


def run(scenario: Scenario, *, smoke: bool = False,
        overrides: Optional[RunOverrides] = None,
        sanitize: Optional[bool] = None, device: DeviceLike = None) -> Result:
    """Run one scenario end to end: resolve components from the registries,
    simulate every method, return the unified :class:`Result`.

    This is the single simulation entry point — the legacy ``simulate()`` /
    ``simulate_fleet()`` signatures are thin wrappers over it (they pass
    resolved components via ``overrides``), so declarative and imperative
    callers exercise the same engines.

    Args:
        scenario: the spec (typically ``Scenario.from_file(...)``).
        smoke: apply the spec's ``smoke_overrides`` first (CI scale).
        overrides: already-resolved components to use instead of building
            from the spec (see :class:`RunOverrides`).
        sanitize: run under the repro-san invariant sanitizer
            (``repro_torch.core.sanitize``): instrumented assertions at every
            drain step, a :class:`~repro_torch.core.sanitize.SanitizeError` with
            a repro artifact on violation, bit-identical results otherwise.
            ``None`` (default) follows the ``REPRO_SANITIZE`` env knob.
        device: where the ``fleet_vec`` engine's cap=1 scan runs when it is
            on (``REPRO_FLEET_VEC_SCAN=1``): ``cuda`` unless ``"cpu"``.

    Returns:
        A :class:`Result`; ``result.raw[method]`` holds the engine-native
        per-method result objects.
    """
    # deferred: fleet imports this module's wrappers' home modules —
    # importing it at module load would be circular
    from repro_torch.core.fleet import FleetConfig, _simulate_fleet_impl
    from repro_torch.core.sanitize import FleetSanitizer, sanitize_enabled
    from repro_torch.core.simulator import _simulate_impl

    scn = scenario.smoke_scaled() if smoke else scenario
    ov = overrides if overrides is not None else RunOverrides()
    san_on = sanitize_enabled() if sanitize is None else bool(sanitize)
    scn_dict = scn.to_dict() if san_on else None

    traces = (ov.traces if ov.traces is not None
              else TRACE_GENERATORS.build(scn.traces.name, **scn.traces.kwargs))
    if isinstance(traces, TraceStream):
        # chunked execution: the fleet event engine consumes the stream
        # natively (bit-identical to the materialized run — docs/TRACES.md);
        # fleet_vec falls back to it via fast_path_reason. The single engine
        # has no chunked path, so it materializes.
        if scn.engine == "single":
            traces = traces.materialize()
        elif scn.disruption is not None:
            raise ValueError(
                "disruption schedules are built against the trace horizon, "
                "which a stream only knows after its last chunk; set "
                "traces.kwargs.stream=false to combine disruption with "
                "this workload")
    cost = (ov.cost if ov.cost is not None
            else COST_MODELS.build(scn.cost.name, **scn.cost.kwargs))
    page = ov.page_cost
    if page is None and scn.page_cost is not None:
        page = PAGE_COST_MODELS.build(scn.page_cost.name, cost=cost,
                                      **scn.page_cost.kwargs)

    raw: Dict[str, Any] = {}
    if scn.engine == "single":
        # no placement validation here: the single engine has none, and
        # construction already rejected a non-default placement spec — so a
        # simulation-only caller never pays the repro_torch.serving import
        keep_alive = (ov.keep_alive if ov.keep_alive is not None
                      else KeepAlivePolicy(scn.keep_alive_min))
        for m in scn.methods:
            raw[m] = _simulate_impl(traces, m, cost, keep_alive,
                                    scn.shared_images, page)
            if san_on:
                FleetSanitizer("single", m,
                               scenario=scn_dict).check_single(raw[m])
    else:
        # deferred: repro_torch.serving pulls in the model/engine stack
        from repro_torch.serving.scheduler import PLACEMENTS
        scn.validate_components()
        fleet_cfg = ov.fleet
        if fleet_cfg is None:
            placement = (scn.placement.name if not scn.placement.kwargs
                         else PLACEMENTS.build(scn.placement.name,
                                               **scn.placement.kwargs))
            prewarm = (scn.prewarm.name if not scn.prewarm.kwargs
                       else PREWARM_POLICIES.build(scn.prewarm.name,
                                                   **scn.prewarm.kwargs))
            disruption = None
            if scn.disruption is not None:
                # schedule factories take the runtime-injected fleet shape:
                # the worker count and the trace horizon (last arrival)
                horizon = max((float(t.arrivals_min[-1]) for t in traces
                               if len(t.arrivals_min)), default=0.0)
                disruption = DISRUPTIONS.build(
                    scn.disruption.name, n_workers=scn.n_workers,
                    horizon_min=horizon, **scn.disruption.kwargs)
            fleet_cfg = FleetConfig(
                n_workers=scn.n_workers,
                placement=placement,
                max_instances_per_fn=scn.max_instances_per_fn,
                worker_capacity_bytes=scn.worker_capacity_bytes,
                prewarm=prewarm,
                keep_alive_min=scn.keep_alive_min,
                page_cost=page,
                shared_cache_bytes=scn.shared_cache_bytes,
                disruption=disruption,
            )
        if scn.engine == "fleet_vec":
            from repro_torch.core.fleet_vec import simulate_fleet_vec
            impl = functools.partial(simulate_fleet_vec, device=device)
        else:
            impl = _simulate_fleet_impl
        for m in scn.methods:
            if san_on:
                raw[m] = impl(traces, m, cost, fleet_cfg,
                              sanitizer=FleetSanitizer(scn.engine, m,
                                                       scenario=scn_dict))
            else:
                raw[m] = impl(traces, m, cost, fleet_cfg)

    summary: Dict[str, float] = {}
    if "warmswap" in raw and "prebaking" in raw:
        summary["memory_saving_vs_prebaking"] = memory_saving_fraction(
            raw["warmswap"], raw["prebaking"])
    if page is not None:
        # the paper's dependency-loading comparison (2.2-3.2x band at the
        # ~230 MB paper-scale image) priced by the scenario's own page model
        summary["dependency_loading_speedup"] = (
            page.dependency_loading_speedup())
    return Result(scenario=scn.to_dict(), engine=scn.engine,
                  summary=summary, raw=raw,
                  traces=(traces.meta_traces()
                          if isinstance(traces, TraceStream) else traces))
