"""HotSwap core in PyTorch: the cold-start path (pages, images, pool,
migration, registry, workloads, the cold-start orchestrator) and the
simulation track.

Port of ``repro.core``; it imports neither JAX nor the JAX package:
  * pages       — pytree <-> page-store encoding (the memory-page layer)
  * image       — LiveDependencyImage / build_image (the shareable unit)
  * pool        — DependencyManager (provider-side pool, RAM+disk tiers, LRU)
                  and ClusterImageCache (the fleet's cluster-wide image tier)
  * migration   — PageServer + MigrationClient, 4 restore policies
  * registry    — FunctionRegistry (endpoints = image ref + private handler)
  * coldstart   — ColdStartOrchestrator with per-phase timers and the page
                  model's predicted cold latency
  * keepalive   — E_cs(λ) arrival math + pluggable pre-warm policies
  * traces, trace_stream — Azure-statistics / Zipf / CSV fleet traces
  * simulator   — single-worker, queue-accurate simulation (Fig. 7)
  * costmodel   — the page-granular cold-start cost model
  * events, fleet, fleet_vec — the discrete-event and vectorized fleet
                  engines (fleet_vec's cap=1 scan runs the fleet_scan kernel)
  * disruption, sanitize, oracle — churn schedules, the runtime invariant
                  sanitizer, hindsight-optimal lower bounds
  * scenario    — declarative Scenario spec + run() + sweep()
  * workloads   — FunctionBench-analogue suite
"""
from repro_torch.core.coldstart import (
    ColdStartConfig,
    ColdStartOrchestrator,
    FunctionInstance,
    PhaseTimes,
)
from repro_torch.core.costmodel import PAGE_COST_MODELS, PageCostModel
from repro_torch.core.events import Event, EventKind, EventQueue
from repro_torch.core.fleet import FleetConfig, FleetResult, simulate_fleet
from repro_torch.core.image import ImageMetadata, LiveDependencyImage, build_image
from repro_torch.core.keepalive import (
    PREWARM_POLICIES,
    BytesAwareKeepAlive,
    HistogramKeepAlive,
    KeepAlivePolicy,
    PrewarmPolicy,
    SpesPrewarm,
    expected_cold_starts,
)
from repro_torch.core.migration import (
    LinkModel,
    MigrationClient,
    MigrationStats,
    PageServer,
    RestoredImage,
    RestorePolicy,
)
from repro_torch.core.pages import (
    DEFAULT_PAGE_SIZE,
    LeafEntry,
    PageTable,
    materialize,
    materialize_leaf,
    paginate,
    params_from_numpy,
)
from repro_torch.core.pool import (
    CapacityLedger,
    ClusterImageCache,
    DependencyManager,
    PoolStats,
)
from repro_torch.core.registry import (
    FunctionRegistry,
    FunctionSpec,
    Registry,
    UnknownComponentError,
)
from repro_torch.core.scenario import (
    ComponentSpec,
    MethodResult,
    Result,
    RunOverrides,
    Scenario,
    run,
    sweep,
    validate_result,
)
from repro_torch.core.simulator import (
    COST_MODELS,
    CostModel,
    memory_saving_fraction,
    simulate,
)
from repro_torch.core.traces import TRACE_GENERATORS, generate_fleet_traces, generate_traces
from repro_torch.core.tree import TreeDef

__all__ = [
    "BytesAwareKeepAlive", "COST_MODELS", "CapacityLedger", "ClusterImageCache",
    "ColdStartConfig", "ColdStartOrchestrator", "ComponentSpec", "CostModel",
    "DEFAULT_PAGE_SIZE", "DependencyManager", "Event", "EventKind", "EventQueue",
    "FleetConfig", "FleetResult", "FunctionInstance", "FunctionRegistry",
    "FunctionSpec", "HistogramKeepAlive", "ImageMetadata", "KeepAlivePolicy",
    "LeafEntry", "LinkModel", "LiveDependencyImage", "MethodResult",
    "MigrationClient", "MigrationStats", "PAGE_COST_MODELS", "PREWARM_POLICIES",
    "PageCostModel", "PageServer", "PageTable", "PhaseTimes", "PoolStats",
    "PrewarmPolicy", "Registry", "RestorePolicy", "RestoredImage", "Result",
    "RunOverrides", "Scenario", "SpesPrewarm", "TRACE_GENERATORS", "TreeDef",
    "UnknownComponentError", "build_image", "expected_cold_starts",
    "generate_fleet_traces", "generate_traces", "materialize", "materialize_leaf",
    "memory_saving_fraction", "paginate", "params_from_numpy", "run", "simulate",
    "simulate_fleet", "sweep", "validate_result",
]
