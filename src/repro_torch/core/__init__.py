"""The HotSwap cold-start path in PyTorch: pages, images, pool, migration,
registry, workloads and the cold-start orchestrator.

Only this slice's modules are exported; the simulation track of
``repro.core`` is not ported yet.
"""
from repro_torch.core.coldstart import (
    ColdStartConfig,
    ColdStartOrchestrator,
    FunctionInstance,
    PhaseTimes,
)
from repro_torch.core.image import ImageMetadata, LiveDependencyImage, build_image
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
from repro_torch.core.pool import CapacityLedger, DependencyManager, PoolStats
from repro_torch.core.registry import FunctionRegistry, FunctionSpec, Registry
from repro_torch.core.tree import TreeDef

__all__ = [
    "CapacityLedger", "ColdStartConfig", "ColdStartOrchestrator", "DEFAULT_PAGE_SIZE",
    "DependencyManager", "FunctionInstance", "FunctionRegistry", "FunctionSpec",
    "ImageMetadata", "LeafEntry", "LinkModel", "LiveDependencyImage",
    "MigrationClient", "MigrationStats", "PageServer", "PageTable", "PhaseTimes",
    "PoolStats", "Registry", "RestorePolicy", "RestoredImage", "TreeDef",
    "build_image", "materialize", "materialize_leaf", "paginate", "params_from_numpy",
]
