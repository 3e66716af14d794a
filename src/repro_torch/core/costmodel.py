"""Page-granular cold-start cost model for the simulators (paper §3.2, Table 2).

Port of ``repro.core.costmodel``: the same code with the imports pointed at the
port, so every sample, counter and float sum is bit-identical.

``simulator.CostModel`` charges one scalar latency per cold start. That hides
the thing HotSwap actually optimizes: a cold start *moves pages* — the shared
dependency image is live-migrated into the container page by page, and its
latency depends on how many pages must move, over which link, and how much of
the transfer the BULK policy hides behind execution. This module prices that:

    cold_latency = scalar base (boot + init compute + handler, per method)
                 + blocking page-transfer time
                   = f(image pages, pages already resident, link tier,
                       fault-on-demand vs background-stream mix)

Three link tiers, matching the cluster-shared image cache (``pool.py``):

  * ``local``  — the worker's own Dependency-Manager pool holds the image;
    pages move at host-memcpy speed (near-zero).
  * ``remote`` — some *other* worker's pool holds it (cluster-shared cache
    hit); pages cross the data-center network once.
  * ``miss``   — no pool holds it; pages come from the source store
    (registry / cold checkpoint storage), the slowest tier. The fetch
    populates the shared cache so the cluster pays it once.

The transfer math mirrors ``migration.RestoredImage`` under ``BULK``: a small
fraction of pages is faulted on demand (each fault pays a full per-request
round trip, serial), the rest is background-streamed in one request with most
of its time overlapped with the function's own execution. ``LAZY`` would be
``fault_fraction=1.0``; the paper's "w/o Lazy Migration" is
``stream_overlap=0.0``.

Units throughout: seconds for latencies, bytes for sizes, pages for counts
(one page = ``page_size`` bytes, default 4 MiB — ``pages.DEFAULT_PAGE_SIZE``).

Degenerate contract (asserted in ``tests/test_costmodel.py`` and relied on by
``docs/SIMULATION.md``): :meth:`PageCostModel.degenerate` — zero per-request
latency, infinite bandwidth on every tier — makes every blocking term exactly
0.0, so ``cold_latency_s`` equals ``method_cold_latency_s`` and both
``simulate()`` and ``simulate_fleet()`` reproduce their scalar results bit for
bit, including the 88 % memory-saving headline.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Optional

from repro_torch.core.migration import LinkModel
from repro_torch.core.pages import DEFAULT_PAGE_SIZE
from repro_torch.core.registry import Registry
from repro_torch.core.simulator import CostModel, method_cold_latency_s

#: Valid values for the ``tier`` argument of :meth:`PageCostModel.cold_latency_s`.
TIERS = ("local", "remote", "miss")

#: Name -> page-cost-model factory. Every factory takes the resolved scalar
#: ``cost`` model as its first kwarg (scenario specs inject it): ``default``
#: is the page-granular model with its stock link tiers, ``degenerate`` the
#: scalar-equivalent configuration (infinite bandwidth, zero RTT).
PAGE_COST_MODELS = Registry("page cost model")


def _default_local() -> LinkModel:
    """Host memcpy: ~10 GB/s, negligible per-request setup."""
    return LinkModel(latency_s=2e-6, bandwidth_bps=10e9)


def _default_remote() -> LinkModel:
    """Worker-to-worker DCN: 10 Gb/s with a ~200 us request round trip."""
    return LinkModel(latency_s=2e-4, bandwidth_bps=1.25e9)


def _default_source() -> LinkModel:
    """Source store (registry / cold checkpoint storage): ~400 MB/s, 5 ms RTT."""
    return LinkModel(latency_s=5e-3, bandwidth_bps=400e6)


@dataclass
class PageCostModel:
    """Page-granular cold-start pricing on top of a scalar :class:`CostModel`.

    Args:
        cost: the scalar per-method model. Its ``cold_*_s`` values are read as
            the *zero-transfer* base (container + boot + init compute +
            handler); this model adds the data-movement term on top. Its
            ``image_bytes`` / ``snapshot_bytes`` provide the default payload
            sizes.
        page_size: bytes per page (the transfer/sharing unit).
        local / remote / source: per-tier transports (see module docstring).
        fault_fraction: fraction of the missing pages fetched via synchronous
            page faults (each pays one full per-request round trip, serially).
            The remainder moves in one background bulk stream. 0.0..1.0.
        stream_overlap: fraction of the bulk-stream time hidden behind the
            function's own execution (BULK restore overlaps the stream with
            useful work). 0.0 = fully blocking, 1.0 = fully hidden.
    """
    cost: CostModel
    page_size: int = DEFAULT_PAGE_SIZE
    local: LinkModel = field(default_factory=_default_local)
    remote: LinkModel = field(default_factory=_default_remote)
    source: LinkModel = field(default_factory=_default_source)
    fault_fraction: float = 0.05
    stream_overlap: float = 0.85

    def __post_init__(self) -> None:
        if not (0.0 <= self.fault_fraction <= 1.0):
            raise ValueError(f"fault_fraction must be in [0, 1], "
                             f"got {self.fault_fraction}")
        if not (0.0 <= self.stream_overlap <= 1.0):
            raise ValueError(f"stream_overlap must be in [0, 1], "
                             f"got {self.stream_overlap}")
        if self.page_size <= 0:
            raise ValueError(f"page_size must be positive, got {self.page_size}")

    # ------------------------------------------------------------- constructors
    @classmethod
    def degenerate(cls, cost: CostModel) -> "PageCostModel":
        """The scalar-equivalent configuration: infinite bandwidth, zero
        per-request latency on every tier, so every transfer term is exactly
        0.0 and ``cold_latency_s`` == ``method_cold_latency_s`` for all
        methods, tiers, and residencies. This is the documented bridge between
        the page model and the pre-existing scalar engine."""
        return cls(cost=cost, local=LinkModel(), remote=LinkModel(),
                   source=LinkModel(), fault_fraction=0.0, stream_overlap=1.0)

    # ------------------------------------------------------------------ helpers
    def n_pages(self, nbytes: int) -> int:
        """Pages needed to hold ``nbytes`` (ceil division; >= 0)."""
        return max(0, -(-int(nbytes) // self.page_size))

    def image_pages(self, image_bytes: Optional[int] = None) -> int:
        """Page count of a dependency image (default: ``cost.image_bytes``)."""
        return self.n_pages(self.cost.image_bytes if image_bytes is None
                            else image_bytes)

    def _link(self, tier: str) -> LinkModel:
        try:
            return {"local": self.local, "remote": self.remote,
                    "miss": self.source}[tier]
        except KeyError:
            raise ValueError(f"unknown tier: {tier!r} (choose from {TIERS})")

    def blocking_s(self, missing_pages: int, link: LinkModel) -> float:
        """Execution-blocking seconds to migrate ``missing_pages`` over ``link``.

        BULK-style split: ``ceil(fault_fraction * missing)`` pages arrive via
        synchronous faults (one request each, serial); the rest arrives in one
        background stream whose time is ``(1 - stream_overlap)`` blocking.
        Returns exactly 0.0 when nothing is missing, and 0.0 under a
        :meth:`degenerate` link (no bandwidth term, no latency term).
        """
        missing = int(missing_pages)
        if missing <= 0:
            return 0.0
        fault_pages = min(missing, math.ceil(self.fault_fraction * missing))
        stream_pages = missing - fault_pages
        t = fault_pages * link.delay_for(self.page_size)
        if stream_pages:
            t += (1.0 - self.stream_overlap) * link.delay_for(
                stream_pages * self.page_size)
        return t

    def transfer_blocking_s(self, tier: str, resident_pages: int = 0,
                            image_bytes: Optional[int] = None) -> float:
        """The warmswap page-transfer term alone (no scalar base): blocking
        seconds to bring the image's non-resident pages in over ``tier``.
        This is the quantity placement ranks workers by (same base everywhere,
        only the transfer differs per worker)."""
        total = self.image_pages(image_bytes)
        return self.blocking_s(total - min(int(resident_pages), total),
                               self._link(tier))

    # ------------------------------------------------------------- the cold path
    def cold_latency_s(self, method: str, tier: str = "local",
                       resident_pages: int = 0,
                       image_bytes: Optional[int] = None) -> float:
        """Cold-start latency (seconds) for ``method`` under the page model.

        Args:
            method: ``'warmswap' | 'prebaking' | 'baseline'``.
            tier: where the warmswap image's pages come from (``'local'`` =
                this worker's pool, ``'remote'`` = another worker's pool via
                the cluster-shared cache, ``'miss'`` = source store). Ignored
                for prebaking (snapshots restore from local RAM) and baseline
                (everything always comes from the source store).
            resident_pages: pages already present at the destination
                (container-side partial residency); only the remainder moves.
                Ignored for baseline, which caches nothing.
            image_bytes: payload size override (default: the scalar model's
                ``image_bytes`` for warmswap/baseline, ``snapshot_bytes`` for
                prebaking).

        Returns:
            ``method_cold_latency_s(cost, method)`` plus the blocking transfer
            term. Under :meth:`degenerate` the transfer term is exactly 0.0.
        """
        if method not in ("warmswap", "prebaking", "baseline"):
            raise ValueError(f"unknown method: {method!r}")
        base = method_cold_latency_s(self.cost, method)
        resident = max(0, int(resident_pages))
        if method == "warmswap":
            total = self.image_pages(image_bytes)
            return base + self.blocking_s(total - min(resident, total),
                                          self._link(tier))
        if method == "prebaking":
            # one whole-snapshot restore: a single eager copy, no page
            # server, nothing overlapped. Tier picks the link: 'local' =
            # this worker's RAM, 'remote' = a peer's snapshot over the
            # network, 'miss' = the source snapshot store.
            total = self.n_pages(self.cost.snapshot_bytes if image_bytes is None
                                 else image_bytes)
            missing = total - min(resident, total)
            return base + (self._link(tier).delay_for(missing * self.page_size)
                           if missing else 0.0)
        # method == "baseline": the full dependency payload from the source
        # store, every time (nothing is ever cached)
        total = self.image_pages(image_bytes)
        return base + (self.source.delay_for(total * self.page_size)
                       if total else 0.0)

    def dependency_loading_speedup(self, tier: str = "local",
                                   image_bytes: Optional[int] = None) -> float:
        """Baseline-vs-WarmSwap *dependency-loading* ratio (the paper's
        2.2-3.2x band): time to make dependencies usable from scratch vs by
        live migration over ``tier``, excluding the shared container overhead
        both methods pay."""
        total = self.image_pages(image_bytes)
        base_s = (self.cost.cold_baseline_s
                  + (self.source.delay_for(total * self.page_size)
                     if total else 0.0))
        ws_s = (self.cost.cold_warmswap_s
                + self.blocking_s(total, self._link(tier)))
        return base_s / max(ws_s, 1e-12)


def _link_from(value) -> LinkModel:
    """A :class:`LinkModel` from a JSON-shaped dict (scenario kwargs) or a
    ready instance."""
    if isinstance(value, LinkModel):
        return value
    return LinkModel(**value)


@PAGE_COST_MODELS.register("default")
def _build_default(cost: CostModel, *, local=None, remote=None, source=None,
                   **kwargs) -> PageCostModel:
    """The stock page-granular model; ``local``/``remote``/``source`` accept
    ``{"latency_s": ..., "bandwidth_bps": ...}`` dicts so scenario specs can
    re-parameterize the link tiers from JSON."""
    for name, value in (("local", local), ("remote", remote),
                        ("source", source)):
        if value is not None:
            kwargs[name] = _link_from(value)
    return PageCostModel(cost=cost, **kwargs)


PAGE_COST_MODELS.register("degenerate", PageCostModel.degenerate)
