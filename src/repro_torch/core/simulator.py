"""Trace-driven fleet simulation: WarmSwap vs Prebaking vs Baseline (paper §4.5).

Port of ``repro.core.simulator``: the same code with the imports pointed at the
port, so every sample, counter and float sum is bit-identical.

Discrete-event simulation over per-function invocation traces:

  * each function keeps at most one instance; an invocation within the keep-alive
    window is a **warm start**, otherwise a **cold start** (the >99 % case the paper
    scopes to, §2.2);
  * queue-accurate: an arrival while the (single) instance is still executing
    waits for it — latency = queue delay + warm cost, and the instance's
    completion time never rewinds (Lindley recursion over each trace);
  * cold-start latency comes from a per-method :class:`CostModel` — either measured
    numbers produced by ``benchmarks/bench_coldstart.py`` on this machine, or the
    paper's own Table 2 values for a paper-faithful simulation;
  * memory accounting follows each method's structure: WarmSwap = one shared image
    per *dependency* + per-function metadata/handler; Prebaking = one full snapshot
    per *function*; Baseline = nothing resident.

Outputs match Fig. 7: average latency per invocation-rate quartile + required cache
memory, and the headline "X % memory saved when N functions share one image".
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np

from repro_torch.core.keepalive import KeepAlivePolicy
from repro_torch.core.registry import Registry
from repro_torch.core.traces import Trace, quartile_groups

#: Name -> scalar cost-model factory. Scenario specs address cost models by
#: key: ``paper_table2`` is the paper's measured Table 2 numbers, ``scalar``
#: builds a :class:`CostModel` from explicit kwargs.
COST_MODELS = Registry("cost model")


@dataclass
class CostModel:
    """Per-method start latencies (seconds) and memory shapes (bytes).

    This is the *scalar* model: one constant cold-start latency per method.
    ``core/costmodel.PageCostModel`` wraps it to price cold starts by page
    transfer volume instead; there the ``cold_*_s`` values are read as the
    zero-transfer base (boot + init compute + handler) and the page-transfer
    term is added on top. Under ``PageCostModel.degenerate`` the two models
    agree exactly (see docs/SIMULATION.md).
    """
    cold_warmswap_s: float
    cold_prebaking_s: float
    cold_baseline_s: float
    warm_s: float
    container_s: float = 0.5          # included for cold starts of BOTH methods (§4.5)
    image_bytes: int = 230 << 20      # one shared dependency image (paper: 260 MB total
    metadata_bytes: int = 3 << 20     #   = image + 10 x per-fn metadata, §4.5)
    snapshot_bytes: int = 230 << 20   # one prebaked snapshot per function (~2.3 GB /10)
    image_revive_s: float = 0.4       # extra cold-start cost when the worker's pool
                                      #   must revive/rebuild the image first
                                      #   (disk-tier revive, §3.2; fleet sim only)

    @classmethod
    def paper_table2(cls) -> "CostModel":
        """The paper's measured rnn_serving-class numbers (Table 2 / §4.5)."""
        return cls(cold_warmswap_s=0.89, cold_prebaking_s=0.91, cold_baseline_s=2.2,
                   warm_s=0.004)


COST_MODELS.register("scalar", CostModel)
COST_MODELS.register("paper_table2", CostModel.paper_table2)


def method_cold_latency_s(cost: CostModel, method: str) -> float:
    """Scalar cold-start latency (seconds) for ``method``, pool hit assumed.

    Args:
        cost: the scalar cost model.
        method: ``'warmswap' | 'prebaking' | 'baseline'``.

    Returns:
        Per-method cold latency including the flat container overhead.
        Shared by ``simulate()`` and ``fleet.simulate_fleet()``; the
        page-granular model (``costmodel.PageCostModel``) uses it as the
        zero-transfer base.
    """
    return {
        "warmswap": cost.cold_warmswap_s + cost.container_s,
        "prebaking": cost.cold_prebaking_s + cost.container_s,
        "baseline": cost.cold_baseline_s + cost.container_s,
    }[method]


def method_memory_bytes(cost: CostModel, method: str, n_functions: int,
                        shared_images: int = 1) -> int:
    """Single-worker resident-memory model (bytes).

    Args:
        cost: the scalar cost model (``image_bytes`` / ``metadata_bytes`` /
            ``snapshot_bytes``).
        method: ``'warmswap' | 'prebaking' | 'baseline'``.
        n_functions: functions served by this worker.
        shared_images: distinct dependency images across those functions.

    Returns:
        WarmSwap = shared images + per-function metadata (O(#images));
        Prebaking = one full snapshot per function (O(#functions));
        Baseline = nothing resident.
    """
    return {
        "warmswap": shared_images * cost.image_bytes
                    + n_functions * cost.metadata_bytes,
        "prebaking": n_functions * cost.snapshot_bytes,
        "baseline": 0,
    }[method]


def latency_percentiles(samples: np.ndarray) -> Dict[str, float]:
    """P50/P95/P99 (+ mean/max) over per-request latency samples (seconds)."""
    samples = np.asarray(samples, np.float64)
    if samples.size == 0:
        return {"p50": 0.0, "p95": 0.0, "p99": 0.0, "mean": 0.0, "max": 0.0}
    p50, p95, p99 = np.percentile(samples, [50.0, 95.0, 99.0])
    return {"p50": float(p50), "p95": float(p95), "p99": float(p99),
            "mean": float(samples.mean()), "max": float(samples.max())}


@dataclass
class SimResult:
    """One ``simulate()`` run's outputs (latencies in seconds, memory in
    bytes; ``latency_samples_s`` is per request, in per-trace order)."""
    method: str
    n_invocations: int
    n_cold: int
    n_warm: int
    total_latency_s: float
    memory_bytes: int
    per_fn_latency: Dict[int, float] = field(default_factory=dict)
    per_fn_invocations: Dict[int, int] = field(default_factory=dict)
    n_queued: int = 0                    # arrivals that waited on a busy instance
    queue_delay_s: float = 0.0           # total time arrivals spent waiting
    latency_samples_s: np.ndarray = field(
        default_factory=lambda: np.empty(0))   # per request (per-trace order)
    sample_fn: np.ndarray = field(
        default_factory=lambda: np.empty(0, np.int64))  # fn index per sample

    @property
    def avg_latency_s(self) -> float:
        return self.total_latency_s / max(self.n_invocations, 1)

    def latency_percentiles(self) -> Dict[str, float]:
        return latency_percentiles(self.latency_samples_s)


def _simulate_trace(arrivals: np.ndarray, ka: float, cold_s: float,
                    warm_s: float):
    """Queue-accurate single-instance scan over one trace.

    Returns ``(lats_s, waits_s, n_cold)``. An arrival within the keep-alive
    window of the previous completion is warm; if the instance is still
    executing it queues behind it (single-server FIFO), so its latency is
    queue delay + warm cost and the completion time never rewinds.

    Vectorized: an arrival whose gap to its predecessor is <= ka is
    *guaranteed* warm (the previous completion is >= the previous arrival, so
    its expiry covers the gap). Only gap > ka arrivals can cold-start, which
    splits the trace into segments headed by a potential cold start followed
    by all-warm interiors. Each interior is a Lindley recursion with constant
    (warm) service — solved in closed form with a running maximum — so a
    multi-million-arrival high-rate trace costs a few numpy passes, not a
    Python loop per request.
    """
    n = len(arrivals)
    lats = np.empty(n)
    waits = np.zeros(n)
    if n == 0:
        return lats, waits, 0
    w_min = warm_s / 60.0
    heads = np.concatenate(
        ([0], np.flatnonzero(np.diff(arrivals) > ka) + 1))
    n_cold = 0
    free_at = -np.inf                  # completion time of the in-flight request
    for s, h in enumerate(heads):
        end = heads[s + 1] if s + 1 < len(heads) else n    # segment [h, end)
        t_h = float(arrivals[h])
        if t_h > free_at + ka:
            # instance expired (or first arrival): fresh cold start, no wait
            n_cold += 1
            start, svc = t_h, cold_s
        else:
            # warm; a long backlog can still cover a gap > ka, so the head may
            # queue behind the in-flight request
            start, svc = max(t_h, free_at), warm_s
        waits[h] = (start - t_h) * 60.0
        lats[h] = waits[h] + svc
        free_at = start + svc / 60.0
        if end > h + 1:
            # interior j in (h, end): completion c_j = max(t_j, c_{j-1}) + w.
            # With u_p = t_p - p*w (p = interior position), the recursion
            # unrolls to c_p = (p+1)*w + max(c_head, runmax(u_0..u_p)).
            seg = arrivals[h + 1: end]
            p = np.arange(end - h - 1, dtype=np.float64)
            peak = np.maximum(np.maximum.accumulate(seg - p * w_min), free_at)
            starts = peak + p * w_min                     # = c_j - w_min
            waits[h + 1: end] = (starts - seg) * 60.0
            lats[h + 1: end] = waits[h + 1: end] + warm_s
            free_at = float(starts[-1]) + w_min
    return lats, waits, n_cold


def simulate(
    traces: List[Trace],
    method: str,                       # 'warmswap' | 'prebaking' | 'baseline'
    cost: CostModel,
    keep_alive: Optional[KeepAlivePolicy] = None,
    shared_images: int = 1,            # distinct dependency images across the fleet
    page_cost: Optional["PageCostModel"] = None,  # page-granular cold pricing
) -> SimResult:
    """Single-worker, queue-accurate trace simulation (paper Fig. 7).

    Thin wrapper over the declarative entry point
    (:func:`repro_torch.core.scenario.run` with ``engine='single'``): the engine
    body is :func:`_simulate_impl`, and this signature survives for callers
    that already hold resolved components (traces, a cost-model instance).
    New code should build a :class:`~repro_torch.core.scenario.Scenario` instead.

    Args:
        traces: per-function arrival traces (times in minutes).
        method: ``'warmswap' | 'prebaking' | 'baseline'``.
        cost: scalar cost model (latencies in seconds, sizes in bytes).
        keep_alive: fixed keep-alive window (minutes); default 15 (paper §4.5).
        shared_images: distinct dependency images, for the memory model.
        page_cost: optional :class:`~repro_torch.core.costmodel.PageCostModel`.
            When given, each cold start is priced page-granularly at the
            ``local`` tier (the single worker's pool always holds the image,
            so pages move at host-memcpy speed; the container starts with
            zero resident pages). ``PageCostModel.degenerate(cost)``
            reproduces the default scalar results exactly.

    Returns:
        A :class:`SimResult` with counts, total/per-function latency
        (seconds), static per-method memory (bytes), queueing stats, and
        per-request latency samples.
    """
    # deferred: scenario imports this module (the engine impl lives here)
    from repro_torch.core.scenario import RunOverrides, Scenario, run
    result = run(Scenario(engine="single", methods=[method],
                          shared_images=shared_images),
                 overrides=RunOverrides(traces=traces, cost=cost,
                                        keep_alive=keep_alive,
                                        page_cost=page_cost))
    return result.raw[method]


def _simulate_impl(
    traces: List[Trace],
    method: str,
    cost: CostModel,
    keep_alive: Optional[KeepAlivePolicy] = None,
    shared_images: int = 1,
    page_cost: Optional["PageCostModel"] = None,
) -> SimResult:
    """The single-worker engine body behind :func:`simulate` (same contract);
    called by :func:`repro_torch.core.scenario.run`."""
    keep_alive = keep_alive if keep_alive is not None else KeepAlivePolicy(15.0)
    cold_latency = (page_cost.cold_latency_s(method, tier="local")
                    if page_cost is not None
                    else method_cold_latency_s(cost, method))

    n_cold = n_warm = n_queued = 0
    total = queue_delay = 0.0
    per_fn_lat: Dict[int, float] = {}
    per_fn_n: Dict[int, int] = {}
    sample_chunks: List[np.ndarray] = []
    fn_chunks: List[np.ndarray] = []
    for tr in traces:
        lats, waits, cold = _simulate_trace(
            np.asarray(tr.arrivals_min, np.float64),
            keep_alive.keep_alive_min, cold_latency, cost.warm_s)
        n_cold += cold
        n_warm += len(lats) - cold
        n_queued += int((waits > 0).sum())
        queue_delay += float(waits.sum())
        lat_sum = float(lats.sum())
        total += lat_sum
        per_fn_lat[tr.fn_index] = lat_sum
        per_fn_n[tr.fn_index] = len(tr.arrivals_min)
        sample_chunks.append(lats)
        fn_chunks.append(np.full(len(lats), tr.fn_index, np.int64))

    memory = method_memory_bytes(cost, method, len(traces), shared_images)
    return SimResult(method=method, n_invocations=n_cold + n_warm, n_cold=n_cold,
                     n_warm=n_warm, total_latency_s=total, memory_bytes=memory,
                     per_fn_latency=per_fn_lat, per_fn_invocations=per_fn_n,
                     n_queued=n_queued, queue_delay_s=queue_delay,
                     latency_samples_s=(np.concatenate(sample_chunks)
                                        if sample_chunks else np.empty(0)),
                     sample_fn=(np.concatenate(fn_chunks)
                                if fn_chunks else np.empty(0, np.int64)))


def quartile_latencies(traces: List[Trace], result: SimResult) -> Dict[str, float]:
    """Fig. 7-left: average latency per invocation-rate quartile."""
    groups = quartile_groups(traces)
    out = {}
    for name, members in groups.items():
        lat = sum(result.per_fn_latency.get(t.fn_index, 0.0) for t in members)
        n = sum(result.per_fn_invocations.get(t.fn_index, 0) for t in members)
        out[name] = lat / max(n, 1)
    return out


def quartile_percentiles(traces: List[Trace], result) -> Dict[str, Dict[str, float]]:
    """P50/P95/P99 per invocation-rate quartile, from the per-request latency
    samples. ``result`` is a SimResult or FleetResult (duck-typed: needs
    ``latency_samples_s`` + ``sample_fn``)."""
    groups = quartile_groups(traces)
    samples = np.asarray(result.latency_samples_s)
    sample_fn = np.asarray(result.sample_fn)
    out = {}
    for name, members in groups.items():
        fns = np.array([t.fn_index for t in members], np.int64)
        mask = np.isin(sample_fn, fns)
        out[name] = latency_percentiles(samples[mask])
    return out


def memory_saving_fraction(warmswap: SimResult, prebaking: SimResult) -> float:
    """The paper's headline: WarmSwap saves ~88 % of warm-up memory for 10 functions
    sharing one image."""
    if prebaking.memory_bytes == 0:
        return 0.0
    return 1.0 - warmswap.memory_bytes / prebaking.memory_bytes
