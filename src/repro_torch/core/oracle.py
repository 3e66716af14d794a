"""Hindsight-optimal oracle: offline latency lower bounds for completed traces.

Port of ``repro.core.oracle``: the same code with the imports pointed at the
port, so every sample, counter and float sum is bit-identical.

Every online policy in this repo (prewarm × placement, ``core/keepalive.py`` /
``serving/scheduler.py``) decides with *partial* knowledge — past arrivals
only. The oracle answers the question those policies are measured against:
**with the full arrival sequence known in advance, how low could latency go
under the same cost model and constraints?** The per-cell distance to that
bound (the *oracle gap*) is the headline metric of the policy tournament
(``experiments/tournament.py``) and the quantity every future learned policy
chases (ROADMAP "policy frontier").

Two tools, with different contracts:

:func:`hindsight_floor` — the **sound** bound, used by the CI dominance gate.
  A pointwise per-request floor built from only three facts about the
  engines (``core/fleet.py``, ``core/simulator.py``):

    1. queue wait is never negative;
    2. a warm serve costs exactly ``cost.warm_s``; a cold serve costs at
       least :func:`min_cold_latency_s` — the cheapest price the engine can
       ever charge for a cold start of that method (scalar revive and
       page-transfer terms are non-negative, and prebaking's
       snapshot-evicted fallback is priced in);
    3. the **first arrival of each function can never be warm-served**:
       pre-warm spawns for a function are only ever scheduled from a prior
       arrival of that same function (``PrewarmPolicy.prewarm_after`` is
       called inside the arrival handler), so no instance of a function
       exists before its first arrival.

  Pointwise dominance implies dominance of the total, of every percentile
  (sorting preserves pointwise order sample-by-sample, and
  ``np.percentile`` is monotone in the sorted samples), and of the mean —
  the **oracle-dominance invariant** asserted in tier-1
  (``tests/test_oracle_properties.py``) and gated in CI
  (``tools/ci/check_bench.py`` fails on any negative or non-finite gap).

:func:`keepalive_frontier` — the **hindsight-optimal keep-alive plan**, used
  for the Pareto report only. With arrivals known, the optimal
  keep-alive-restricted schedule is a fractional knapsack: each inter-arrival
  gap of a function can be "covered" (instance kept alive across it) for a
  byte-minute price of ``gap × idle_bytes``, converting one cold start into
  a warm one (a constant latency gain), so the cheapest gaps are covered
  first and the LP relaxation yields the latency-vs-byte-minutes frontier.
  This is *not* a sound bound against predictive pre-warming (a policy may
  spawn just-in-time and pay fewer idle byte-minutes than the full gap), so
  it never feeds the dominance gate — see docs/SIMULATION.md, "Oracle and
  disruption semantics".

Disruption note: the floor holds unchanged under any
``core/disruption.py`` schedule — worker failures and eviction storms only
ever *add* wait, requeue delay, or cold-start cost, never undercut the
fair-weather minimum, and the oracle (which may place work on any worker)
is free to avoid disrupted workers entirely.

Units follow the repo convention: minutes for times, seconds for latencies,
bytes for sizes (docs/SIMULATION.md).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Union

import numpy as np

from repro_torch.core.costmodel import PageCostModel
from repro_torch.core.simulator import CostModel, method_cold_latency_s
from repro_torch.core.trace_stream import TraceStream
from repro_torch.core.traces import Trace

#: Percentile keys reported by :meth:`OracleResult.latency_percentiles`,
#: matching the engines' ``latency_percentiles()`` schema.
PERCENTILES = (50, 90, 95, 99)


def idle_bytes_for(method: str, cost: CostModel) -> int:
    """Bytes an idle instance of ``method`` pins — the byte-minute unit cost
    of keep-alive, identical to the fleet engine's accounting: warmswap idles
    on per-function metadata only (the image is shared), prebaking on its
    private snapshot, baseline on its privately initialized dependencies."""
    try:
        return {"warmswap": cost.metadata_bytes,
                "prebaking": cost.snapshot_bytes,
                "baseline": cost.image_bytes}[method]
    except KeyError:
        raise ValueError(f"unknown method: {method!r}")


def min_cold_latency_s(method: str, cost: CostModel,
                       page: Optional[PageCostModel] = None) -> float:
    """The cheapest cold-start price either engine can charge for ``method``.

    This is the floor's cold term, derived from the engines' pricing paths
    (``fleet.cold_start`` / ``cold_start_paged`` / the single-worker
    engine's constant): scalar revive (``image_revive_s``) and page-transfer
    blocking terms are additive and non-negative, so the minimum is the
    zero-transfer, pool-hit base — except prebaking, whose snapshot-evicted
    fallback is priced as a *baseline* start, so a pathological cost model
    with ``cold_baseline_s < cold_prebaking_s`` floors at the baseline base.
    ``page`` is accepted for signature symmetry: the page model only adds
    non-negative transfer terms on top of the same scalar bases.
    """
    base = method_cold_latency_s(cost, method)   # validates the method key
    if method == "warmswap":
        # revive is charged on pool miss; guard against fuzzed negatives
        return min(base, base + cost.image_revive_s)
    if method == "prebaking":
        return min(base, method_cold_latency_s(cost, "baseline"))
    return base


@dataclass(frozen=True)
class OracleResult:
    """The hindsight floor for one (traces, method, cost model) triple.

    ``latency_samples_s`` is in merged-arrival order (stable sort by time,
    trace order breaking ties — the same order both engines emit), so it is
    directly comparable index-by-index against an engine result's
    ``latency_samples_s``.
    """
    method: str
    n_invocations: int
    n_cold: int                       # floor: one unavoidable cold per function
    n_warm: int
    min_cold_s: float                 # the per-request cold floor used
    warm_s: float
    idle_bytes: int
    total_latency_s: float
    latency_samples_s: np.ndarray = field(repr=False)

    @property
    def avg_latency_s(self) -> float:
        return (self.total_latency_s / self.n_invocations
                if self.n_invocations else 0.0)

    def percentile(self, q: float) -> float:
        if not self.n_invocations:
            return 0.0
        return float(np.percentile(self.latency_samples_s, q))

    def latency_percentiles(self) -> Dict[str, float]:
        return {f"p{q}": self.percentile(q) for q in PERCENTILES}

    def to_dict(self) -> Dict[str, Any]:
        d = dataclasses.asdict(self)
        del d["latency_samples_s"]
        d["avg_latency_s"] = self.avg_latency_s
        d["latency_percentiles_s"] = self.latency_percentiles()
        return d


def hindsight_floor(traces: Union[Sequence[Trace], TraceStream], method: str,
                    cost: CostModel,
                    page_cost: Optional[PageCostModel] = None) -> OracleResult:
    """The sound per-request latency floor over a completed trace set.

    Accepts a :class:`~repro_torch.core.trace_stream.TraceStream` as well: the
    floor is accumulated chunk by chunk (a seen-set of function indices
    carries first-arrival state across chunks), never materializing the
    arrival arrays, and is bit-identical to the in-memory result.

    Each function's first arrival pays :func:`min_cold_latency_s` (no
    instance of it can predate it — see the module docstring); every other
    request pays ``min(warm_s, min_cold_s)`` (served warm at best, or cold
    if the model prices colds below warms); waits are zero. The result's
    total, mean, and every percentile lower-bound every online policy ×
    placement × disruption combination on the same traces under the same
    cost model — byte-minute budgets, capacity pressure, and worker churn
    can only push real results further above the floor.
    """
    mc = min_cold_latency_s(method, cost, page_cost)
    warm = min(cost.warm_s, mc)
    if isinstance(traces, TraceStream):
        # Chunk-wise accumulation: each chunk arrives in the engines' merge
        # order, so the first chunk position of a not-yet-seen function is
        # exactly its first merged-arrival index. Both branches assign the
        # same two constants at the same global positions => bit-identical.
        parts: List[np.ndarray] = []
        seen: set = set()
        n_cold = 0
        for chunk in traces.chunks():
            part = np.full(len(chunk.fn), warm)
            uniq, first_idx = np.unique(chunk.fn, return_index=True)
            for fn, pos in zip(uniq.tolist(), first_idx.tolist()):
                if fn not in seen:
                    seen.add(fn)
                    part[pos] = mc
                    n_cold += 1
            parts.append(part)
        samples = np.concatenate(parts) if parts else np.empty((0,))
    else:
        all_t = (np.concatenate([np.asarray(t.arrivals_min, np.float64)
                                 for t in traces])
                 if traces else np.empty((0,)))
        all_fn = (np.concatenate([np.full(len(t.arrivals_min), t.fn_index,
                                          np.int64) for t in traces])
                  if traces else np.empty((0,), np.int64))
        order = np.argsort(all_t, kind="stable")   # the engines' merge order
        all_fn = all_fn[order]
        samples = np.full(len(all_fn), warm)
        if len(all_fn):
            # first merged arrival of each function index pays the cold floor
            _, first_idx = np.unique(all_fn, return_index=True)
            samples[first_idx] = mc
            n_cold = len(first_idx)
        else:
            n_cold = 0
    return OracleResult(
        method=method,
        n_invocations=len(samples),
        n_cold=n_cold,
        n_warm=len(samples) - n_cold,
        min_cold_s=mc,
        warm_s=cost.warm_s,
        idle_bytes=idle_bytes_for(method, cost),
        total_latency_s=float(samples.sum()),
        latency_samples_s=samples,
    )


def gap_report(oracle: OracleResult, result) -> Dict[str, float]:
    """Per-cell oracle gap: how far an engine result sits above the floor.

    ``result`` is any engine result with ``total_latency_s``,
    ``n_invocations`` and a ``latency_samples_s`` array (``FleetResult`` /
    ``SimResult``). All gaps are >= 0 whenever the dominance invariant
    holds; the CI gate (``tools/ci/check_bench.py``) fails the build on a
    negative or non-finite gap.
    """
    if result.n_invocations != oracle.n_invocations:
        raise ValueError(
            f"oracle was built for {oracle.n_invocations} request(s) but the "
            f"result has {result.n_invocations}; they must share traces")
    samples = np.asarray(result.latency_samples_s, np.float64)
    p99 = float(np.percentile(samples, 99)) if len(samples) else 0.0
    return {
        "total_gap_s": float(result.total_latency_s) - oracle.total_latency_s,
        "p99_gap_s": p99 - oracle.percentile(99),
        "oracle_total_s": oracle.total_latency_s,
        "oracle_p99_s": oracle.percentile(99),
    }


# ---------------------------------------------------------------------------
# Hindsight-optimal keep-alive: the latency/byte-minute frontier (report only)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class FrontierPoint:
    """One point of the hindsight keep-alive frontier: covering the
    ``covered_gaps`` cheapest inter-arrival gaps costs ``byte_minutes``
    (idle residency) and achieves ``total_latency_s``."""
    byte_minutes: float
    total_latency_s: float
    covered_gaps: int

    def to_dict(self) -> Dict[str, float]:
        return dataclasses.asdict(self)


def keepalive_frontier(traces: Sequence[Trace], method: str, cost: CostModel,
                       page_cost: Optional[PageCostModel] = None,
                       n_points: int = 9) -> List[FrontierPoint]:
    """The hindsight-optimal keep-alive latency-vs-byte-minutes frontier.

    Restricted model (one instance per function, keep-alive decisions only):
    covering a function's inter-arrival gap ``g`` minutes keeps its instance
    resident across it — byte-minute cost ``g * idle_bytes``, latency gain
    ``min_cold_s - warm_s`` seconds (one cold becomes warm). Gains are
    constant, so the optimal plan under any byte-minute budget covers the
    cheapest (shortest) gaps first; sweeping the budget yields this
    frontier, from all-cold (0 byte-minutes) to all-gaps-covered.

    This is a *report* — optimal only among keep-alive-restricted schedules.
    A predictive pre-warm can beat a point here by spawning just-in-time
    (paying less idle residency than the full gap), which is why the CI
    dominance gate uses :func:`hindsight_floor`, never this frontier.

    Returns ``n_points`` points (at least the two endpoints), byte-minutes
    non-decreasing. A :class:`~repro_torch.core.trace_stream.TraceStream` is
    materialized first (gap sorting needs full per-function arrival arrays) —
    this is a report path, not part of the out-of-core contract.
    """
    if isinstance(traces, TraceStream):
        traces = traces.materialize()
    mc = min_cold_latency_s(method, cost, page_cost)
    gain_s = max(0.0, mc - cost.warm_s)
    idle = idle_bytes_for(method, cost)
    gaps = [np.diff(np.asarray(t.arrivals_min, np.float64))
            for t in traces if len(t.arrivals_min) > 1]
    gaps_min = (np.sort(np.concatenate(gaps), kind="stable") if gaps
                else np.empty((0,)))
    n_req = sum(len(t.arrivals_min) for t in traces)
    n_fns = sum(1 for t in traces if len(t.arrivals_min))
    # all-cold baseline: every request pays the cold floor
    all_cold_s = n_req * mc
    costs_bm = np.cumsum(gaps_min) * idle        # cheapest-first cumulative
    n_gaps = len(gaps_min)
    if n_points < 2:
        n_points = 2
    picks = sorted(set(
        int(round(i * n_gaps / (n_points - 1))) for i in range(n_points)))
    out = []
    for k in picks:
        bm = float(costs_bm[k - 1]) if k else 0.0
        out.append(FrontierPoint(
            byte_minutes=bm,
            total_latency_s=all_cold_s - k * gain_s,
            covered_gaps=k,
        ))
    # sanity: covering every gap leaves exactly one cold per function
    assert out[-1].covered_gaps != n_gaps or \
        abs(out[-1].total_latency_s
            - (n_fns * mc + (n_req - n_fns) * cost.warm_s)) < 1e-6 * max(
                1.0, all_cold_s)
    return out


# ---------------------------------------------------------------------------
# Spec-level entry point
# ---------------------------------------------------------------------------

def oracle_from_scenario(scenario, *, smoke: bool = False,
                         traces: Optional[Sequence[Trace]] = None,
                         ) -> Dict[str, OracleResult]:
    """Hindsight floors for every method of a :class:`~repro_torch.core.scenario.
    Scenario`, resolving its trace/cost/page components from the registries
    exactly as :func:`repro_torch.core.scenario.run` would (``smoke`` applies the
    spec's ``smoke_overrides`` first). Pass ``traces`` to reuse
    already-materialized arrivals (e.g. from a ``Result``), guaranteeing the
    floor and the engine run saw the same sequence."""
    from repro_torch.core.costmodel import PAGE_COST_MODELS
    from repro_torch.core.simulator import COST_MODELS
    from repro_torch.core.traces import TRACE_GENERATORS

    scn = scenario.smoke_scaled() if smoke else scenario
    if traces is None:
        traces = TRACE_GENERATORS.build(scn.traces.name, **scn.traces.kwargs)
    cost = COST_MODELS.build(scn.cost.name, **scn.cost.kwargs)
    page = None
    if scn.page_cost is not None:
        page = PAGE_COST_MODELS.build(scn.page_cost.name, cost=cost,
                                      **scn.page_cost.kwargs)
    return {m: hindsight_floor(traces, m, cost, page) for m in scn.methods}
