"""Policy × scenario tournament: every prewarm × placement cell vs the oracle.

Port of ``repro.experiments.tournament``: the same code with the imports
pointed at the port, and the scan's ``device`` passed to the sweep.

The tournament is the repo's answer to "which online policy should a fleet
run, and how much is left on the table?" It drives the full prewarm ×
placement grid through the resumable sweep executor
(``experiments/executor.py``) on one scenario, scores every cell on the three
axes the paper trades off —

  * **P99 latency** (seconds) — the tail the user feels,
  * **byte-minutes** (idle instance residency × per-method idle bytes) — the
    memory bill keep-alive pays,
  * **cold-start count** — the events the whole system exists to avoid,

— attaches each cell's **oracle gap** (distance above the hindsight floor of
``core/oracle.py``; >= 0 whenever the dominance invariant holds, which CI
asserts), and marks the **Pareto front**: cells no other cell beats on all
three axes simultaneously. The hindsight keep-alive frontier rides along as
the "what would clairvoyance buy" reference curve for the same traces.

One tournament = one scenario spec. Disruption axes (worker churn, preemption
waves, eviction storms — ``core/disruption.py``) enter as different specs,
not extra grid axes, so each foul-weather variant is a first-class, separately
stored tournament (see ``benchmarks/scenarios/tournament.json`` and the
``python -m repro_torch.experiments tournament`` CLI).

All cells share the scenario's traces (the grid only varies policy
components and the trace build is seeded), so one oracle per method prices
every cell — asserted here rather than assumed.
"""
from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence

from repro_torch.core.oracle import (OracleResult, idle_bytes_for,
                               keepalive_frontier, oracle_from_scenario)
from repro_torch.core.scenario import Scenario
from repro_torch.core.simulator import COST_MODELS
from repro_torch.device import DeviceLike
from repro_torch.experiments.executor import SweepReport, run_sweep

#: Version of the serialized tournament report schema.
TOURNAMENT_SCHEMA_VERSION = 1


@dataclass(frozen=True)
class TournamentCell:
    """One (prewarm, placement, method) outcome with its oracle gap."""
    prewarm: str
    placement: str
    method: str
    total_latency_s: float
    p99_s: float
    byte_minutes: float
    n_cold: int
    n_warm: int
    oracle_gap_total_s: float
    oracle_gap_p99_s: float
    pareto: bool = False

    def objectives(self) -> Sequence[float]:
        """The minimized axes, in report order."""
        return (self.p99_s, self.byte_minutes, float(self.n_cold))

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)


def pareto_front(cells: Sequence[TournamentCell]) -> List[bool]:
    """Non-dominated flags for ``cells`` on their :meth:`~TournamentCell.
    objectives` (all minimized): cell i is dominated when some cell j is <=
    on every axis and strictly < on at least one. O(n^2) — tournament grids
    are tens of cells."""
    objs = [c.objectives() for c in cells]
    flags = []
    for i, oi in enumerate(objs):
        dominated = any(
            all(a <= b for a, b in zip(oj, oi))
            and any(a < b for a, b in zip(oj, oi))
            for j, oj in enumerate(objs) if j != i)
        flags.append(not dominated)
    return flags


@dataclass
class TournamentReport:
    """Everything one tournament produced, JSON-serializable."""
    scenario: Dict[str, Any]
    methods: List[str]
    cells: List[TournamentCell]
    oracle: Dict[str, Dict[str, Any]]            # method -> OracleResult dict
    frontier: Dict[str, List[Dict[str, float]]]  # method -> keep-alive curve
    n_run: int = 0
    n_skipped: int = 0
    schema_version: int = TOURNAMENT_SCHEMA_VERSION

    def pareto_cells(self) -> List[TournamentCell]:
        return [c for c in self.cells if c.pareto]

    def min_gaps(self) -> Dict[str, Dict[str, float]]:
        """Per-method minimum gaps over the grid — the headline the bench
        artifact carries and ``tools/ci/check_bench.py`` gates (>= 0,
        finite). The minimum is the sharpest dominance witness: if any cell
        dipped below the floor, its method's min would go negative."""
        out: Dict[str, Dict[str, float]] = {}
        for m in self.methods:
            cells = [c for c in self.cells if c.method == m]
            out[m] = {
                "min_total_gap_s": min(c.oracle_gap_total_s for c in cells),
                "min_p99_gap_s": min(c.oracle_gap_p99_s for c in cells),
                "n_cells": len(cells),
            }
        return out

    def to_dict(self) -> Dict[str, Any]:
        return {
            "schema_version": self.schema_version,
            "scenario": self.scenario,
            "methods": list(self.methods),
            "cells": [c.to_dict() for c in self.cells],
            "oracle": self.oracle,
            "frontier": self.frontier,
            "min_gaps": self.min_gaps(),
            "n_run": self.n_run,
            "n_skipped": self.n_skipped,
        }

    def to_json(self, indent: int = 1) -> str:
        return json.dumps(self.to_dict(), indent=indent)


def _grid_axes(prewarms: Optional[Sequence[str]],
               placements: Optional[Sequence[str]]) -> Dict[str, List[str]]:
    """The tournament grid: every registered prewarm × placement by default
    (resolved at call time so newly registered policies are swept
    automatically — the acceptance bar for the dominance gate)."""
    from repro_torch.core.keepalive import PREWARM_POLICIES
    from repro_torch.serving.scheduler import PLACEMENTS
    return {
        "prewarm.name": list(prewarms) if prewarms is not None
        else sorted(PREWARM_POLICIES.names()),
        "placement.name": list(placements) if placements is not None
        else sorted(PLACEMENTS.names()),
    }


def run_tournament(
    base: Scenario,
    *,
    smoke: bool = False,
    parallel: int = 1,
    store_path: Optional[str] = None,
    resume: bool = False,
    prewarms: Optional[Sequence[str]] = None,
    placements: Optional[Sequence[str]] = None,
    frontier_points: int = 9,
    progress=None,
    device: DeviceLike = None,
) -> TournamentReport:
    """Run the policy tournament for one scenario.

    Args:
        base: the scenario (must use a fleet engine — the single-worker
            engine has no placement/prewarm surface to tournament).
        smoke: apply the spec's ``smoke_overrides`` (CI scale).
        parallel / store_path / resume / progress: passed through to
            :func:`repro_torch.experiments.executor.run_sweep` (same resumable,
            serial==parallel-identical store semantics).
        prewarms / placements: restrict the grid (default: every
            registered key, sorted).
        frontier_points: points on the hindsight keep-alive curve.
        device: where the sweep's ``fleet_vec`` scan runs, if it runs.

    Returns:
        A :class:`TournamentReport` with every cell gap-scored against the
        hindsight floor and the Pareto front marked.
    """
    if base.engine == "single":
        raise ValueError("the tournament sweeps fleet policies; "
                         "engine='single' has none — use engine='fleet'")
    axes = _grid_axes(prewarms, placements)
    report: SweepReport = run_sweep(
        base, axes, smoke=smoke, parallel=parallel, store_path=store_path,
        resume=resume, progress=progress, device=device)

    # one oracle per method prices every cell: the grid varies only policy
    # components, so all cells share the scenario's (seeded) traces
    for p in report.points:
        for key in ("traces", "cost", "page_cost"):
            if p.spec.get(key) != report.points[0].spec.get(key):
                raise RuntimeError(
                    f"tournament cells disagree on {key!r}; one oracle "
                    f"cannot price them all")
    oracles: Dict[str, OracleResult] = oracle_from_scenario(base, smoke=smoke)

    scn = base.smoke_scaled() if smoke else base
    cost = COST_MODELS.build(scn.cost.name, **scn.cost.kwargs)
    cells: List[TournamentCell] = []
    for point, result in zip(report.points, report.results):
        spec = point.spec
        for m, mr in result["methods"].items():
            orc = oracles[m]
            cells.append(TournamentCell(
                prewarm=spec["prewarm"]["name"],
                placement=spec["placement"]["name"],
                method=m,
                total_latency_s=float(mr["total_latency_s"]),
                p99_s=float(mr["latency_percentiles_s"]["p99"]),
                byte_minutes=float(mr["instance_resident_min"])
                * idle_bytes_for(m, cost),
                n_cold=int(mr["n_cold"]),
                n_warm=int(mr["n_warm"]),
                oracle_gap_total_s=float(mr["total_latency_s"])
                - orc.total_latency_s,
                oracle_gap_p99_s=float(mr["latency_percentiles_s"]["p99"])
                - orc.percentile(99),
            ))
    # Pareto per method (cross-method comparison conflates cost models)
    flagged: List[TournamentCell] = []
    for m in scn.methods:
        group = [c for c in cells if c.method == m]
        for c, keep in zip(group, pareto_front(group)):
            flagged.append(dataclasses.replace(c, pareto=keep))
    from repro_torch.core.traces import TRACE_GENERATORS
    traces = TRACE_GENERATORS.build(scn.traces.name, **scn.traces.kwargs)
    frontier = {
        m: [p.to_dict() for p in keepalive_frontier(
            traces, m, cost, n_points=frontier_points)]
        for m in scn.methods}
    return TournamentReport(
        scenario=scn.to_dict(),
        methods=list(scn.methods),
        cells=flagged,
        oracle={m: o.to_dict() for m, o in oracles.items()},
        frontier=frontier,
        n_run=report.n_run,
        n_skipped=report.n_skipped,
    )
