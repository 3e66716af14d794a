"""Parallel, resumable sweep executor over the declarative scenario layer.

Port of ``repro.experiments.executor``: the same code with the imports
pointed at the port, plus the device the ``fleet_vec`` scan runs on
(``device``: ``cuda`` unless the caller passes ``"cpu"``), handed to every
point explicitly, spawned workers included. The scan runs only under
``REPRO_FLEET_VEC_SCAN=1`` (which spawned workers inherit); asking for it on
``cuda`` without a card raises in the worker and fails the sweep, never
falling back to the numpy solver.

``sweep()`` (core/scenario.py) turns a base spec + axes into a grid of
resolved scenarios; this module *runs* that grid at production scale:

  * **parallel** — grid points run across a ``multiprocessing`` pool
    (spawn context: no inherited RNG or CUDA state, workers import the port
    fresh, and no JAX). Each point is a pure function of its resolved spec — every seed
    lives in the spec — so scheduling cannot affect results, and a serial
    and a parallel run of the same grid are **bit-identical** through the
    store (asserted in tests/test_torch_experiments.py);
  * **streaming + resumable** — each validated result is appended to an
    append-only JSONL :class:`~repro_torch.experiments.store.ResultStore` keyed by
    the content hash of the fully resolved spec, fsynced per point. An
    interrupted sweep rerun with ``resume=True`` skips every key already in
    the store (a torn final line from a kill is dropped and recomputed);
  * **deterministic per-point seeds** — with ``derive_seeds=True`` each grid
    point's ``traces.kwargs.seed`` is pinned to a stable hash of the rest of
    its spec, so every point draws independent arrivals without any
    cross-point RNG coupling, reproducibly.

CLI::

    python -m repro_torch.experiments sweep spec.json --axis n_workers=1,4,16 \\
        --parallel 4 --store results/sweep.jsonl --resume
    python -m repro_torch.experiments report results/sweep.jsonl
"""
from __future__ import annotations

import functools
import hashlib
import json
import multiprocessing
from dataclasses import dataclass, field
from typing import Any, Dict, List, Mapping, Optional, Sequence

from repro_torch.core.scenario import Scenario, run, sweep, validate_result
from repro_torch.device import DeviceLike
from repro_torch.experiments.store import (ResultStore, StoreError, canonical_json,
                                     normalize_spec, spec_key)


@dataclass
class SweepPoint:
    """One resolved grid cell: the runnable spec dict and its store key."""
    index: int                 # position in the expanded grid
    spec: Dict[str, Any]       # fully resolved (overrides + smoke + seed)
    key: str                   # content hash of ``spec`` (the store key)

    @property
    def name(self) -> str:
        return self.spec.get("name", f"point{self.index}")


@dataclass
class SweepReport:
    """What :func:`run_sweep` did: results in grid order + resume stats."""
    points: List[SweepPoint]
    results: List[Dict[str, Any]]      # serialized Result per point, in order
    n_run: int = 0                     # points actually simulated this call
    n_skipped: int = 0                 # points satisfied from the store
    store_path: Optional[str] = None
    parallel: int = 1
    extras: Dict[str, Any] = field(default_factory=dict)


def point_seed(spec: Mapping[str, Any]) -> int:
    """Deterministic per-point seed: a stable 31-bit hash of the spec with
    any existing ``traces.kwargs.seed`` removed (so the derived seed is a
    function of *what* the point simulates, not of a previous seed).
    Non-semantic trace kwargs (``stream``, ``chunk_min``) are dropped too
    (:func:`repro_torch.experiments.store.normalize_spec`): streamed and in-memory
    runs of one spec must draw the same derived seed."""
    d = normalize_spec(spec)
    d.get("traces", {}).get("kwargs", {}).pop("seed", None)
    digest = hashlib.sha256(canonical_json(d).encode()).digest()
    return int.from_bytes(digest[:4], "big") & 0x7FFFFFFF


def resolve_points(base: Scenario, axes: Mapping[str, Sequence[Any]], *,
                   smoke: bool = False,
                   derive_seeds: bool = False) -> List[SweepPoint]:
    """Expand ``axes`` over ``base`` and fully resolve each cell: smoke
    overrides applied, seeds optionally derived, content hash computed.

    The returned specs are what workers run and what the store is keyed by —
    ``run()`` is called on them with no further transformation."""
    points = []
    for i, scn in enumerate(sweep(base, axes)):
        if smoke:
            scn = scn.smoke_scaled()
        if derive_seeds:
            scn = scn.with_overrides(
                {"traces.kwargs.seed": point_seed(scn.to_dict())})
        spec = scn.to_dict()
        points.append(SweepPoint(index=i, spec=spec, key=spec_key(spec)))
    return points


def run_point(spec: Mapping[str, Any], device: DeviceLike = None) -> Dict[str, Any]:
    """Run one fully resolved spec dict; returns the validated serialized
    result. Module-level so ``multiprocessing`` workers can import it.
    ``device``: where the ``fleet_vec`` scan runs, if it runs
    (``scenario.run``)."""
    result = run(Scenario.from_dict(spec), device=device)
    d = result.to_dict()
    validate_result(d)
    return d


def run_sweep(
    base: Scenario,
    axes: Mapping[str, Sequence[Any]],
    *,
    smoke: bool = False,
    parallel: int = 1,
    store_path: Optional[str] = None,
    resume: bool = False,
    derive_seeds: bool = False,
    mp_context: str = "spawn",
    progress=None,
    device: DeviceLike = None,
) -> SweepReport:
    """Run a sweep grid, optionally in parallel, optionally through a store.

    Args:
        base: the base scenario; ``axes`` are dotted-path grid axes
            (see :func:`repro_torch.core.scenario.sweep`).
        smoke: apply each spec's ``smoke_overrides`` (CI scale).
        parallel: worker processes; ``<= 1`` runs in-process. Results are
            appended in grid order either way, so serial and parallel runs
            of the same grid produce byte-identical stores.
        store_path: JSONL results store; ``None`` keeps results in memory
            only. Appends are fsynced per point (kill-safe).
        resume: skip points whose key is already stored. Without it, an
            existing non-empty store is refused rather than silently mixed
            into.
        derive_seeds: pin each point's ``traces.kwargs.seed`` to
            :func:`point_seed` of its spec.
        mp_context: multiprocessing start method (default ``spawn``).
        progress: optional callable ``(done, total, point, skipped)`` for
            per-point reporting.
        device: where each point's ``fleet_vec`` scan runs under
            ``REPRO_FLEET_VEC_SCAN=1`` (``cuda`` unless ``"cpu"``), in this
            process and in every worker.

    Returns:
        A :class:`SweepReport`; ``results`` holds every point's serialized
        result in grid order (stored points included when resuming).
    """
    if resume and not store_path:
        raise StoreError("resume=True needs a store_path "
                         "(--resume needs --store): there is nothing to "
                         "resume from without a results store")
    points = resolve_points(base, axes, smoke=smoke,
                            derive_seeds=derive_seeds)
    store = ResultStore(store_path) if store_path else None
    completed: Dict[str, Dict[str, Any]] = {}
    if store is not None and store.exists():
        if resume:
            completed = store.completed_keys()
        elif store.records():
            raise StoreError(
                f"{store_path} already holds results; pass resume=True "
                f"(--resume) to skip completed points, or use a fresh path")

    todo = [p for p in points if p.key not in completed]
    results_by_key: Dict[str, Dict[str, Any]] = {
        k: r["result"] for k, r in completed.items()}
    report = SweepReport(points=points, results=[],
                         n_skipped=len(points) - len(todo),
                         store_path=store_path, parallel=max(parallel, 1))

    def finish(point: SweepPoint, result: Dict[str, Any]) -> None:
        results_by_key[point.key] = result
        if store is not None:
            store.append(point.key, result, name=point.name)
        report.n_run += 1
        if progress is not None:
            progress(report.n_run + report.n_skipped, len(points), point,
                     False)

    if progress is not None:
        done = 0
        for p in points:
            if p.key in completed:
                done += 1
                progress(done, len(points), p, True)
    if todo:
        if parallel > 1:
            ctx = multiprocessing.get_context(mp_context)
            with ctx.Pool(processes=min(parallel, len(todo))) as pool:
                # ordered imap: results stream back (and append to the
                # store) in grid order, making serial == parallel stores
                # byte-identical
                for point, result in zip(
                        todo, pool.imap(functools.partial(run_point, device=device),
                                        [p.spec for p in todo])):
                    finish(point, result)
        else:
            for point in todo:
                finish(point, run_point(point.spec, device))

    report.results = [results_by_key[p.key] for p in points]
    return report


def summarize_store(store_path: str) -> Dict[str, Any]:
    """Project a results store back onto the unified result schema: every
    record's result validated, plus a compact per-point summary table —
    the CLI ``report`` command's payload."""
    store = ResultStore(store_path)
    records = store.records()
    table = []
    for rec in records:
        result = rec["result"]
        validate_result(result)
        row: Dict[str, Any] = {
            "key": rec["key"],
            "name": rec.get("name") or result["scenario"].get("name", ""),
            "engine": result["engine"],
            "summary": dict(result["summary"]),
        }
        for m, mr in result["methods"].items():
            row[m] = {"avg_latency_s": mr["avg_latency_s"],
                      "p99_s": mr["latency_percentiles_s"]["p99"],
                      "n_cold": mr["n_cold"],
                      "memory_bytes": mr["memory_bytes"]}
        table.append(row)
    return {
        "store_path": store_path,
        "n_points": len(records),
        "torn_tail_dropped": store.torn_tail,
        "points": table,
        "results": [rec["result"] for rec in records],
    }
