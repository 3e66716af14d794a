"""Experiments CLI: run declarative scenario specs from the command line.

    PYTHONPATH=src python -m repro_torch.experiments run benchmarks/scenarios/degenerate.json
    PYTHONPATH=src python -m repro_torch.experiments run spec.json --smoke --out out.json
    PYTHONPATH=src python -m repro_torch.experiments sweep spec.json --axis n_workers=1,4,16
    PYTHONPATH=src python -m repro_torch.experiments sweep spec.json \\
        --axis traces.kwargs.seed=0,1,2,3 --parallel 4 --store results/sweep.jsonl --resume
    PYTHONPATH=src python -m repro_torch.experiments report results/sweep.jsonl
    PYTHONPATH=src python -m repro_torch.experiments tournament \\
        benchmarks/scenarios/tournament.json --smoke
    PYTHONPATH=src python -m repro_torch.experiments validate benchmarks/scenarios/*.json
    PYTHONPATH=src python -m repro_torch.experiments smoke benchmarks/scenarios/*.json
    PYTHONPATH=src python -m repro_torch.experiments list
    REPRO_FLEET_VEC_SCAN=1 PYTHONPATH=src python -m repro_torch.experiments sweep spec.json \\
        --axis traces.kwargs.seed=0,1 --device cpu      # the scan's plain version

Port of ``repro.experiments``: the same CLI and code with the imports pointed
at the port. One addition: ``--device`` (and ``device=``) names where the
``fleet_vec`` engine's cap=1 scan runs when ``REPRO_FLEET_VEC_SCAN=1`` turns
it on: ``cuda`` (the ``fleet_scan`` kernel) unless ``cpu`` is asked for;
without a card the ``cuda`` default raises. Results are bit-identical either
way, and the stores equal the reference's byte for byte.

Scenario schema, registry keys, and the result schema: ``docs/API.md``.
The programmatic mirrors (:func:`run_file`, :func:`sweep_file`) share one
code path with the CLI (the reference's ``benchmarks/bench_fleet.py`` drives
its cells through the reference's). Sweeps run through the parallel,
resumable executor (:mod:`repro_torch.experiments.executor`): ``--parallel N``
fans grid points across a process pool, ``--store`` streams each validated
result to an append-only JSONL store keyed by spec content hash, and
``--resume`` skips points the store already holds.
"""
from __future__ import annotations

import argparse
import json
import sys
from typing import Any, Dict, List, Mapping, Optional, Sequence

from repro_torch.core.scenario import (Result, Scenario, run, sweep,
                                       validate_result)
from repro_torch.device import DeviceLike
from repro_torch.experiments.executor import (SweepReport, run_sweep,
                                              summarize_store)


def run_file(path: str, *, smoke: bool = False,
             overrides: Optional[Mapping[str, Any]] = None,
             device: DeviceLike = None) -> Result:
    """Load ``path``, apply optional dotted-path ``overrides``, run it, and
    schema-validate the result before returning it. ``device``: where the
    ``fleet_vec`` scan runs, if it runs."""
    scn = Scenario.from_file(path)
    if overrides:
        scn = scn.with_overrides(overrides)
    result = run(scn, smoke=smoke, device=device)
    validate_result(result.to_dict())
    return result


def sweep_file(path: str, axes: Mapping[str, Sequence[Any]], *,
               smoke: bool = False, device: DeviceLike = None) -> List[Result]:
    """Load ``path``, expand ``axes`` into the scenario grid, run every cell
    (each result schema-validated)."""
    base = Scenario.from_file(path)
    out = []
    for scn in sweep(base, axes):
        result = run(scn, smoke=smoke, device=device)
        validate_result(result.to_dict())
        out.append(result)
    return out


def _parse_value(text: str) -> Any:
    """One axis/override value: JSON literal when it parses, ``None`` for
    none/null, the raw string otherwise."""
    if text.lower() in ("none", "null"):
        return None
    try:
        return json.loads(text)
    except json.JSONDecodeError:
        return text


def parse_axis(text: str) -> Dict[str, List[Any]]:
    """``"n_workers=1,4,16"`` -> ``{"n_workers": [1, 4, 16]}``."""
    if "=" not in text:
        raise ValueError(f"--axis needs path=v1,v2,..., got {text!r}")
    path, _, values = text.partition("=")
    return {path.strip(): [_parse_value(v) for v in values.split(",")]}


def _print_result(result: Result, label: str = "") -> None:
    _print_result_dict(result.to_dict(), label)


def _print_result_dict(result: Mapping[str, Any], label: str = "") -> None:
    """Print one serialized result's per-method table + summary lines (the
    one output format; :func:`_print_result` delegates here)."""
    prefix = f"{label}: " if label else ""
    for m, mr in result["methods"].items():
        pct = mr["latency_percentiles_s"]
        print(f"{prefix}{m:9s} avg {mr['avg_latency_s'] * 1e3:9.2f} ms | "
              f"p99 {pct['p99'] * 1e3:9.2f} ms | cold {mr['n_cold']:6d} | "
              f"warm {mr['n_warm']:6d} | queued {mr['n_queued']:5d} | "
              f"mem {mr['memory_bytes'] / 1e6:8.1f} MB")
    for k, v in result["summary"].items():
        print(f"{prefix}summary.{k} = {v:.4f}")


def _write(path: Optional[str], payload) -> None:
    if not path:
        return
    with open(path, "w") as f:
        json.dump(payload, f, indent=1)
    print(f"wrote {path}", file=sys.stderr)


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.experiments",
        description="Run declarative simulation scenarios (docs/API.md).")
    sub = ap.add_subparsers(dest="command", required=True)

    def device_option(p):
        p.add_argument("--device", default=None, choices=("cuda", "cpu"),
                       help="where the fleet_vec scan runs under "
                            "REPRO_FLEET_VEC_SCAN=1 (default cuda: the "
                            "fleet_scan kernel; cpu: its plain version)")

    p_run = sub.add_parser("run", help="run one scenario spec")
    p_run.add_argument("spec")
    p_run.add_argument("--smoke", action="store_true",
                       help="apply the spec's smoke_overrides (CI scale)")
    p_run.add_argument("--out", default=None, help="write the result JSON here")
    p_run.add_argument("--set", action="append", default=[], metavar="PATH=V",
                       help="dotted-path override, e.g. n_workers=8")
    device_option(p_run)

    p_sweep = sub.add_parser("sweep", help="grid-expand axes and run each cell "
                             "(parallel + resumable via the executor)")
    p_sweep.add_argument("spec")
    p_sweep.add_argument("--axis", action="append", default=[], required=True,
                         metavar="PATH=V1,V2,...",
                         help="sweep axis, e.g. --axis n_workers=1,4,16")
    p_sweep.add_argument("--smoke", action="store_true")
    p_sweep.add_argument("--out", default=None,
                         help="write the list of result JSONs here")
    p_sweep.add_argument("--parallel", type=int, default=1, metavar="N",
                         help="worker processes (default 1 = in-process); "
                              "serial and parallel runs store identical "
                              "results")
    p_sweep.add_argument("--store", default=None, metavar="PATH",
                         help="append each validated result to this JSONL "
                              "results store (fsynced per point, keyed by "
                              "spec content hash)")
    p_sweep.add_argument("--resume", action="store_true",
                         help="skip grid points already in --store (e.g. "
                              "after a kill; a torn trailing line is "
                              "recomputed)")
    p_sweep.add_argument("--derive-seeds", action="store_true",
                         help="pin each point's traces.kwargs.seed to a "
                              "stable hash of its spec (independent "
                              "arrivals per point, reproducibly)")
    device_option(p_sweep)

    p_report = sub.add_parser(
        "report", help="summarize a results store back into the unified "
                       "result schema")
    p_report.add_argument("store")
    p_report.add_argument("--out", default=None,
                          help="write the summary JSON here")

    p_tour = sub.add_parser(
        "tournament", help="sweep every registered prewarm x placement over "
                           "one spec, score each cell against the hindsight "
                           "oracle, and mark the Pareto front")
    p_tour.add_argument("spec")
    p_tour.add_argument("--smoke", action="store_true",
                        help="apply the spec's smoke_overrides (CI scale)")
    p_tour.add_argument("--out", default=None,
                        help="write the tournament report JSON here")
    p_tour.add_argument("--parallel", type=int, default=1, metavar="N")
    p_tour.add_argument("--store", default=None, metavar="PATH",
                        help="JSONL results store for the underlying sweep "
                             "(resumable)")
    p_tour.add_argument("--resume", action="store_true",
                        help="skip grid points already in --store")
    device_option(p_tour)

    p_val = sub.add_parser("validate", help="load + schema-check specs")
    p_val.add_argument("specs", nargs="+")

    p_smoke = sub.add_parser(
        "smoke", help="run specs at smoke scale and schema-check the results")
    p_smoke.add_argument("specs", nargs="+")
    device_option(p_smoke)

    sub.add_parser("list", help="list the component registries")

    args = ap.parse_args(argv)

    if args.command == "run":
        overrides = {}
        for item in args.set:
            if "=" not in item:
                raise ValueError(f"--set needs path=value, got {item!r}")
            path, _, value = item.partition("=")
            overrides[path.strip()] = _parse_value(value)
        result = run_file(args.spec, smoke=args.smoke, overrides=overrides,
                          device=args.device)
        _print_result(result)
        _write(args.out, result.to_dict())
        return 0

    if args.command == "sweep":
        axes: Dict[str, List[Any]] = {}
        for item in args.axis:
            axes.update(parse_axis(item))
        def progress(done, total, point, skipped):
            verb = "skipped (stored)" if skipped else "done"
            print(f"[{done}/{total}] {point.name}: {verb}", file=sys.stderr)

        report = run_sweep(Scenario.from_file(args.spec), axes,
                           smoke=args.smoke, parallel=args.parallel,
                           store_path=args.store, resume=args.resume,
                           derive_seeds=args.derive_seeds,
                           progress=progress, device=args.device)
        for point, result in zip(report.points, report.results):
            _print_result_dict(result, label=point.name)
        if report.n_skipped:
            print(f"resumed: {report.n_skipped} stored point(s) skipped, "
                  f"{report.n_run} run", file=sys.stderr)
        _write(args.out, report.results)
        return 0

    if args.command == "report":
        summary = summarize_store(args.store)
        for row in summary["points"]:
            for m in ("warmswap", "prebaking", "baseline"):
                if m in row:
                    mr = row[m]
                    print(f"{row['name']}: {m:9s} "
                          f"avg {mr['avg_latency_s'] * 1e3:9.2f} ms | "
                          f"p99 {mr['p99_s'] * 1e3:9.2f} ms | "
                          f"cold {mr['n_cold']:6d} | "
                          f"mem {mr['memory_bytes'] / 1e6:8.1f} MB")
            for k, v in row["summary"].items():
                print(f"{row['name']}: summary.{k} = {v:.4f}")
        print(f"{summary['n_points']} point(s) in {args.store}"
              + (" (torn trailing line dropped)"
                 if summary["torn_tail_dropped"] else ""),
              file=sys.stderr)
        _write(args.out, summary)
        return 0

    if args.command == "tournament":
        from repro_torch.experiments.tournament import run_tournament
        def progress(done, total, point, skipped):
            verb = "skipped (stored)" if skipped else "done"
            print(f"[{done}/{total}] {point.name}: {verb}", file=sys.stderr)

        rep = run_tournament(Scenario.from_file(args.spec), smoke=args.smoke,
                             parallel=args.parallel, store_path=args.store,
                             resume=args.resume, progress=progress,
                             device=args.device)
        for c in rep.cells:
            star = "*" if c.pareto else " "
            print(f"{star} {c.method:9s} prewarm={c.prewarm:9s} "
                  f"placement={c.placement:12s} "
                  f"p99 {c.p99_s * 1e3:9.2f} ms | "
                  f"byte-min {c.byte_minutes / 1e9:9.3f} GB-min | "
                  f"cold {c.n_cold:6d} | "
                  f"gap {c.oracle_gap_total_s:9.3f} s")
        for m, g in rep.min_gaps().items():
            print(f"{m}: min total gap {g['min_total_gap_s']:.6f} s, "
                  f"min p99 gap {g['min_p99_gap_s']:.6f} s over "
                  f"{g['n_cells']} cells (* = Pareto front)",
                  file=sys.stderr)
        _write(args.out, rep.to_dict())
        return 0

    if args.command == "validate":
        for path in args.specs:
            scn = Scenario.from_file(path)
            scn.validate_components()      # incl. the placement registry key
            print(f"ok: {path} ({scn.name!r}, engine={scn.engine}, "
                  f"methods={scn.methods})")
        return 0

    if args.command == "smoke":
        for path in args.specs:
            result = run_file(path, smoke=True, device=args.device)
            print(f"ok: {path}")
            _print_result(result, label=result.scenario["name"])
        return 0

    if args.command == "list":
        from repro_torch.core.costmodel import PAGE_COST_MODELS
        from repro_torch.core.disruption import DISRUPTIONS
        from repro_torch.core.keepalive import PREWARM_POLICIES
        from repro_torch.core.simulator import COST_MODELS
        from repro_torch.core.traces import TRACE_GENERATORS
        from repro_torch.serving.scheduler import PLACEMENTS
        for reg in (TRACE_GENERATORS, COST_MODELS, PAGE_COST_MODELS,
                    PREWARM_POLICIES, PLACEMENTS, DISRUPTIONS):
            print(f"{reg.kind}: {', '.join(reg.names())}")
        print("workload: (import repro_torch.core.workloads to list — pulls in "
              "the PyTorch model stack)")
        return 0

    raise AssertionError(f"unhandled command {args.command!r}")
