"""Fleet simulation tour on the PyTorch port, scenario-first: every cell below
is a checked-in declarative spec (``benchmarks/scenarios/*.json``) run through
the port's one ``repro_torch.core.scenario.run()`` entry point — the same specs
the benchmark suite drives through ``python -m repro_torch.experiments``.

The port's counterpart of ``examples/fleet_sim.py``, with the same printed
lines: the simulation track is the reference's numpy, so every number equals
the reference's. Every spec here runs the event engines on the host; the
device (``--device``, default ``cuda``) is where a ``fleet_vec`` scan would
run, and this tour runs none.

The questions the multi-worker engine answers beyond the single-worker model:

  1. Degenerate check — 1 worker / 1 instance per function reproduces the
     paper's Fig. 7 numbers, including the ~88 % memory-saving headline
     (asserted against the legacy ``simulate()`` wrapper).
  2. Does image-affinity placement beat round-robin on a skewed workload?
     (one spec, ``sweep()`` over ``placement.name``)
  3. What does pool capacity pressure do to each method?
  4. How do keep-alive / pre-warm policies trade latency for residency?
     (``sweep()`` over ``prewarm.name`` — the PREWARM_POLICIES registry)
  5. What does an instance cap do to the tail? (queue-accurate P50/P95/P99)
  6. What does a cold start actually *cost* when it is priced page by page?
     (page-granular cost model + cluster-shared image cache — the
     ``bounded_cache`` spec vs the same spec with affinity placement)

    PYTHONPATH=src python examples/fleet_sim_torch.py [--device cpu]

``--device`` defaults to ``cuda``; without a card the script raises unless
``--device cpu`` is given.
"""
import argparse
import os

from repro_torch.core import CostModel, KeepAlivePolicy, PageCostModel, simulate
from repro_torch.core.scenario import Scenario, run, sweep
from repro_torch.core.traces import TRACE_GENERATORS, sharing_degrees
from repro_torch.device import resolve_device

SCENARIOS = os.path.join(os.path.dirname(__file__), "..", "benchmarks",
                         "scenarios")


def spec(name: str) -> Scenario:
    return Scenario.from_file(os.path.join(SCENARIOS, f"{name}.json"))


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; cpu runs the plain path)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    cm = CostModel.paper_table2()

    # --- 1. degenerate point == the paper's simulation --------------------------
    res = run(spec("degenerate"), device=dev)
    rw = res.methods["warmswap"]
    ref = simulate(res.traces, "warmswap", cm, KeepAlivePolicy(15.0))
    print(f"degenerate: scenario avg {rw.avg_latency_s * 1e3:.2f} ms "
          f"== simulate() {ref.avg_latency_s * 1e3:.2f} ms; "
          f"memory saving {res.summary['memory_saving_vs_prebaking'] * 100:.1f} % "
          f"(paper: 88 %)\n")
    assert abs(rw.total_latency_s - ref.total_latency_s) < 1e-6

    # --- a skewed 40-function fleet over 4 shared images ------------------------
    base = spec("fleet_base")
    n_fns = base.traces.kwargs["n_functions"]
    traces = TRACE_GENERATORS.build(base.traces.name, **base.traces.kwargs)
    print(f"fleet workload: {n_fns} fns, sharing degrees "
          f"{sharing_degrees(traces)}")

    # --- 2. placement policies under identical everything else ------------------
    # (the shipped spec runs all three methods for the bench suite; this tour
    # only reads warmswap, so don't simulate the other two)
    print("\nplacement (4 workers, pool capacity = 2 images each, warmswap):")
    for scn in sweep(spec("placement").with_overrides({"methods": ["warmswap"]}),
                     {"placement.name": ["affinity", "least_loaded",
                                         "round_robin"]}):
        mr = run(scn, device=dev).methods["warmswap"]
        print(f"  {scn.placement.name:13s} avg {mr.avg_latency_s * 1e3:7.1f} ms | "
              f"cold {mr.n_cold:5d} | pool misses {mr.pool_misses:4d} | "
              f"evictions {mr.evictions:4d} | peak mem {mr.memory_bytes >> 20} MB")

    # --- 3. capacity pressure per method ----------------------------------------
    print("\npool capacity (4 workers, affinity):")
    for cap in (1, 2, None):
        r = run(base.with_overrides({"worker_capacity_bytes": (
            None if cap is None else cap * cm.image_bytes)}), device=dev)
        row = [f"{m} {mr.avg_latency_s * 1e3:6.1f} ms/"
               f"{mr.memory_bytes >> 20:4d} MB"
               for m, mr in r.methods.items()]
        print(f"  {str(cap or 'unlimited'):>9s} images/worker: " + " | ".join(row))

    # --- 4. pre-warm policies ----------------------------------------------------
    print("\npre-warm policy (4 workers, warmswap): latency vs residency")
    for scn in sweep(spec("prewarm"),
                     {"prewarm.name": ["none", "histogram", "spes"]}):
        mr = run(scn, device=dev).methods["warmswap"]
        print(f"  {scn.prewarm.name:9s} avg {mr.avg_latency_s * 1e3:7.1f} ms | "
              f"cold {mr.n_cold:5d} | warm-instance residency "
              f"{mr.instance_resident_min:9.0f} inst-min | "
              f"prewarm spawns/hits {mr.prewarm_spawns}/{mr.prewarm_hits}")
    peak = run(base.with_overrides(
        {"worker_capacity_bytes": None, "methods": ["warmswap"]}), device=dev)
    print("\nconcurrency: arrivals overlapping a busy instance spawn new ones "
          "(peak concurrent instances of one function above: "
          f"{peak.methods['warmswap'].max_concurrent_instances})")

    # --- 5. queueing: instance caps make the tail visible ------------------------
    print("\ninstance cap (2 workers, warmswap): queue delay shows in the tail")
    for scn in sweep(spec("queueing"), {"max_instances_per_fn": [None, 2, 1]}):
        mr = run(scn, device=dev).methods["warmswap"]
        p = mr.latency_percentiles_s
        print(f"  cap={str(scn.max_instances_per_fn):>4s} "
              f"avg {mr.avg_latency_s * 1e3:7.1f} ms | "
              f"P50 {p['p50'] * 1e3:6.1f} | P95 {p['p95'] * 1e3:7.1f} | "
              f"P99 {p['p99'] * 1e3:7.1f} ms | queued {mr.n_queued:4d} "
              f"({mr.queue_delay_s:.1f}s waiting)")

    # --- 6. page-granular cold starts + the cluster-shared image cache ----------
    model = PageCostModel(cost=cm)
    n_img = model.image_pages()
    print(f"\npage-granular cost model ({n_img} pages x "
          f"{model.page_size >> 20} MiB for the {cm.image_bytes >> 20} MB image):")
    for tier, label in (("local", "local pool hit (memcpy)"),
                        ("remote", "remote peer via shared cache (DCN)"),
                        ("miss", "source-store fetch (cache miss)")):
        lat = model.cold_latency_s("warmswap", tier=tier)
        print(f"  warmswap cold, {label:36s} {lat * 1e3:7.1f} ms")
    half = model.cold_latency_s("warmswap", tier="remote",
                                resident_pages=n_img // 2)
    print(f"  warmswap cold, remote + half-resident image   {half * 1e3:7.1f} ms"
          f"  (partial residency: only missing pages move)")
    print(f"  baseline  cold (full source fetch, no cache)  "
          f"{model.cold_latency_s('baseline') * 1e3:7.1f} ms | "
          f"dependency-loading speedup "
          f"{model.dependency_loading_speedup():.2f}x (paper band: 2.2-3.2x)")

    print("\ncluster-shared cache (4 workers, pool = 1 image each, shared tier"
          " = 2 images, round-robin to force cross-worker traffic):")
    r = run(spec("bounded_cache"), device=dev).methods["warmswap"]
    print(f"  cold starts by tier: local {r.cache_hits['local']} | "
          f"remote {r.cache_hits['remote']} | source miss {r.cache_hits['miss']} | "
          f"cluster evictions {r.shared_cache_evictions}")
    print(f"  network page volume {r.pages_transferred} pages | avg latency "
          f"{r.avg_latency_s * 1e3:.1f} ms | shared-tier peak "
          f"{r.shared_cache_peak_bytes >> 20} MB")
    ra = run(spec("bounded_cache").with_overrides(
        {"placement.name": "affinity"}), device=dev).methods["warmswap"]
    print(f"  ...with bandwidth-aware affinity placement instead: local "
          f"{ra.cache_hits['local']} | remote {ra.cache_hits['remote']} | miss "
          f"{ra.cache_hits['miss']} | {ra.pages_transferred} pages moved "
          f"({ra.avg_latency_s * 1e3:.1f} ms avg)")

    # --- 7. large sweeps: the parallel, resumable executor ----------------------
    # Grid points fan out over a process pool; each validated result streams
    # to an append-only JSONL store keyed by spec content hash, so a killed
    # sweep resumes by skipping finished points — and serial vs parallel
    # runs store byte-identical results (docs/API.md).
    import tempfile

    from repro_torch.experiments.executor import run_sweep

    store = os.path.join(tempfile.mkdtemp(prefix="warmswap-sweep-"),
                         "sweep.jsonl")
    axes = {"traces.kwargs.seed": [0, 1]}
    report = run_sweep(spec("degenerate"), axes, smoke=True, parallel=2,
                       store_path=store, device=dev)
    resumed = run_sweep(spec("degenerate"), axes, smoke=True,
                        store_path=store, resume=True, device=dev)
    print(f"\nexecutor sweep ({len(report.points)} points, 2 processes) -> "
          f"{store}")
    for point, result in zip(report.points, report.results):
        ws = result["methods"]["warmswap"]
        print(f"  {point.name}: warmswap avg "
              f"{ws['avg_latency_s'] * 1e3:.2f} ms | cold {ws['n_cold']} | "
              f"saving {result['summary']['memory_saving_vs_prebaking']:.1%}")
    assert resumed.n_run == 0 and resumed.n_skipped == len(report.points)
    assert resumed.results == report.results
    print(f"  re-run with --resume: {resumed.n_skipped} stored points "
          f"skipped, 0 recomputed")
    return {"degenerate_ms": rw.avg_latency_s * 1e3,
            "saving": res.summary["memory_saving_vs_prebaking"],
            "sweep_points": len(report.points), "resumed_skipped": resumed.n_skipped,
            "store": store}


if __name__ == "__main__":
    main()
