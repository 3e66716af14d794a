"""Multi-tenant fleet under Azure-statistics traffic on the PyTorch port: the
paper's §4.5 case study as a runnable scenario — 10 endpoints, one shared
image in a pool on the card, trace-driven cold/warm starts, with live memory
accounting vs the Prebaking alternative.

The port's counterpart of ``examples/multi_tenant_fleet.py``, with the same
flags and printed lines. Two runs of the same workload:

  1. **live replay** — real cold/warm starts against the live Dependency-
     Manager pool on the device (actual page migration through the
     ``page_gather`` kernel, actual memory);
  2. **simulated twin** — the checked-in declarative spec
     ``benchmarks/scenarios/multi_tenant.json`` through the port's
     ``repro_torch.core.scenario.run()`` (host numpy), so the measured replay
     and the model share a workload definition.

    PYTHONPATH=src python examples/multi_tenant_fleet_torch.py [--hours 4] [--device cpu]

``--device`` defaults to ``cuda``; without a card the script raises unless
``--device cpu`` is given.
"""
import argparse
import os
import tempfile

from repro_torch.core import (
    ColdStartConfig,
    ColdStartOrchestrator,
    DependencyManager,
    FunctionRegistry,
    KeepAlivePolicy,
)
from repro_torch.core import workloads as wl
from repro_torch.core.scenario import Scenario, run as run_scenario
from repro_torch.core.traces import generate_traces
from repro_torch.device import resolve_device

SPEC = os.path.join(os.path.dirname(__file__), "..", "benchmarks",
                    "scenarios", "multi_tenant.json")


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--hours", type=float, default=4.0)
    ap.add_argument("--tenants", type=int, default=10)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; cpu runs the plain path)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    with tempfile.TemporaryDirectory(prefix="warmswap-fleet-") as tmp:
        mgr = DependencyManager(disk_dir=f"{tmp}/pool", device=dev)
        reg = FunctionRegistry(store_dir=f"{tmp}/store")
        image_id = "model-tiny"
        builder = wl.model_params_builder(image_id, device=dev)
        execs = wl.make_model_executables(image_id)
        wl.warm_executables(execs, builder(), image_id)
        mgr.register_image(image_id, image_id, builder, executables=execs)
        w = wl.WORKLOADS["lr_serving"]
        for i in range(args.tenants):
            reg.register(f"fn-{i}", image_id, wl._head_builder(image_id, seed=i),
                         w.handler_fn, base_params_builder=builder)
        orch = ColdStartOrchestrator(mgr, reg, ColdStartConfig())

        # trace-driven replay: real cold/warm starts against the live pool
        horizon = args.hours * 60
        traces = generate_traces(args.tenants, horizon_min=horizon, seed=0,
                                 rates=[0.02 + 0.05 * i for i in range(args.tenants)])
        keep = KeepAlivePolicy(15.0)
        instances, expiry = {}, {}
        events = sorted((t_min, tr.fn_index) for tr in traces
                        for t_min in tr.arrivals_min)
        cold = warm = 0
        cold_s = warm_s = 0.0
        for t_min, fi in events:
            fn = f"fn-{fi}"
            if fn in instances and t_min <= expiry[fn]:
                # the handler copies its classes to the host, so the seconds
                # end after the device's work
                _, dt = instances[fn].invoke(w.request_builder())
                warm += 1
                warm_s += dt
            else:
                inst, t = orch.cold_start_warmswap(fn)
                instances[fn] = inst
                cold += 1
                cold_s += t.total
            expiry[fn] = t_min + keep.keep_alive_min

        pool_bytes = mgr.pool_bytes()
        prebake_bytes = args.tenants * pool_bytes  # what Prebaking would pin
        print(f"[fleet] {len(events)} invocations over {args.hours:.1f}h: "
              f"{cold} cold ({cold_s/max(cold,1)*1e3:.0f}ms avg), "
              f"{warm} warm ({warm_s/max(warm,1)*1e3:.1f}ms avg)")
        print(f"[fleet] pool memory: {pool_bytes/1e6:.1f} MB shared by "
              f"{args.tenants} tenants (prebaking would pin "
              f"{prebake_bytes/1e6:.0f} MB -> "
              f"{(1 - pool_bytes/prebake_bytes)*100:.0f}% saved)")
        print(f"[fleet] image initialized {mgr.stats.builds} time(s)")
        builds = mgr.stats.builds

    # --- the simulated twin: same workload as a declarative scenario spec ------
    scn = Scenario.from_file(SPEC)
    if args.hours * 60 != scn.traces.kwargs["horizon_min"] or \
            args.tenants != scn.traces.kwargs["n_functions"]:
        scn = scn.with_overrides({
            "traces.kwargs.horizon_min": args.hours * 60,
            "traces.kwargs.n_functions": args.tenants,
            "traces.kwargs.rates": [0.02 + 0.05 * i
                                    for i in range(args.tenants)]})
    res = run_scenario(scn, device=dev)
    sim_w = res.methods["warmswap"]
    print(f"[sim]   scenario twin ({os.path.basename(SPEC)}): "
          f"{sim_w.n_cold} cold / {sim_w.n_warm} warm, "
          f"avg {sim_w.avg_latency_s * 1e3:.0f} ms | memory saving vs "
          f"prebaking {res.summary['memory_saving_vs_prebaking'] * 100:.0f} % "
          f"(paper: 88 %)")
    return {"invocations": len(events), "cold": cold, "warm": warm,
            "cold_ms": cold_s / max(cold, 1) * 1e3, "warm_ms": warm_s / max(warm, 1) * 1e3,
            "pool_bytes": pool_bytes, "prebake_bytes": prebake_bytes, "builds": builds,
            "twin_cold": sim_w.n_cold, "twin_warm": sim_w.n_warm,
            "twin_saving": res.summary["memory_saving_vs_prebaking"]}


if __name__ == "__main__":
    main()
