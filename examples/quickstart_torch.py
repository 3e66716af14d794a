"""Quickstart on the PyTorch port: the WarmSwap loop in ~60 lines, on the card.

The port's counterpart of ``examples/quickstart.py``, with the same steps and
printed lines:

1. Provider registers a live dependency image (base model, pre-initialized once)
   in a pool on the device.
2. Two tenants register endpoints that share it.
3. Cold starts: Baseline (load + first forward from scratch) vs WarmSwap (live
   migration through the ``page_gather`` kernel).
4. The same comparison as a declarative scenario: one serializable spec, one
   ``run()``.

    PYTHONPATH=src python examples/quickstart_torch.py [--device cpu]

``--device`` defaults to ``cuda``; without a card the script raises unless
``--device cpu`` is given.
"""
import argparse
import tempfile
import zlib

from repro_torch.core import (
    ColdStartConfig,
    ColdStartOrchestrator,
    DependencyManager,
    FunctionRegistry,
    RestorePolicy,
)
from repro_torch.core import workloads as wl
from repro_torch.device import resolve_device

TENANTS = ("tenant-a", "tenant-b")


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; cpu runs the plain path)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    out = {"tenants": {}}
    with tempfile.TemporaryDirectory(prefix="warmswap-quickstart-") as tmp:
        manager = DependencyManager(disk_dir=f"{tmp}/pool", device=dev)
        registry = FunctionRegistry(store_dir=f"{tmp}/store")

        # --- provider setup phase (paper Fig. 4b): build the shared image ONCE ---
        image_id = "model-small"
        builder = wl.model_params_builder(image_id, device=dev)
        executables = wl.make_model_executables(image_id)
        wl.warm_executables(executables, builder(), image_id)   # first forward
        manager.register_image(image_id, image_id, builder, executables=executables)
        print(f"pool: {manager.summary()['live_images']} "
              f"({manager.pool_bytes()/1e6:.1f} MB live)")
        out["pool_bytes"] = manager.pool_bytes()

        # --- tenants: same dependency, private handlers ---------------------------
        w = wl.WORKLOADS["cnn_serving"]
        for tenant in TENANTS:
            registry.register(tenant, image_id,
                              wl._head_builder(image_id,
                                               seed=zlib.crc32(tenant.encode()) % 100),
                              w.handler_fn, base_params_builder=builder,
                              write_baseline_checkpoint=True)

        orch = ColdStartOrchestrator(manager, registry,
                                     ColdStartConfig(policy=RestorePolicy.BULK))

        # --- runtime phase (paper Fig. 4c): cold starts ---------------------------
        for tenant in TENANTS:
            inst_b, tb = orch.cold_start_baseline(tenant)
            inst_w, tw = orch.cold_start_warmswap(tenant)
            req = w.request_builder()
            out_b, _ = inst_b.invoke(req)       # numpy classes, copied off the device
            out_w, _ = inst_w.invoke(req)
            assert (out_b == out_w).all(), "migrated instance must match baseline"
            print(f"{tenant}: baseline {tb.total:.3f}s "
                  f"(load {tb.dependency_load:.3f}s + compile "
                  f"{tb.dependency_compile:.3f}s)"
                  f" | warmswap {tw.total:.3f}s (comm {tw.communication*1e3:.1f}ms + "
                  f"migrate {tw.migration*1e3:.1f}ms) -> x{tb.total/tw.total:.1f}")
            out["tenants"][tenant] = {
                "baseline_s": tb.total, "warmswap_s": tw.total,
                "speedup": tb.total / tw.total, "classes": out_w.tolist(),
                "baseline_classes": out_b.tolist()}
        print(f"image initialized {manager.stats.builds} time(s) for "
              f"{len(registry.list())} tenants")
        out["builds"] = manager.stats.builds
    out["scenario_saving"] = scenario_quickstart(dev)
    return out


def scenario_quickstart(device=None) -> float:
    """The scenario API in 10 lines: declare the paper's Fig. 7 comparison as
    data, run it, read the headline (host numpy: the single-worker engine
    runs no kernel)."""
    from repro_torch.core import Scenario, run

    spec = Scenario(
        name="quickstart",
        engine="single",                  # the paper-faithful Fig. 7 model
        traces={"name": "azure",          # registry key + kwargs
                "kwargs": {"n_functions": 10, "horizon_min": 24 * 60}},
        cost="paper_table2",              # the paper's measured Table 2 costs
    )
    result = run(Scenario.from_json(spec.to_json()), device=device)  # specs round-trip
    saving = result.summary["memory_saving_vs_prebaking"]
    print(f"scenario '{spec.name}': warmswap saves "
          f"{saving * 100:.0f} % memory "
          f"vs prebaking (paper: 88 %)")
    return saving


if __name__ == "__main__":
    main()
