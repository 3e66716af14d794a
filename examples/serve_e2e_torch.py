"""End-to-end serving driver on the PyTorch port (the paper's kind: serving).

The port's counterpart of ``examples/serve_e2e.py``, with the same flags and
printed lines. A provider fleet: one shared dependency image in a pool on the
card, two serving replicas brought up by live migration (``page_gather``),
continuous-batched decode traffic (``flash_attention`` prefill,
``decode_attention`` decode), a simulated node failure, and pool-based
recovery — timed at every step.

    PYTHONPATH=src python examples/serve_e2e_torch.py [--requests 24] [--device cpu]

``--device`` defaults to ``cuda``; without a card the script raises unless
``--device cpu`` is given.
"""
import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_reduced
from repro_torch.core import DependencyManager, RestorePolicy
from repro_torch.device import resolve_device
from repro_torch.models.transformer import init_params
from repro_torch.runtime import ReplicaSet
from repro_torch.serving import ServeConfig, ServingEngine


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--requests", type=int, default=24)
    ap.add_argument("--arch", default="qwen3_1_7b")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; cpu runs the plain path)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    cfg = get_reduced(args.arch)

    def build():
        return init_params(torch.Generator(device=dev).manual_seed(0), cfg, torch.float32)

    mgr = DependencyManager(device=dev)
    mgr.register_image("base", cfg.name, build)
    print(f"[pool] image 'base' live: {mgr.pool_bytes()/1e6:.1f} MB")

    scfg = ServeConfig(max_slots=4, max_seq_len=128, max_new_tokens=8)

    def make_engine(manager, image_id, cfg, method):
        if method == "warmswap":
            return ServingEngine.from_pool(manager, image_id, cfg, scfg,
                                           policy=RestorePolicy.BULK)
        # the engine builds its own decode state, which decode writes in place
        return ServingEngine(cfg, init_params(torch.Generator(device=dev).manual_seed(0),
                                              cfg, torch.float32), scfg)

    fleet = ReplicaSet(mgr, "base", cfg, make_engine, n_replicas=2)
    for e in fleet.events:
        print(f"[fleet] {e.replica} up via {e.method} in {e.seconds:.3f}s")

    # traffic
    rng = np.random.default_rng(0)
    t0 = time.perf_counter()
    names = list(fleet.replicas)
    for i in range(args.requests):
        eng = fleet.replicas[names[i % len(names)]]
        eng.submit(rng.integers(0, cfg.vocab_size, int(rng.integers(4, 32))))
    served = {}
    for name, eng in fleet.replicas.items():
        eng.run_until_done()
        m = eng.metrics()
        served[name] = m
        print(f"[serve] {name}: {m['completed']} done, "
              f"ttft {m['mean_ttft_s']*1e3:.0f}ms, "
              f"latency {m['mean_latency_s']*1e3:.0f}ms")
    wall = time.perf_counter() - t0
    print(f"[serve] wall: {wall:.2f}s")

    # failure + recovery through the pool
    victim = names[0]
    print(f"[fault] killing {victim}")
    fleet.kill(victim)
    dt_warm = fleet.recover(victim, method="warmswap")
    fleet.kill(victim)
    dt_cold = fleet.recover(victim, method="baseline")
    print(f"[fault] recovery via pool: {dt_warm:.3f}s | cold reload: {dt_cold:.3f}s "
          f"-> x{dt_cold/max(dt_warm,1e-9):.1f} faster")
    eng = fleet.replicas[victim]
    eng.submit(rng.integers(0, cfg.vocab_size, 8))
    eng.run_until_done()
    recovered = eng.metrics()["completed"]
    print(f"[fault] recovered replica serving again: "
          f"{recovered} request(s) done")
    return {"bringup": [(e.replica, e.method, e.seconds) for e in fleet.events],
            "served": served, "wall_s": wall,
            "ttft_s": float(np.mean([m["mean_ttft_s"] for m in served.values()])),
            "recovery_warm_s": dt_warm, "recovery_cold_s": dt_cold,
            "recovery_ratio": dt_cold / max(dt_warm, 1e-9),
            "recovered_completed": recovered}


if __name__ == "__main__":
    main()
