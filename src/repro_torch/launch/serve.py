"""End-to-end serving driver: WarmSwap pool -> engine bring-up -> batched requests.

Port of ``repro.launch.serve``, with the same flags and printout. The provider
registers a dependency image once; a replica cold-starts by live migration
from the pool and then serves continuous-batched decode traffic. It runs on
``cuda`` unless ``--device cpu`` is given.

  python -m repro_torch.launch.serve --image model-tiny --requests 16 --slots 4
  python -m repro_torch.launch.serve --arch qwen3_1_7b --reduced --requests 8 --device cpu
  python -m repro_torch.launch.serve --arch qwen3_1_7b
  python -m repro_torch.launch.serve --arch recurrentgemma_2b --reduced --device cpu
  python -m repro_torch.launch.serve --arch recurrentgemma_2b
  python -m repro_torch.launch.serve --arch granite_moe_3b_a800m
  python -m repro_torch.launch.serve --arch moonshot_v1_16b_a3b --reduced --device cpu

``--arch`` takes every id whose prompts are tokens alone (all but
whisper_small and internvl2_1b, which need frontend embeddings); its
images hold fp32 parameters, as the reference builds them, and run with TF32
off (fp32 products and convolutions in full fp32). The ``--image`` ones are
the workload suite's bf16 images, which the port serves with a bf16 decode
state.
"""
from __future__ import annotations

import argparse
import time

import numpy as np


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--image", default=None,
                    help="workload image id (model-tiny/small/medium)")
    ap.add_argument("--arch", default=None, help="or an assigned arch id")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--max-seq", type=int, default=256)
    ap.add_argument("--policy", default="bulk",
                    choices=["bulk", "lazy", "no_pageserver", "no_lazy"])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda; 'cpu' runs the plain path)")
    args = ap.parse_args()

    import torch

    from repro_torch.core import DependencyManager, RestorePolicy
    from repro_torch.core import workloads as wl
    from repro_torch.device import resolve_device, synchronize
    from repro_torch.models.transformer import init_params
    from repro_torch.serving import ServeConfig, ServingEngine

    device = resolve_device(args.device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    policy = RestorePolicy(args.policy)
    mgr = DependencyManager(device=device)

    if args.arch:
        from repro_torch.configs import get_config, get_reduced
        cfg = get_reduced(args.arch) if args.reduced else get_config(args.arch)
        image_id = f"arch-{cfg.name}"
        mgr.register_image(
            image_id, cfg.name,
            lambda: init_params(torch.Generator(device=device).manual_seed(args.seed),
                                cfg, torch.float32))
    else:
        image_id = args.image or "model-tiny"
        cfg = wl.IMAGE_CONFIGS[image_id]
        mgr.register_image(image_id, image_id,
                           wl.model_params_builder(image_id, device=device))

    print(f"[serve] pool ready: {mgr.summary()['live_images']} "
          f"({mgr.pool_bytes()/1e6:.1f} MB)")

    t0 = time.perf_counter()
    engine = ServingEngine.from_pool(
        mgr, image_id, cfg,
        ServeConfig(max_slots=args.slots, max_seq_len=args.max_seq,
                    max_new_tokens=args.max_new),
        policy=policy)
    synchronize(device)
    print(f"[serve] replica cold-start via WarmSwap ({policy.value}): "
          f"{time.perf_counter()-t0:.3f}s")

    rng = np.random.default_rng(args.seed)
    for _ in range(args.requests):
        plen = int(rng.integers(4, min(64, args.max_seq - args.max_new)))
        engine.submit(rng.integers(0, cfg.vocab_size, plen))
    t1 = time.perf_counter()
    engine.run_until_done()
    dt = time.perf_counter() - t1
    m = engine.metrics()
    total_tokens = sum(len(r.tokens) for r in engine.completed.values())
    print(f"[serve] {m['completed']} requests, {total_tokens} tokens in {dt:.2f}s "
          f"({total_tokens/dt:.1f} tok/s); mean ttft={m['mean_ttft_s']*1e3:.0f}ms "
          f"mean latency={m['mean_latency_s']*1e3:.0f}ms")


if __name__ == "__main__":
    main()
