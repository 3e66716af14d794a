"""End-to-end training launcher (port of ``repro.launch.train``).

Config -> init -> train step -> deterministic data -> ``TrainSupervisor``
(async checkpoints, rollback on a non-finite loss or a failure, replay) ->
a metrics log. It runs on ``cuda`` unless ``--device cpu`` is given, in fp32
with TF32 off, as the reference trains.

  python -m repro_torch.launch.train --arch fnbench_tiny --steps 3 --device cpu
  python -m repro_torch.launch.train --arch qwen1_5_0_5b --steps 10 --batch 4 --seq 1024
  python -m repro_torch.launch.train --arch qwen3_1_7b --reduced --steps 50 --resume

``--model-axis`` other than 1 raises: sharding is not ported yet. Each
step's metrics, with its wall time in ``seconds`` (the first one includes the
anchor checkpoint), go to ``--log`` as JSON lines; :func:`main` also returns
the final parameters, optimizer state and history.
"""
from __future__ import annotations

import argparse
import json
import os
import time


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="fnbench_tiny")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ckpt-dir", default="results/train_ckpt")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--model-axis", type=int, default=1)
    ap.add_argument("--remat", default="none", choices=["none", "unit", "dots"])
    ap.add_argument("--log", default="results/train_log.jsonl")
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda; 'cpu' runs the plain path)")
    args = ap.parse_args(argv)
    if args.model_axis != 1:
        raise ValueError("--model-axis > 1 needs sharding, which the port does not "
                         "have yet")

    import torch

    from repro_torch.checkpoint import CheckpointConfig, latest_step
    from repro_torch.configs import get_config, get_reduced
    from repro_torch.core.tree import leaves
    from repro_torch.data import DataConfig, SyntheticTokenPipeline, batch_to_torch
    from repro_torch.device import resolve_device
    from repro_torch.models.api import make_train_step
    from repro_torch.models.transformer import init_params
    from repro_torch.optim import adamw_init
    from repro_torch.runtime import SupervisorConfig, TrainSupervisor, on_devices_of

    device = resolve_device(args.device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = get_reduced(args.arch) if args.reduced else get_config(args.arch)
    data = DataConfig(global_batch=args.batch, seq_len=args.seq, seed=args.seed)

    params = init_params(torch.Generator(device=device).manual_seed(args.seed), cfg,
                         torch.float32)
    opt_state = adamw_init(params)
    n_params = sum(p.numel() for p in leaves(params))
    print(f"[train] {cfg.name}: {n_params / 1e6:.2f}M params, batch={args.batch} "
          f"seq={args.seq} device={device} remat={args.remat}")

    step_fn = make_train_step(cfg, peak_lr=args.lr, total_steps=args.steps,
                              remat=args.remat)
    sup = TrainSupervisor(
        SupervisorConfig(checkpoint_every=args.ckpt_every,
                         checkpoint=CheckpointConfig(args.ckpt_dir)),
        step_fn,
        lambda s: batch_to_torch(SyntheticTokenPipeline.batch_at(cfg, data, s), device))
    start = 0
    if args.resume and latest_step(args.ckpt_dir) is not None:
        restored = sup.ckpt.restore(None, {"params": params, "opt_state": opt_state})
        params = on_devices_of(restored["params"], params)
        opt_state = on_devices_of(restored["opt_state"], opt_state)
        start = int(restored["__manifest__"]["step"])
        print(f"[train] resumed from step {start}")

    os.makedirs(os.path.dirname(args.log) or ".", exist_ok=True)
    t0 = time.perf_counter()
    last = [t0]
    with open(args.log, "a") as logf:
        def on_metrics(step, m):
            now = time.perf_counter()      # the metrics are on the host: the step is done
            m["seconds"], last[0] = now - last[0], now
            logf.write(json.dumps(m) + "\n")
            if step % 10 == 0 or step == start:
                dt = time.perf_counter() - t0
                tok_s = (step - start + 1) * args.batch * args.seq / max(dt, 1e-9)
                print(f"[train] step {step:5d} loss={m['loss']:.4f} lr={m['lr']:.2e} "
                      f"gnorm={m['grad_norm']:.2f} ({tok_s:.0f} tok/s)")

        params, opt_state, hist = sup.run(params, opt_state, start, args.steps - start,
                                          on_metrics=on_metrics)
    if hist:
        print(f"[train] done: loss {hist[0]['loss']:.4f} -> {hist[-1]['loss']:.4f} "
              f"over {len(hist)} steps")
    return {"params": params, "opt_state": opt_state, "history": hist}


if __name__ == "__main__":
    main()
