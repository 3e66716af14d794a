"""End-to-end training launcher (port of ``repro.launch.train``).

Config -> init -> train step -> deterministic data -> ``TrainSupervisor``
(async checkpoints, rollback on a non-finite loss or a failure, replay) ->
a metrics log. It runs on ``cuda`` unless ``--device cpu`` is given, in fp32
with TF32 off, as the reference trains.

  python -m repro_torch.launch.train --arch fnbench_tiny --steps 3 --device cpu
  python -m repro_torch.launch.train --arch qwen1_5_0_5b --steps 10 --batch 4 --seq 1024
  python -m repro_torch.launch.train --arch qwen3_1_7b --reduced --steps 50 --resume

On several ranks (``launch/cluster.py``'s environment, or a process group
the caller made) it trains on a ``("data", "model")`` mesh of
``world // --model-axis`` by ``--model-axis`` ranks, or with ``--pods N`` > 1
on a ``("pod", "data", "model")`` mesh of N pods (data parallelism over pod x
data, the reference's multi-pod layout): each rank holds its
shards of the parameters and moments (``models/sharding.py``) and its rows
of each global batch, and checkpoints hold the global arrays
(``ShardedCheckpointer``), so ``--resume`` may change the mesh. Without a
process group, ``--model-axis N`` > 1 starts N local ranks itself (a file
rendezvous; ``gloo`` on the CPU or where the ranks share a card, ``nccl``
where each has its own), which print; rank 0 writes the log.

  python -m repro_torch.launch.train --arch fnbench_tiny --steps 3 --model-axis 2 --device cpu
  python -m repro_torch.launch.train --arch fnbench_tiny --steps 3 --model-axis 2 --pods 2 \
      --device cpu                 # 4 local ranks on a (2, 1, 2) pod x data x model mesh

Each step's metrics, with its wall time in ``seconds`` (the first one
includes the anchor checkpoint), go to ``--log`` as JSON lines; :func:`main`
also returns the final parameters (this rank's shards), optimizer state and
history.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
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
    ap.add_argument("--pods", type=int, default=1)
    ap.add_argument("--remat", default="none", choices=["none", "unit", "dots"])
    ap.add_argument("--log", default="results/train_log.jsonl")
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda; 'cpu' runs the plain path)")
    args = ap.parse_args(argv)

    import torch
    import torch.distributed as dist

    from repro_torch.checkpoint import CheckpointConfig, Checkpointer, ShardedCheckpointer
    from repro_torch.configs import get_config, get_reduced
    from repro_torch.core.tree import leaves
    from repro_torch.data import DataConfig, SyntheticTokenPipeline, batch_to_torch
    from repro_torch.device import resolve_device
    from repro_torch.launch.cluster import initialize_distributed
    from repro_torch.launch.mesh import make_local_mesh, rank_device
    from repro_torch.models import sharding as sh
    from repro_torch.models.api import make_train_step
    from repro_torch.models.transformer import init_params
    from repro_torch.optim import adamw_init
    from repro_torch.runtime import SupervisorConfig, TrainSupervisor, on_devices_of

    device = resolve_device(args.device)
    rank, world = initialize_distributed(device.type)
    if world == 1 and args.model_axis * args.pods > 1:
        return _spawn_ranks(sys.argv[1:] if argv is None else argv,
                            args.model_axis * args.pods, device.type)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = get_reduced(args.arch) if args.reduced else get_config(args.arch)
    data = DataConfig(global_batch=args.batch, seq_len=args.seq, seed=args.seed)
    par = None
    if world > 1:
        device = rank_device(device.type, int(os.environ.get("LOCAL_RANK", rank)))
        par = sh.Parallel.of(make_local_mesh(args.model_axis, device.type, args.pods), cfg)
        if args.batch % par.dp:
            raise ValueError(f"--batch {args.batch} does not split over the data axes "
                             f"({par.dp})")
        if rank == 0:
            print(f"[train] mesh {' x '.join(f'{a}={n}' for a, n in zip(par.axes, par.sizes))}"
                  f", backend {dist.get_backend()}, {world} ranks")

    params = init_params(torch.Generator(device=device).manual_seed(args.seed), cfg,
                         torch.float32)
    n_params = sum(p.numel() for p in leaves(params))
    ckpt_cfg = CheckpointConfig(args.ckpt_dir)
    if par is not None:
        specs = sh.param_pspecs(cfg, params, par.tp)
        params = sh.shard_tree(params, specs, par)
    opt_state = adamw_init(params)
    if par is not None:
        ckpt = ShardedCheckpointer(ckpt_cfg, par, {
            "params": specs, "opt_state": sh.opt_state_pspecs(cfg, opt_state, specs)},
            device)
    else:
        ckpt = Checkpointer(ckpt_cfg)
    if rank == 0:
        print(f"[train] {cfg.name}: {n_params / 1e6:.2f}M params, batch={args.batch} "
              f"seq={args.seq} device={device} remat={args.remat}")

    def batch_at(s):
        b = SyntheticTokenPipeline.batch_at(cfg, data, s)   # the global batch
        if par is not None:                                 # and this rank's rows
            n = args.batch // par.dp
            b = {k: v[par.dp_rank * n:(par.dp_rank + 1) * n] for k, v in b.items()}
        return batch_to_torch(b, device)

    step_fn = make_train_step(cfg, peak_lr=args.lr, total_steps=args.steps,
                              remat=args.remat, par=par)
    sup = TrainSupervisor(SupervisorConfig(checkpoint_every=args.ckpt_every,
                                           checkpoint=ckpt_cfg),
                          step_fn, batch_at, ckpt=ckpt)
    start = 0
    if args.resume and ckpt.latest() is not None:
        restored = sup.ckpt.restore(None, {"params": params, "opt_state": opt_state})
        params = on_devices_of(restored["params"], params)
        opt_state = on_devices_of(restored["opt_state"], opt_state)
        start = int(restored["__manifest__"]["step"])
        if rank == 0:
            print(f"[train] resumed from step {start}")

    os.makedirs(os.path.dirname(args.log) or ".", exist_ok=True)
    t0 = time.perf_counter()
    last = [t0]
    with open(args.log if rank == 0 else os.devnull, "a") as logf:
        def on_metrics(step, m):
            now = time.perf_counter()      # the metrics are on the host: the step is done
            m["seconds"], last[0] = now - last[0], now
            logf.write(json.dumps(m) + "\n")
            if rank == 0 and (step % 10 == 0 or step == start):
                dt = time.perf_counter() - t0
                tok_s = (step - start + 1) * args.batch * args.seq / max(dt, 1e-9)
                print(f"[train] step {step:5d} loss={m['loss']:.4f} lr={m['lr']:.2e} "
                      f"gnorm={m['grad_norm']:.2f} ({tok_s:.0f} tok/s)")

        params, opt_state, hist = sup.run(params, opt_state, start, args.steps - start,
                                          on_metrics=on_metrics)
    if hist and rank == 0:
        print(f"[train] done: loss {hist[0]['loss']:.4f} -> {hist[-1]['loss']:.4f} "
              f"over {len(hist)} steps")
    return {"params": params, "opt_state": opt_state, "history": hist}


def _rank_main(rank: int, world: int, argv) -> None:
    main(argv)


def _spawn_ranks(argv, world: int, device_type: str) -> dict:
    """``main(argv)`` on ``world`` local ranks; raises if any rank fails."""
    from repro_torch.launch.mesh import spawn_local_ranks
    print(f"[train] starting {world} local ranks", flush=True)
    spawn_local_ranks(_rank_main, world, device_type, args=(argv,))
    return {"ranks": world}


if __name__ == "__main__":
    main()
