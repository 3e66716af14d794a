"""Train a small LM end-to-end on the PyTorch port with the full substrate:
deterministic pipeline, AdamW + cosine schedule, async checkpoints, and an
injected mid-run failure that the supervisor rolls back transparently.

The port's counterpart of ``examples/train_small.py``, with the same flags and
printed lines. On the card every step runs the flash_attention forward (fp32,
``cuda_core`` route) and its backward (``tc_tf32x3`` route).

    PYTHONPATH=src python examples/train_small_torch.py [--steps 200] [--device cpu]

``--device`` defaults to ``cuda``; without a card the script raises unless
``--device cpu`` is given.
"""
import argparse
import tempfile
import time

import torch

from repro_torch.checkpoint import CheckpointConfig
from repro_torch.configs import get_config
from repro_torch.core.tree import leaves
from repro_torch.data import DataConfig, SyntheticTokenPipeline, batch_to_torch
from repro_torch.device import resolve_device
from repro_torch.models.api import make_train_step
from repro_torch.models.transformer import init_params
from repro_torch.optim import adamw_init
from repro_torch.runtime import InjectedFailure, SupervisorConfig, TrainSupervisor


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; cpu runs the plain path)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = get_config("fnbench_tiny")
    data = DataConfig(global_batch=args.batch, seq_len=args.seq, seed=0)
    params = init_params(torch.Generator(device=dev).manual_seed(0), cfg, torch.float32)
    opt = adamw_init(params)
    n = sum(x.numel() for x in leaves(params))
    print(f"[train] {cfg.name}: {n/1e6:.2f}M params, {args.steps} steps")

    # the step updates the parameters and moments in place: nothing to donate
    step_fn = make_train_step(cfg, peak_lr=1e-3, warmup_steps=20,
                              total_steps=args.steps, remat="none")
    with tempfile.TemporaryDirectory() as tmp:
        sup = TrainSupervisor(
            SupervisorConfig(checkpoint_every=50,
                             checkpoint=CheckpointConfig(tmp)),
            step_fn,
            lambda s: batch_to_torch(SyntheticTokenPipeline.batch_at(cfg, data, s), dev))
        losses = []
        t0 = time.perf_counter()
        # the supervisor hands on_metrics the step's metrics as host floats
        params, opt, hist = sup.run(
            params, opt, 0, args.steps,
            fail_at={args.steps // 2: InjectedFailure("simulated node failure")},
            on_metrics=lambda s, m: (
                losses.append(m["loss"]),
                print(f"[train] step {s:4d} loss={m['loss']:.4f} "
                      f"lr={m['lr']:.2e}") if s % 25 == 0 else None))
        seconds = time.perf_counter() - t0
    print(f"[train] loss {hist[0]['loss']:.3f} -> {hist[-1]['loss']:.3f}; "
          f"failures recovered: {sup.restores}")
    assert hist[-1]["loss"] < hist[0]["loss"], "training must make progress"
    return {"params": n, "losses": losses, "first_loss": hist[0]["loss"],
            "last_loss": hist[-1]["loss"], "restores": sup.restores,
            "steps_run": len(losses), "seconds": seconds,
            "step_s": seconds / max(len(losses), 1)}


if __name__ == "__main__":
    main()
