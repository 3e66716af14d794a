"""Multi-process bootstrap for sharded runs (port of ``repro.launch.cluster``).

Every process runs the same command; the scheduler sets the reference's
environment, and this module joins the process group from it:

    COORDINATOR_ADDRESS=host:port NUM_PROCESSES=8 PROCESS_ID=$i \\
        python -m repro_torch.launch.cluster --role train --arch gemma2_27b ...

  * :func:`initialize_distributed` reads ``COORDINATOR_ADDRESS`` (``host:port``,
    or a ``tcp://`` / ``file://`` URL), ``NUM_PROCESSES`` and ``PROCESS_ID``
    (and ``LOCAL_RANK`` / ``LOCAL_WORLD_SIZE`` where a host runs several
    ranks) and joins the default process group on the backend
    ``launch.mesh.choose_backend`` picks; single-process when they are unset;
  * the production mesh across all ranks where there are enough of them,
    else the local one (``launch/mesh.py``), with ``--multi-pod`` the
    ``("pod", "data", "model")`` one (2 pods);
  * ``--role train`` hands over to ``launch/train.py`` with ``--resume`` (and
    ``--pods 2`` with ``--multi-pod``), the checkpoint directory being shared
    storage: a restore re-shards to the current mesh, so the job may resume
    on another mesh shape (elastic restart, tests/test_torch_elastic.py);
    ``--role serve`` hands over to ``launch/serve.py`` (a replica a
    process, as in the reference); ``--role dryrun`` to
    ``launch/dryrun.py``, in one process with no process group, as the
    reference's dry run needs no fleet.
"""
from __future__ import annotations

import argparse
import os
import sys


def initialize_distributed(device_type: str = "cuda") -> tuple:
    """Returns ``(rank, world)``: (0, 1) when no coordinator is set and no
    process group exists."""
    import torch.distributed as dist

    coord = os.environ.get("COORDINATOR_ADDRESS")
    nproc = os.environ.get("NUM_PROCESSES")
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    if coord and nproc:
        from repro_torch.launch.mesh import init_ranks
        rank, world = int(os.environ.get("PROCESS_ID", "0")), int(nproc)
        init_ranks(rank, world, coord if "://" in coord else f"tcp://{coord}", device_type,
                   local_rank=int(os.environ.get("LOCAL_RANK", rank)),
                   ranks_on_host=int(os.environ.get("LOCAL_WORLD_SIZE", world)))
        return rank, world
    return 0, 1


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--role", choices=["train", "serve", "dryrun"], default="train")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--arch", default="fnbench_tiny")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--ckpt-dir", default=os.environ.get("CKPT_DIR",
                                                         "results/cluster_ckpt"))
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args, passthrough = ap.parse_known_args(argv)
    if args.role == "dryrun":
        from repro_torch.launch.dryrun import main as dryrun_main
        dryrun_main(["--arch", args.arch] + passthrough)
        return

    rank, world = initialize_distributed(args.device)
    print(f"[cluster] process {rank}/{world}")

    from repro_torch.launch.mesh import make_local_mesh, make_production_mesh
    pods = 2 if args.multi_pod else 1
    if world > 1:
        try:
            mesh = make_production_mesh(multi_pod=args.multi_pod, device_type=args.device)
        except RuntimeError:                                   # smaller fleets
            mesh = make_local_mesh(device_type=args.device, pods=pods)
        print(f"[cluster] mesh: {dict(zip(mesh.mesh_dim_names, mesh.shape))}")

    if args.role == "train":
        from repro_torch.launch.train import main as train_main
        train_main(["--arch", args.arch, "--steps", str(args.steps), "--ckpt-dir",
                    args.ckpt_dir, "--resume", "--device", args.device,
                    "--pods", str(pods)] + passthrough)
    else:
        sys.argv = ["serve", "--arch", args.arch, "--reduced", "--device",
                    args.device] + passthrough
        from repro_torch.launch.serve import main as serve_main
        serve_main()


if __name__ == "__main__":
    main()
