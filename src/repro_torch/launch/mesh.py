"""Meshes of ``torch.distributed`` ranks (port of ``repro.launch.mesh``).

The reference's meshes are arrays of JAX devices; the port's are
``DeviceMesh``es of ranks, one process each, made with ``init_device_mesh``
once the default process group exists (:func:`init_ranks`, or
``launch/cluster.initialize_distributed``). Functions, not module constants,
so importing this module touches no process group.

The backend is chosen explicitly and printed (:func:`choose_backend`):
``nccl`` when each rank has a card of its own, ``gloo`` when ranks share a
card or run on the CPU. The port's collectives are ``all_reduce`` and
``broadcast`` only, the two that gloo takes on CUDA tensors, so one code
path serves all three. :func:`spawn_local_ranks` starts a group of ranks on
one host and fails as soon as one of them does.

Topology of the reference's production meshes:
  * single-pod: (16, 16)    = ('data', 'model')
  * multi-pod:  (2, 16, 16) = ('pod', 'data', 'model'); 'pod' is the
    data-parallel axis across hosts, 'model' stays inside a pod.
"""
from __future__ import annotations

import datetime
import os
from typing import Any, Callable, List, Optional

import torch
import torch.distributed as dist


def choose_backend(device_type: str, ranks_on_host: int) -> str:
    """``nccl`` when ``device_type`` is cuda and each of the host's
    ``ranks_on_host`` ranks has a card of its own; ``gloo`` otherwise
    (ranks sharing a card: NCCL refuses two ranks on one device; CPU
    ranks)."""
    if device_type == "cuda" and ranks_on_host <= torch.cuda.device_count():
        return "nccl"
    return "gloo"


def rank_device(device_type: str, local_rank: int) -> torch.device:
    """The device a rank computes on: card ``local_rank % cards`` (several
    ranks share a card when there are fewer cards than ranks), or the CPU."""
    if device_type == "cuda":
        return torch.device("cuda", local_rank % torch.cuda.device_count())
    return torch.device("cpu")


def init_ranks(rank: int, world: int, init_method: str, device_type: str, *,
               local_rank: Optional[int] = None, ranks_on_host: Optional[int] = None,
               timeout_s: float = 600.0) -> torch.device:
    """Join the default process group as ``rank`` of ``world`` through
    ``init_method`` (``tcp://host:port`` or ``file://path``), on the backend
    :func:`choose_backend` picks, and print the choice. Returns the rank's
    device (made current for cuda)."""
    local_rank = rank if local_rank is None else local_rank
    ranks_on_host = world if ranks_on_host is None else ranks_on_host
    backend = choose_backend(device_type, ranks_on_host)
    device = rank_device(device_type, local_rank)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=world,
                            timeout=datetime.timedelta(seconds=timeout_s))
    if rank == 0:
        print(f"[mesh] {world} ranks, backend {backend} ({ranks_on_host} on this host, "
              f"{torch.cuda.device_count() if device_type == 'cuda' else 0} cards), "
              f"rank 0 on {device}", flush=True)
    return device


def _local_rank_entry(fn, rank: int, world: int, tmp: str, device_type: str, args: tuple,
                      timeout_s: float) -> None:
    import traceback
    try:
        init_ranks(rank, world, f"file://{os.path.join(tmp, 'rdv')}", device_type,
                   timeout_s=timeout_s)
        torch.save(fn(rank, world, *args), os.path.join(tmp, f"out{rank}.pt"))
    except BaseException:
        with open(os.path.join(tmp, f"err{rank}.txt"), "w") as f:
            f.write(traceback.format_exc())
        raise SystemExit(1)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def spawn_local_ranks(fn: Callable[..., Any], world: int, device_type: str = "cuda", *,
                      args: tuple = (), timeout: Optional[float] = None) -> List[Any]:
    """``fn(rank, world, *args)`` in ``world`` spawned processes on this
    host, joined by :func:`init_ranks` through a file rendezvous in a
    temporary directory (groups started side by side never share a port).
    Returns each rank's result (picklable) by rank. A rank that fails fails
    the call at once, and so does any rank still running after ``timeout``
    seconds (None: no limit but the process group's 600 s a collective): the
    other ranks are killed and the error holds the ranks' tracebacks."""
    import multiprocessing
    import tempfile
    import time

    ctx = multiprocessing.get_context("spawn")
    with tempfile.TemporaryDirectory(prefix="ranks-") as tmp:
        procs = [ctx.Process(target=_local_rank_entry, daemon=True,
                             args=(fn, r, world, tmp, device_type, tuple(args),
                                   timeout or 600.0))
                 for r in range(world)]
        for p in procs:
            p.start()
        deadline = None if timeout is None else time.monotonic() + timeout
        try:
            while any(p.is_alive() for p in procs):
                if any(p.exitcode not in (None, 0) for p in procs) or (
                        deadline is not None and time.monotonic() > deadline):
                    break
                time.sleep(0.2)
        finally:
            running = [r for r, p in enumerate(procs) if p.is_alive()]
            for p in procs:
                if p.is_alive():
                    p.kill()
                p.join(30)
        codes = [p.exitcode for p in procs]
        if codes != [0] * world:
            errors = ""
            for r in range(world):
                path = os.path.join(tmp, f"err{r}.txt")
                if os.path.exists(path):
                    with open(path) as f:
                        errors += f"--- rank {r}\n{f.read()}"
            raise RuntimeError(f"local ranks failed: exit codes {codes}, killed while "
                               f"running {running}\n{errors[-6000:]}")
        return [torch.load(os.path.join(tmp, f"out{r}.pt"), weights_only=False)
                for r in range(world)]


def _world() -> int:
    if not dist.is_initialized():
        raise RuntimeError("no process group: call launch.mesh.init_ranks or "
                           "launch.cluster.initialize_distributed first")
    return dist.get_world_size()


def make_production_mesh(*, multi_pod: bool = False, device_type: str = "cuda"):
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    n = 1
    for s in shape:
        n *= s
    world = _world()
    if world < n:
        raise RuntimeError(f"need {n} devices for mesh {shape}, have {world} — a "
                           "smaller fleet runs make_local_mesh")
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


def make_local_mesh(model_axis: int = 1, device_type: str = "cuda", pods: int = 1):
    """Every rank, as ('data', 'model') = (world // model_axis, model_axis),
    row-major (rank r at (r // model_axis, r % model_axis)), as the
    reference's ``Mesh(devices.reshape(...))`` lays them out; with ``pods``
    > 1, as ('pod', 'data', 'model') = (pods, world // (pods * model_axis),
    model_axis), the multi-pod mesh's axes."""
    world = _world()
    if model_axis < 1 or pods < 1 or world % (model_axis * pods):
        raise ValueError(f"{pods} pods x model axis {model_axis} do not divide "
                         f"{world} ranks")
    from torch.distributed.device_mesh import init_device_mesh
    if pods > 1:
        return init_device_mesh(device_type, (pods, world // (pods * model_axis),
                                              model_axis),
                                mesh_dim_names=("pod", "data", "model"))
    return init_device_mesh(device_type, (world // model_axis, model_axis),
                            mesh_dim_names=("data", "model"))
