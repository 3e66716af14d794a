"""Multi-pod dry run: trace one rank's program of every (arch x shape x mesh)
cell (port of ``repro.launch.dryrun``).

The reference lowers and compiles each cell's step under the production mesh
on 512 placeholder devices and reads XLA's analyses. The port traces the
partitioned program of one rank instead, at full size, on meta tensors: no
weights, no card, no process group. Under the port's uniform cut every
rank's shards have the same shapes, so rank 0 (``Parallel.placeholder``)
stands for all; its collectives are counted, not run
(``sharding.dry_collectives``), and ``launch/cost.py`` counts its FLOPs,
bytes and peak live bytes. A cell fails here where it would fail on the
card for its shapes: the ops' fake implementations refuse what the kernels
refuse (``decode_attention``'s uncompiled (head dim, group) pairs).

  train_4k      -> train_step   (bf16; fwd + bwd + AdamW with ZeRO-1 moments,
                                 as the reference traces it)
  prefill_32k   -> prefill_step (bf16; builds the decode state)
  decode_32k    -> serve_step   (bf16; 1 new token against a seq_len cache)
  long_500k     -> serve_step   (sub-quadratic archs only; batch=1 splits the
                                 cache's positions over 'data')

The parameters, the batch and the decode state are the rank's shards, as the
port's training and serving hold them. A train cell's AdamW moments (fp32)
are the rank's ZeRO-1 slices (``Parallel.zero1``, ``sharding.zero1_cuts``):
each leaf's shard cut over 'data' on its first free, divisible dim, the
reference's rule, so a train cell's arguments are the reference's bytes per
device; the step gathers the updated slices with one more ``all_reduce``.

Each record keeps the reference's keys: ``lower_s`` (building the shards'
shapes) and ``compile_s`` (the trace), ``cost_raw`` and ``hlo_walk`` (the
trace's counts, ``launch/cost.py``; the port has no separate raw and
trip-count-aware numbers, so both hold the same FLOPs and bytes, and
transcendentals are not counted), ``memory`` (``argument_size_in_bytes``,
``output_size_in_bytes``, ``alias_size_in_bytes`` (outputs written in place
into an argument), ``temp_size_in_bytes`` (the peak of what the program
allocates) and ``live_bytes`` = arguments + that peak), ``arguments`` (the
shards' bytes by part), ``model_flops_*`` and ``roofline`` (at the H100's
datasheet peaks).

Usage:
  python -m repro_torch.launch.dryrun --arch gemma2_27b --shape train_4k --mesh single
  python -m repro_torch.launch.dryrun --all --mesh both --out results/dryrun_torch
"""
import argparse
import dataclasses
import json
import os
import sys
import time
import traceback
from typing import Any, Dict, Optional

#: mesh kind -> (axes, shape): the reference's production meshes
MESHES = {"single": (("data", "model"), (16, 16)),
          "multi": (("pod", "data", "model"), (2, 16, 16))}


class SkipCell(Exception):
    pass


def _tensors(tree) -> list:
    import torch

    from repro_torch.core.tree import leaves
    return [t for t in leaves(tree) if isinstance(t, torch.Tensor)]


def _bytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in _tensors(tree))


def shard_params(cfg, dtype, par, device="meta"):
    """This rank's parameter shards, and their specs. On ``meta`` the global
    shapes come from ``init_params`` under ``FakeTensorMode`` (no memory);
    on a real device the parameters are drawn from seed 0. Cut by the
    reference's rules."""
    import torch
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.core.tree import map_with_path
    from repro_torch.models import sharding as sh
    from repro_torch.models.transformer import init_params
    if str(device) == "meta":
        with FakeTensorMode():
            fake = init_params(torch.Generator(), cfg, dtype)
        full = map_with_path(lambda _, t: torch.empty(t.shape, dtype=t.dtype,
                                                      device="meta"), fake)
    else:
        full = init_params(torch.Generator(device=device).manual_seed(0), cfg, dtype)
    specs = sh.param_pspecs(cfg, full, par.tp)
    return sh.shard_tree(full, specs, par), specs


def _batch(cfg, shape, par, device):
    """The rank's rows of one global batch (all of it where the batch does
    not cover the data axes): token 0 and zero embeddings."""
    import numpy as np
    import torch

    from repro_torch.data.pipeline import DataConfig, make_batch_specs
    specs = make_batch_specs(cfg, DataConfig(global_batch=shape.global_batch,
                                             seq_len=shape.seq_len))
    rows = (shape.global_batch // par.dp if par.for_batch(shape.global_batch).batch_covers
            else shape.global_batch)
    return {k: torch.zeros((rows, *s[1:]), device=device,
                           dtype=torch.int32 if d == np.int32 else torch.float32)
            for k, (s, d) in specs.items()}


def build_cell(cfg, shape, par, device="meta"):
    """Returns ``(step_fn, args, dtype name, arguments' bytes by part)`` of
    one cell on this rank: ``cfg`` an ``ArchConfig``, ``shape`` a
    ``ShapeConfig``, ``par`` the rank's place on the mesh (a placeholder for
    the dry run), the tensors on ``device``. Raises :class:`SkipCell` where
    the reference skips."""
    import torch

    from repro_torch.models.api import (init_opt_state, make_prefill_step, make_serve_step,
                                        make_train_step)
    from repro_torch.models.transformer import init_decode_state

    if shape.name == "long_500k" and not cfg.supports_long_context:
        raise SkipCell(f"{cfg.name} is pure full-attention — long_500k skipped "
                       "(DESIGN.md §4)")
    dtype = torch.bfloat16
    params, _ = shard_params(cfg, dtype, par, device)
    parts = {"params": _bytes(params)}
    if shape.kind == "train":
        par = dataclasses.replace(par, zero1=True)
        batch, opt = _batch(cfg, shape, par, device), init_opt_state(params, cfg, par)
        parts.update(opt_state=_bytes(opt), batch=_bytes(batch))
        fn = make_train_step(cfg, remat="unit", par=par)
        args = (params, opt, batch, 0)
    elif shape.kind == "prefill":
        batch = _batch(cfg, shape, par, device)
        parts["batch"] = _bytes(batch)
        fn = make_prefill_step(cfg, state_len=shape.seq_len,
                               par=par.for_batch(shape.global_batch))
        args = (params, batch)
    else:
        pb = par.for_batch(shape.global_batch)
        state = init_decode_state(cfg, shape.global_batch, shape.seq_len, torch.bfloat16,
                                  device=device, par=pb)
        rows = shape.global_batch // pb.dp if pb.batch_covers else shape.global_batch
        token = torch.zeros((rows, 1), dtype=torch.int32, device=device)
        parts.update(decode_state=_bytes(state), batch=_bytes(token))
        fn = make_serve_step(cfg, pb)
        args = (params, state, token)
    return fn, args, str(dtype).split(".")[1], parts


def trace_cell(cfg, shape, axes, sizes) -> Dict[str, Any]:
    """One rank's program of the cell, traced: the record's numbers (see the
    module docstring), without the cell's names and status."""
    from repro_torch.launch.cost import CostMode, collective_summary, roofline_terms
    from repro_torch.models import sharding as sh

    t0 = time.perf_counter()
    fn, args, dtype, parts = build_cell(cfg, shape, sh.Parallel.placeholder(cfg, axes, sizes))
    t1 = time.perf_counter()
    before = sh.collective_counts()
    mode = CostMode(held=_tensors(args))
    with sh.dry_collectives(), mode:
        out = fn(*args)
    t2 = time.perf_counter()
    walk = {"flops": mode.flops, "bytes": mode.bytes,
            **collective_summary(before, sh.collective_counts()),
            "n_ops": mode.ops, "flops_by_op": dict(mode.flops_by_op)}
    held = {t.untyped_storage()._cdata for t in _tensors(args)}
    outs = _tensors(out)
    out_bytes = _bytes(outs)
    alias = _bytes([t for t in outs if t.untyped_storage()._cdata in held])
    n_args = float(sum(parts.values()))
    record: Dict[str, Any] = {
        "lower_s": t1 - t0, "compile_s": t2 - t1, "dtype": dtype,
        "cost_raw": {"flops": mode.flops, "bytes_accessed": mode.bytes,
                     "transcendentals": None},
        "memory": {"argument_size_in_bytes": n_args,
                   "output_size_in_bytes": float(out_bytes),
                   "alias_size_in_bytes": float(alias),
                   "temp_size_in_bytes": float(mode.peak),
                   "live_bytes": n_args + mode.peak},
        "arguments": parts, "hlo_walk": walk}
    n_chips = 1
    for s in sizes:
        n_chips *= s
    tokens = shape.global_batch * (shape.seq_len if shape.kind != "decode" else 1)
    model_flops = (6 if shape.kind == "train" else 2) * cfg.active_param_count() * tokens
    if shape.kind == "decode":
        # decode attention reads the KV cache: count 2*N*B for the matmuls only
        model_flops = 2 * cfg.active_param_count() * shape.global_batch
    record["model_flops_global"] = float(model_flops)
    record["model_flops_per_device"] = float(model_flops / n_chips)
    rt = roofline_terms(walk["flops"], walk["bytes"],
                        walk["collective_ring_weighted_bytes"], dtype)
    rt["useful_flops_ratio"] = record["model_flops_per_device"] / max(walk["flops"], 1.0)
    rt["mfu_upper_bound"] = (record["model_flops_per_device"]
                             / max(rt["step_lower_bound_s"], 1e-30) / rt["peak_flops"])
    record["roofline"] = rt
    return record


def run_cell(arch: str, shape_name: str, mesh_kind: str,
             out_path: Optional[str] = None, verbose: bool = True) -> Dict[str, Any]:
    """The cell's record, written to ``out_path`` if given."""
    from repro_torch.configs import get_config
    from repro_torch.models.config import SHAPES

    t_start = time.perf_counter()
    axes, sizes = MESHES[mesh_kind]
    n_chips = 1
    for s in sizes:
        n_chips *= s
    record: Dict[str, Any] = {"arch": arch, "shape": shape_name, "mesh": mesh_kind,
                              "mesh_shape": list(sizes), "chips": n_chips, "status": "ok"}
    try:
        record.update(trace_cell(get_config(arch), SHAPES[shape_name], axes, sizes))
        if verbose:
            walk, rt = record["hlo_walk"], record["roofline"]
            print(f"[dryrun] {arch} x {shape_name} x {mesh_kind}: "
                  f"trace={record['compile_s']:.1f}s "
                  f"flops/dev={walk['flops']:.3e} bytes/dev={walk['bytes']:.3e} "
                  f"coll/dev={walk['collective_ring_weighted_bytes']:.3e}B "
                  f"live={record['memory']['live_bytes'] / 1e9:.2f}GB "
                  f"bottleneck={rt['bottleneck']} "
                  f"useful={rt['useful_flops_ratio']:.2f}")
            print(f"[dryrun]   memory: {record['memory']}")
    except SkipCell as e:
        record["status"] = "skipped"
        record["reason"] = str(e)
        if verbose:
            print(f"[dryrun] {arch} x {shape_name} x {mesh_kind}: SKIPPED — {e}")
    except Exception as e:  # a failure here is a bug in the distribution config
        record["status"] = "failed"
        record["error"] = f"{type(e).__name__}: {e}"
        record["traceback"] = traceback.format_exc()[-4000:]
        if verbose:
            print(f"[dryrun] {arch} x {shape_name} x {mesh_kind}: FAILED — {e}")
    record["wall_s"] = time.perf_counter() - t_start
    if out_path:
        os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
        with open(out_path, "w") as f:
            json.dump(record, f, indent=1)
    return record


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--mesh", default="single", choices=["single", "multi", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default="results/dryrun_torch")
    ap.add_argument("--timeout", type=int, default=1800)
    ap.add_argument("--skip-existing", action="store_true")
    args = ap.parse_args(argv)

    from repro_torch.configs import ARCH_IDS
    from repro_torch.models.config import SHAPES

    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    if not args.all:
        if not (args.arch and args.shape):
            ap.error("--arch and --shape, or --all")
        rc = 0
        for mk in meshes:
            rec = run_cell(args.arch, args.shape, mk, out_path=os.path.join(
                args.out, f"{args.arch}__{args.shape}__{mk}.json"))
            rc |= int(rec["status"] == "failed")
        sys.exit(rc)

    # --all: one subprocess per cell (isolation: a single pathological cell
    # cannot take down the sweep)
    import subprocess
    archs = [a for a in ARCH_IDS if a != "fnbench_tiny"]
    failures = 0
    for mk in meshes:
        for arch in archs:
            for shape_name in SHAPES:
                path = os.path.join(args.out, f"{arch}__{shape_name}__{mk}.json")
                if args.skip_existing and os.path.exists(path):
                    print(f"[dryrun] skip existing {path}")
                    continue
                cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
                       "--arch", arch, "--shape", shape_name, "--mesh", mk,
                       "--out", args.out]
                t0 = time.perf_counter()
                try:
                    rc = subprocess.run(cmd, timeout=args.timeout).returncode
                except subprocess.TimeoutExpired:
                    rc = -1
                    os.makedirs(args.out, exist_ok=True)
                    with open(path, "w") as f:
                        json.dump({"arch": arch, "shape": shape_name, "mesh": mk,
                                   "status": "failed",
                                   "error": f"timeout>{args.timeout}s"}, f)
                failures += int(rc != 0)
                print(f"[sweep] {arch} x {shape_name} x {mk}: rc={rc} "
                      f"({time.perf_counter() - t0:.0f}s)")
    print(f"[sweep] done, {failures} failures")
    sys.exit(int(failures > 0))


if __name__ == "__main__":
    main()
