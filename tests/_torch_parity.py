"""Shared helpers for the tests that hold the PyTorch port against the JAX
package: arrays cross between the two as numpy (bf16 as its uint16 bits)."""
from __future__ import annotations

import contextlib
import importlib.util
import io
import os
import sys

import numpy as np
import torch

EXAMPLES = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "examples")


def to_torch(a) -> torch.Tensor:
    """A JAX or numpy array as a CPU tensor, bit for bit (bf16 included)."""
    arr = np.asarray(a)
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(arr))


def to_f32(t) -> np.ndarray:
    """A tensor or array as float32 numpy, for tolerance comparisons."""
    if isinstance(t, torch.Tensor):
        return t.detach().float().cpu().numpy()
    return np.asarray(t).astype(np.float32)


def tree_to_torch(tree):
    """JAX pytree (dicts / tuples) -> the same nesting of CPU tensors."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: tree_to_torch(v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_to_torch(v) for v in tree)
    return to_torch(tree)


def pages_to_torch(store) -> torch.Tensor:
    return torch.from_numpy(np.array(store, dtype=np.uint8))


def port_params(params, device=None):
    """JAX parameters -> the port's, leaf for leaf and bit for bit (a bf16
    leaf crosses as its uint16 view), keyed by keystr."""
    import jax

    from repro_torch.core.pages import params_from_numpy
    flat = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(params)[0]:
        arr = np.asarray(leaf)
        flat[jax.tree_util.keystr(path)] = (arr.view(np.uint16)
                                           if arr.dtype.name == "bfloat16" else arr)
    return params_from_numpy(flat, device)


def load_example(name: str):
    """``examples/<name>.py`` as a module of its own (examples/ is not a
    package and stays off ``sys.path``)."""
    spec = importlib.util.spec_from_file_location(
        f"_example_{name}", os.path.join(EXAMPLES, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def run_example(mod, argv: list):
    """``(main's return, its stdout lines)``. The reference's examples parse
    ``sys.argv`` and the port's take ``argv``, so ``argv`` reaches both."""
    buf = io.StringIO()
    saved = sys.argv
    sys.argv = [mod.__file__, *argv]
    try:
        with contextlib.redirect_stdout(buf):
            out = mod.main(argv) if mod.__name__.endswith("_torch") else mod.main()
    finally:
        sys.argv = saved
    return out, buf.getvalue().splitlines()


def frontend(cfg, batch: int, rng) -> dict:
    """The stub frontend's part of a batch: whisper's frames, or a VLM's
    patches (fp32, from the numpy generator ``rng``); empty for token-only
    configs."""
    if cfg.frontend == "audio_frames":
        return {"frames": rng.standard_normal(
            (batch, cfg.n_enc_positions, cfg.d_model)).astype(np.float32)}
    if cfg.frontend == "vision_patches":
        return {"patches": rng.standard_normal(
            (batch, cfg.n_frontend_tokens, cfg.d_model)).astype(np.float32)}
    return {}


# ---------------------------------------------------------------------------------
# Several ranks on the CPU (gloo), for the sharded tests
# ---------------------------------------------------------------------------------

RANK_TIMEOUT = 240.0     # seconds for init_process_group, each collective and the join


def _one_thread(rank: int, world: int, fn, *args):
    torch.set_num_threads(1)
    return fn(rank, world, *args)


def run_ranks(fn, world: int, *args, timeout: float = RANK_TIMEOUT) -> list:
    """``fn(rank, world, *args)`` on ``world`` gloo CPU ranks of one thread
    each (``launch.mesh.spawn_local_ranks``); their results by rank. A rank
    that fails, or hangs past ``timeout`` seconds, fails the call with the
    ranks' tracebacks."""
    from repro_torch.launch.mesh import spawn_local_ranks
    return spawn_local_ranks(_one_thread, world, "cpu", args=(fn, *args), timeout=timeout)


def sharded_exec_rank(rank: int, world: int, job: dict) -> dict:
    """One rank of tests/test_torch_sharding.py's sharded run: the reduced
    config ``job['arch']`` (``job['overrides']``) with the reference's
    parameters (``job['params']``, keystr -> numpy) on a (dp, tp) mesh:

    * ``job['train']`` (global batch): the loss and gradients, and the
      parameters after one train step, gathered;
    * ``job['decode']``: prefill of ``prompt`` (after the stub frontend's
      ``front``, if any) then teacher-forced decode of ``steps``, the logits
      of each, gathered;
    * ``job['empty']``: the serve step's tokens from an empty state.

    ``job['mesh']`` is (data, model) or (pod, data, model). Every rank
    returns its replicated leaves' gradients; rank 0 also the gathered
    results."""
    from repro_torch.configs import get_reduced
    from repro_torch.core.pages import params_from_numpy
    from repro_torch.core.tree import flatten_with_keys
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models import sharding as sh
    from repro_torch.models.api import (frontend_embeds_from_batch, loss_and_grads,
                                        make_serve_step, make_serve_step_with_logits,
                                        make_train_step)
    from repro_torch.models.transformer import forward, init_decode_state
    from repro_torch.optim import adamw_init

    cfg = get_reduced(job["arch"], **job.get("overrides", {}))
    *dps, tp = job["mesh"]
    par = sh.Parallel.of(make_local_mesh(tp, "cpu", pods=dps[0] if len(dps) == 2 else 1),
                         cfg)
    dp = par.dp
    full = params_from_numpy(job["params"])
    specs = sh.param_pspecs(cfg, full, tp)
    out: dict = {"rank": rank}

    def rows(a, batch_covers=True):
        a = torch.from_numpy(np.asarray(a))
        if not batch_covers:
            return a
        n = a.shape[0] // dp
        return a[par.dp_rank * n:(par.dp_rank + 1) * n]

    def whole_rows(t, covers):
        return sh.gather_dim(t.contiguous(), 0, par.dp_axes, par) if covers else t

    if "decode" in job:
        d = job["decode"]
        prompt, steps = d["prompt"], d["steps"]
        pb = par.for_batch(prompt.shape[0])
        covers = pb.batch_covers
        params = sh.shard_tree(full, specs, par)
        front = {k: rows(v, covers) for k, v in d.get("front", {}).items()}
        logits, state = forward(params, rows(prompt, covers), cfg, make_state=True,
                                frontend_embeds=frontend_embeds_from_batch(front, cfg),
                                state_len=d["state_len"], logits_slice=1, par=pb)
        got = [whole_rows(sh.gather_vocab(logits[:, -1], pb), covers)]
        serve = make_serve_step_with_logits(cfg, pb)
        for i in range(steps.shape[1]):
            lg, state = serve(params, state, rows(steps[:, i:i + 1], covers))
            got.append(whole_rows(lg, covers))
        out["decode"] = [x.numpy() for x in got]
        out["seq_axes"] = pb.seq_axes
    if "empty" in job:
        B = job["empty"]["batch"]
        pb = par.for_batch(B)
        params = sh.shard_tree(full, specs, par)
        state = init_decode_state(cfg, B, job["empty"]["state_len"], torch.float32,
                                  par=pb)
        tok, _ = make_serve_step(cfg, pb)(params, state,
                                          rows(np.zeros((B, 1), np.int32), pb.batch_covers))
        out["empty"] = whole_rows(tok, pb.batch_covers).numpy()
    if "train" in job:
        batch = {k: rows(v) for k, v in job["train"].items()}
        params = sh.shard_tree(full, specs, par)
        loss, parts, grads = loss_and_grads(params, batch, cfg, remat="none", par=par)
        keys = [k for k, _ in flatten_with_keys(grads)]
        mask = sh.sharded_mask(specs)
        out["replicated_grads"] = {k: gr.numpy() for k, gr, m in
                                   zip(keys, [x for _, x in flatten_with_keys(grads)], mask)
                                   if not m}
        gathered = sh.gather_tree(grads, specs, par)
        out["loss"] = float(loss)
        out["grads"] = {k: v.numpy() for k, v in flatten_with_keys(gathered)}
        step = make_train_step(cfg, remat="none", total_steps=10, par=par)
        new, _, m = step(params, adamw_init(params), batch, 0)
        out["step_loss"] = float(m["loss"])
        out["params"] = {k: v.numpy() for k, v in
                         flatten_with_keys(sh.gather_tree(new, specs, par))}
    if rank != 0:
        for k in ("grads", "params", "decode", "empty"):
            out.pop(k, None)
    return out


def launcher_rank(rank: int, world: int, argv: list) -> list:
    """One rank of ``launch/train.main(argv)``: its history's losses."""
    from repro_torch.launch.train import main
    return [m["loss"] for m in main(argv)["history"]]


def elastic_rank(rank: int, world: int, job: dict) -> dict:
    """One rank of tests/test_torch_elastic.py (8 ranks): the reference run,
    8 steps on a 4 x 2 mesh, and the elastic one, 4 steps on 4 x 2, a
    checkpoint, a restore on 2 x 4 and 4 more steps. Rank 0 returns the
    gathered parameters of both, their last losses and the global arrays it
    saved."""
    from repro_torch.checkpoint import CheckpointConfig, ShardedCheckpointer
    from repro_torch.configs import get_reduced
    from repro_torch.core.pages import params_from_numpy
    from repro_torch.core.tree import flatten_with_keys
    from repro_torch.data import DataConfig, SyntheticTokenPipeline
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models import sharding as sh
    from repro_torch.models.api import make_train_step
    from repro_torch.optim import adamw_init

    cfg = get_reduced(job["arch"], **job["overrides"])
    data = DataConfig(global_batch=8, seq_len=16, seed=11)
    step_fn = {}
    wide = sh.Parallel.of(make_local_mesh(2, "cpu"), cfg)      # data 4 x model 2
    narrow = sh.Parallel.of(make_local_mesh(4, "cpu"), cfg)    # data 2 x model 4
    full = params_from_numpy(job["params"])

    def run(params, opt, start, n, par):
        fn = step_fn.setdefault(par.tp, make_train_step(cfg, remat="none",
                                                         total_steps=12, par=par))
        for s in range(start, start + n):
            b = SyntheticTokenPipeline.batch_at(cfg, data, s)
            k = 8 // par.dp
            b = {key: torch.from_numpy(v[par.dp_rank * k:(par.dp_rank + 1) * k])
                 for key, v in b.items()}
            params, opt, m = fn(params, opt, b, s)
        return params, opt, float(m["loss"])

    def ckpt(par):
        p_specs = sh.param_pspecs(cfg, full, par.tp)
        return ShardedCheckpointer(CheckpointConfig(job["dir"], async_save=False), par,
                                   {"params": p_specs, "opt_state": sh.opt_state_pspecs(
                                       cfg, None, p_specs)}, torch.device("cpu"))

    def gathered(params, par):
        return {k: v.numpy() for k, v in flatten_with_keys(
            sh.gather_tree(params, sh.param_pspecs(cfg, full, par.tp), par))}

    p = sh.shard_tree(full, sh.param_pspecs(cfg, full, wide.tp), wide)
    p_ref, _, loss_ref = run(p, adamw_init(p), 0, 8, wide)
    out = {"ref": gathered(p_ref, wide), "loss_ref": loss_ref}

    p = sh.shard_tree(full, sh.param_pspecs(cfg, full, wide.tp), wide)
    p1, o1, _ = run(p, adamw_init(p), 0, 4, wide)
    ckpt(wide).save(4, {"params": p1, "opt_state": o1})
    out["saved"] = gathered(p1, wide)
    like_p = sh.shard_tree(full, sh.param_pspecs(cfg, full, narrow.tp), narrow)
    restored = ckpt(narrow).restore(None, {"params": like_p, "opt_state": adamw_init(like_p)})
    p2, _, loss_el = run(restored["params"], restored["opt_state"], 4, 4, narrow)
    out.update(elastic=gathered(p2, narrow), loss_el=loss_el,
               step=restored["__manifest__"]["step"])
    return out if rank == 0 else {"rank": rank}


def combine_rank(rank: int, world: int) -> dict:
    """One rank of tests/test_torch_sharding.py's two-shard merge: its half
    of the slots through the plain decode attention, merged over the ranks;
    the largest difference from the unsplit result."""
    import torch.distributed as dist

    from repro_torch.kernels import decode_attention_plain
    from repro_torch.models.sharding import combine_attention
    rng = np.random.default_rng(3)
    B, H, Hkv, S, d = 3, 8, 2, 64, 32
    q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
               for s in ((B, H, d), (B, Hkv, S, d), (B, Hkv, S, d)))
    valid = torch.from_numpy(rng.random((B, S)) < 0.6)
    valid[1, S // 2:] = False            # every live slot on rank 0
    valid[2] = False                     # no live slot anywhere
    want = decode_attention_plain(q, k, v, valid, softcap=30.0)
    s0, s1 = rank * S // world, (rank + 1) * S // world
    part, lse = decode_attention_plain(q, k[:, :, s0:s1].contiguous(),
                                       v[:, :, s0:s1].contiguous(), valid[:, s0:s1],
                                       softcap=30.0, return_lse=True)
    got = combine_attention(part, lse, dist.group.WORLD)
    return {"rank": rank, "err": float((got - want).abs().max())}


def dryrun_live_rank(rank: int, world: int, job: dict) -> dict:
    """One rank of tests/test_torch_dryrun.py's live run: each of
    ``job['shapes']`` (name -> ``ShapeConfig`` fields) built as the dry run
    builds it (``launch/dryrun.build_cell``) but on real CPU tensors and a
    real mesh, and run once; the collective counters it moved, by kind, and
    the arguments' bytes by part."""
    from repro_torch.configs import get_reduced
    from repro_torch.launch.dryrun import build_cell
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models import sharding as sh
    from repro_torch.models.config import ShapeConfig

    cfg = get_reduced(job["arch"], **job["overrides"])
    *dps, tp = job["mesh"]
    par = sh.Parallel.of(make_local_mesh(tp, "cpu", pods=dps[0] if len(dps) == 2 else 1),
                         cfg)
    out = {}
    for name, fields in job["shapes"].items():
        fn, args, _, parts = build_cell(cfg, ShapeConfig(*fields), par, device="cpu")
        before = sh.collective_counts()
        fn(*args)
        after = sh.collective_counts()
        out[name] = {"calls": {k: after[k]["calls"] - before[k]["calls"] for k in after},
                     "bytes": {k: after[k]["bytes"] - before[k]["bytes"] for k in after},
                     "parts": parts}
    return out


def reference_lax_scan(monkeypatch):
    """The JAX package's jitted cap=1 ``lax.scan`` (``fleet_vec._get_scan_fn``),
    built as the reference writes it. The reference takes
    ``jax.experimental.enable_x64``, which newer JAX releases offer only as
    ``jax.enable_x64``; without the name it silently falls back to its numpy
    solver, so the test lends it the name for its duration."""
    import jax
    import jax.experimental

    from repro.core import fleet_vec
    if not hasattr(jax.experimental, "enable_x64"):
        monkeypatch.setattr(jax.experimental, "enable_x64", jax.enable_x64,
                            raising=False)
    monkeypatch.setattr(fleet_vec, "_SCAN_FN", [])
    fn = fleet_vec._get_scan_fn()
    assert fn is not None, "the reference's lax.scan path did not build"
    return fn


def _bits(t: torch.Tensor) -> torch.Tensor:
    """A float tensor's bits, as integers of its width (bitwise comparison)."""
    return t.view({2: torch.int16, 4: torch.int32, 8: torch.int64}[t.element_size()])


def zero1_rank(rank: int, world: int, job: dict) -> dict:
    """One rank of tests/test_torch_train.py's ZeRO-1 check: the reduced
    config ``job['arch']`` (``job['overrides']``) in each dtype of
    ``job['dtypes']``, parameters drawn from seed 0 and cut to this rank's
    shards on the ``job['mesh']`` mesh, then ``job['steps']`` train steps on
    ``job['batch']`` (numpy tokens, split over the data axes) with whole
    moments and, from the same start, with ``Parallel.zero1``. Per dtype:
    whether parameters, losses and ``grad_norm`` agree bitwise, both runs'
    moment bytes, the ZeRO-1 cuts, and the all_reduce calls a step adds."""
    import dataclasses

    from repro_torch.configs import get_reduced
    from repro_torch.core.tree import TreeDef, leaves
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models import sharding as sh
    from repro_torch.models.api import init_opt_state, make_train_step
    from repro_torch.models.transformer import init_params

    cfg = get_reduced(job["arch"], **job["overrides"])
    *dps, tp = job["mesh"]
    par = sh.Parallel.of(make_local_mesh(tp, "cpu", pods=dps[0] if len(dps) == 2 else 1),
                         cfg)
    tokens = torch.from_numpy(job["batch"])
    n = tokens.shape[0] // par.dp
    batch = {"tokens": tokens[par.dp_rank * n:(par.dp_rank + 1) * n]}
    out = {}
    for name in job["dtypes"]:
        full = init_params(torch.Generator().manual_seed(0), cfg, getattr(torch, name))
        runs = {}
        for zero1 in (False, True):
            p = dataclasses.replace(par, zero1=zero1)
            params = sh.shard_tree(full, sh.param_pspecs(cfg, full, tp), p)
            params = TreeDef.of(params).unflatten([t.clone() for t in leaves(params)])
            opt = init_opt_state(params, cfg, p)
            step = make_train_step(cfg, remat="none", total_steps=10, par=p)
            metrics, calls = [], []
            for s in range(job["steps"]):
                before = sh.all_reduce.calls
                params, opt, m = step(params, opt, batch, s)
                calls.append(sh.all_reduce.calls - before)
                metrics.append((m["loss"].clone(), m["grad_norm"].clone()))
            runs[zero1] = (params, opt, metrics, calls)
        (p0, o0, m0, c0), (p1, o1, m1, c1) = runs[False], runs[True]
        moment_bytes = {z: sum(t.numel() * t.element_size()
                               for t in leaves({"mu": o["mu"], "nu": o["nu"]}))
                        for z, (_, o, _, _) in runs.items()}
        out[name] = {
            "params_equal": all(torch.equal(_bits(a), _bits(b))
                                for a, b in zip(leaves(p0), leaves(p1))),
            "metrics_equal": all(torch.equal(_bits(a), _bits(b)) for x, y in zip(m0, m1)
                                 for a, b in zip(x, y)),
            "params_moved": not all(torch.equal(a, b) for a, b in zip(
                leaves(p0), leaves(sh.shard_tree(full, sh.param_pspecs(cfg, full, tp),
                                                 par)))),
            "loss": [float(m[0]) for m in m1],
            "moment_bytes": moment_bytes,
            "cuts": sh.zero1_cuts(cfg, p1, dataclasses.replace(par, zero1=True)),
            "extra_calls": [b - a for a, b in zip(c0, c1)],
        }
    return out


# ---------------------------------------------------------------------------------
# fleet_scan batches: one builder for the CPU model test and the card's test
# ---------------------------------------------------------------------------------

#: warm_s, cold_s: a warm service (2 s) longer than the mean gap, so queues form
SCAN_SERVICE = (2.0, 1.39)


def scan_consts(ka: float) -> tuple:
    """``(warm_s, cold_s, wm, cold60, ka)`` as ``fleet_vec`` passes them."""
    warm_s, cold_s = SCAN_SERVICE
    return warm_s, cold_s, warm_s / 60.0, cold_s / 60.0, ka


def scan_group(rng, n: int) -> np.ndarray:
    """Bursts of gaps under a warm service, and one gap in ten long enough to
    outlive a keep-alive: cold, queued and warm arrivals all occur."""
    gaps = np.where(rng.random(n) < 0.1, rng.exponential(20.0, n), rng.exponential(0.03, n))
    return np.cumsum(gaps)


def queued_group(rng, n: int) -> np.ndarray:
    """Gaps under 0.02 min against a 2 s (0.033 min) warm service: after the
    first, every arrival queues, and the backlog only grows."""
    return np.cumsum(rng.uniform(0.0, 0.02, n))


def busy_group(n: int, at) -> np.ndarray:
    """Arrivals a minute apart (each finds the instance idle) but for a burst
    0.001 min apart around each index in ``at``, where a queue builds."""
    gaps = np.ones(n)
    for i in at:
        gaps[max(1, i - 6):i + 6] = 0.001
    return np.cumsum(gaps)


def scan_csr(groups) -> tuple:
    """CPU tensors ``(t, offsets)`` of a CSR batch of the groups."""
    offsets = np.zeros(len(groups) + 1, np.int64)
    np.cumsum([len(g) for g in groups], out=offsets[1:])
    return torch.from_numpy(np.concatenate(groups)), torch.from_numpy(offsets)


def scan_cases(segment: int, warmup: int) -> dict:
    """name -> (groups, keep-alive (min), segment, warmup): the batches that
    hold the segmented scan's every path; ``segment`` and ``warmup`` are the
    kernel's defaults, for the case at them."""
    rng = np.random.default_rng(23)
    around = [15, 16, 17, 33]
    S = segment
    return {
        "around_S_loose": ([scan_group(rng, n) for n in around], 15.0, 16, 4),
        "around_S_tight": ([scan_group(rng, n) for n in around], 0.02, 16, 4),
        "shorter_than_W": ([scan_group(rng, n) for n in (3, 5, 7, 9, 20)], 15.0, 4, 8),
        "all_queued": ([queued_group(rng, 200), scan_group(rng, 5)], 15.0, 16, 4),
        "busy_boundary": ([busy_group(100, (32, 64)), busy_group(70, (31,))], 15.0, 32, 2),
        "w0_small_S": ([scan_group(rng, n) for n in (50, 37, 8)]
                       + [queued_group(rng, 30)], 15.0, 4, 0),
        "defaults": ([scan_group(rng, n) for n in (S - 1, S, S + 1, 2 * S + 1)]
                     + [queued_group(rng, 2 * S + 88)], 15.0, segment, warmup),
    }
