"""The port's dry run (``repro_torch.launch.dryrun``, ``launch/cost.py``)
against a live run and against the JAX package.

* Collectives: at reduced configs on a (2, 4) ("data", "model") mesh and the
  (2, 2, 2) multi-pod one, the traced rank 0's collective calls and bytes by
  kind equal the counters of the same cells run live on 8 gloo CPU ranks,
  exactly (train, prefill, decode, and decode at batch 1, whose cache
  positions split over data); so do the arguments' bytes.
* Parameter shards: their bytes equal those the reference's ``param_pspecs``
  give on ``jax.eval_shape``'d parameters, for every config on both
  production meshes.
* Train cells: every config's ``train_4k`` arguments (bf16 parameters, fp32
  ZeRO-1 moments, the batch) equal, part by part, the per-device bytes of
  the reference's own ``build_cell`` on a ``jax.sharding.AbstractMesh`` of
  the production shape.
* ``model_flops_*``: the reference's formula on the reference's config.
* The FLOP formula of each port op equals a hand count at one shape.
* Every (head dim, group) pair a rank hands ``decode_attention`` at model
  axis 2-16 has a compiled kernel (the op's fake refuses the others).
* Full-size single-pod cells trace in seconds.
"""
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCH_IDS, get_config as jax_config
from repro.models import sharding as jsh
from repro.models.transformer import init_params as jax_init
from repro_torch.configs import get_config, get_reduced
from repro_torch.core.tree import leaves
from repro_torch.kernels import decode_attention, diag_recurrence, flash_attention
from repro_torch.launch import dryrun
from repro_torch.launch.cost import PEAK_FLOPS, CostMode
from repro_torch.models.config import SHAPES, ShapeConfig
from repro_torch.models.sharding import Parallel
from tests._torch_parity import dryrun_live_rank, run_ranks

OVERRIDES = dict(d_model=64, n_heads=4, n_kv_heads=2, d_ff=128, head_dim=64)
CELLS = {"train": ("train", 16, 4, "train"), "prefill": ("prefill", 32, 4, "prefill"),
         "decode": ("decode", 32, 4, "decode"), "decode_b1": ("decode_b1", 32, 1, "decode")}


def _reference_model_flops(jcfg, shape) -> float:
    """The reference's formula (``repro/launch/dryrun.py``)."""
    n_active = jcfg.active_param_count()
    if shape.kind == "decode":
        return float(2 * n_active * shape.global_batch)
    tokens = shape.global_batch * shape.seq_len
    return float((6 if shape.kind == "train" else 2) * n_active * tokens)


@pytest.mark.parametrize("arch,mesh", [
    ("qwen3_1_7b", (2, 4)), ("recurrentgemma_2b", (2, 4)), ("whisper_small", (2, 4)),
    ("qwen3_1_7b", (2, 2, 2))])
def test_collectives_equal_a_live_run(arch, mesh):
    live = run_ranks(dryrun_live_rank, int(np.prod(mesh)),
                     {"arch": arch, "overrides": OVERRIDES, "mesh": mesh, "shapes": CELLS})
    cfg = get_reduced(arch, **OVERRIDES)
    axes, _ = dryrun.MESHES["multi" if len(mesh) == 3 else "single"]
    for name, fields in CELLS.items():
        shape = ShapeConfig(*fields)
        rec = dryrun.trace_cell(cfg, shape, axes, mesh)
        walk, want = rec["hlo_walk"], live[0][name]
        assert walk["collective_count_by_kind"] == want["calls"], (name, walk, want)
        assert walk["collective_bytes_by_kind"] == {k: float(v) for k, v in
                                                    want["bytes"].items()}, name
        assert want["calls"]["all_reduce"] > 0
        assert rec["arguments"] == want["parts"], name
        assert rec["model_flops_global"] == _reference_model_flops(
            jax_config(arch).reduced(**OVERRIDES), shape)
        assert rec["model_flops_per_device"] == rec["model_flops_global"] / np.prod(mesh)
    assert [r[n]["calls"] for r in live[1:] for n in CELLS] == \
        [live[0][n]["calls"] for _ in live[1:] for n in CELLS]    # every rank alike


def _reference_dryrun():
    """``repro.launch.dryrun``, imported with the process's ``XLA_FLAGS`` kept:
    the module sets a 512-device host platform for its own CLI, which must
    not reach the other tests of this process."""
    import importlib
    import os
    saved = os.environ.get("XLA_FLAGS")
    try:
        return importlib.import_module("repro.launch.dryrun")
    finally:
        if saved is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = saved


def _per_device_bytes(tree) -> int:
    return sum(math.prod(leaf.sharding.shard_shape(leaf.shape)) * leaf.dtype.itemsize
               for leaf in jax.tree_util.tree_leaves(tree))


@pytest.mark.parametrize("arch", [a for a in ARCH_IDS if a != "fnbench_tiny"])
@pytest.mark.parametrize("kind", list(dryrun.MESHES))
def test_train_cell_arguments_equal_the_reference_build_cell(arch, kind):
    axes, sizes = dryrun.MESHES[kind]
    jdry = _reference_dryrun()
    _, jargs, *_ = jdry.build_cell(arch, "train_4k",
                                   jax.sharding.AbstractMesh(sizes, axes))
    want = dict(zip(("params", "opt_state", "batch"),
                    (_per_device_bytes(a) for a in jargs[:3])))
    cfg = get_config(arch)
    fn, args, dtype, parts = dryrun.build_cell(cfg, SHAPES["train_4k"],
                                               Parallel.placeholder(cfg, axes, sizes))
    assert dtype == "bfloat16"
    assert parts == want, (arch, kind, parts, want)
    assert all(t.dtype == torch.float32 for t in leaves(args[1]["mu"]))


def test_zero1_cuts_follow_the_reference_rule():
    """At qwen1.5-0.5b's (16, 16) mesh: each moment is cut over data on the
    first dim the reference's ``zero1`` picks, and rank 0 of data holds the
    first slice."""
    jdry = _reference_dryrun()
    mesh = jax.sharding.AbstractMesh((16, 16), ("data", "model"))
    _, jargs, *_ = jdry.build_cell("qwen1_5_0_5b", "train_4k", mesh)
    jspecs = [leaf.sharding.spec for leaf in jax.tree_util.tree_leaves(jargs[1]["mu"])]
    cfg = get_config("qwen1_5_0_5b")
    par = dataclasses.replace(Parallel.placeholder(cfg, ("data", "model"), (16, 16)),
                              zero1=True)
    params, _ = dryrun.shard_params(cfg, torch.bfloat16, par)
    from repro_torch.models.sharding import zero1_cuts
    cuts = zero1_cuts(cfg, params, par)
    assert len(cuts) == len(jspecs)
    for cut, spec, p in zip(cuts, jspecs, leaves(params)):
        dims = list(spec) + [None] * (p.ndim - len(spec))
        want = dims.index("data") if "data" in dims else None
        assert (cut[0] if cut else None) == want
        if cut:
            assert cut[1:] == (0, p.shape[cut[0]] // 16)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_shard_bytes_equal_the_reference_specs(arch):
    jcfg = jax_config(arch)
    jparams = jax.eval_shape(lambda: jax_init(jax.random.PRNGKey(0), jcfg, jnp.bfloat16))
    jleaves = jax.tree_util.tree_leaves(jparams)
    for kind, (axes, sizes) in dryrun.MESHES.items():
        size = dict(zip(axes, sizes))
        specs = jax.tree_util.tree_leaves(
            jsh.param_pspecs(jcfg, jparams, size["model"]),
            is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
        want = 0
        for leaf, spec in zip(jleaves, specs):
            cut = math.prod(size[a] for s in spec if s is not None
                            for a in ((s,) if isinstance(s, str) else s))
            want += leaf.size * leaf.dtype.itemsize // cut
        cfg = get_config(arch)
        params, _ = dryrun.shard_params(cfg, torch.bfloat16,
                                        Parallel.placeholder(cfg, axes, sizes))
        got = sum(t.numel() * t.element_size() for t in leaves(params))
        assert got == want, (arch, kind, got, want)


def _flops(fn, *tensors) -> dict:
    with CostMode() as mode:
        fn(*tensors)
    return dict(mode.flops_by_op)


def test_op_flop_formulas_match_hand_counts():
    B, H, Hkv, S, d = 1, 4, 2, 8, 32
    q = torch.empty((B, H, S, d), device="meta", requires_grad=True)
    k = torch.empty((B, Hkv, S, d), device="meta", requires_grad=True)
    # causal over 8 positions: 1 + 2 + ... + 8 = 36 pairs; a window of 3 keeps
    # 1 + 2 + 3 * 6 = 21; non-causal 64
    for opts, pairs in (({"causal": True}, 36), ({"causal": True, "window": 3}, 21),
                        ({"causal": False}, 64)):
        def fwd_bwd(q, k):
            flash_attention(q, k, k, **opts).sum().backward()
        got = _flops(fwd_bwd, q, k)
        assert got["repro_torch.flash_attention"] == 2 * 2 * B * H * pairs * d, opts
        assert got["repro_torch.flash_attention_backward"] == 5 * 2 * B * H * pairs * d
    qd = torch.empty((B, H, 64), device="meta")                  # (d, g) = (64, 2)
    kc = torch.empty((B, Hkv, 100, 64), device="meta")
    got = _flops(lambda: decode_attention(qd, kc, kc, torch.ones(100, dtype=torch.bool,
                                                                 device="meta")))
    assert got["repro_torch.decode_attention"] == 2 * 2 * B * H * 100 * 64
    a = torch.empty((2, 10, 7), device="meta")
    got = _flops(lambda: diag_recurrence(a, a, torch.empty((2, 7), device="meta")))
    assert got["repro_torch.diag_recurrence"] == 2 * 2 * 10 * 7


def test_decode_fake_refuses_an_uncompiled_pair():
    """The fake implementation applies the kernel's check: (d=32, g=2) has
    no compiled kernel, so a trace that would hand it to the card fails."""
    qd = torch.empty((1, 4, 32), device="meta")
    kc = torch.empty((1, 2, 16, 32), device="meta")
    with pytest.raises(ValueError, match="head dim, H/Hkv"):
        decode_attention(qd, kc, kc, torch.ones(16, dtype=torch.bool, device="meta"))


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_every_rank_hands_decode_attention_a_compiled_pair(arch):
    """At model axis 2, 4, 8 and 16, a decode step of one pattern unit at
    full width (self and cross attention, heads split, replicated or
    gathered) traces through ``decode_attention``'s fake, which refuses the
    (head dim, group) pairs the kernel has not compiled."""
    cfg = get_config(arch)
    cfg = dataclasses.replace(cfg, n_layers=len(cfg.attn_pattern),
                              n_enc_layers=min(cfg.n_enc_layers, 1))
    for tp in (2, 4, 8, 16):
        rec = dryrun.trace_cell(cfg, ShapeConfig("decode", 64, 16, "decode"),
                                ("data", "model"), (1, tp))
        calls = rec["hlo_walk"]["flops_by_op"]
        assert cfg.is_attention_free or calls["repro_torch.decode_attention"] > 0, tp


@pytest.mark.parametrize("arch,shape_name", [
    ("qwen3_1_7b", "decode_32k"), ("recurrentgemma_2b", "long_500k"),
    ("whisper_small", "prefill_32k"), ("whisper_small", "long_500k")])
def test_full_size_single_pod_cells_trace_in_seconds(arch, shape_name, tmp_path):
    rec = dryrun.run_cell(arch, shape_name, "single", str(tmp_path / "cell.json"),
                          verbose=False)
    if shape_name == "long_500k" and arch == "whisper_small":
        assert rec["status"] == "skipped"            # the reference's skip
        return
    assert rec["status"] == "ok", rec.get("traceback")
    assert rec["compile_s"] < 30.0
    shape = SHAPES[shape_name]
    assert rec["chips"] == 256
    assert rec["model_flops_global"] == _reference_model_flops(jax_config(arch), shape)
    walk, rt = rec["hlo_walk"], rec["roofline"]
    assert walk["flops"] > rec["model_flops_per_device"] > 0
    assert walk["collective_ring_weighted_bytes"] == \
        walk["collective_output_bytes"] + walk["collective_bytes_by_kind"]["all_reduce"]
    assert rt["peak_flops"] == PEAK_FLOPS[rec["dtype"]] and "H100" in rt["peaks"]
    assert 0 < rt["useful_flops_ratio"] < 1 and rt["mfu_upper_bound"] > 0
    assert rec["memory"]["live_bytes"] >= rec["memory"]["argument_size_in_bytes"] > 0
