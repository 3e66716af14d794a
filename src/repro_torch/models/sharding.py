"""Sharding: the reference's partition rules, and the partitioned program they imply.

Port of ``repro.models.sharding``. The rules keep the reference's names and
results (DESIGN.md §5 there):

* ``model`` axis = tensor parallelism: attention heads, FFN hidden, expert
  axis (true EP when ``n_experts_padded % tp == 0``, else TP inside each
  expert), vocab, the SSM's inner channels;
* ``data`` axis = data parallelism over the batch; when the batch cannot
  cover it, a decode cache's *positions* are sharded over ``data`` instead,
  and over ``model`` when the kv heads do not divide the model axis;
* archs whose head counts do not divide the model axis replicate attention
  and shard FFN and vocab (:func:`arch_sharding_caps`).

A spec is :class:`PartitionSpec`, one entry per dimension: an
axis name, a tuple of names (the dimension split over their product, the
first one major, as JAX lays it out) or ``None``. Paths are
:func:`repro_torch.core.tree.flatten_with_keys`'s keystr paths, which spell
JAX's (``['unit'][0]['attn']['wq']``). The reference's environment-gated
``REPRO_PERF_BASELINE`` branch of :func:`decode_state_pspecs` is not ported.

In the reference the specs are only a layout and XLA's partitioner adds the
collectives. PyTorch has no partitioner for the port's kernels, so this
module also runs the partitioned program: :class:`Parallel` holds a rank's
place on a ``("data", "model")`` or ``("pod", "data", "model")`` mesh of
``torch.distributed`` ranks (data parallelism over ``pod`` x ``data``);
:func:`shard_tree` cuts a rank's shard of a global tree and
:func:`gather_tree` rebuilds the global tree; :func:`f` and :func:`g` are the
Megatron pair of autograd ops around every tensor-parallel region (``f``:
identity forward, ``all_reduce`` over ``model`` backward, on each replicated
tensor just before it enters a rank's share of the work; ``g``:
``all_reduce`` forward, identity backward, after each row-parallel product),
so every replicated leaf's gradient comes out whole and equal on all ranks;
:func:`gather_model` is a differentiable gather over ``model`` (the RG-LRU's
gates read the whole width). The only collectives are ``all_reduce`` and
``broadcast``: the gloo backend takes CUDA tensors for those two only, and so
one code path serves several ranks sharing one card (gloo), one rank per card
(NCCL) and CPU ranks (gloo). Both are counted (:func:`collective_counts`),
and under :func:`dry_collectives` they are only counted, which lets the dry
run trace one rank's program with no process group.

One deviation from the layout the spec names: the SSM's ``in_proj`` is
``(D, 2 * d_inner)`` with x and z side by side, and its ``P(None, 'model')``
would hand rank 0 a block of x only. The port gives each rank matching
slices of the x half and of the z half (the *logical* shard), so a rank's
channels line up with its ``conv_w``, ``dt_proj`` and ``out_proj`` rows;
:func:`shard_tree` and :func:`gather_tree` know the two halves, the spec
stays the reference's.

ZeRO-1 (``Parallel.zero1``, the reference's dry-run layout of the AdamW
moments): :func:`zero1_cuts` picks each leaf's slice over ``data`` by the
reference's rule, and :func:`gather_cuts` puts the updated slices together
with one ``all_reduce`` of an integer view, which keeps the bits.
"""
from __future__ import annotations

import contextlib
import dataclasses
import itertools
import math
import pickle
import re
from typing import Any, Dict, Optional, Tuple

import torch
import torch.distributed as dist

from repro_torch.models.config import ArchConfig


def map_with_path(fn, tree, *rest):
    # imported here: the package repro_torch.core imports the models
    from repro_torch.core.tree import map_with_path as walk
    return walk(fn, tree, *rest)


def leaves(tree) -> list:
    from repro_torch.core.tree import leaves as flat
    return flat(tree)


class PartitionSpec:
    """One entry per dimension: an axis name, a tuple of names, or None. A
    plain object, not a tuple, so that a tree of specs flattens with one
    spec per leaf; it compares equal to the tuple of its entries."""

    __slots__ = ("dims",)

    def __init__(self, *dims):
        self.dims = tuple(dims)

    def __iter__(self):
        return iter(self.dims)

    def __eq__(self, other) -> bool:
        return tuple(self) == tuple(other) if isinstance(other, (PartitionSpec, tuple)) \
            else NotImplemented

    def __hash__(self) -> int:
        return hash(self.dims)

    def __repr__(self) -> str:
        return f"P{self.dims!r}"


P = PartitionSpec


def mesh_axes(mesh) -> Tuple[Tuple[str, ...], str]:
    """Returns (dp_axes, model_axis) of a mesh (a ``DeviceMesh`` or anything
    with ``mesh_dim_names``)."""
    names = tuple(mesh.mesh_dim_names)
    if names[-1] != "model":
        raise ValueError(f"mesh must end with 'model', got {names}")
    return names[:-1], "model"


def arch_sharding_caps(cfg: ArchConfig, tp: int) -> Dict[str, bool]:
    return {
        "shard_q": cfg.n_heads % tp == 0,
        "shard_kv": cfg.n_kv_heads % tp == 0,
        "shard_ff": (cfg.d_ff % tp == 0) and cfg.d_ff > 0,
        "shard_experts": cfg.n_experts > 0 and cfg.n_experts_padded % tp == 0,
        "shard_expert_ff": cfg.n_experts > 0 and cfg.d_ff % tp == 0,
        "shard_inner": (cfg.d_inner % tp == 0),
        "shard_lru": (cfg.resolved_lru_width % tp == 0),
    }


def _param_rule(name: str, caps: Dict[str, bool], cfg: ArchConfig) -> P:
    m = "model"
    # embeddings
    if name == "tok":
        return P(m, None)
    if name == "head":
        return P(None, m)
    # attention
    if name == "wq":
        return P(None, m) if caps["shard_q"] else P(None, None)
    if name in ("wk", "wv"):
        return P(None, m) if caps["shard_kv"] else P(None, None)
    if name == "wo":
        return P(m, None) if caps["shard_q"] else P(None, None)
    if name == "bq":
        return P(m) if caps["shard_q"] else P(None)
    if name in ("bk", "bv"):
        return P(m) if caps["shard_kv"] else P(None)
    if name in ("q_norm", "k_norm"):
        return P(None)
    # dense MLP
    if name in ("w_gate", "w_in"):
        if cfg.n_experts > 0:  # expert tensors (E, D, F)
            if caps["shard_experts"]:
                return P(m, None, None)
            return P(None, None, m) if caps["shard_expert_ff"] else P(None, None, None)
        return P(None, m) if caps["shard_ff"] else P(None, None)
    if name == "w_out":
        if cfg.n_experts > 0:  # (E, F, D)
            if caps["shard_experts"]:
                return P(m, None, None)
            return P(None, m, None) if caps["shard_expert_ff"] else P(None, None, None)
        return P(m, None) if caps["shard_ff"] else P(None, None)
    if name == "router":
        return P(None, None)
    # mamba
    if name == "in_proj":
        return P(None, m) if caps["shard_inner"] else P(None, None)
    if name in ("conv_w",):
        return P(m, None) if caps["shard_inner"] else P(None, None)
    if name in ("conv_b", "dt_bias", "D"):
        return P(m) if caps["shard_inner"] else P(None)
    if name == "x_proj":
        return P(m, None) if caps["shard_inner"] else P(None, None)
    if name == "dt_proj":
        return P(None, m) if caps["shard_inner"] else P(None, None)
    if name == "A_log":
        return P(m, None) if caps["shard_inner"] else P(None, None)
    if name == "out_proj":
        sharded = caps["shard_inner"] if cfg.d_ff == 0 else caps["shard_lru"]
        return P(m, None) if sharded else P(None, None)
    # rg-lru
    if name in ("linear_x", "linear_y", "w_a", "w_x"):
        return P(None, m) if caps["shard_lru"] else P(None, None)
    if name in ("b_a", "b_x", "lambda"):
        return P(m) if caps["shard_lru"] else P(None)
    # norms / scalars
    if name in ("scale",):
        return P(None)
    return P()  # default: replicate


_TOKEN = re.compile(r"\[('(?:[^'\\]|\\.)*'|\"(?:[^\"\\]|\\.)*\"|-?\d+)\]|\.(\w+)")


def _leaf_name(path: str) -> Tuple[str, bool]:
    """(final dict key or field, is_stacked) of a keystr path; stacked =
    inside 'unit'/'enc' (leading units dim). Sequence indices are skipped, as
    the reference skips ``SequenceKey``s."""
    keys = []
    for item, attr in _TOKEN.findall(path):
        if attr:
            keys.append(attr)
        elif item[0] in "'\"":
            keys.append(item[1:-1])
    stacked = bool(keys) and keys[0] in ("unit", "enc")
    return (keys[-1] if keys else ""), stacked


def _fit(spec, ndim: int) -> P:
    """``spec`` cut or padded with None to ``ndim`` entries."""
    spec = tuple(spec)[:ndim]
    return P(*spec, *([None] * (ndim - len(spec))))


def param_pspecs(cfg: ArchConfig, params: Any, tp: int):
    """PartitionSpec tree matching ``params`` (tensors of any device, meta
    included: only ``ndim`` is read)."""
    caps = arch_sharding_caps(cfg, tp)

    def rule(path, leaf):
        name, stacked = _leaf_name(path)
        # conv weights are shared-name between ssm and rglru; pick caps accordingly
        if name in ("conv_w", "conv_b") and cfg.resolved_lru_width and cfg.d_ff > 0 \
                and "rec" in path:
            spec = (P("model", None) if caps["shard_lru"] else P(None, None)) \
                if name == "conv_w" else (P("model") if caps["shard_lru"] else P(None))
        else:
            spec = _param_rule(name, caps, cfg)
        spec = tuple(spec)[:leaf.ndim]
        if stacked:
            spec = (None, *spec)[:leaf.ndim]
        return _fit(spec, leaf.ndim)

    return map_with_path(rule, params)


def opt_state_pspecs(cfg: ArchConfig, opt_state: Any, params_specs: Any):
    return {
        "mu": params_specs,
        "nu": params_specs,
        "count": P(),
    }


def batch_pspecs(cfg: ArchConfig, batch: Dict[str, Any], dp_axes: Tuple[str, ...],
                 dp_size: int):
    """Shard the batch over DP axes (replicate if batch doesn't cover them)."""
    specs = {}
    for k, v in batch.items():
        bdim = dp_axes if v.shape[0] % dp_size == 0 and v.shape[0] >= dp_size else None
        specs[k] = P(bdim, *([None] * (v.ndim - 1)))
    return specs


def _seq_axes(caps: Dict[str, bool], dp_axes: Tuple[str, ...],
              batch_covers: bool) -> Optional[Tuple[str, ...]]:
    """The axes a decode cache's position dimension is split over, or None:
    ``data`` when the batch does not cover the DP axes (sequence parallelism
    for decode), and ``model`` when the kv heads do not divide it (else the
    cache would be replicated tp-ways)."""
    parts = []
    if not batch_covers:
        parts.append("data" if "data" in dp_axes else dp_axes[-1])
    if not caps["shard_kv"]:
        parts.append("model")
    return tuple(parts) if parts else None


def _is_int32(leaf) -> bool:
    return str(leaf.dtype).rsplit(".", 1)[-1] == "int32"


def decode_state_pspecs(cfg: ArchConfig, state: Any, dp_axes: Tuple[str, ...],
                        dp_size: int, tp: int, batch: int):
    """KV caches: batch over DP when possible, else sequence over 'data' (SP);
    kv-heads over model when divisible, else sequence over 'model'. Recurrent
    states: width over model."""
    caps = arch_sharding_caps(cfg, tp)
    batch_covers = batch % dp_size == 0 and batch >= dp_size
    kv_axis = "model" if caps["shard_kv"] else None
    seq_axis = _seq_axes(caps, dp_axes, batch_covers)
    bspec = dp_axes if batch_covers else None

    def rule(kp, leaf):
        name, _ = _leaf_name(kp)
        lead = (None,) if (kp.startswith("['unit']") or "cross" in kp) else ()
        if name == "pos" or leaf.ndim == 0:
            return P(*([bspec if leaf.ndim == 1 else None] * leaf.ndim))
        if _is_int32(leaf):                                   # k_pos (B,C) [+lead]
            dims = lead + (bspec, seq_axis)
            return P(*dims[-leaf.ndim:]) if leaf.ndim <= len(dims) else \
                P(*dims, *([None] * (leaf.ndim - len(dims))))
        # whisper cross-attention KV: batch sharding only (it's small)
        if "cross" in kp:
            dims = lead + (bspec,) + (None,) * (leaf.ndim - len(lead) - 1)
            return P(*dims[: leaf.ndim])
        # KVCache k/v: (B, Hkv, C, hd) [+unit lead]
        if leaf.ndim - len(lead) == 4:
            return P(*lead, bspec, kv_axis, seq_axis, None)
        # ssm h: (B, di, N) [+lead] — keyed by field name, not dtype
        if name == "h" and leaf.ndim - len(lead) == 3:
            inner = "model" if caps["shard_inner"] else None
            return P(*lead, bspec, inner, None)
        # conv tail states (B, w-1, C) [+lead]
        if name == "conv" and leaf.ndim - len(lead) == 3:
            ch = "model" if (caps["shard_inner"] or caps["shard_lru"]) else None
            return P(*lead, bspec, None, ch)
        # rglru h (B, W) [+lead]
        if leaf.ndim - len(lead) == 2:
            ch = "model" if caps["shard_lru"] else None
            return P(*lead, bspec, ch)
        if leaf.ndim - len(lead) == 3:
            return P(*lead, bspec, None, None)
        return P(*([None] * leaf.ndim))

    return map_with_path(rule, state)


# ---------------------------------------------------------------------------------
# A rank's place on the mesh
# ---------------------------------------------------------------------------------

#: the meshes the port runs: the reference's single-pod and multi-pod axes
MESH_AXES = (("data", "model"), ("pod", "data", "model"))


def _axis_set(axes) -> frozenset:
    return frozenset((axes,) if isinstance(axes, str) else axes)


def mesh_groups(mesh) -> Dict[frozenset, Any]:
    """The process group of every proper subset of ``mesh``'s axes (the ranks
    that share this rank's coordinates on the other axes), keyed by the set
    of names; the whole set is the default group. Single axes are the mesh's
    own groups; a pair of axes of a 3-D mesh is made here, one group per
    coordinate of the third axis (``new_subgroups_by_enumeration``: every
    rank makes every group, in the same order)."""
    names = tuple(mesh.mesh_dim_names)
    ranks = mesh.mesh
    groups = {frozenset((n,)): mesh.get_group(n) for n in names}
    for size in range(2, len(names)):
        for subset in itertools.combinations(range(len(names)), size):
            rest = [d for d in range(len(names)) if d not in subset]
            moved = ranks.permute(*rest, *subset).reshape(
                -1, math.prod(ranks.shape[d] for d in subset))
            groups[frozenset(names[d] for d in subset)] = \
                dist.new_subgroups_by_enumeration(moved.tolist())[0]
    return groups


@dataclasses.dataclass(frozen=True)
class Parallel:
    """This rank's place on a ``("data", "model")`` or ``("pod", "data",
    "model")`` mesh, for one config.

    Data parallelism runs over the product of the axes before ``model``
    (``dp_axes``), ``pod`` major, as JAX lays out a tuple axis. ``batch`` is
    the global batch a prefill or decode state serves (set by
    :meth:`for_batch`): it decides whether the batch is split over
    ``dp_axes`` or a decode cache's positions are. ``groups`` maps a set of
    axis names to its process group (:func:`mesh_groups`); a placeholder
    (:meth:`placeholder`) has none and runs its collectives under
    :func:`dry_collectives` only. ``zero1`` asks the train step for ZeRO-1:
    each ``data`` rank holds and updates only its slice of the AdamW moments
    (:func:`zero1_cuts`).
    """
    cfg: ArchConfig
    axes: Tuple[str, ...]
    sizes: Tuple[int, ...]
    coords: Tuple[int, ...]
    groups: Dict[frozenset, Any] = dataclasses.field(default_factory=dict, compare=False,
                                                     hash=False, repr=False)
    batch: Optional[int] = None
    zero1: bool = False

    @classmethod
    def of(cls, mesh, cfg: ArchConfig) -> "Parallel":
        """From a ``DeviceMesh`` named as one of :data:`MESH_AXES`."""
        names = tuple(mesh.mesh_dim_names)
        if names not in MESH_AXES:
            raise ValueError(f"the mesh's axes must be one of {MESH_AXES}, got {names}")
        return cls(cfg, names, tuple(mesh.size(i) for i in range(len(names))),
                   tuple(mesh.get_coordinate()), mesh_groups(mesh))

    @classmethod
    def placeholder(cls, cfg: ArchConfig, axes: Tuple[str, ...], sizes: Tuple[int, ...]
                    ) -> "Parallel":
        """Rank 0 of a mesh of ``sizes`` that has no process group: its
        shards' shapes are every rank's (the cut is uniform), and its
        collectives run only under :func:`dry_collectives` (the dry run)."""
        if tuple(axes) not in MESH_AXES or len(sizes) != len(axes):
            raise ValueError(f"the mesh's axes must be one of {MESH_AXES}, got {axes}")
        return cls(cfg, tuple(axes), tuple(sizes), (0,) * len(axes))

    def for_batch(self, batch: int) -> "Parallel":
        return dataclasses.replace(self, batch=batch)

    @property
    def dp_axes(self) -> Tuple[str, ...]:
        return self.axes[:-1]

    @property
    def dp(self) -> int:
        return math.prod(self.sizes[:-1])

    @property
    def tp(self) -> int:
        return self.sizes[-1]

    @property
    def dp_rank(self) -> int:
        return self.block(self.dp_axes)[1]

    @property
    def tp_rank(self) -> int:
        return self.coords[-1]

    @property
    def data_group(self):
        """The group data parallelism runs over (all of ``dp_axes``)."""
        return self.group(self.dp_axes)

    @property
    def model_group(self):
        return self.group("model")

    @property
    def caps(self) -> Dict[str, bool]:
        return arch_sharding_caps(self.cfg, self.tp)

    @property
    def batch_covers(self) -> bool:
        if self.batch is None:
            raise ValueError("the global batch is not set (Parallel.for_batch)")
        return self.batch % self.dp == 0 and self.batch >= self.dp

    @property
    def seq_axes(self) -> Optional[Tuple[str, ...]]:
        return _seq_axes(self.caps, self.dp_axes, self.batch_covers)

    def block(self, axes) -> Tuple[int, int]:
        """(count, index) of this rank's block of a dimension split over
        ``axes`` (a name, a tuple of names, major first, or None)."""
        if axes is None:
            return 1, 0
        count, index = 1, 0
        for a in (axes,) if isinstance(axes, str) else axes:
            i = self.axes.index(a)
            count, index = count * self.sizes[i], index * self.sizes[i] + self.coords[i]
        return count, index

    def group(self, axes):
        """The process group spanning ``axes`` (None: the default group, all
        ranks; a placeholder has none)."""
        names = _axis_set(axes)
        if not names <= set(self.axes):
            raise ValueError(f"no group for axes {axes} on a mesh of {self.axes}")
        if names == set(self.axes) or not self.groups:
            return None
        return self.groups[names]

    def span(self, n: int, axes="model") -> Tuple[int, int]:
        """[lo, hi) of this rank's block of a length-``n`` dimension split
        over ``axes``."""
        count, index = self.block(axes)
        if n % count:
            raise ValueError(f"{n} does not split over {count} ranks")
        per = n // count
        return index * per, (index + 1) * per


def tp_of(par: Optional[Parallel]) -> int:
    return par.tp if par is not None else 1


# ---------------------------------------------------------------------------------
# Collectives and the Megatron pair
# ---------------------------------------------------------------------------------

_DRY = [False]      # process-wide: a backward may run on another thread


@contextlib.contextmanager
def dry_collectives():
    """Collectives inside are counted as they would run and return their
    input unchanged, with no process group: the dry run traces one rank's
    program this way (``launch/dryrun.py``)."""
    before, _DRY[0] = _DRY[0], True
    try:
        yield
    finally:
        _DRY[0] = before


def all_reduce(x: torch.Tensor, group, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """In place over ``group``; returns ``x``. Counted in ``all_reduce.calls``
    and ``all_reduce.bytes`` (this rank's tensor), under
    :func:`dry_collectives` too."""
    if not _DRY[0]:
        dist.all_reduce(x, op=op, group=group)
    all_reduce.calls += 1
    all_reduce.bytes += x.numel() * x.element_size()
    return x


all_reduce.calls = 0
all_reduce.bytes = 0


def collective_counts() -> Dict[str, Dict[str, int]]:
    """The collective counters, by kind: ``{kind: {"calls", "bytes"}}``
    (``broadcast`` counts :func:`broadcast_object`)."""
    return {"all_reduce": {"calls": all_reduce.calls, "bytes": all_reduce.bytes},
            "broadcast": {"calls": broadcast_object.calls,
                          "bytes": broadcast_object.bytes}}


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return all_reduce(grad.contiguous().clone(), ctx.group), None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce(x.contiguous().clone(), group)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def f(x: torch.Tensor, par: Optional[Parallel]) -> torch.Tensor:
    """Identity forward, ``all_reduce`` over ``model`` backward: a
    replicated tensor entering a rank's share of the work."""
    if tp_of(par) == 1:
        return x
    return _CopyToModel.apply(x, par.model_group)


def g(x: torch.Tensor, par: Optional[Parallel]) -> torch.Tensor:
    """``all_reduce`` over ``model`` forward, identity backward: the sum of
    the ranks' partial products."""
    if tp_of(par) == 1:
        return x
    return _ReduceFromModel.apply(x, par.model_group)


def gather_dim(x: torch.Tensor, dim: int, axes, par: Parallel) -> torch.Tensor:
    """The whole of a dimension split over ``axes``: this rank's block placed
    in a zero-filled buffer, ``all_reduce``d over their group (no gradient;
    :func:`gather_model` is the differentiable one)."""
    count, index = par.block(axes)
    if count == 1:
        return x
    shape = list(x.shape)
    n = shape[dim]
    shape[dim] = n * count
    out = x.new_zeros(shape)
    out.narrow(dim, index * n, n).copy_(x)
    return all_reduce(out, par.group(axes))


class _GatherFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, par):
        ctx.dim, ctx.par, ctx.n = dim, par, x.shape[dim]
        return gather_dim(x.contiguous(), dim, "model", par)

    @staticmethod
    def backward(ctx, grad):
        whole = all_reduce(grad.contiguous().clone(), ctx.par.model_group)
        return whole.narrow(ctx.dim, ctx.par.tp_rank * ctx.n, ctx.n), None, None


def gather_model(x: torch.Tensor, dim: int, par: Optional[Parallel]) -> torch.Tensor:
    """The whole of dimension ``dim`` split over ``model``, differentiable:
    the backward sums the incoming gradient over ``model`` (each rank's
    consumers of the whole contribute a part) and keeps this rank's block."""
    if tp_of(par) == 1:
        return x
    return _GatherFromModel.apply(x, dim, par)


def combine_attention(out: torch.Tensor, lse: torch.Tensor, group) -> torch.Tensor:
    """Merge attention over disjoint blocks of slots, one per rank of
    ``group``: ``out (..., H, d)`` and its logsumexp ``lse (..., H)`` (fp32)
    per rank -> the attention over all slots, in ``out``'s dtype. Two
    ``all_reduce``s: the max of lse, then the exp-weighted outputs with
    their weights. A rank whose slots hold no live position gives lse about
    NEG_INF (-2e38), whose weight against a live rank's finite max is
    exactly 0; where no rank has one, every weight is 1 and the merge
    averages the ranks' averages of v, the unsplit kernel's answer."""
    m = all_reduce(lse.clone(), group, dist.ReduceOp.MAX)
    w = torch.exp(lse - m)[..., None]
    buf = all_reduce(torch.cat([out.float() * w, w], dim=-1), group)
    return (buf[..., :-1] / buf[..., -1:]).to(out.dtype)


def vocab_argmax(logits: torch.Tensor, cfg: ArchConfig, par: Optional[Parallel]
                 ) -> torch.Tensor:
    """Argmax over the live vocabulary of logits ``(..., Vp)`` or their
    ``model`` shard ``(..., Vp / tp)``, as int64: the max across shards
    (``all_reduce`` max), then the lowest index that holds it (``all_reduce``
    min), so ties go to the lower index as in JAX."""
    if tp_of(par) == 1:
        return torch.argmax(logits[..., : cfg.vocab_size], dim=-1)
    n = logits.shape[-1]
    cols = torch.arange(par.tp_rank * n, (par.tp_rank + 1) * n, device=logits.device)
    x = logits.masked_fill(cols >= cfg.vocab_size, -math.inf)
    best = all_reduce(x.amax(dim=-1), par.model_group, dist.ReduceOp.MAX)
    big = torch.iinfo(torch.int64).max
    idx = torch.where(x == best[..., None], cols, torch.full_like(cols, big)).amin(dim=-1)
    return all_reduce(idx, par.model_group, dist.ReduceOp.MIN)


def gather_vocab(logits: torch.Tensor, par: Optional[Parallel]) -> torch.Tensor:
    """Logits ``(..., Vp / tp)`` of every ``model`` rank -> ``(..., Vp)``."""
    if tp_of(par) == 1:
        return logits
    return gather_dim(logits.contiguous(), logits.dim() - 1, "model", par)


# ---------------------------------------------------------------------------------
# Shards of trees
# ---------------------------------------------------------------------------------

#: leaves whose last dimension is two blocks side by side (the SSM's x and z),
#: each split over the mesh on its own (the logical shard)
_HALVES = ("['ssm']['in_proj']",)


def _segments(n_local: int, count: int, index: int, halves: int):
    """[(global start, local start, length), ...] of a rank's block of a
    dimension of ``n_local * count`` elements."""
    part = n_local // halves
    return [(h * part * count + index * part, h * part, part) for h in range(halves)]


def _dims(path: str, leaf_ndim: int, spec, par: Parallel):
    """Per dimension: (count, index, halves)."""
    spec = _fit(spec, leaf_ndim)
    out = []
    for d, axes in enumerate(spec):
        count, index = par.block(axes)
        halves = 2 if (count > 1 and d == leaf_ndim - 1
                       and any(path.endswith(h) for h in _HALVES)) else 1
        out.append((count, index, halves))
    return out


def shard_leaf(path: str, leaf: torch.Tensor, spec, par: Parallel) -> torch.Tensor:
    """This rank's shard of a global leaf (a new tensor unless unsharded)."""
    dims = _dims(path, leaf.ndim, spec, par)
    if all(c == 1 for c, _, _ in dims):
        return leaf
    x = leaf
    for d, (count, index, halves) in enumerate(dims):
        if count == 1:
            continue
        n = x.shape[d]
        if n % (count * halves):
            raise ValueError(f"{path}: dim {d} of {n} does not split over {count} ranks")
        segs = _segments(n // count, count, index, halves)
        parts = [x.narrow(d, s, ln) for s, _, ln in segs]
        x = parts[0] if len(parts) == 1 else torch.cat(parts, dim=d)
    return x.clone(memory_format=torch.contiguous_format)


def gather_leaf(path: str, leaf: torch.Tensor, spec, par: Parallel) -> torch.Tensor:
    """The global leaf from this rank's shard (collective over the ranks the
    spec names; every rank gets it)."""
    dims = _dims(path, leaf.ndim, spec, par)
    axes = {a for s in _fit(spec, leaf.ndim) if s is not None
            for a in ((s,) if isinstance(s, str) else s)}
    if not axes:
        return leaf
    shape = [n * c for n, (c, _, _) in zip(leaf.shape, dims)]
    out = leaf.new_zeros(shape)
    per_dim = [_segments(n, c, i, h) for n, (c, i, h) in zip(leaf.shape, dims)]
    for combo in itertools.product(*per_dim):
        dst, src = out, leaf
        for d, (gs, ls, ln) in enumerate(combo):
            dst, src = dst.narrow(d, gs, ln), src.narrow(d, ls, ln)
        dst.copy_(src)
    return all_reduce(out, par.group(axes))


def shard_tree(tree: Any, specs: Any, par: Parallel) -> Any:
    """This rank's shards of a global tree, specs a matching tree."""
    return map_with_path(lambda p, leaf, s: shard_leaf(p, leaf, s, par), tree, specs)


def gather_tree(tree: Any, specs: Any, par: Parallel) -> Any:
    """The global tree from every rank's shards (collective)."""
    return map_with_path(lambda p, leaf, s: gather_leaf(p, leaf, s, par), tree, specs)


def sharded_mask(specs: Any) -> list:
    """Per leaf of a spec tree (in flatten order): does it split over
    ``model``? (A leaf split over ``model`` holds a part of the whole; one
    that is not is the same on every model rank.)"""
    return [any(s == "model" or (isinstance(s, tuple) and "model" in s) for s in spec)
            for spec in leaves(specs)]


def zero1_cuts(cfg: ArchConfig, params: Any, par: Parallel) -> list:
    """Per parameter leaf (in flatten order): ``(dim, start, length)`` of this
    rank's slice of the leaf's AdamW moments under ZeRO-1, or None where the
    leaf keeps whole moments. The reference's rule (its dry run's ``zero1``):
    the first dimension of the leaf's shard that is not split over ``model``
    and whose size is a multiple of the ``data`` axis' size and at least that
    size is cut over ``data`` (``pod``, where there is one, keeps copies)."""
    n = par.sizes[par.axes.index("data")]
    if n == 1:
        return [None] * len(leaves(params))
    _, index = par.block("data")
    cuts = []
    for leaf, spec in zip(leaves(params), leaves(param_pspecs(cfg, params, par.tp))):
        cut = None
        for d, (size, s) in enumerate(zip(leaf.shape, _fit(spec, leaf.ndim))):
            if s is None and size % n == 0 and size >= n:
                cut = (d, index * (size // n), size // n)
                break
        cuts.append(cut)
    return cuts


def gather_cuts(tensors: list, cuts: list, par: Parallel) -> None:
    """Every ``data`` rank's slice (``cuts``, as :func:`zero1_cuts` gives
    them) of each tensor, written into every rank's tensor in place: one
    ``all_reduce`` over ``data`` of a zero-filled buffer that holds this
    rank's slices at their places, summed as int32. Each byte is nonzero on
    one rank at most, so the integer sum puts the bits together exactly in
    any dtype (gloo and NCCL both sum int32)."""
    items = [(t, c) for t, c in zip(tensors, cuts) if c is not None]
    if not items:
        return
    spans, total = [], 0
    for t, _ in items:
        nbytes = t.numel() * t.element_size()
        spans.append((total, nbytes))
        total += -(-nbytes // 4) * 4
    buf = torch.zeros(total // 4, dtype=torch.int32, device=items[0][0].device)
    raw = buf.view(torch.uint8)

    def region(t, o, nbytes):
        return raw[o:o + nbytes].view(t.dtype).view(t.shape)

    for (t, (d, s, n)), (o, nbytes) in zip(items, spans):
        region(t, o, nbytes).narrow(d, s, n).copy_(t.narrow(d, s, n))
    all_reduce(buf, par.group("data"))
    for (t, _), (o, nbytes) in zip(items, spans):
        t.copy_(region(t, o, nbytes))


def broadcast_object(obj: Any, src: int = 0) -> Any:
    """``obj`` of rank ``src`` on every rank (through ``broadcast``); counted
    in ``broadcast_object.calls`` and ``.bytes`` (its pickle), under
    :func:`dry_collectives` too."""
    box = [obj]
    if not _DRY[0]:
        dist.broadcast_object_list(box, src=src)
    broadcast_object.calls += 1
    broadcast_object.bytes += len(pickle.dumps(box[0]))
    return box[0]


broadcast_object.calls = 0
broadcast_object.bytes = 0


def barrier(device) -> None:
    """Every rank has reached this point (one small ``all_reduce``)."""
    all_reduce(torch.zeros(1, device=device), None)
