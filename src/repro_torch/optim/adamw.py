"""AdamW with global-norm clipping (port of ``repro.optim.adamw``).

The optimizer state mirrors the parameter tree: ``mu`` and ``nu`` in fp32
whatever the parameters' dtype, ``count`` an int32 scalar, so it pages and
checkpoints through the same machinery as the parameters. The arithmetic
keeps the reference's order (clip, moments, bias correction, weight decay).
The reference returns new trees; here the parameters, ``mu`` and ``nu`` are
written in place (under ``torch.no_grad()``) to save a copy of each, and the
returned trees hold the same tensors. Under tensor parallelism the moments
are sharded like the parameters, and the clipping norm sums a sharded leaf's
squares over the model ranks and counts a replicated leaf once. Under ZeRO-1
(``cuts``) a leaf's moments are one slice of it, the step updates only that
slice of the parameter, and ``gather`` puts the slices of every rank
together; the update is elementwise, so the parameters come out bitwise as
without the cut.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import torch

from repro_torch.core.tree import TreeDef, leaves


@dataclass(frozen=True)
class AdamWConfig:
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0


Cut = Optional[Tuple[int, int, int]]      # (dim, start, length) of a leaf's slice


def _slice(t: torch.Tensor, cut: Cut) -> torch.Tensor:
    return t if cut is None else t.narrow(*cut)


def adamw_init(params: Any, cuts: Optional[Sequence[Cut]] = None) -> Dict[str, Any]:
    """Zero moments (fp32, on each parameter's device) and a zero int32 count.
    With ``cuts`` (per leaf, ``sharding.zero1_cuts``) each leaf's moments
    have the shape of its slice."""
    treedef = TreeDef.of(params)
    flat = leaves(params)
    cuts = cuts or [None] * len(flat)

    def zeros():
        return treedef.unflatten([torch.zeros(_slice(p, c).shape, dtype=torch.float32,
                                              device=p.device) for p, c in zip(flat, cuts)])

    device = flat[0].device if flat else None
    return {"mu": zeros(), "nu": zeros(),
            "count": torch.zeros((), dtype=torch.int32, device=device)}


def global_norm(tree: Any, sharded: Optional[Sequence[bool]] = None,
                reduce: Optional[Callable[[torch.Tensor], torch.Tensor]] = None
                ) -> torch.Tensor:
    """sqrt of the sum over leaves of each leaf's sum of squares, in fp32.
    With ``sharded`` (per leaf: is it one rank's shard?) the shards' sum goes
    through ``reduce`` (the sum over the ranks that hold the other shards)
    and each replicated leaf counts once."""
    flat = leaves(tree)
    if sharded is None:
        total = sum(torch.sum(torch.square(leaf.float())) for leaf in flat)
        return torch.sqrt(torch.as_tensor(total, dtype=torch.float32))
    sq = [torch.sum(torch.square(leaf.float())) for leaf in flat]
    part = torch.stack([s for s, sh in zip(sq, sharded) if sh] or [sq[0] * 0]).sum()
    part = reduce(part)
    rep = [s for s, sh in zip(sq, sharded) if not sh]
    return torch.sqrt(part + (torch.stack(rep).sum() if rep else 0.0))


@torch.no_grad()
def adamw_update(grads: Any, opt_state: Dict[str, Any], params: Any, lr,
                 cfg: AdamWConfig = AdamWConfig(), *,
                 sharded: Optional[Sequence[bool]] = None,
                 reduce: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
                 cuts: Optional[Sequence[Cut]] = None,
                 gather: Optional[Callable[[list, Sequence[Cut]], None]] = None
                 ) -> Tuple[Any, Dict[str, Any], dict]:
    """Returns ``(params, opt_state, metrics)``; ``params``, ``mu`` and ``nu``
    are updated in place. ``grads`` has the parameters' structure; ``lr`` is
    a float or an fp32 scalar tensor; ``sharded`` and ``reduce`` as in
    :func:`global_norm`. With ``cuts`` (ZeRO-1, as in :func:`adamw_init`)
    only each leaf's slice is updated, and then ``gather(leaves, cuts)``
    writes every rank's slices into the leaves."""
    gnorm = global_norm(grads, sharded, reduce)
    scale = torch.clamp(cfg.clip_norm / (gnorm + 1e-9), max=1.0)
    count = opt_state["count"] + 1
    c1 = 1.0 - cfg.b1 ** count.float()
    c2 = 1.0 - cfg.b2 ** count.float()
    flat = leaves(params)
    cuts = cuts or [None] * len(flat)
    for g, mu, nu, p, cut in zip(leaves(grads), leaves(opt_state["mu"]),
                                 leaves(opt_state["nu"]), flat, cuts):
        g, p = _slice(g, cut), _slice(p, cut)
        g = g.float() * scale
        mu.copy_(cfg.b1 * mu + (1 - cfg.b1) * g)
        nu.copy_(cfg.b2 * nu + (1 - cfg.b2) * torch.square(g))
        step = (mu / c1) / (torch.sqrt(nu / c2) + cfg.eps)
        step = step + cfg.weight_decay * p.float()
        p.copy_((p.float() - lr * step).to(p.dtype))
    if any(c is not None for c in cuts):
        gather(flat, cuts)
    metrics = {"grad_norm": gnorm, "clip_scale": scale}
    return params, {"mu": opt_state["mu"], "nu": opt_state["nu"], "count": count}, metrics
