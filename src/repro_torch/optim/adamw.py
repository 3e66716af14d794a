"""AdamW with global-norm clipping (port of ``repro.optim.adamw``).

The optimizer state mirrors the parameter tree: ``mu`` and ``nu`` in fp32
whatever the parameters' dtype, ``count`` an int32 scalar, so it pages and
checkpoints through the same machinery as the parameters. The arithmetic
keeps the reference's order (clip, moments, bias correction, weight decay).
The reference returns new trees; here the parameters, ``mu`` and ``nu`` are
written in place (under ``torch.no_grad()``) to save a copy of each, and the
returned trees hold the same tensors.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Tuple

import torch

from repro_torch.core.tree import TreeDef, leaves


@dataclass(frozen=True)
class AdamWConfig:
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0


def adamw_init(params: Any) -> Dict[str, Any]:
    """Zero moments (fp32, on each parameter's device) and a zero int32 count."""
    treedef = TreeDef.of(params)
    flat = leaves(params)

    def zeros():
        return treedef.unflatten([torch.zeros(p.shape, dtype=torch.float32,
                                              device=p.device) for p in flat])

    device = flat[0].device if flat else None
    return {"mu": zeros(), "nu": zeros(),
            "count": torch.zeros((), dtype=torch.int32, device=device)}


def global_norm(tree: Any) -> torch.Tensor:
    """sqrt of the sum over leaves of each leaf's sum of squares, in fp32."""
    total = sum(torch.sum(torch.square(leaf.float())) for leaf in leaves(tree))
    return torch.sqrt(torch.as_tensor(total, dtype=torch.float32))


@torch.no_grad()
def adamw_update(grads: Any, opt_state: Dict[str, Any], params: Any, lr,
                 cfg: AdamWConfig = AdamWConfig()) -> Tuple[Any, Dict[str, Any], dict]:
    """Returns ``(params, opt_state, metrics)``; ``params``, ``mu`` and ``nu``
    are updated in place. ``grads`` has the parameters' structure; ``lr`` is
    a float or an fp32 scalar tensor."""
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.clip_norm / (gnorm + 1e-9), max=1.0)
    count = opt_state["count"] + 1
    c1 = 1.0 - cfg.b1 ** count.float()
    c2 = 1.0 - cfg.b2 ** count.float()
    for g, mu, nu, p in zip(leaves(grads), leaves(opt_state["mu"]),
                            leaves(opt_state["nu"]), leaves(params)):
        g = g.float() * scale
        mu.copy_(cfg.b1 * mu + (1 - cfg.b1) * g)
        nu.copy_(cfg.b2 * nu + (1 - cfg.b2) * torch.square(g))
        step = (mu / c1) / (torch.sqrt(nu / c2) + cfg.eps)
        step = step + cfg.weight_decay * p.float()
        p.copy_((p.float() - lr * step).to(p.dtype))
    metrics = {"grad_norm": gnorm, "clip_scale": scale}
    return params, {"mu": opt_state["mu"], "nu": opt_state["nu"], "count": count}, metrics
