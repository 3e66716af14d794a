"""Int8 gradient compression with error feedback (port of
``repro.optim.compression``).

Before a data-parallel all-reduce, each gradient is quantized to int8 with a
per-tensor fp32 scale; the quantization residual is kept in an
error-feedback buffer and added back at the next step.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Tuple

import torch

from repro_torch.core.tree import TreeDef, leaves


@dataclass(frozen=True)
class CompressionConfig:
    enabled: bool = False
    bits: int = 8           # int8 quantization


def init_error_feedback(params: Any) -> Any:
    return TreeDef.of(params).unflatten(
        [torch.zeros(p.shape, dtype=torch.float32, device=p.device) for p in leaves(params)])


def _q(g: torch.Tensor, ef: torch.Tensor):
    g = g.float() + ef
    amax = torch.clamp(torch.max(torch.abs(g)), min=1e-12)
    scale = amax / 127.0
    q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
    residual = g - q.float() * scale
    return q, scale, residual


def compress_gradients(grads: Any, error_feedback: Any) -> Tuple[Dict[str, Any], Any]:
    """Returns ``({'q': int8 tree, 'scale': fp32 tree}, new_error_feedback)``."""
    treedef = TreeDef.of(grads)
    out = [_q(g, ef) for g, ef in zip(leaves(grads), leaves(error_feedback))]
    return ({"q": treedef.unflatten([o[0] for o in out]),
             "scale": treedef.unflatten([o[1] for o in out])},
            treedef.unflatten([o[2] for o in out]))


def decompress_gradients(compressed: Dict[str, Any]) -> Any:
    treedef = TreeDef.of(compressed["q"])
    return treedef.unflatten([q.float() * s for q, s in
                              zip(leaves(compressed["q"]), leaves(compressed["scale"]))])
