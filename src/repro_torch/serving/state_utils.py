"""Decode-state surgery for continuous batching (port of ``repro.serving.state_utils``).

The batched decode state stores the batch dimension at axis 1 for unit-stacked
leaves (``unit``: (n_units, B, ...)) and axis 0 elsewhere (``rem`` leaves,
``pos``). These helpers splice a single request's state into a batch slot,
extract one, and reset slots, with the reference's path rules over the port's
own tree walk (``core/tree.py``). Where the reference builds a new state, the
port writes the slot in place and returns the same state, so a step never
copies the whole cache.
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.core.tree import map_with_path


def _batch_axis(key: str) -> int:
    return 1 if (key.startswith("['unit']") or "cross" in key) else 0


def state_splice(batched: Any, single: Any, slot: int) -> Any:
    """Write ``single`` (batch size 1) into ``batched`` at ``slot``, casting to
    the batched dtypes; in place."""
    def ins(key, b, s):
        if b.dim() == 0:
            return s
        b.narrow(_batch_axis(key), slot, 1).copy_(s)
        return b
    return map_with_path(ins, batched, single)


def state_extract(batched: Any, slot: int) -> Any:
    """A copy of one slot's state (batch size 1)."""
    def ext(key, b):
        return b.narrow(_batch_axis(key), slot, 1).clone() if b.dim() > 0 else b
    return map_with_path(ext, batched)


def state_reset_slot(batched: Any, slot: int) -> Any:
    """Clear one slot in place: caches emptied (``k_pos`` = -1), states
    zeroed, pos = 0."""
    def rst(key, b):
        if b.dim() == 0:
            return b
        fill = -1 if (b.dtype == torch.int32 and "k_pos" in key) else 0
        b.select(_batch_axis(key), slot).fill_(fill)
        return b
    return map_with_path(rst, batched)
