"""Per-device cost of one rank's program, from a trace (port of
``repro.launch.hlo_analysis`` and ``repro.launch.hlo_walk``).

The reference reads its costs from XLA: ``cost_analysis`` and
``memory_analysis`` of the compiled executable, and a walk over the
optimized HLO text for FLOPs, an HBM-traffic proxy and collective bytes. The
port has no compiler between the model and the kernels, so it runs the
rank's program itself on meta tensors (no data, no card, no process group)
under :class:`CostMode`, a ``TorchDispatchMode`` that sees every op below
autograd, the backward included:

* **FLOPs**: the formulas of ``torch.utils.flop_counter`` (``mm``, ``bmm``,
  ``addmm``, ``baddbmm``, convolution and the rest it knows, from their
  shapes), and the port's own ops through the formulas registered beside
  them with ``register_flop_formula`` (``flash_attention`` forward and
  backward, ``decode_attention``, ``diag_recurrence``). Elementwise FLOPs
  are not counted, as in ``hlo_walk``.
* **Bytes**: operand + result bytes of every op that is not a view (a view's
  bytes are its own elements, not its storage's); an indexed in-place write
  (``index_put_``, ``index_copy_``, ``scatter_``) is charged three times its
  update and indices (read the region and the update, write the region), as
  ``hlo_walk`` charges a ``dynamic-update-slice``, not the whole buffer. Unlike
  ``hlo_walk``'s proxy, which charges a fusion its parameters and results
  once, eager ops are not fused: every elementwise op reads and writes
  device memory here, so the proxy over-counts elementwise traffic against
  what a fused program would move.
* **Loops**: the eager trace unrolls every layer loop and every chunk loop,
  so each op is seen as often as it runs. The trip-count machinery that
  ``hlo_walk`` exists for (``while`` bodies counted once by
  ``cost_analysis``) has no counterpart.
* **Peak live bytes**: every storage an op creates is added when it is
  made and taken off when the last tensor on it is freed (a
  ``weakref.finalize`` on each tensor, counted by storage); the peak is the
  largest sum over the trace, on top of the arguments the program is handed
  (the shards of parameters, optimizer state, batch and decode state).
* **Collectives**: counted by ``models/sharding``'s own counters of
  ``all_reduce`` and ``broadcast``, which the trace runs under
  ``sharding.dry_collectives`` (counted, not run).

The roofline constants are those of the card the port runs on, datasheet
figures and not measurements: NVIDIA H100 80GB HBM3 (SXM) at its 700 W
power limit, dense bf16 989 TFLOP/s on the tensor cores, fp32 67 TFLOP/s on
the CUDA cores (where the port's fp32 programs run: its fp32 kernels and its
fp32 products with TF32 off), HBM3 3.35 TB/s, NVLink 450 GB/s each way.
"""
from __future__ import annotations

import weakref
from collections import defaultdict
from typing import Any, Dict

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry

#: datasheet peaks of the card (not measurements), by the dtype a program computes in
CARD = "NVIDIA H100 80GB HBM3, 700 W"
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
HBM_BW = 3.35e12            # bytes/s
LINK_BW = 450e9             # bytes/s each way, NVLink
DATASHEET = (f"datasheet peaks of the {CARD} (dense bf16 989 TFLOP/s, fp32 67 TFLOP/s, "
             "HBM3 3.35 TB/s, NVLink 450 GB/s each way); not measurements")

_aten = torch.ops.aten
_INDEXED_WRITES = {_aten.index_put_, _aten.index_copy_, _aten.scatter_, _aten.index_put,
                   _aten._index_put_impl_}
_NO_TRAFFIC = {_aten.empty, _aten.empty_like, _aten.empty_strided, _aten.new_empty,
               _aten.new_empty_strided, _aten.detach, _aten.alias, _aten.lift_fresh,
               _aten._local_scalar_dense}


def _nbytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in tree_flatten(tree)[0]
               if isinstance(t, torch.Tensor))


class CostMode(TorchDispatchMode):
    """FLOPs, bytes and peak live bytes of the ops run inside it (see the
    module docstring for the method); ``flops_by_op`` splits the FLOPs by
    op. ``held`` are the tensors the program is handed: an op that writes
    into one of them (in place, or through a view) allocates nothing."""

    def __init__(self, held=()):
        super().__init__()
        self._held = {t.untyped_storage()._cdata for t in tree_flatten(held)[0]
                      if isinstance(t, torch.Tensor)}
        self.flops = 0.0
        self.bytes = 0.0
        self.ops = 0
        self.flops_by_op: Dict[str, float] = defaultdict(float)
        self.live = 0
        self.peak = 0
        self._storages: Dict[int, list] = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        packet = func._overloadpacket
        self.ops += 1
        if packet in flop_registry:
            n = float(flop_registry[packet](*args, **kwargs, out_val=out))
            self.flops += n
            self.flops_by_op[str(packet)] += n
        if packet in _INDEXED_WRITES:      # indices and update, not the region
            self.bytes += 3 * (_nbytes(args[1:]) + _nbytes(kwargs))
        elif not func.is_view and packet not in _NO_TRAFFIC:
            self.bytes += _nbytes(args) + _nbytes(kwargs) + _nbytes(out)
        self._track(out)
        return out

    def _track(self, out) -> None:
        for t in tree_flatten(out)[0]:
            if not isinstance(t, torch.Tensor):
                continue
            key = t.untyped_storage()._cdata
            if key in self._held:
                continue
            entry = self._storages.get(key)
            if entry is None:
                entry = self._storages[key] = [t.untyped_storage().nbytes(), 0]
                self.live += entry[0]
                self.peak = max(self.peak, self.live)
            entry[1] += 1
            weakref.finalize(t, self._drop, key)

    def _drop(self, key: int) -> None:
        entry = self._storages[key]
        entry[1] -= 1
        if entry[1] == 0:
            self.live -= entry[0]
            del self._storages[key]


def collective_summary(before: Dict[str, Dict[str, int]],
                       after: Dict[str, Dict[str, int]]) -> Dict[str, Any]:
    """Per-device collective calls and bytes by kind between two readings of
    ``sharding.collective_counts``, with the reference's ring weight: an
    all-reduce moves about twice its bytes (``hlo_analysis.collective_bytes``)."""
    calls = {k: after[k]["calls"] - before[k]["calls"] for k in after}
    nbytes = {k: float(after[k]["bytes"] - before[k]["bytes"]) for k in after}
    total = sum(nbytes.values())
    return {"collective_bytes_by_kind": nbytes, "collective_count_by_kind": calls,
            "collective_output_bytes": total,
            "collective_ring_weighted_bytes": total + nbytes.get("all_reduce", 0.0)}


def roofline_terms(flops_per_device: float, bytes_per_device: float,
                   collective_bytes_per_device: float, dtype: str) -> Dict[str, Any]:
    """The reference's three terms at the card's datasheet peaks, the fp32 or
    bf16 one by the program's dtype; the lower bound of a step assumes they
    overlap perfectly."""
    peak = PEAK_FLOPS[dtype]
    terms = {"compute_s": flops_per_device / peak,
             "memory_s": bytes_per_device / HBM_BW,
             "collective_s": collective_bytes_per_device / LINK_BW}
    bottleneck = max(terms, key=terms.get)
    total = max(sum(terms.values()), 1e-30)
    return {**terms, "bottleneck": bottleneck.replace("_s", ""),
            "bound_fraction": terms[bottleneck] / total,
            "step_lower_bound_s": max(terms.values()),
            "peak_flops": peak, "peaks": DATASHEET}
