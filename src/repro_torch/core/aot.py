"""Serialized executables for dependency images (port of ``repro.core.aot``;
paper §3.2, the disk tier).

A live image carries its step functions ready to run. To survive the disk
tier and a process restart without re-running their set-up, each one is
exported with ``torch.export`` at its sample arguments (parameters as a dict
of tensors included) and saved as bytes:

    blobs = serialize_executables({"prefill": fn}, {"prefill": (params, tokens)})
    ...process restart / image revived from disk...
    execs = deserialize_executables(blobs)      # no re-trace of fn
    execs["prefill"](params, tokens)

A deserialized entry is the loaded program's module: calling it runs the
stored graph, never the Python function. The graph calls the kernels as the
``repro_torch::`` ops, whose fake implementations let export trace them and
whose CPU or CUDA implementation runs at the call; the shapes are fixed at the
sample arguments'.
"""
from __future__ import annotations

import io
from typing import Any, Callable, Dict, Tuple

import torch

import repro_torch.kernels  # noqa: F401  (registers the repro_torch:: ops the graphs call)


class _Callable(torch.nn.Module):
    """A module whose forward is ``fn``, as ``torch.export`` takes it."""

    def __init__(self, fn: Callable):
        super().__init__()
        self.fn = fn

    def forward(self, *args):
        return self.fn(*args)


def serialize_executables(execs: Dict[str, Callable],
                          sample_args: Dict[str, Tuple[Any, ...]]) -> Dict[str, bytes]:
    """Export each callable traced at its sample arguments, as bytes: the
    graph and its signature, without the sample tensors themselves (a
    model's parameters would otherwise be saved with it)."""
    blobs: Dict[str, bytes] = {}
    for name, fn in execs.items():
        exported = torch.export.export(_Callable(fn), tuple(sample_args[name]))
        exported.example_inputs = None    # the graph only: not the sample tensors
        buf = io.BytesIO()
        torch.export.save(exported, buf)
        blobs[name] = buf.getvalue()
    return blobs


def deserialize_executables(blobs: Dict[str, bytes]) -> Dict[str, Callable]:
    """Callables over the stored graphs (no re-trace of the original
    functions)."""
    return {name: torch.export.load(io.BytesIO(blob)).module()
            for name, blob in blobs.items()}


def executables_nbytes(blobs: Dict[str, bytes]) -> int:
    return sum(len(b) for b in blobs.values())
