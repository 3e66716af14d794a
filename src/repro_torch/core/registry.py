"""Registries: component name -> factory, plus the serverless function registry.

Port of ``repro.core.registry``:

  * :class:`Registry` — the general name -> component pattern (workloads here).
    Unknown keys fail with did-you-mean suggestions.
  * :class:`FunctionRegistry` — serverless endpoints = shared image ref +
    per-tenant handler. The dependency image contains only the *public* base
    model; user-specific state (handler head weights and the handler callable)
    never enters the shared pool.
"""
from __future__ import annotations

import difflib
import os
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Iterator, List, Optional

import numpy as np
import torch

from repro_torch.core.tree import leaves

def did_you_mean(name: str, choices) -> str:
    """A ``" — did you mean ...?"`` suffix for an unknown-key error message,
    or ``""`` when nothing is close. Shared by :class:`Registry` and the
    scenario spec validators."""
    close = difflib.get_close_matches(str(name), list(choices), n=3)
    return f" — did you mean {', '.join(map(repr, close))}?" if close else ""


class UnknownComponentError(ValueError, KeyError):
    """A registry lookup failed; the message carries did-you-mean hints.

    Subclasses both :class:`ValueError` (what the simulators historically
    raised for unknown names) and :class:`KeyError` (what a dict-shaped
    lookup raises), so pre-registry ``except`` clauses keep working.
    """

    # KeyError.__str__ repr-quotes the message; keep plain Exception rendering
    __str__ = Exception.__str__


class Registry:
    """Name -> component registry with a ``@register("name")`` decorator.

    Components plug into the engines by string key — the unit of
    serializability for scenario specs — without the engine ever naming the
    concrete class. Registered objects are usually factories (classes or
    functions); :meth:`build` calls them with per-component kwargs. A
    registry can also hold plain instances (e.g. the workload suite), in
    which case :meth:`build` returns them as-is when no kwargs are given.

    Dict-shaped reads (``in``, ``[...]``, iteration over names, ``get``)
    are supported so pre-registry call sites keep working unchanged.
    """

    def __init__(self, kind: str):
        self.kind = kind                      # human label for error messages
        self._entries: Dict[str, Any] = {}

    # ------------------------------------------------------------ registration
    def register(self, name: str, obj: Any = None):
        """Register ``obj`` under ``name``; usable as a decorator.

        ``@REG.register("x")`` on a class/function registers it and returns
        it unchanged; ``REG.register("x", obj)`` registers directly.
        Re-registering a taken name raises (shadowing a component silently
        would make scenario specs ambiguous).
        """
        if obj is None:
            def deco(target):
                self.register(name, target)
                return target
            return deco
        if name in self._entries:
            raise ValueError(f"{self.kind} {name!r} is already registered")
        self._entries[name] = obj
        return obj

    # ----------------------------------------------------------------- lookup
    def resolve(self, name: str) -> Any:
        """The registered object for ``name``; unknown names raise
        :class:`UnknownComponentError` with did-you-mean suggestions."""
        try:
            return self._entries[name]
        except KeyError:
            raise UnknownComponentError(
                f"unknown {self.kind}: {name!r} "
                f"(choose from {sorted(self._entries)})"
                f"{did_you_mean(name, self._entries)}") from None

    def build(self, name: str, **kwargs) -> Any:
        """Instantiate the component: call the registered factory with
        ``kwargs``. A non-callable entry (a plain registered instance) is
        returned as-is when no kwargs are given."""
        obj = self.resolve(name)
        if not callable(obj):
            if kwargs:
                raise TypeError(f"{self.kind} {name!r} is a plain instance "
                                f"and takes no kwargs, got {sorted(kwargs)}")
            return obj
        return obj(**kwargs)

    def names(self) -> List[str]:
        """Registered names in registration order (dict-read semantics —
        callers that enumerate components see the curated order; error
        messages sort independently)."""
        return list(self._entries)

    # ------------------------------------------------------- dict-shaped reads
    def get(self, name: str, default: Any = None) -> Any:
        return self._entries.get(name, default)

    def __contains__(self, name: object) -> bool:
        return name in self._entries

    def __getitem__(self, name: str) -> Any:
        return self.resolve(name)

    def __iter__(self) -> Iterator[str]:
        return iter(self._entries)

    def __len__(self) -> int:
        return len(self._entries)

    def __repr__(self) -> str:
        return f"Registry({self.kind!r}, {self.names()})"


@dataclass
class FunctionSpec:
    fn_id: str
    image_id: str                     # shared dependency image this endpoint needs
    handler_builder: Callable[[], Dict[str, np.ndarray]]  # per-tenant weights (small)
    handler_fn: Callable[..., Any]    # handler(params, handler_weights, request)
    # provider-side artifacts
    checkpoint_path: Optional[str] = None   # baseline path: full per-fn checkpoint
    handler_bytes: int = 0
    # Provenance timestamp on the live registry entry; simulated results
    # never read it.  # repro-lint: allow[wall-clock]
    registered_at: float = field(default_factory=time.time)


class FunctionRegistry:
    def __init__(self, store_dir: Optional[str] = None):
        self.store_dir = store_dir
        self._fns: Dict[str, FunctionSpec] = {}

    def register(
        self,
        fn_id: str,
        image_id: str,
        handler_builder: Callable[[], Dict[str, np.ndarray]],
        handler_fn: Callable[..., Any],
        *,
        base_params_builder: Optional[Callable[[], Any]] = None,
        write_baseline_checkpoint: bool = False,
    ) -> FunctionSpec:
        """Registering a function is the paper's *setup phase* (Fig. 4b): the user
        uploads code + handler; the provider may also write the traditional full
        per-function container checkpoint (what the Baseline cold start loads)."""
        hw = handler_builder()
        hbytes = sum(np.asarray(v).nbytes for v in hw.values())
        ckpt = None
        if write_baseline_checkpoint and self.store_dir and base_params_builder:
            os.makedirs(self.store_dir, exist_ok=True)
            ckpt = os.path.join(self.store_dir, f"{fn_id}.npz")
            params = base_params_builder()
            flat = {}
            for i, l in enumerate(leaves(params)):   # the port's flatten order
                if isinstance(l, torch.Tensor):
                    if l.dtype == torch.bfloat16:    # npz can't hold bf16: view as u16
                        flat[f"p{i}:bf16"] = (l.detach().cpu().contiguous()
                                              .view(torch.int16).numpy().view(np.uint16))
                        continue
                    l = l.detach().cpu().numpy()
                flat[f"p{i}"] = np.asarray(l)
            flat.update({f"h_{k}": np.asarray(v) for k, v in hw.items()})
            np.savez(ckpt, **flat)
        spec = FunctionSpec(fn_id=fn_id, image_id=image_id,
                            handler_builder=handler_builder, handler_fn=handler_fn,
                            checkpoint_path=ckpt, handler_bytes=hbytes)
        self._fns[fn_id] = spec
        return spec

    def get(self, fn_id: str) -> FunctionSpec:
        return self._fns[fn_id]

    def list(self) -> List[str]:
        return sorted(self._fns)

    def functions_sharing(self, image_id: str) -> List[str]:
        return [f for f, s in self._fns.items() if s.image_id == image_id]
