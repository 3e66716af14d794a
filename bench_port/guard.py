"""The run's refusal to measure a process that loaded JAX or the JAX package.

Module names are compared by their top-level part (before the first dot),
whole: ``repro_torch`` is the port and passes; ``repro`` is the JAX package
and does not.
"""
from __future__ import annotations

from typing import Iterable, List

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden(names: Iterable[str]) -> List[str]:
    """The top-level names among ``names`` that the run may not hold."""
    return sorted({n.split(".", 1)[0] for n in names} & set(FORBIDDEN))
