"""The one traffic generator: a mix's parameters (``traffic/<name>.json``)
and ``--seed`` in, the provider's invocation sequence out.

The loop is closed: invocations are served one at a time, back to back, so
the backlog never empties. Invocation ``i`` names a function and a prompt:

* **lengths** are stratified: the ``strata`` quantiles (at (k + 1/2) /
  strata) of a lognormal of the given median and sigma, clipped to
  [min, max] and rounded to ``round_to`` tokens. Every block of ``strata``
  invocations holds each of them once. The order is balanced: the sorted
  quantiles fall into ``GROUPS`` groups of neighbours, and every run of
  ``GROUPS`` invocations from the block's start takes one length of each
  group, so a window that ends inside a block has still served nearly the
  distribution. The order is drawn once for every seed (from the block's
  number alone): a tail such as a p90 over a window of some hundred
  invocations moves by a whole step between neighbouring lengths when a
  seed puts one more long prompt into the window's unfinished block, so the
  lengths a window serves may not depend on the seed;
* **functions** are drawn per block from the seed, uniformly over
  ``functions`` (a number, or ``"cap"``: the configuration's live-instance
  cap);
* **tokens** are uniform over the vocabulary, drawn from ``(seed, i)``
  alone, so the reference can make any prompt again.
"""
from __future__ import annotations

import json
import math
import statistics
from pathlib import Path
from typing import Dict, List, Tuple

import numpy as np

from bench_port.reference.weights import entropy


GROUPS = 8


def load(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def strata_lengths(spec: dict) -> List[int]:
    """The block's prompt lengths, ascending (see the module docstring)."""
    if spec["kind"] != "lognormal":
        raise ValueError(f"unknown length distribution {spec['kind']!r}")
    z = statistics.NormalDist()
    k, r = spec["strata"], spec["round_to"]
    out = []
    for j in range(k):
        x = spec["median"] * math.exp(spec["sigma"] * z.inv_cdf((j + 0.5) / k))
        x = min(max(x, spec["min"]), spec["max"])
        out.append(int(min(max(round(x / r) * r, spec["min"]), spec["max"])))
    return out


def n_functions(mix: dict, cap: int) -> int:
    n = mix["functions"]
    return cap if n == "cap" else int(n)


class Sequence:
    """The invocations of one run: ``seq[i] -> (function index, length)``,
    ``seq.tokens(i, vocab)``. ``stream`` keeps the window's sequence apart
    from the set-up's warm-up sequence."""

    def __init__(self, mix: dict, cap: int, seed: int, stream: str = "window"):
        self.mix, self.seed, self.stream = mix, seed, stream
        self.n_functions = n_functions(mix, cap)
        self.lengths = strata_lengths(mix["lengths"])
        self._blocks: Dict[int, Tuple[np.ndarray, np.ndarray]] = {}

    def _block(self, b: int) -> Tuple[np.ndarray, np.ndarray]:
        if b not in self._blocks:
            order = np.random.default_rng(entropy(0, self.stream, "lengths", b))
            lengths = balanced(np.sort(np.asarray(self.lengths, dtype=np.int64)), order)
            rng = np.random.default_rng(entropy(self.seed, self.stream, "block", b))
            fns = rng.integers(0, self.n_functions, len(self.lengths))
            self._blocks[b] = (fns, lengths)
        return self._blocks[b]

    def __getitem__(self, i: int) -> Tuple[int, int]:
        fns, lengths = self._block(i // len(self.lengths))
        j = i % len(self.lengths)
        return int(fns[j]), int(lengths[j])

    def tokens(self, i: int, vocab: int) -> np.ndarray:
        """Prompt ``i``'s token ids, uniform over ``[0, vocab)``."""
        _, length = self[i]
        rng = np.random.default_rng(entropy(self.seed, self.stream, "tokens", i))
        return rng.integers(0, vocab, length, dtype=np.int64)


def length_groups(lengths: List[int]) -> Dict[int, int]:
    """Each length's group: the sorted lengths cut into :data:`GROUPS` runs
    of neighbours, as :func:`balanced` deals them."""
    s = sorted(lengths)
    return {x: r * GROUPS // len(s) for r, x in enumerate(s)}


def balanced(sorted_lengths: np.ndarray, rng: np.random.Generator) -> np.ndarray:
    """One block's order: round r takes the r-th of a shuffle of each group
    of neighbouring lengths, the round itself shuffled (a plain shuffle where
    the block does not split into :data:`GROUPS` equal groups)."""
    k = len(sorted_lengths)
    if k % GROUPS or k == GROUPS:
        return rng.permutation(sorted_lengths)
    groups = sorted_lengths.reshape(GROUPS, k // GROUPS)
    cols = np.stack([rng.permutation(g) for g in groups], axis=1)   # (rounds, GROUPS)
    return np.concatenate([rng.permutation(r) for r in cols])

