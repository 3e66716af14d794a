"""Azure-like invocation traces (paper §2.2 / §4.5, Shahrad et al. [22]).

Port of ``repro.core.traces``: the same code with the imports pointed at the
port, so every sample, counter and float sum is bit-identical.

The Azure Functions dataset is not redistributable here, so we generate traces with
the *published summary statistics* the paper relies on:

  * extremely skewed per-function invocation rates — >50 % of functions below
    0.001 calls/min; 75th percentile ≈ 0.04 calls/min (paper §4.5);
  * Poisson arrivals per function (the paper's exponential-gap model, Eq. 1).

Rates are sampled from a lognormal fitted to those two quantiles:
    median = 0.001/min  and  P75 = 0.04/min
    => mu = ln(0.001), sigma = (ln 0.04 − ln 0.001) / z_{0.75}, z_{0.75} = 0.6745.

A loader for the real Azure CSV schema is included for environments that have it.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List, Optional, Sequence

import numpy as np

from repro_torch.core.registry import Registry

MEDIAN_RATE = 0.001      # calls/min (paper §2.2: >50 % below this)
P75_RATE = 0.04          # calls/min (paper §4.5)
_Z75 = 0.674489750196

#: Name -> trace generator (a callable returning ``List[Trace]``). Scenario
#: specs address trace sources by key with per-generator kwargs; new sources
#: self-register with ``@TRACE_GENERATORS.register("name")``.
TRACE_GENERATORS = Registry("trace generator")


@dataclass
class Trace:
    fn_index: int
    rate_per_min: float
    arrivals_min: np.ndarray   # sorted invocation times in minutes
    image_id: int = 0          # dependency image this function runs on


def sample_rates(n: int, seed: int = 0) -> np.ndarray:
    mu = math.log(MEDIAN_RATE)
    sigma = (math.log(P75_RATE) - math.log(MEDIAN_RATE)) / _Z75
    rng = np.random.default_rng(seed)
    return np.exp(rng.normal(mu, sigma, size=n))


def poisson_arrivals(rate_per_min: float, horizon_min: float,
                     rng: np.random.Generator) -> np.ndarray:
    if rate_per_min <= 0:
        return np.empty((0,), np.float64)
    n_expected = rate_per_min * horizon_min
    n = rng.poisson(n_expected)
    return np.sort(rng.uniform(0.0, horizon_min, size=n), kind="stable")


def poisson_arrivals_batched(rates: Sequence[float], horizon_min: float,
                             rng: np.random.Generator, *,
                             sorted: bool = True) -> List[np.ndarray]:
    """Per-function Poisson arrival arrays for ALL rates in three vectorized
    draws (counts, then one uniform fill, then per-segment sorts) instead of
    two RNG calls per function — the production-scale path for traces with
    10^5+ functions or 10^6+ invocations.

    Deterministic given ``rng``'s state, but the stream *interleaving* differs
    from per-function :func:`poisson_arrivals` calls (all counts are drawn
    before any arrival times), so for one seed the batched and unbatched
    arrival values differ; each is reproducible on its own. See
    docs/SIMULATION.md.

    ``sorted=False`` skips the per-segment sorts and returns each function's
    arrivals in raw draw order — the same multiset of times, cheaper at
    production scale. Both fleet engines normalize with one global stable
    argsort over the merged stream, so they accept either ordering and
    produce identical results for it (pinned by tests/test_traces_order.py);
    ``Trace.arrivals_min`` is documented as sorted, so unsorted arrays are
    for engine-level consumers only.
    """
    rates = np.asarray(rates, np.float64)
    counts = rng.poisson(np.maximum(rates, 0.0) * horizon_min)
    counts[rates <= 0] = 0
    flat = rng.uniform(0.0, horizon_min, size=int(counts.sum()))
    segs = np.split(flat, np.cumsum(counts)[:-1])
    return [np.sort(seg, kind="stable") for seg in segs] if sorted else segs


@TRACE_GENERATORS.register("azure")
def generate_traces(n_functions: int, horizon_min: float = 2 * 7 * 24 * 60,
                    seed: int = 0,
                    rates: Optional[Sequence[float]] = None,
                    batched: bool = False) -> List[Trace]:
    """Default horizon: two weeks, as in the paper's case study (§4.5).

    ``batched=True`` draws all functions' arrivals in a few vectorized RNG
    passes (:func:`poisson_arrivals_batched`) — same statistics, different
    stream interleaving, so the per-seed values differ from the default
    per-function draws; use it for production-scale traces."""
    rng = np.random.default_rng(seed + 1)
    if rates is None:
        rates = sample_rates(n_functions, seed)
    if batched:
        arrivals = poisson_arrivals_batched(rates, horizon_min, rng)
        return [Trace(i, float(r), a)
                for i, (r, a) in enumerate(zip(rates, arrivals))]
    return [Trace(i, float(r), poisson_arrivals(float(r), horizon_min, rng))
            for i, r in enumerate(rates)]


def zipf_weights(n: int, s: float) -> np.ndarray:
    """Normalized Zipf(s) weights over ranks 1..n (s=0 -> uniform)."""
    w = np.arange(1, n + 1, dtype=np.float64) ** (-s)
    return w / w.sum()


def assign_images(n_functions: int, n_images: int, skew: float = 1.2,
                  seed: int = 0) -> np.ndarray:
    """Function -> dependency-image mapping with Zipf-skewed image popularity.

    With skew > 0 a few images are shared by many functions (the regime the
    paper's 88 %-saving headline lives in); skew = 0 spreads functions evenly.
    Every image gets at least one function when n_functions >= n_images, so the
    requested sharing degree is real rather than probabilistic."""
    if n_images <= 1:
        return np.zeros(n_functions, np.int64)
    rng = np.random.default_rng(seed + 7)
    out = np.empty(n_functions, np.int64)
    head = min(n_images, n_functions)
    out[:head] = np.arange(head)                      # coverage guarantee
    if n_functions > head:
        out[head:] = rng.choice(n_images, size=n_functions - head,
                                p=zipf_weights(n_images, skew))
    rng.shuffle(out)
    return out


@TRACE_GENERATORS.register("fleet")
def generate_fleet_traces(
    n_functions: int,
    horizon_min: float = 2 * 7 * 24 * 60,
    seed: int = 0,
    n_images: int = 1,
    image_skew: float = 1.2,
    rate_model: str = "azure",        # 'azure' (lognormal §4.5) | 'zipf'
    rate_skew: float = 1.1,           # Zipf exponent when rate_model='zipf'
    total_rate_per_min: float = 1.0,  # fleet-wide rate when rate_model='zipf'
    batched: bool = False,            # vectorized arrival draws (see below)
) -> List[Trace]:
    """Synthetic skewed fleet workload: Azure-statistics (or Zipf-ranked)
    per-function rates plus a Zipf-skewed function->image mapping.

    ``batched=True`` draws all arrivals via
    :func:`poisson_arrivals_batched` — the production-scale path
    (million-invocation traces in well under a second). Same statistics,
    different RNG stream interleaving than the per-function default, so
    per-seed arrival values differ between the two modes; each mode is
    deterministic given ``seed``."""
    if rate_model == "azure":
        rates = sample_rates(n_functions, seed)
    elif rate_model == "zipf":
        rates = total_rate_per_min * zipf_weights(n_functions, rate_skew)
    else:
        raise ValueError(f"unknown rate_model: {rate_model!r}")
    images = assign_images(n_functions, n_images, image_skew, seed)
    rng = np.random.default_rng(seed + 1)
    if batched:
        arrivals = poisson_arrivals_batched(rates, horizon_min, rng)
        return [Trace(i, float(r), a, image_id=int(images[i]))
                for i, (r, a) in enumerate(zip(rates, arrivals))]
    return [Trace(i, float(r), poisson_arrivals(float(r), horizon_min, rng),
                  image_id=int(images[i]))
            for i, r in enumerate(rates)]


def sharing_degrees(traces: List[Trace]) -> dict:
    """image_id -> number of functions sharing that image."""
    out: dict = {}
    for t in traces:
        out[t.image_id] = out.get(t.image_id, 0) + 1
    return out


def quartile_groups(traces: List[Trace]) -> dict:
    """Paper Fig. 7 grouping: quartiles by invocation rate."""
    rates = np.array([t.rate_per_min for t in traces])
    qs = np.quantile(rates, [0.25, 0.5, 0.75])
    groups = {"lowest": [], "25-50%": [], "50-75%": [], "highest": []}
    for t in traces:
        if t.rate_per_min <= qs[0]:
            groups["lowest"].append(t)
        elif t.rate_per_min <= qs[1]:
            groups["25-50%"].append(t)
        elif t.rate_per_min <= qs[2]:
            groups["50-75%"].append(t)
        else:
            groups["highest"].append(t)
    return groups


# The Azure CSV reader and the streaming/adversarial generators (azure_csv,
# diurnal, bursts, tenant_mix, rollout) live in core/trace_stream.py and
# self-register into TRACE_GENERATORS when that module loads; this bottom
# import makes `import repro_torch.core.traces` alone populate the full registry.
# (trace_stream imports this module's names, all defined above, so the
# circular import is resolved by the time registration runs.)
from repro_torch.core import trace_stream as _trace_stream  # noqa: E402,F401
