"""Keep-alive / cold-start arrival math (paper §2.2, Fig. 1).

Port of ``repro.core.keepalive``: the same code with the imports pointed at the
port, so every sample, counter and float sum is bit-identical.

With Poisson invocations at rate λ (per minute) and keep-alive T minutes:

    P(no invocation within T)  =  e^(−λT)                       (paper Eq. 1)
    E[cold starts in D min]    =  D · λ · e^(−λT)                (paper Eq. 2)

maximized at λ* = 1/T. Function-specific tuning pays off only when
w·E_cs(λ) > c (Eq. 3) — the long tail fails this test, which is WarmSwap's
raison d'être.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

import numpy as np

from repro_torch.core.registry import Registry


def p_no_invocation(lam: float, keep_alive_min: float) -> float:
    return math.exp(-lam * keep_alive_min)


def expected_cold_starts(lam, keep_alive_min: float, horizon_min: float):
    """Vectorized Eq. 2."""
    lam = np.asarray(lam, dtype=np.float64)
    return horizon_min * lam * np.exp(-lam * keep_alive_min)


def argmax_rate(keep_alive_min: float) -> float:
    """The invocation rate with the most expected cold starts: λ* = 1/T."""
    return 1.0 / keep_alive_min


def worth_function_specific_tuning(lam: float, keep_alive_min: float,
                                   horizon_min: float, benefit_per_cs: float,
                                   cost: float) -> bool:
    """Paper Eq. 3: w·E_cs(λ) > c."""
    return benefit_per_cs * float(expected_cold_starts(lam, keep_alive_min,
                                                       horizon_min)) > cost


@dataclass(frozen=True)
class KeepAlivePolicy:
    keep_alive_min: float = 15.0     # paper's default (§4.5); AWS/Azure use 5–30

    def expires_at(self, last_use_min: float) -> float:
        return last_use_min + self.keep_alive_min


# ---------------------------------------------------------------------------------
# Pluggable pre-warm policies for the fleet simulator (core/fleet.py).
#
# A policy answers two questions per function, from its observed arrival history:
#   * keep_alive_min(fn, image_bytes=...) — how long an idle instance stays warm
#     after completion. The engine passes the BYTES the idle instance pins
#     (warmswap: per-fn metadata; prebaking: its private snapshot; baseline: its
#     privately initialized dependencies), so policies can reason about memory
#     cost, not just time — see BytesAwareKeepAlive;
#   * prewarm_after(fn,t) — optionally, a (spawn_at, expire_at) window in which a
#     predictively pre-warmed instance should be standing by for the next arrival.
# The fleet engine also feeds completion events (on_completion) so policies can
# anchor decisions to when an instance actually went idle, not just when the
# request arrived (under queueing the two diverge).
#
# Policies are registry-pluggable: ``@PREWARM_POLICIES.register("name")`` makes
# a policy addressable by string key from FleetConfig.prewarm, scenario specs,
# and the experiments CLI without touching the engine.
# ---------------------------------------------------------------------------------

#: Name -> policy class. New policies self-register with
#: ``@PREWARM_POLICIES.register("name")``; the fleet engine and scenario specs
#: look them up by key (per-component kwargs go to the constructor).
PREWARM_POLICIES = Registry("prewarm policy")


@PREWARM_POLICIES.register("none")
class PrewarmPolicy:
    """Base: fixed keep-alive (the paper's §4.5 setting), no prediction."""

    name = "none"

    def __init__(self, keep_alive_min: float = 15.0):
        self._keep_alive_min = keep_alive_min
        self._last_arrival: dict = {}
        self._last_completion: dict = {}  # fn -> last instance-free time (min)
        self._iats: dict = {}        # fn -> list of recent inter-arrival times (min)
        self.max_history = 64

    def on_arrival(self, fn: int, t_min: float) -> None:
        last = self._last_arrival.get(fn)
        if last is not None and t_min > last:
            hist = self._iats.setdefault(fn, [])
            hist.append(t_min - last)
            if len(hist) > self.max_history:
                del hist[0]
        self._last_arrival[fn] = t_min

    def on_completion(self, fn: int, t_min: float) -> None:
        """The fleet engine's instance-free event: a request of ``fn`` finished
        at ``t_min``. The keep-alive window runs from here — under queueing the
        completion diverges from the arrival — so this is the anchor for
        idle-time reasoning. The base class records it for subclasses; the
        built-in policies are arrival-driven and don't consult it."""
        self._last_completion[fn] = t_min

    def keep_alive_min(self, fn: int,
                       image_bytes: Optional[int] = None) -> float:
        """Keep-alive window (minutes) for an idle instance of ``fn``.

        Args:
            fn: function index.
            image_bytes: bytes the idle instance pins in memory (``None``
                when the caller has no size information). The base policy and
                the time-only subclasses ignore it; byte-aware policies scale
                the window by it.
        """
        return self._keep_alive_min

    def prewarm_after(self, fn: int, t_min: float):
        """Return (spawn_at_min, expire_at_min) for a predictive pre-warm, or
        None. Called after each arrival has been served."""
        return None


@PREWARM_POLICIES.register("histogram")
class HistogramKeepAlive(PrewarmPolicy):
    """Serverless-in-the-wild-style adaptive keep-alive: per function, keep the
    instance warm for a high percentile of the observed inter-arrival times,
    clamped to [lo, hi]. Rarely-invoked functions stop wasting memory on a
    window they never hit; chatty functions get a window that covers them."""

    name = "histogram"

    def __init__(self, percentile: float = 99.0, lo_min: float = 1.0,
                 hi_min: float = 60.0, min_samples: int = 4,
                 default_min: float = 15.0):
        super().__init__(keep_alive_min=default_min)
        self.percentile = percentile
        self.lo_min = lo_min
        self.hi_min = hi_min
        self.min_samples = min_samples

    def keep_alive_min(self, fn: int,
                       image_bytes: Optional[int] = None) -> float:
        hist = self._iats.get(fn, ())
        if len(hist) < self.min_samples:
            return self._keep_alive_min
        ka = float(np.percentile(np.asarray(hist), self.percentile))
        return min(max(ka, self.lo_min), self.hi_min)


@PREWARM_POLICIES.register("spes")
class SpesPrewarm(PrewarmPolicy):
    """SPES-style (arXiv 2403.17574) predictive pre-warming: keep-alive is cut
    short (cheap), and instead the next arrival is predicted from the median
    inter-arrival time; an instance is pre-warmed shortly before the predicted
    time and kept only for a margin around it. Trades a little spawn work for
    much less idle residency on predictable functions."""

    name = "spes"

    def __init__(self, keep_alive_min: float = 2.0, margin_frac: float = 0.25,
                 min_samples: int = 4, max_window_min: float = 120.0):
        super().__init__(keep_alive_min=keep_alive_min)
        self.margin_frac = margin_frac
        self.min_samples = min_samples
        self.max_window_min = max_window_min

    def prewarm_after(self, fn: int, t_min: float):
        hist = self._iats.get(fn, ())
        if len(hist) < self.min_samples:
            return None
        med = float(np.median(np.asarray(hist)))
        if med <= 0 or med > self.max_window_min:
            return None                      # too unpredictable / too rare
        margin = max(self.margin_frac * med, 1e-3)
        return (t_min + med - margin, t_min + med + margin)


@PREWARM_POLICIES.register("bytes")
class BytesAwareKeepAlive(PrewarmPolicy):
    """Keep-alive priced in byte-minutes, not minutes.

    A fixed time window treats a 3 MB idle handler and a 2.3 GB idle snapshot
    as equally cheap; a provider's cache does not. This policy grants every
    idle instance the same *byte-minute* budget, so the window scales
    inversely with the bytes the instance pins: tiny WarmSwap metadata idles
    for a long time (the shared image is already paid for), a private
    Prebaking snapshot gets a short leash. With the default budget a 230 MB
    resident gets exactly the paper's 15-minute window.

    Args:
        budget_byte_min: byte-minutes one idle instance may consume
            (default: 230 MiB x 15 min).
        lo_min / hi_min: clamp on the resulting window (minutes).
        default_min: window when the caller passes no size (minutes).
    """

    name = "bytes"

    def __init__(self, budget_byte_min: float = float(230 << 20) * 15.0,
                 lo_min: float = 1.0, hi_min: float = 240.0,
                 default_min: float = 15.0):
        super().__init__(keep_alive_min=default_min)
        self.budget_byte_min = budget_byte_min
        self.lo_min = lo_min
        self.hi_min = hi_min

    def keep_alive_min(self, fn: int,
                       image_bytes: Optional[int] = None) -> float:
        if not image_bytes or image_bytes <= 0:
            return self._keep_alive_min
        return min(max(self.budget_byte_min / image_bytes, self.lo_min),
                   self.hi_min)


