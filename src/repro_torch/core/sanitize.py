"""repro-san: the runtime invariant sanitizer for the fleet engines.

Port of ``repro.core.sanitize``: the same code with the imports pointed at the
port, so every sample, counter and float sum is bit-identical.

The reference package's static layer (``tools/analysis``, which lints the
reference's paths only) proves the *declared* contract is the *coded*
contract; this module checks the contract **holds while a simulation runs**.
With ``REPRO_SANITIZE=1`` (or ``run(..., sanitize=True)``) both fleet engines
execute instrumented assertions at every drain step:

* ``event-order``    — heap pops follow the documented ``(time, kind, seq)``
  total order (docs/SIMULATION.md tie-break table) and never go backwards;
* ``negative-wait``  — no request is served before it arrived;
* ``busy-regression``— an instance's ``busy_until`` only ever advances (no
  double-booked instance, no negative service time);
* ``ledger-books``   — every :class:`~repro_torch.core.pool.CapacityLedger`
  balances: the incremental byte total equals the recomputed sum, refcounts
  and sizes are nonnegative;
* ``cluster-books``  — the shared tier's holder sets and its ledger agree
  bidirectionally, and every holder's worker pool really holds the key;
* ``counter-conservation`` — the counter laws of docs/SIMULATION.md, chiefly
  ``n_invocations <= n_cold + n_warm <= n_invocations + requeued`` (strict
  equality when nothing was requeued);
* ``sample-domain``  — latency/wait sample arrays are finite, nonnegative,
  and elementwise ``latency >= wait``.

A violation raises :class:`SanitizeError` after writing a minimized repro
artifact (``results/sanitizer/<sha16>.json``): the invariant, the resolved
scenario, the first violating event, and a counter snapshot — everything a
debugging session needs to replay the failure. Artifact names are content
hashes, not timestamps, so sanitized runs stay deterministic.

The checks are assertions only: a sanitized run returns bit-identical
results (CI's ``sanitize`` leg replays the golden suite and the reduced
differential fuzz under ``REPRO_SANITIZE=1`` to prove it).
"""
from __future__ import annotations

import hashlib
import json
import os
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

#: Artifact layout version (bump on any payload shape change).
SANITIZER_SCHEMA_VERSION = 1

#: Where repro artifacts land unless the caller overrides it.
DEFAULT_ARTIFACT_DIR = os.path.join("results", "sanitizer")

#: FleetResult counters that must never go negative.
_NONNEG_COUNTERS = (
    "n_invocations", "n_cold", "n_warm", "n_queued", "requeued",
    "pool_misses", "evictions", "prewarm_spawns", "prewarm_hits",
    "prewarm_dropped", "max_concurrent_instances", "memory_bytes",
    "cache_local_hits", "cache_remote_hits", "cache_misses",
    "pages_transferred", "shared_cache_peak_bytes", "shared_cache_evictions",
    "placement_warm_hits", "placement_pool_hits", "worker_failures",
    "worker_recoveries", "cache_flushes",
)


def sanitize_enabled() -> bool:
    """True when ``REPRO_SANITIZE`` asks for a sanitized run (any value but
    empty/``0``)."""
    return os.environ.get("REPRO_SANITIZE", "") not in ("", "0")


class SanitizeError(RuntimeError):
    """An invariant violation caught by the sanitizer; ``artifact_path``
    locates the minimized repro artifact (``None`` if it could not be
    written)."""

    def __init__(self, message: str, artifact_path: Optional[str] = None):
        super().__init__(message)
        self.artifact_path = artifact_path


class FleetSanitizer:
    """Per-simulation invariant checker, threaded through one engine run.

    Args:
        engine: ``"fleet"`` / ``"fleet_vec"`` / ``"single"`` (artifact tag).
        method: the method being simulated (artifact tag).
        scenario: the resolved scenario dict (``Scenario.to_dict()``), echoed
            into the repro artifact so a failure replays from the artifact
            alone; ``None`` for imperative callers.
        artifact_dir: where to write repro artifacts (default
            ``results/sanitizer``).
    """

    #: Full books audits run every this-many heap events (plus once at the
    #: end) — every event would turn O(n log n) runs quadratic.
    BOOKS_EVERY = 4096

    def __init__(self, engine: str, method: str,
                 scenario: Optional[Dict[str, Any]] = None,
                 artifact_dir: Optional[str] = None):
        self.engine = engine
        self.method = method
        self.scenario = scenario
        self.artifact_dir = artifact_dir or DEFAULT_ARTIFACT_DIR
        self._last_event: Optional[Tuple[float, int, int]] = None
        self._n_events = 0

    # ------------------------------------------------------------- failure
    def fail(self, invariant: str, message: str, *,
             event: Optional[Dict[str, Any]] = None,
             counters: Optional[Dict[str, Any]] = None) -> None:
        """Write the repro artifact and raise :class:`SanitizeError`."""
        payload = {
            "sanitizer_schema_version": SANITIZER_SCHEMA_VERSION,
            "invariant": invariant,
            "message": message,
            "engine": self.engine,
            "method": self.method,
            "scenario": self.scenario,
            "event": event,
            "counters": counters,
            "n_events_processed": self._n_events,
        }
        blob = json.dumps(payload, sort_keys=True, indent=1, default=str)
        digest = hashlib.sha256(blob.encode()).hexdigest()[:16]
        path: Optional[str] = os.path.join(self.artifact_dir,
                                           f"{digest}.json")
        try:
            os.makedirs(self.artifact_dir, exist_ok=True)
            with open(path, "w") as f:
                f.write(blob + "\n")
        except OSError:
            path = None
        where = f" (repro artifact: {path})" if path else ""
        raise SanitizeError(
            f"[repro-san/{invariant}] {self.engine}/{self.method}: "
            f"{message}{where}", artifact_path=path)

    # ------------------------------------------------------------ event loop
    def check_event(self, t: float, kind: int, seq: int) -> bool:
        """Validate one heap pop against the ``(time, kind, seq)`` total
        order; returns True when a periodic books audit is due."""
        self._n_events += 1
        ev = {"t": t, "kind": int(kind), "seq": int(seq)}
        if not np.isfinite(t) or t < 0:
            self.fail("event-order",
                      f"event time {t!r} is negative or non-finite",
                      event=ev)
        cur = (t, int(kind), int(seq))
        if self._last_event is not None and cur <= self._last_event:
            self.fail("event-order",
                      f"heap popped {cur} after {self._last_event}: the "
                      f"(time, kind, seq) total order went backwards",
                      event=ev)
        self._last_event = cur
        return self._n_events % self.BOOKS_EVERY == 0

    def check_service(self, *, start: float, req_t: float, prev_busy: float,
                      busy_until: float, worker: int, fn: int) -> None:
        """Validate one service start: nonnegative wait, and the instance's
        ``busy_until`` never regresses (no double-booking, no negative
        service time)."""
        ev = {"t": start, "req_t": req_t, "worker": worker, "fn": fn,
              "prev_busy_until": prev_busy, "busy_until": busy_until}
        if start < req_t:
            self.fail("negative-wait",
                      f"request arriving at t={req_t} started service at "
                      f"t={start}, before it arrived", event=ev)
        if start < prev_busy:
            self.fail("busy-regression",
                      f"instance (worker {worker}, fn {fn}) started a new "
                      f"request at t={start} while busy until "
                      f"t={prev_busy}", event=ev)
        if busy_until < start:
            self.fail("busy-regression",
                      f"instance (worker {worker}, fn {fn}) computed "
                      f"busy_until={busy_until} < start={start}: negative "
                      f"service time", event=ev)

    # ----------------------------------------------------------------- books
    def check_books(self, workers, cluster=None) -> None:
        """Audit every capacity ledger and the shared cluster tier."""
        for w in workers:
            ledger = w.ledger
            recomputed = sum(e.nbytes for e in ledger.entries.values())
            if ledger.used_bytes() != recomputed:
                self.fail("ledger-books",
                          f"worker {w.idx} ledger books do not balance: "
                          f"tracked {ledger.used_bytes()} bytes, entries "
                          f"sum to {recomputed}",
                          event={"worker": w.idx})
            for key, e in ledger.entries.items():
                if e.nbytes < 0 or e.refcount < 0:
                    self.fail("ledger-books",
                              f"worker {w.idx} ledger entry {key!r} has "
                              f"nbytes={e.nbytes}, refcount={e.refcount}",
                              event={"worker": w.idx, "key": key})
        if cluster is None:
            return
        held = set(cluster.holders)
        resident = set(cluster.ledger.entries)
        if held != resident:
            self.fail("cluster-books",
                      f"shared-tier holder sets and ledger disagree: "
                      f"holders-only {sorted(held - resident)}, "
                      f"ledger-only {sorted(resident - held)}")
        by_idx = {w.idx: w for w in workers}
        for key, holders in cluster.holders.items():
            if not holders:
                self.fail("cluster-books",
                          f"shared tier lists {key!r} with an empty holder "
                          f"set (the last worker_evicted should have "
                          f"dropped it)", event={"key": key})
            for idx in holders:
                w = by_idx.get(idx)
                if w is None or not w.ledger.holds(key):
                    self.fail("cluster-books",
                              f"shared tier says worker {idx} holds "
                              f"{key!r} but its pool does not",
                              event={"worker": idx, "key": key})

    # -------------------------------------------------------------- counters
    def check_counters(self, res) -> None:
        """The counter conservation laws (docs/SIMULATION.md) over a final
        ``FleetResult``."""
        snap = {name: getattr(res, name) for name in _NONNEG_COUNTERS
                if hasattr(res, name)}
        for name, value in snap.items():
            if value < 0:
                self.fail("counter-conservation",
                          f"counter {name} is negative: {value}",
                          counters=snap)
        n_inv = res.n_invocations
        starts = res.n_cold + res.n_warm
        requeued = getattr(res, "requeued", 0)
        if requeued == 0 and starts != n_inv:
            self.fail("counter-conservation",
                      f"service conservation violated: n_cold + n_warm = "
                      f"{starts} != n_invocations = {n_inv} with nothing "
                      f"requeued", counters=snap)
        if not (n_inv <= starts <= n_inv + requeued):
            self.fail("counter-conservation",
                      f"service conservation violated: n_invocations = "
                      f"{n_inv} <= n_cold + n_warm = {starts} <= "
                      f"n_invocations + requeued = {n_inv + requeued} "
                      f"does not hold", counters=snap)
        if res.n_queued > n_inv:
            self.fail("counter-conservation",
                      f"n_queued = {res.n_queued} exceeds n_invocations = "
                      f"{n_inv}", counters=snap)
        tiers = (res.cache_local_hits + res.cache_remote_hits
                 + res.cache_misses)
        if tiers > res.n_cold:
            self.fail("counter-conservation",
                      f"cache tier accesses ({tiers}) exceed cold starts "
                      f"({res.n_cold}): every tier classification belongs "
                      f"to one cold start", counters=snap)
        if res.prewarm_hits > res.prewarm_spawns:
            self.fail("counter-conservation",
                      f"prewarm_hits = {res.prewarm_hits} exceeds "
                      f"prewarm_spawns = {res.prewarm_spawns}",
                      counters=snap)
        if res.worker_recoveries > res.worker_failures:
            self.fail("counter-conservation",
                      f"worker_recoveries = {res.worker_recoveries} "
                      f"exceeds worker_failures = {res.worker_failures}",
                      counters=snap)
        if requeued and res.worker_failures == 0:
            self.fail("counter-conservation",
                      f"requeued = {requeued} with zero worker failures",
                      counters=snap)
        for name in ("total_latency_s", "queue_delay_s"):
            v = float(getattr(res, name))
            if not np.isfinite(v) or v < 0:
                self.fail("counter-conservation",
                          f"{name} is negative or non-finite: {v!r}",
                          counters=snap)
        if res.queue_delay_s > res.total_latency_s:
            self.fail("counter-conservation",
                      f"queue_delay_s = {res.queue_delay_s} exceeds "
                      f"total_latency_s = {res.total_latency_s}: latency "
                      f"includes every queue wait", counters=snap)

    def check_samples(self, samples: np.ndarray,
                      waits: np.ndarray) -> None:
        """Finite, nonnegative sample arrays with elementwise
        ``latency >= wait``."""
        for name, arr in (("latency", samples), ("wait", waits)):
            if arr.size and not np.isfinite(arr).all():
                idx = int(np.flatnonzero(~np.isfinite(arr))[0])
                self.fail("sample-domain",
                          f"{name} sample {idx} is non-finite "
                          f"({arr[idx]!r})", event={"index": idx})
        if waits.size and bool((waits < 0).any()):
            idx = int(np.flatnonzero(waits < 0)[0])
            self.fail("sample-domain",
                      f"wait sample {idx} is negative ({waits[idx]!r})",
                      event={"index": idx, "wait_s": float(waits[idx])})
        if samples.size and bool((samples < waits).any()):
            idx = int(np.flatnonzero(samples < waits)[0])
            self.fail("sample-domain",
                      f"latency sample {idx} ({samples[idx]!r}) is below "
                      f"its queue wait ({waits[idx]!r})",
                      event={"index": idx})

    # ------------------------------------------------------- single engine
    def check_single(self, res) -> None:
        """Light post-run checks for the single-worker engine (no requeue,
        no ledgers): exact service conservation and finite totals."""
        if res.n_cold + res.n_warm != res.n_invocations:
            self.fail("counter-conservation",
                      f"service conservation violated: n_cold + n_warm = "
                      f"{res.n_cold + res.n_warm} != n_invocations = "
                      f"{res.n_invocations}")
        for name in ("n_invocations", "n_cold", "n_warm", "memory_bytes"):
            if getattr(res, name) < 0:
                self.fail("counter-conservation",
                          f"counter {name} is negative: "
                          f"{getattr(res, name)}")
        v = float(res.total_latency_s)
        if not np.isfinite(v) or v < 0:
            self.fail("counter-conservation",
                      f"total_latency_s is negative or non-finite: {v!r}")
