"""Typed discrete-event core for the fleet simulator (``core/fleet.py``).

Port of ``repro.core.events``: the same code with the imports pointed at the
port, so every sample, counter and float sum is bit-identical.

The fleet engine is a single time-ordered queue of four event kinds plus the
(pre-sorted, vectorized) merged arrival stream.  Arrivals never enter the
heap — ``fleet.py`` merges the sorted arrival arrays against the heap head —
so per-event work stays O(log n) no matter how many invocations a trace has.

Tie-breaking at equal timestamps is load-bearing and encoded in the
``EventKind`` integer values:

  1. ``INSTANCE_FREE``    — a completing request frees its instance *before*
     anything else at that instant, so an arrival (or queued request) at
     exactly the completion time sees an idle instance (warm, no wait);
  2. ``PREWARM_SPAWN``    — a predictive pre-warm lands before the arrival it
     anticipates;
  3. (arrivals)           — merged in here from the sorted trace arrays;
  4. ``KEEPALIVE_EXPIRY`` — an arrival at exactly the expiry instant is still
     warm (``simulate()``'s ``t <= expiry`` contract).

Disruption events (``core/disruption.py``) rank strictly AFTER every
fair-weather kind at the same instant — new kinds are **appended** at ranks
>= 4 so the documented [0, 1, 2, 3] tie-break above never renumbers:

  5. ``WORKER_FAIL``      — a worker dying at ``t`` lets arrivals and
     expiries at exactly ``t`` resolve first (a request arriving the instant
     a worker fails is served or queued under fair weather, then disrupted);
  6. ``WORKER_RECOVER``   — likewise, and a same-instant fail+recover pair
     resolves fail-first (it was authored as a downtime of zero);
  7. ``CACHE_FLUSH``      — an eviction storm at ``t`` evicts after every
     same-instant cold start already admitted its image.

Within one (time, kind) bucket, insertion order wins (FIFO).
"""
from __future__ import annotations

import heapq
import itertools
from dataclasses import dataclass
from enum import IntEnum
from typing import Any, Optional, Tuple


class EventKind(IntEnum):
    """Heap tie-break order at equal timestamps (see module docstring).

    Ranks [0, 3] are the documented fair-weather tie-break and are pinned by
    ``tests/test_sim_properties.py``; new kinds must be appended at >= 4.
    """
    INSTANCE_FREE = 0
    PREWARM_SPAWN = 1
    ARRIVAL = 2            # never heaped; used as the merge-comparison rank
    KEEPALIVE_EXPIRY = 3
    WORKER_FAIL = 4        # disruption: kill a worker (core/disruption.py)
    WORKER_RECOVER = 5     # disruption: the worker returns, pool empty
    CACHE_FLUSH = 6        # disruption: fleet-wide shared-image eviction storm


@dataclass(frozen=True, slots=True)
class Event:
    time: float            # minutes
    kind: EventKind
    payload: Any = None


class EventQueue:
    """Min-heap of events, ordered by (time, kind, insertion seq).

    Payloads are never compared: the insertion sequence number is a unique
    tie-break, so arbitrary (unorderable) payload objects are fine.

    Heap records are plain ``(time, kind_int, seq, payload)`` tuples — the
    fleet engine's hot loop uses :meth:`pop_raw` (and reads :attr:`heap`
    directly for its merge comparison) so a million-event run never
    constructs an :class:`Event` or an ``EventKind`` per pop; :meth:`pop`
    wraps the same record for callers that want the typed view.
    """

    __slots__ = ("heap", "_seq")

    def __init__(self) -> None:
        #: The underlying heap list of ``(time, kind_int, seq, payload)``
        #: records; read-only for callers (the engine peeks ``heap[0]``).
        self.heap: list = []
        self._seq = itertools.count()

    def push(self, time: float, kind: int, payload: Any = None) -> None:
        """Schedule an event.

        Args:
            time: firing time in simulation **minutes**.
            kind: event type (an :class:`EventKind` or its integer value);
                the integer is the equal-time tie-break rank (see the
                module docstring).
            payload: opaque data handed back on :meth:`pop`; never compared.
        """
        heapq.heappush(self.heap, (time, int(kind), next(self._seq), payload))

    def pop(self) -> Event:
        """Remove and return the earliest event (by time, then kind, then
        insertion order). Raises ``IndexError`` when empty."""
        time, kind, _, payload = heapq.heappop(self.heap)
        return Event(time, EventKind(kind), payload)

    def pop_raw(self) -> Tuple[float, int, int, Any]:
        """Remove and return the earliest raw heap record
        ``(time_minutes, kind_int, seq, payload)`` without wrapping it —
        the allocation-free form the fleet engine's event loop consumes."""
        return heapq.heappop(self.heap)

    def peek_key(self) -> Optional[Tuple[float, int]]:
        """``(time_minutes, kind_rank)`` of the earliest event, or ``None``
        when empty — the comparison key the fleet engine merges the sorted
        arrival stream against."""
        if not self.heap:
            return None
        return (self.heap[0][0], self.heap[0][1])

    def __len__(self) -> int:
        return len(self.heap)

    def __bool__(self) -> bool:
        return bool(self.heap)
