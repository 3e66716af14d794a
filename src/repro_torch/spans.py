"""Program spans: where the port's host time goes, by phase, layer and kernel call.

A span is a named host interval, ``with span("forward"): ...``. Spans are
live while the module's flag is on (:func:`enable`) or while a
``torch.profiler`` profile records, so a profiled run carries them without a
switch of its own. Off, :func:`span` returns one shared no-op object and
records nothing: the cost is a flag read and a call.

Live, each span records ``Span(name, start_ns, end_ns, parent, invocation,
thread)`` in memory on ``time.perf_counter_ns``: ``parent`` is the name of
the span open around it on its thread (or the one a carried thread started
under, :func:`carry`), ``invocation`` the id :func:`invocation` set for the
thread. While a profiler records, the span also opens a profiler range of
its name on the calling thread, so it lands on the profiler's timeline
beside the device operations. The range is a plain host range: it adds no
event to the device's timeline. Records stay in memory until :func:`take`;
nothing is written while they gather.

:func:`phase` is a span that reads the clock even when off and keeps its
duration in ``.seconds``: the cold start's ``PhaseTimes`` come from its two
reads.
"""
from __future__ import annotations

import contextlib
import itertools
import threading
import time
from typing import Callable, List, NamedTuple, Optional

import torch
from torch.autograd import profiler as _profiler

#: the profiler's host range (no device-side copy, unlike ``record_function``)
_RANGE = torch._C._profiler._RecordFunctionFast
_NOOP = contextlib.nullcontext()


class Span(NamedTuple):
    name: str
    start_ns: int
    end_ns: int
    parent: Optional[str]          # the enclosing span's name, None at a root
    invocation: Optional[int]      # the id :func:`invocation` set, None outside one
    thread: int                    # ``threading.get_ident()`` of the recording thread


class _Thread(threading.local):
    def __init__(self):
        self.stack: List[str] = []             # names of the open spans, innermost last
        self.parent: Optional[str] = None      # the parent of a carried thread's roots
        self.invocation: Optional[int] = None


_enabled = False
_lock = threading.Lock()
_records: List[Span] = []                      # guarded-by: _lock
_thread = _Thread()
_invocation_ids = itertools.count(1)


def enable() -> None:
    global _enabled
    _enabled = True


def disable() -> None:
    global _enabled
    _enabled = False


def live() -> bool:
    """Spans record: the flag is on or a profiler records."""
    return _enabled or _profiler._is_profiler_enabled


class _Span:
    """One live span; ``seconds`` holds its duration once it has closed."""
    __slots__ = ("name", "seconds", "_start", "_parent", "_range")

    def __init__(self, name: str):
        self.name = name
        self.seconds = 0.0

    def __enter__(self):
        st = _thread
        self._parent = st.stack[-1] if st.stack else st.parent
        st.stack.append(self.name)
        self._range = None
        if _profiler._is_profiler_enabled:
            self._range = _RANGE(self.name)
            self._range.__enter__()
        self._start = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> bool:
        end = time.perf_counter_ns()
        if self._range is not None:
            self._range.__exit__(None, None, None)
        st = _thread
        st.stack.pop()
        record = Span(self.name, self._start, end, self._parent, st.invocation,
                      threading.get_ident())
        with _lock:
            _records.append(record)
        self.seconds = (end - self._start) / 1e9
        return False


class _Clock:
    """An off :func:`phase`: the two clock reads and nothing else."""
    __slots__ = ("seconds", "_start")

    def __enter__(self):
        self._start = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> bool:
        self.seconds = (time.perf_counter_ns() - self._start) / 1e9
        return False


def span(name: str):
    """A context manager recording ``name`` while spans are live."""
    return _Span(name) if _enabled or _profiler._is_profiler_enabled else _NOOP


def phase(name: str):
    """A span whose duration is kept, live or not: ``with phase(n) as p: ...``,
    then ``p.seconds``."""
    return _Span(name) if _enabled or _profiler._is_profiler_enabled else _Clock()


class _Invocation:
    __slots__ = ("_id", "_saved")

    def __init__(self, invocation_id: Optional[int]):
        self._id = invocation_id

    def __enter__(self):
        st = _thread
        self._saved = st.invocation
        if self._id is not None:
            st.invocation = self._id
        elif st.invocation is None:
            st.invocation = next(_invocation_ids)
        return st.invocation

    def __exit__(self, *exc) -> bool:
        _thread.invocation = self._saved
        return False


def invocation(invocation_id: Optional[int] = None):
    """Sets the thread's invocation id for the block: ``invocation_id``, or
    with none a fresh id unless the thread is inside an invocation already
    (a cold start's first request keeps the cold start's id)."""
    return _Invocation(invocation_id) if live() else _NOOP


def carry(fn: Callable) -> Callable:
    """``fn`` run, on whichever thread calls it, under the calling thread's
    innermost span and invocation id: a worker thread's spans then name the
    span that started it as their parent."""
    if not live():
        return fn
    st = _thread
    parent = st.stack[-1] if st.stack else st.parent
    inv = st.invocation

    def run(*args, **kwargs):
        here = _thread
        saved = here.parent, here.invocation
        here.parent, here.invocation = parent, inv
        try:
            return fn(*args, **kwargs)
        finally:
            here.parent, here.invocation = saved
    return run


def take() -> List[Span]:
    """The records gathered so far, in the order the spans closed; clears them."""
    with _lock:
        out = list(_records)
        _records.clear()
    return out
