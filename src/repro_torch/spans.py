"""Spans and counters of the port's self-scheduled entry points.

A span is a named stretch of the program's host work::

    with span("repro_torch.worker_lists"):
        tables = schedule.worker_lists()
    count("h2d_bytes", n)

The operator's profiler is the switch.  With no ``torch.profiler`` recording
(``torch.autograd._profiler_enabled()`` false), ``span`` makes that one test
and returns a shared null context: no ``record_function``, no allocation, no
clock read; ``count`` makes the same test and returns.  While a profiler
records, a span enters ``torch.profiler.record_function(name)``, so it lands
among the profiler's own events on the trace's clock, and on leaving appends
a ``Span`` record to a bounded in-memory store that ``records()`` returns.
``count(name, n)`` adds ``n`` to the innermost open span's ``counts``.

Times are ``time.time_ns()``, the clock kineto stamps host events with.
Each thread keeps its own stack of open spans; a span opened with none open
is a root, and every span inside it shares its ``root``.  Torch keeps the
profiler's switch per thread, so a thread the profiler does not record (one
started from Python while it records) records no spans either.  Nothing is
written to disk.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import itertools
import threading
from time import time_ns
from typing import Dict, List, Optional

import torch

#: closed spans the store keeps, newest last (a drain makes at most six)
STORE_SIZE = 4096


@dataclasses.dataclass
class Span:
    name: str
    index: int                  # this span's id, in the order spans open
    parent: Optional[int]       # the enclosing span's index; None for a root
    root: int                   # the index of the root it lies in (its own for a root)
    start_ns: int
    end_ns: int = 0
    counts: Dict[str, int] = dataclasses.field(default_factory=dict)


_STORE: collections.deque = collections.deque(maxlen=STORE_SIZE)
_IDS = itertools.count()
_LOCAL = threading.local()
_OFF = contextlib.nullcontext()
_recording = torch.autograd._profiler_enabled


def _stack() -> List[Span]:
    try:
        return _LOCAL.stack
    except AttributeError:
        _LOCAL.stack = []
        return _LOCAL.stack


class _Open:
    """A span while a profiler records."""

    __slots__ = ("name", "_rf", "_span")

    def __init__(self, name: str):
        self.name = name

    # The clock is read before record_function's enter and after its exit,
    # which stamp the profiler's event: what they do beside their stamps (the
    # profiler's first event in a thread can take a millisecond) lies inside
    # both the event and the span.
    def __enter__(self):
        start = time_ns()
        self._rf = torch.profiler.record_function(self.name)
        self._rf.__enter__()
        stack = _stack()
        i = next(_IDS)
        up = stack[-1] if stack else None
        self._span = Span(self.name, i, up.index if up else None,
                          up.root if up else i, start)
        stack.append(self._span)

    def __exit__(self, *exc):
        try:
            self._rf.__exit__(*exc)
        finally:
            s = self._span
            s.end_ns = time_ns()
            _stack().pop()
            _STORE.append(s)
        return False


def span(name: str):
    """A context manager that records ``name`` while a profiler records."""
    if not _recording():
        return _OFF
    return _Open(name)


def count(name: str, n: int) -> None:
    """Add ``n`` to the innermost open span's ``counts[name]`` while a
    profiler records."""
    if not _recording():
        return
    stack = _stack()
    if stack:
        c = stack[-1].counts
        c[name] = c.get(name, 0) + n


def records() -> List[Span]:
    """The store's closed spans, in the order they closed."""
    return list(_STORE)
