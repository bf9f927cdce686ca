"""Spans of the receiver's host work, kept in memory.

`span(name)` times a block of the receiver on `time.perf_counter()`, the
clock the benchmark's own spans and its window mark use, so that every
span can be placed against the device's trace. It records while a torch
profiler runs or inside `recording()`; otherwise it returns one shared
context that does nothing (no clock read, no allocation), and an untraced
receiver pays one check a span.

A record is `Span(name, t0, t1)`. Records from every thread go into one
bounded buffer, oldest out first; `dropped()` counts those pushed out since
the last `clear()`.

Spans never open a profiler range (`torch.profiler.record_function`): such
a range can put a record of its own on the device's timeline, and the
device's busy time and record counts must show only the receiver's work.
"""

from __future__ import annotations

import contextlib
import threading
import time
from collections import deque
from typing import NamedTuple

import torch
from torch.autograd import profiler as _autograd_profiler

CAPACITY = 1 << 16     # records kept; a traced benchmark run makes < 10^4


class Span(NamedTuple):
    name: str
    t0: float                 # time.perf_counter() seconds
    t1: float


def profiler_flag(module=_autograd_profiler):
    """A function that says whether a torch profiler runs: the autograd
    profiler's module flag, set for every thread while any profiler runs,
    or, where a torch lacks that flag, the profiler's own query, which sees
    only a profiler started on the calling thread."""
    if hasattr(module, "_is_profiler_enabled"):
        return lambda: module._is_profiler_enabled
    return torch._C._autograd._profiler_enabled


_profiling = profiler_flag()
_lock = threading.Lock()
_records: deque = deque(maxlen=CAPACITY)
_dropped = 0
_recording = 0                # open recording() blocks, all threads


class _Noop:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NOOP = _Noop()


class _Open:
    __slots__ = ("name", "t0")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        global _dropped
        rec = Span(self.name, self.t0, time.perf_counter())
        with _lock:
            if len(_records) == _records.maxlen:
                _dropped += 1
            _records.append(rec)
        return False


def span(name: str):
    """A context that records `name` over its block (see the module's
    docstring for when)."""
    if _recording or _profiling():
        return _Open(name)
    return _NOOP


@contextlib.contextmanager
def recording():
    """Record spans inside the block, in every thread, with no profiler."""
    global _recording
    with _lock:
        _recording += 1
    try:
        yield
    finally:
        with _lock:
            _recording -= 1


def spans(name: str | None = None) -> list[Span]:
    """The records kept, oldest first; only those named `name` if given."""
    with _lock:
        recs = list(_records)
    return recs if name is None else [s for s in recs if s.name == name]


def dropped() -> int:
    """Records pushed out of the full buffer since the last clear()."""
    return _dropped


def clear() -> None:
    """Empty the buffer and zero dropped()."""
    global _dropped
    with _lock:
        _records.clear()
        _dropped = 0
