"""Spans and counters of the serving loop, on the host's clock and the
stream's, placed on the profiler's clock by one anchor.

A span is a ``with`` block that records its name, an id, its parent's id,
the request's ``rid`` (given, or else its parent's) and its start and end
on ``time.perf_counter_ns()``. A span opened with ``stream`` true also
records a timing ``torch.cuda.Event`` on the current stream at enter and at
exit; ``stream`` may instead be an ``Events`` pair the caller started
itself, which the span adopts, so that one pair times both. Stream times
are read by ``Recording.export`` only, after the run's own reads have
waited for the card: the hot path gets no synchronisation. A counter is a
named integer.

The recorder is active inside ``recording()`` and while ``torch.profiler``
records. While the profiler records, every span also opens a host event
of its own name in the profiler's trace, so the span lies on the device
trace's timeline and an idle gap under it is named after it. That event is
a plain record function, not a user annotation (``record_function``): the
profiler mirrors a user annotation onto the device's timeline as a
``gpu_user_annotation`` interval, which a reader of the device's busy time
would count as work. Each recording keeps one clock anchor, a
``(perf_counter_ns, time_ns)`` pair; the profiler's ``start_ns()`` is on
the Unix clock, so a span starts at ``start_ns - anchor[0] + anchor[1]``
there.

Inactive, a span site costs a flag read and returns a shared no-op
context, and a counter site returns at once.

    from repro_torch.utils import trace
    with trace.recording() as rec:
        completions, stats = scheduler.run(requests)
    stats["trace"]          # {"spans": [...], "counters": {...}, "anchor": [...]}
"""
from __future__ import annotations

import contextlib
import itertools
import threading
import time
from typing import Dict, Iterator, List, Optional

import torch
import torch.autograd.profiler as _profiler

# the open recording (None: the recorder is off unless the profiler records)
_REC: Optional["Recording"] = None
# a blocking host wait inside this span counts under ADMIT_SYNCS
ADMISSION = "scheduler.admit"
ADMIT_SYNCS = "admit.host_syncs"


class Events:
    """A pair of timing events on the current CUDA stream; the first is
    recorded when the pair is made, the second by ``stop``."""
    __slots__ = ("start", "end")

    def __init__(self):
        self.start = torch.cuda.Event(enable_timing=True)
        self.start.record()
        self.end = None

    def stop(self) -> None:
        if self.end is None:
            self.end = torch.cuda.Event(enable_timing=True)
            self.end.record()

    def done(self) -> bool:
        """Whether the stream has passed the second event (never blocks)."""
        return self.end is not None and self.end.query()

    def ms(self) -> float:
        """Stream milliseconds between the two events (waits for the
        second)."""
        self.end.synchronize()
        return self.start.elapsed_time(self.end)


class Span:
    """One span of a recording (see the module's docstring)."""
    __slots__ = ("rec", "name", "id", "parent", "rid", "start_ns", "end_ns",
                 "events", "_stream", "_fn")

    def __init__(self, rec: Optional["Recording"], name: str,
                 rid: Optional[int], stream):
        self.rec, self.name, self.rid, self._stream = rec, name, rid, stream
        self.id = self.parent = None
        self.start_ns = self.end_ns = 0
        self.events: Optional[Events] = None
        self._fn = None

    def __enter__(self) -> "Span":
        if _profiler._is_profiler_enabled:
            self._fn = torch._C._profiler._RecordFunctionFast(self.name)
            self._fn.__enter__()
        rec = self.rec
        if rec is not None:
            stack = rec._stack()
            if stack:
                top = stack[-1]
                self.parent = top.id
                if self.rid is None:
                    self.rid = top.rid
            self.id = next(rec._ids)
            stack.append(self)
            rec.spans.append(self)
            if isinstance(self._stream, Events):
                self.events = self._stream
            elif self._stream:
                self.events = Events()
        self.start_ns = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> bool:
        self.end_ns = time.perf_counter_ns()
        if self.events is not None:
            self.events.stop()
        if self.rec is not None:
            self.rec._stack().pop()
        if self._fn is not None:
            self._fn.__exit__(None, None, None)
            self._fn = None
        return False

    def as_dict(self) -> Dict:
        return {"name": self.name, "id": self.id, "parent": self.parent,
                "rid": self.rid, "start_ns": self.start_ns,
                "end_ns": self.end_ns,
                "stream_ms": (None if self.events is None
                              else self.events.ms())}


class _Noop:
    """The shared context of a span site while the recorder is off."""
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc) -> bool:
        return False


_NOOP = _Noop()


class Recording:
    """The spans and counters of one ``recording()``."""

    def __init__(self):
        p0 = time.perf_counter_ns()
        t = time.time_ns()
        p1 = time.perf_counter_ns()
        self.anchor = ((p0 + p1) // 2, t)
        self.spans: List[Span] = []
        self.counters: Dict[str, int] = {}
        self._ids = itertools.count(1)
        self._local = threading.local()
        self._lock = threading.Lock()

    def add(self, name: str, n: int) -> None:
        with self._lock:
            self.counters[name] = self.counters.get(name, 0) + n

    def _stack(self) -> List[Span]:
        s = getattr(self._local, "stack", None)
        if s is None:
            s = self._local.stack = []
        return s

    def in_span(self, name: str) -> bool:
        return any(s.name == name for s in self._stack())

    def mark(self):
        """A point to export from: (span count, counters then)."""
        with self._lock:
            return len(self.spans), dict(self.counters)

    def export(self, since=(0, {})) -> Dict:
        """The spans opened and the counters moved since ``mark()``, with
        each span's stream milliseconds (this waits for the card)."""
        n, before = since
        with self._lock:
            counters = dict(self.counters)
        return {"spans": [s.as_dict() for s in self.spans[n:]],
                "counters": {k: v - before.get(k, 0)
                             for k, v in counters.items()},
                "anchor": list(self.anchor)}


def summary(exported: Dict) -> Dict[str, Dict]:
    """Per span name of an ``export()``: how many, their host milliseconds
    and their stream milliseconds (None where a span was not timed on the
    stream), in order of first appearance."""
    out: Dict[str, Dict] = {}
    for s in exported["spans"]:
        row = out.setdefault(s["name"], {"count": 0, "host_ms": 0.0,
                                         "stream_ms": 0.0})
        row["count"] += 1
        row["host_ms"] += (s["end_ns"] - s["start_ns"]) * 1e-6
        if s["stream_ms"] is None or row["stream_ms"] is None:
            row["stream_ms"] = None
        else:
            row["stream_ms"] += s["stream_ms"]
    return out


def active() -> bool:
    return _REC is not None or _profiler._is_profiler_enabled


def span(name: str, rid: Optional[int] = None, stream=False):
    """A span named ``name`` (see the module's docstring); a shared no-op
    while the recorder is off."""
    if _REC is None and not _profiler._is_profiler_enabled:
        return _NOOP
    return Span(_REC, name, rid, stream)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name`` of the open recording."""
    rec = _REC
    if rec is not None:
        rec.add(name, n)


def host_sync(n: int = 1) -> None:
    """``n`` blocking host waits on the card: counted under
    ``admit.host_syncs`` where they happen inside an admission."""
    rec = _REC
    if rec is None or not n:
        return
    if rec.in_span(ADMISSION):
        rec.add(ADMIT_SYNCS, n)


@contextlib.contextmanager
def recording() -> Iterator[Recording]:
    """Record spans and counters inside the block; an enclosing recording,
    if one is open, takes them."""
    global _REC
    if _REC is not None:
        yield _REC
        return
    rec = _REC = Recording()
    try:
        yield rec
    finally:
        _REC = None


@contextlib.contextmanager
def run_recording() -> Iterator[Optional[Recording]]:
    """The recording a serving run reports from: the open one, a fresh one
    for the run while the profiler records, or None (recorder off)."""
    if _REC is None and not _profiler._is_profiler_enabled:
        yield None
        return
    with recording() as rec:
        yield rec
