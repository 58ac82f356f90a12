"""The program's spans and counters in the traced wave, for the readers
of the per-layer metrics that read them.

While ``torch.profiler`` records, ``Scheduler.run`` reports its spans and
counters under ``stats["trace"]`` (``repro_torch.utils.trace``): each span
with its name, ``start_ns`` and ``end_ns`` on the host's
``perf_counter_ns`` and, on the card, ``stream_ms`` between two events on
the stream. Every helper returns None where the wave has no such record
(a program without the recorder), and a stream time None where no card
timed the span.
"""
from __future__ import annotations

from typing import Dict, List, Optional


def of(rec) -> Optional[Dict]:
    """The traced wave's ``stats["trace"]``, or None."""
    if rec.traced is None:
        return None
    return rec.traced.stats.get("trace")


def named(rec, name: str) -> Optional[List[Dict]]:
    tr = of(rec)
    if tr is None:
        return None
    return [s for s in tr["spans"] if s["name"] == name]


def host_ms(span: Dict) -> float:
    return (span["end_ns"] - span["start_ns"]) * 1e-6


def counter(rec, name: str) -> Optional[int]:
    tr = of(rec)
    return None if tr is None else tr["counters"].get(name)


def stream_ms(spans: List[Dict]) -> Optional[float]:
    """The spans' stream milliseconds summed; None if any is untimed."""
    if any(s["stream_ms"] is None for s in spans):
        return None
    return float(sum(s["stream_ms"] for s in spans))


def per_admission(rec, total) -> Optional[float]:
    """``total`` over the wave's admissions (``admit.count``)."""
    n = counter(rec, "admit.count")
    if total is None or not n:
        return None
    return total / n
