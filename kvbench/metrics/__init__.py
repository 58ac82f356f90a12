"""One reader per metric, found by the metric's name in BENCHMARK.json:
``kvbench/metrics/<name>.py``, where ``<name>`` is the part of the
metric's name before its first dot. So ``mfu_pct.<cell>``, a per-layer
entry whose ``workloads`` lists only cells added after ``mfu_pct``'s, is
read by ``mfu_pct.py``: a new cell reports an existing quantity through
an entry of its own, without an edit to the accepted entry.

A reader is ``read(rec) -> float | None`` over the run's
``kvbench.harness.Record``; None leaves the metric out of the result
line. A reader of a kernel's device time names the kernels it needs in
``KERNELS`` (substrings of kernel names); the traced wave's seconds of
those kernels reach it as ``rec.trace["groups"][<reader name>]``.
"""
