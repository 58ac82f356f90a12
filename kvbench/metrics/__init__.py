"""One reader per metric, found by the metric's name in BENCHMARK.json.

A reader is ``read(rec) -> float | None`` over the run's
``kvbench.harness.Record``; None leaves the metric out of the result
line. A reader of a kernel's device time names the kernels it needs in
``KERNELS`` (substrings of kernel names); the traced wave's seconds of
those kernels reach it as ``rec.trace["groups"][<metric name>]``.
"""
