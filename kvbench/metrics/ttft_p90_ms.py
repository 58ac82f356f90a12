"""90th percentile, over every request of the window, of the time from
the start of its wave's ``Scheduler.run`` to its first token read on the
host (``Completion.ttft_s``, which starts after the slot table is made)."""
import numpy as np


def read(rec):
    t = [c.ttft_s for w in rec.waves for c in w.completions.values()]
    return float(np.percentile(t, 90)) * 1e3 if t else None
