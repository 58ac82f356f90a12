"""Mean slot-table occupancy of the window's ragged steps: each wave's
``Scheduler.run`` occupancy weighted by its steps, in %."""


def read(rec):
    steps = sum(w.stats["steps"] for w in rec.waves)
    if not steps:
        return None
    occ = sum(w.stats["occupancy"] * w.stats["steps"] for w in rec.waves)
    return 100.0 * occ / steps
