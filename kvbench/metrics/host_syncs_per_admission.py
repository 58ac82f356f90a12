"""Blocking host waits on the card per admission in the traced wave: the
program's ``admit.host_syncs`` counter (each synchronising copy of the
wire codec, each explicit wait inside an admission) over
``admit.count``."""
from kvbench import spans


def read(rec):
    return spans.per_admission(rec, spans.counter(rec, "admit.host_syncs"))
