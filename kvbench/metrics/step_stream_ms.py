"""Stream milliseconds of one ragged step in the traced wave: the mean,
over the program's ``scheduler.step`` spans, of the time between the two
events each records on the stream (the model's decode step with K1, and
any wait of the stream for the host inside it)."""
from kvbench import spans


def read(rec):
    steps = spans.named(rec, "scheduler.step")
    if not steps:
        return None
    total = spans.stream_ms(steps)
    return None if total is None else total / len(steps)
