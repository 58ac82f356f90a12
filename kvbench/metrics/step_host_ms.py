"""Host milliseconds of one ragged step in the traced wave: the mean of
the program's ``scheduler.step`` spans on the host's clock (dispatch of
``receiver.ragged_step`` and its bookkeeping). Beside ``step_stream_ms`` it
says whether decode is paced by the host or by the card."""
from kvbench import spans


def read(rec):
    steps = spans.named(rec, "scheduler.step")
    if not steps:
        return None
    return sum(spans.host_ms(s) for s in steps) / len(steps)
