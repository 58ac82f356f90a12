"""Stream milliseconds of the transport per admission in the traced wave:
the program's ``transport.send`` spans (gather, the codec and its copies
to the host and back, the receiver's view) on the stream, over
``admit.count``."""
from kvbench import spans


def read(rec):
    s = spans.named(rec, "transport.send")
    if not s:
        return None
    return spans.per_admission(rec, spans.stream_ms(s))
