"""Stream milliseconds of the sender's prefill per admission in the
traced wave: the program's ``sender.prefill`` spans (``export_kv`` inside
``CommSession.share``) on the stream, over ``admit.count``."""
from kvbench import spans


def read(rec):
    s = spans.named(rec, "sender.prefill")
    if not s:
        return None
    return spans.per_admission(rec, spans.stream_ms(s))
