"""The host's time blocked on the card in the traced wave, as a share of
its ``Scheduler.run``, in %: the program's ``scheduler.host_read`` spans
(a lagged token read whose copy had not landed) and ``wire.host_copy``
spans (the codec's synchronising copies), on the host's clock, over the
``scheduler.run`` span."""
from kvbench import spans


def read(rec):
    root = spans.named(rec, "scheduler.run")
    if not root:
        return None
    waits = (spans.named(rec, "scheduler.host_read")
             + spans.named(rec, "wire.host_copy"))
    run = sum(spans.host_ms(s) for s in root)
    return 100.0 * sum(spans.host_ms(s) for s in waits) / run if run \
        else None
