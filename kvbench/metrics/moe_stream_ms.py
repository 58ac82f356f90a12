"""Stream milliseconds of the expert layer per ragged step in the traced
wave: the program's ``moe.experts`` spans (each MoE call's expert
computation, after its routing) that lie inside a ``scheduler.step``
span, summed on the stream, over the steps."""
from kvbench import spans


def read(rec):
    tr = spans.of(rec)
    if tr is None:
        return None
    by_id = {s["id"]: s for s in tr["spans"]}
    steps = {i for i, s in by_id.items() if s["name"] == "scheduler.step"}

    def in_step(s):
        while s is not None:
            if s["id"] in steps:
                return True
            s = by_id.get(s["parent"])
        return False

    moe = [s for s in tr["spans"] if s["name"] == "moe.experts"
           and in_step(s)]
    if not moe or not steps:
        return None
    total = spans.stream_ms(moe)
    return None if total is None else total / len(steps)
