"""The traced wave's wall time with no kernel, copy or memset running on
the card, in %."""


def read(rec):
    if rec.trace is None or not rec.trace["window_s"]:
        return None
    return 100.0 * (1.0 - rec.trace["busy_s"] / rec.trace["window_s"])
