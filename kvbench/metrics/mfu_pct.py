"""The window's needed operations (the configuration's family's
``window_flops``, ``kvbench.counts`` for the dense one) over the window's
seconds, as a share of the card's bf16 dense peak, in %."""
from kvbench.peaks import peak


def read(rec):
    p = peak(rec.device_kind, "bf16_flops")
    if p is None or not rec.window_s:
        return None
    flops = rec.cell.family.window_flops(rec.cell.model, rec.cell.mlp,
                                         rec.items, rec.layers)
    return 100.0 * flops / (rec.window_s * p)
