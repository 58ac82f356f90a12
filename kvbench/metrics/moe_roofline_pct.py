"""K5 (the grouped expert kernels, ``kernels/moe_grouped.py``) in the
traced wave: the least time the wave's routed expert work takes on the
card over K5's device time, in %. Each expert-layer call the wave needs
(the configuration's family's ``moe_calls``: live tokens only) takes the
larger of its operations (``moe_flops``) at the bf16 peak and its bytes
(``moe_bytes``: the experts it touches, its input and output rows) at
the HBM peak; a prefill's calls are bound by operations, a decode step's
by bytes. None in a configuration without experts, or where no K5 kernel
ran."""
from kvbench.peaks import peak

KERNELS = ("moe_grouped_gate_up", "moe_grouped_down")


def read(rec):
    fam = rec.cell.family
    flops, bw = (peak(rec.device_kind, "bf16_flops"),
                 peak(rec.device_kind, "hbm_bytes"))
    if rec.trace is None or not hasattr(fam, "moe_calls") or None in (
            flops, bw):
        return None
    busy = rec.trace["groups"].get("moe_roofline_pct", 0.0)
    if busy <= 0:
        return None
    model = rec.cell.model
    need = sum(max(fam.moe_flops(model, n) / flops,
                   fam.moe_bytes(model, n) / bw)
               for n in fam.moe_calls(model, rec.traced.items, rec.layers))
    return 100.0 * need / busy
