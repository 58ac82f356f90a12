"""K1 (the ragged decode, ``kernels/ragged_decode.py``) in the traced
wave: the least time its needed bytes take at the card's HBM bandwidth
over its device time, in %. The bytes (the configuration's family's
``k1_bytes``, ``kvbench.counts.k1_bytes`` for the dense one) are the K
and V of each live row's attended positions, read once, and its query and
output rows; decode attention is bound by bytes."""
from kvbench.peaks import peak

KERNELS = ("ragged_mma_kernel", "ragged_split_kernel", "ragged_merge_kernel")


def read(rec):
    bw = peak(rec.device_kind, "hbm_bytes")
    if rec.trace is None or bw is None:
        return None
    busy = rec.trace["groups"].get("k1_roofline_pct", 0.0)
    if busy <= 0:
        return None
    need = rec.cell.family.k1_bytes(rec.cell.model, rec.traced.items,
                                    rec.layers)
    return 100.0 * need / bw / busy
