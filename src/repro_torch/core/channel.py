"""Transfer records and the analytic wire-byte counts."""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

from repro_torch.configs.base import ModelConfig


@dataclass
class TransferRecord:
    kind: str                   # "kv"
    n_bytes: int
    layers: int
    context_len: int
    wire_dtype: str = "model"   # payload dtype ("model" = compute dtype)
    latency_s: float = 0.0      # device-synced wall clock of the transfer
                                # (0.0 until a deferred stamp settles)
    # paged-store dedup accounting (zero on the unpaged path): the block
    # table referenced pages_total pages, pages_hit of them were already in
    # the receiver's pool and only pages_sent crossed; n_bytes then matches
    # kv_wire_bytes_paged at pages_sent, plus the scales
    pages_total: int = 0
    pages_sent: int = 0
    pages_hit: int = 0

    @property
    def hit_rate(self) -> float:
        """Fraction of this transfer's pages the receiver already held
        (0.0 for unpaged transfers)."""
        return (self.pages_hit / self.pages_total) if self.pages_total \
            else 0.0


# per-value wire widths, as in repro_torch.comm.transport._WIRE_BITS (core
# does not import comm)
_WIRE_BITS = {"float32": 32, "bfloat16": 16, "float16": 16, "int8": 8,
              "int4": 4}


def _plan_dtypes(plan) -> Optional[Tuple[str, ...]]:
    """A ``WirePlan``-like object (has ``.dtypes``), a ``"plan:..."`` spec or
    an iterable of wire dtype names -> the per-slot dtype tuple; None stays
    None."""
    if plan is None:
        return None
    if hasattr(plan, "dtypes"):
        return tuple(plan.dtypes)
    if isinstance(plan, str):
        body = plan[5:] if plan.startswith("plan:") else plan
        return tuple(d for d in body.split(",") if d)
    return tuple(plan)


def kv_wire_bytes(cfg: ModelConfig, batch: int, context_len: int,
                  num_layers_sent: int, itemsize: int = 2,
                  plan=None) -> int:
    """Analytic KV wire bytes (int8/int4 scales excluded). ``plan`` bills
    each slot at its own wire width (int4: half a byte per value; the even
    head_dim keeps it integral)."""
    dtypes = _plan_dtypes(plan)
    if dtypes is not None:
        per_layer_vals = (2 * batch * context_len
                          * cfg.num_kv_heads * cfg.resolved_head_dim)
        return sum(per_layer_vals * _WIRE_BITS[d] for d in dtypes) // 8
    return (2 * num_layers_sent * batch * context_len
            * cfg.num_kv_heads * cfg.resolved_head_dim * itemsize)


def kv_wire_bytes_paged(cfg: ModelConfig, batch: int, context_len: int,
                        num_layers_sent: int, *, page_len: int,
                        pages_sent=None, itemsize: int = 2,
                        plan=None) -> int:
    """Analytic wire bytes of a paged KV transfer: ``pages_sent`` pages
    (default: every page the prefix splits into, a cold pool) of
    2 * batch * page_len * Hkv * Dh values each; the tail page is padded up
    to ``page_len``. Scales and block-table IDs are not counted.

    Under ``plan`` a page is billed at its slot's width, and
    ``pages_sent`` may be a per-slot sequence; an int is only unambiguous
    at 0 or the full total."""
    pages_per_layer = -(-context_len // page_len)    # ceil
    page_vals = (2 * batch * page_len
                 * cfg.num_kv_heads * cfg.resolved_head_dim)
    dtypes = _plan_dtypes(plan)
    if dtypes is not None:
        total = len(dtypes) * pages_per_layer
        if pages_sent is None:
            per_slot = [pages_per_layer] * len(dtypes)
        elif isinstance(pages_sent, int):
            if pages_sent == 0:
                per_slot = [0] * len(dtypes)
            elif pages_sent == total:
                per_slot = [pages_per_layer] * len(dtypes)
            else:
                raise ValueError(
                    "a partial int pages_sent is ambiguous under a plan "
                    "(per-layer widths differ); pass a per-slot sequence")
        else:
            per_slot = list(pages_sent)
            if len(per_slot) != len(dtypes):
                raise ValueError(f"pages_sent has {len(per_slot)} entries "
                                 f"for a {len(dtypes)}-slot plan")
        return sum(n * page_vals * _WIRE_BITS[d]
                   for n, d in zip(per_slot, dtypes)) // 8
    total = num_layers_sent * pages_per_layer
    sent = total if pages_sent is None else pages_sent
    return sent * page_vals * itemsize
