"""Transfer records, the analytic wire-byte counts and the multi-sender
composition of §J."""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.types import SharedKV


@dataclass
class TransferRecord:
    kind: str                   # "kv" | "text" | "hidden"
    n_bytes: int
    layers: int
    context_len: int
    wire_dtype: str = "model"   # payload dtype ("model" = compute dtype)
    latency_s: float = 0.0      # device-synced wall clock of the transfer
                                # (0.0 until a deferred stamp settles)
    # the remote breakdown (RemoteTransport stamps these; in-process
    # transports leave them 0): encode and framing, channel write and read
    # back, parse and rebuild; frame_bytes is the whole frame, header and
    # checksum included, beside the payload-only n_bytes
    serialize_s: float = 0.0
    channel_s: float = 0.0
    deserialize_s: float = 0.0
    frame_bytes: int = 0
    # paged-store dedup accounting (zero on the unpaged path): the block
    # table referenced pages_total pages, pages_hit of them were already in
    # the receiver's pool and only pages_sent crossed; n_bytes then matches
    # kv_wire_bytes_paged at pages_sent, plus the scales
    pages_total: int = 0
    pages_sent: int = 0
    pages_hit: int = 0
    # channel attempts the transfer took (RemoteTransport stamps it), and
    # the DegradationEvent of the fallback rung that served it (None on the
    # primary path)
    attempts: int = 1
    degradation: Optional[object] = None

    @property
    def hit_rate(self) -> float:
        """Fraction of this transfer's pages the receiver already held
        (0.0 for unpaged transfers)."""
        return (self.pages_hit / self.pages_total) if self.pages_total \
            else 0.0


def combine_senders(shareds: List[SharedKV]) -> SharedKV:
    """§J multi-sender composition: the senders' prefixes concatenated
    along the context axis, in order. Packed views with one layer map stay
    packed (``src_layers`` kept only when every sender has the same one);
    otherwise the dense views concatenate and their selection masks are
    OR-combined."""
    if not shareds:
        raise ValueError("need at least one sender")
    base = shareds[0]
    if any(s.pos_mode != base.pos_mode for s in shareds):
        raise ValueError("senders disagree on pos_mode")
    prefix_len = sum(s.prefix_len for s in shareds)
    if all(s.is_packed for s in shareds) \
            and len({s.layers for s in shareds}) == 1:
        packed = {p: torch.cat([s.packed_kv[p] for s in shareds], dim=2)
                  for p in ("k", "v")}
        src = (base.src_layers
               if len({s.src_layers for s in shareds}) == 1 else None)
        return SharedKV(packed_kv=packed, layers=base.layers,
                        src_layers=src, select=base.select,
                        prefix_len=prefix_len, pos_mode=base.pos_mode)
    dense = [s.to_dense() for s in shareds]
    kv = {p: torch.cat([s.kv[p] for s in dense], dim=2) for p in ("k", "v")}
    select = base.select
    for s in dense[1:]:
        select = select | s.select
    return SharedKV(kv=kv, select=select, prefix_len=prefix_len,
                    pos_mode=base.pos_mode)


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
