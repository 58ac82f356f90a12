"""The dedup-aware paged wire: page_query / page_need / page_data frames.

A paged transfer replaces the monolithic ``shared_kv`` frame with three
frames over the framed codec of ``repro_torch.comm.remote``:

  sender                                   receiver (owns the PageStore)
  ------                                   -----------------------------
  page_query {xid, table meta, scales}  ->  look up the pool
                                        <-  page_need {xid, missing ids}
  page_data  {xid, missing pages}       ->  insert pages, pin the table,
                                            materialize the SharedKV

Only the pages the receiver's pool is missing ride ``page_data``. The
block-table IDs are control plane (frame overhead, not payload bytes);
int8/int4 scales are payload and counted. Page IDs and ``BlockTable.meta()``
are the reference store's, so the frames are the reference's and the two
sides interoperate.

``PagedReceiver`` is the receiver-side state machine. It re-derives every
shipped page's content hash before inserting it, so a tampered or
mis-keyed page never enters the content-addressed pool. SSM states (a
fixed-size recurrent state, which sequence-axis paging does not apply to)
ride ``page_data`` beside the pages, as the ``s{i}`` arrays and ``states``
meta block of ``repro_torch.comm.remote``.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch import resolve_device
from repro_torch.comm.remote import (PayloadMismatchError, _decode_states,
                                     _put_states, encode_frame)
from repro_torch.comm.transport import wire_has_scales, wire_spec
from repro_torch.core.types import SharedKV
from repro_torch.store.paging import (BlockTable, Page, _raw,
                                      _wire_trailing, page_id_for)
from repro_torch.store.store import PageStore

PAGE_FRAME_KINDS = ("page_query", "page_need", "page_data")


# ---------------------------------------------------------------------------
# frame encode/decode
# ---------------------------------------------------------------------------
def encode_page_query(xid: int, table: BlockTable) -> bytes:
    """The sender's opening frame: the whole block table, plus the scales
    of a quantized wire (every page's KV needs them, hit or miss)."""
    arrays: Dict[str, torch.Tensor] = {}
    if table.scales is not None:
        arrays["k@scale"] = table.scales["k"]
        arrays["v@scale"] = table.scales["v"]
    return encode_frame("page_query",
                        {"xid": int(xid), "table": table.meta()}, arrays)


def decode_page_query(meta: Dict[str, Any],
                      arrays: Dict[str, torch.Tensor]
                      ) -> Tuple[int, BlockTable]:
    try:
        xid = int(meta["xid"])
        tmeta = meta["table"]
        wire_dtype = tmeta["wire_dtype"]
    except (KeyError, TypeError, ValueError) as e:
        raise PayloadMismatchError(
            f"page_query frame meta lacks {e}") from None
    try:
        has_scales = wire_has_scales(wire_dtype)
    except ValueError as e:
        raise PayloadMismatchError(str(e)) from None
    scales = None
    if has_scales:
        try:
            scales = {p: arrays[f"{p}@scale"].float() for p in ("k", "v")}
        except KeyError as e:
            raise PayloadMismatchError(
                f"quantized page_query lacks scale array "
                f"{e.args[0]!r}") from None
    try:
        table = BlockTable.from_meta(tmeta, scales=scales)
    except (KeyError, TypeError, ValueError) as e:
        raise PayloadMismatchError(
            f"cannot rebuild BlockTable: {e}") from None
    if scales is not None:
        want = (len(table.layers), 1, 1, 1, 1)
        for part in ("k", "v"):
            if tuple(scales[part].shape) != want:
                raise PayloadMismatchError(
                    f"{part} scales shape {tuple(scales[part].shape)} != "
                    f"expected {want}")
    return xid, table


def encode_page_need(xid: int, need: Sequence[str]) -> bytes:
    return encode_frame("page_need",
                        {"xid": int(xid), "need": list(need)}, {})


def decode_page_need(meta: Dict[str, Any]) -> Tuple[int, List[str]]:
    try:
        return int(meta["xid"]), [str(p) for p in meta["need"]]
    except (KeyError, TypeError, ValueError) as e:
        raise PayloadMismatchError(
            f"page_need frame meta lacks {e}") from None


def encode_page_data(xid: int, pages: Sequence[Page], *, wire_dtype,
                     states=None, state_select=None) -> Tuple[bytes, int]:
    """Ship the missing pages (and the states). Returns ``(frame, payload
    wire bytes)``: the pages' k and v bytes plus the states' wire, what the
    analytics predict for ``pages_sent`` pages."""
    arrays: Dict[str, torch.Tensor] = {}
    specs: List[Dict[str, Any]] = []
    n_bytes = 0
    for i, pg in enumerate(pages):
        arrays[f"p{i}.k"] = pg.k
        arrays[f"p{i}.v"] = pg.v
        n_bytes += pg.nbytes
        specs.append({"id": pg.page_id, "layer": int(pg.layer),
                      "start": int(pg.start), "length": int(pg.length)})
    state_meta, state_bytes = _put_states(arrays, states, state_select,
                                          wire_dtype)
    n_bytes += state_bytes
    meta = {"xid": int(xid), "pages": specs,
            "wire_dtype": wire_spec(wire_dtype), "states": state_meta}
    return encode_frame("page_data", meta, arrays), n_bytes


def decode_page_data(meta: Dict[str, Any], arrays: Dict[str, torch.Tensor],
                     device=None) -> Tuple[int, List[Page], Any, Any, int]:
    """Returns ``(xid, pages, states, state_select, state_bytes)``, the
    states decoded onto ``device`` (the card unless the caller asks for the
    CPU) when the frame carries any. The pages' content hashes are verified
    by ``PagedReceiver.handle_data``, which holds the table defining their
    geometry and salt."""
    try:
        xid = int(meta["xid"])
        specs = meta["pages"]
        wire_dtype = meta["wire_dtype"]
        state_meta = meta["states"]
        if not isinstance(specs, list):
            raise TypeError("pages must be a list")
    except (KeyError, TypeError, ValueError) as e:
        raise PayloadMismatchError(
            f"page_data frame meta lacks {e}") from None
    pages: List[Page] = []
    for i, spec in enumerate(specs):
        try:
            k = arrays[f"p{i}.k"]
            v = arrays[f"p{i}.v"]
            pages.append(Page(page_id=str(spec["id"]),
                              layer=int(spec["layer"]),
                              start=int(spec["start"]),
                              length=int(spec["length"]), k=k, v=v))
        except (KeyError, TypeError, ValueError) as e:
            raise PayloadMismatchError(
                f"malformed page spec {i}: {e}") from None
        if k.shape != v.shape or k.dim() != 4:
            raise PayloadMismatchError(
                f"page {i} k/v must be (B, page_len, Hkv, Dh); got "
                f"{tuple(k.shape)} vs {tuple(v.shape)}")
    states, state_select, state_bytes = _decode_states(
        state_meta, arrays, wire_dtype,
        None if state_meta is None else resolve_device(device))
    return xid, pages, states, state_select, state_bytes


# ---------------------------------------------------------------------------
# the receiver-side state machine
# ---------------------------------------------------------------------------
class PagedReceiver:
    """The receiving half of the paged exchange against one ``PageStore``:
    answer ``page_query`` with the pool's missing set, then turn the
    matching ``page_data`` into a ``SharedKV`` on ``device`` (the card
    unless the caller asks for the CPU), verifying every shipped page's
    hash and geometry against the pending table before the pool sees
    it."""

    def __init__(self, store: PageStore, device=None) -> None:
        self.store = store
        self.device = resolve_device(device)
        self._pending: Dict[int, BlockTable] = {}

    def handle_query(self, meta: Dict[str, Any],
                     arrays: Dict[str, torch.Tensor]) -> bytes:
        """Process a ``page_query``; returns the ``page_need`` frame."""
        xid, table = decode_page_query(meta, arrays)
        need = self.store.pool.missing(table.all_ids())
        self._pending[xid] = table
        return encode_page_need(xid, need)

    def abort(self, xid: Optional[int] = None) -> None:
        """Forget pending exchanges (nothing is pinned at query time)."""
        if xid is None:
            self._pending.clear()
        else:
            self._pending.pop(xid, None)

    def _verify(self, table: BlockTable, pages: Sequence[Page]) -> None:
        layer_to_slot = {lyr: m for m, lyr in enumerate(table.layers)}
        for pg in pages:
            m = layer_to_slot.get(pg.layer)
            if m is None:
                raise PayloadMismatchError(
                    f"page {pg.page_id!r} names layer {pg.layer}, "
                    f"absent from the table's {table.layers}")
            slot_dt = table.slot_wire_dtype(m)
            want_shape = (table.batch, table.page_len, table.kv_heads,
                          _wire_trailing(slot_dt, table.head_dim))
            if tuple(pg.k.shape) != want_shape:
                raise PayloadMismatchError(
                    f"page {pg.page_id!r} shape {tuple(pg.k.shape)} != "
                    f"table geometry {want_shape}")
            salt = b""
            if table.scales is not None:
                salt = _raw(table.scales["k"][m]).tobytes() \
                    + _raw(table.scales["v"][m]).tobytes()
            derived = page_id_for(pg.layer, pg.start, pg.length, pg.k,
                                  pg.v, wire_dtype=slot_dt, salt=salt)
            if derived != pg.page_id:
                raise PayloadMismatchError(
                    f"page content hash mismatch: frame claims "
                    f"{pg.page_id!r}, content derives {derived!r}; "
                    "refusing to poison the pool")

    def handle_data(self, meta: Dict[str, Any],
                    arrays: Dict[str, torch.Tensor]
                    ) -> Tuple[SharedKV, BlockTable, int, int]:
        """Process a ``page_data``: insert the verified pages, pin the
        table, and return ``(shared, table, novel_bytes, state_bytes)``.
        The table stays pinned: the caller releases it."""
        xid, pages, states, state_select, state_bytes = decode_page_data(
            meta, arrays, device=self.device)
        table = self._pending.pop(xid, None)
        if table is None:
            raise PayloadMismatchError(
                f"page_data for unknown exchange {xid} "
                "(no matching page_query)")
        self._verify(table, pages)
        novel_bytes = self.store.insert_pages(table, pages)
        try:
            shared = self.store.materialize(table, device=self.device,
                                            states=states,
                                            state_select=state_select)
        except BaseException:
            self.store.release(table)
            raise
        return shared, table, novel_bytes, state_bytes
