"""Pages and block tables: the pure split/rebuild half of the store.

A packed payload is one {"k","v"} stack of (M, B, Sc, Hkv, Dh). The store
works on its WIRE form, the arrays ``repro_torch.comm.transport``'s codec
produces, so a page's bytes are a slice of what crosses the wire, and two
transfers of one context at one wire dtype give byte-identical pages
(int8/int4 scales are computed once over each whole layer).

``split_payload`` cuts each slot's wire arrays along the sequence axis into
(B, page_len, Hkv, Dw) pages, the last one zero-padded up to ``page_len``,
and keys each page by a blake2b-128 hash over (layer, span, geometry, wire
dtype, scale bytes, k bytes, v bytes): the same preamble and bytes as the
reference store, so the two give the same page IDs for the same payload.
Pages are host tensors (a bfloat16 page is a torch bfloat16 tensor, hashed
through its raw bytes).

The ``BlockTable`` is the control plane: the per-slot page-ID grid plus
what a receiver needs to rebuild the packed ``SharedKV``. ``meta()`` is the
reference's JSON, so a table from either side loads in the other.
``rebuild_decoded`` assembles the pages into one host buffer, uploads it
once and dequantizes on the device.
"""
from __future__ import annotations

import hashlib
import struct
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.comm.transport import (_SCALED_WIRES, _WIRE_BITS,
                                        _WIRE_DTYPES, HostWire,
                                        _decode_uniform, _wire_groups,
                                        as_wire_plan, encode_payload,
                                        resolve_wire_dtype, wire_has_scales,
                                        wire_spec)
from repro_torch.core.types import SharedKV


def _wire_torch_dtype(name: str) -> torch.dtype:
    """The dtype of a wire array: int4 is nibble-packed uint8."""
    return torch.uint8 if name == "int4" else _WIRE_DTYPES[name]


def _wire_trailing(name: str, head_dim: int) -> int:
    """The trailing (head-dim) extent of a wire array: int4 packs pairs."""
    return head_dim // 2 if name == "int4" else head_dim


def _raw(t: torch.Tensor) -> np.ndarray:
    """A host tensor's bytes, viewed without a copy when contiguous."""
    return t.contiguous().view(torch.uint8).numpy()


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).replace("torch.", "")


def page_id_for(layer: int, start: int, length: int, k: torch.Tensor,
                v: torch.Tensor, *, wire_dtype: str, salt: bytes = b"") -> str:
    """Content hash of one page: 128-bit blake2b over the (layer, span,
    geometry, wire dtype) preamble, the layer's ``salt`` (its scale bytes:
    equal codes under other scales decode differently and must not
    collide) and the page's k and v bytes."""
    h = hashlib.blake2b(digest_size=16)
    B, page_len, Hkv, Dw = k.shape
    h.update(struct.pack(">7i", layer, start, length, B, page_len, Hkv, Dw))
    h.update(wire_dtype.encode("ascii"))
    h.update(salt)
    h.update(_raw(k))
    h.update(_raw(v))
    return h.hexdigest()


@dataclass
class Page:
    """One content-addressed block: k and v of one packed layer slot's wire
    KV over positions [start, start + length), zero-padded up to the
    store's ``page_len``. ``layer`` is the receiver layer slot."""
    page_id: str
    layer: int
    start: int
    length: int                  # real positions (< page_len on the tail)
    k: torch.Tensor              # (B, page_len, Hkv, Dw) wire dtype, host
    v: torch.Tensor

    @property
    def nbytes(self) -> int:
        return int(self.k.numel() * self.k.element_size()
                   + self.v.numel() * self.v.element_size())


@dataclass(frozen=True)
class BlockTable:
    """The static description of one paged prefix: per packed slot the
    ordered page IDs covering [0, prefix_len), and what rebuilding the
    packed ``SharedKV`` needs. Only the scales are arrays (payload, counted
    in wire bytes); ``meta()`` is the rest, JSON-safe."""
    page_ids: Tuple[Tuple[str, ...], ...]   # [M][n_pages], layer order
    layers: Tuple[int, ...]                 # receiver slots
    select: Tuple[bool, ...]                # receiver selection mask
    prefix_len: int
    page_len: int
    pos_mode: str
    wire_dtype: str                         # a name or a "plan:..." spec
    compute_dtype: str
    batch: int
    kv_heads: int
    head_dim: int
    src_layers: Optional[Tuple[int, ...]] = None   # hetero provenance
    # quantized wires: {"k","v"}: (M, 1, 1, 1, 1) float32 per-layer scales;
    # under a WirePlan they span all M slots, 1.0 at the float slots
    scales: Optional[Dict[str, torch.Tensor]] = None

    @property
    def pages_per_slot(self) -> int:
        return -(-self.prefix_len // self.page_len)   # ceil

    @property
    def num_pages(self) -> int:
        return sum(len(ids) for ids in self.page_ids)

    def all_ids(self) -> List[str]:
        return [pid for ids in self.page_ids for pid in ids]

    def slot_wire_dtype(self, m: int) -> str:
        """The wire dtype of packed slot ``m``."""
        plan = as_wire_plan(self.wire_dtype)
        return self.wire_dtype if plan is None else plan.dtypes[m]

    def slot_page_nbytes(self, m: int) -> int:
        """Bytes of one of slot ``m``'s pages (k + v)."""
        vals = 2 * self.batch * self.page_len * self.kv_heads \
            * self.head_dim
        return (vals * _WIRE_BITS[self.slot_wire_dtype(m)]) // 8

    @property
    def page_nbytes(self) -> int:
        """Bytes of one page (k + v) of a uniform wire; under a plan page
        sizes differ per slot (``slot_page_nbytes``)."""
        if as_wire_plan(self.wire_dtype) is not None:
            raise ValueError("page size varies per slot under a wire "
                             "plan; use slot_page_nbytes(m)")
        return self.slot_page_nbytes(0)

    @property
    def scale_nbytes(self) -> int:
        return 0 if self.scales is None else int(
            sum(s.numel() * s.element_size() for s in self.scales.values()))

    def meta(self) -> dict:
        """JSON-safe control-plane description (scales excluded)."""
        return {
            "page_ids": [list(ids) for ids in self.page_ids],
            "layers": list(self.layers),
            "src_layers": (None if self.src_layers is None
                           else list(self.src_layers)),
            "select": [bool(b) for b in self.select],
            "prefix_len": int(self.prefix_len),
            "page_len": int(self.page_len),
            "pos_mode": self.pos_mode,
            "wire_dtype": self.wire_dtype,
            "compute_dtype": self.compute_dtype,
            "batch": int(self.batch),
            "kv_heads": int(self.kv_heads),
            "head_dim": int(self.head_dim),
        }

    @classmethod
    def from_meta(cls, meta: dict,
                  scales: Optional[Dict[str, torch.Tensor]] = None
                  ) -> "BlockTable":
        return cls(
            page_ids=tuple(tuple(ids) for ids in meta["page_ids"]),
            layers=tuple(int(i) for i in meta["layers"]),
            src_layers=(None if meta.get("src_layers") is None
                        else tuple(int(i) for i in meta["src_layers"])),
            select=tuple(bool(b) for b in meta["select"]),
            prefix_len=int(meta["prefix_len"]),
            page_len=int(meta["page_len"]),
            pos_mode=meta["pos_mode"],
            wire_dtype=meta["wire_dtype"],
            compute_dtype=meta["compute_dtype"],
            batch=int(meta["batch"]),
            kv_heads=int(meta["kv_heads"]),
            head_dim=int(meta["head_dim"]),
            scales=scales)


def _slot_wires(wire: HostWire):
    """Per-slot host wire arrays {"k","v"}: [M] of (B, Sc, Hkv, Dw), the
    per-slot wire dtypes, and the {"k","v"}: (M, 1, 1, 1, 1) float32 scales
    (None for a float wire or an empty plan)."""
    M = wire.shape[0]
    slot_dtypes: List[str] = [""] * M
    wires: Dict[str, List[Optional[torch.Tensor]]] = {"k": [None] * M,
                                                      "v": [None] * M}
    scales = None
    if wire_has_scales(wire.wire_dtype):
        scales = {p: torch.ones((M, 1, 1, 1, 1)) for p in ("k", "v")}
    for g, (dt, slots) in enumerate(wire.groups):
        for part in ("k", "v"):
            arrays = wire.arrays[part][g]
            for j, m in enumerate(slots):
                wires[part][m] = arrays[0][j]
                slot_dtypes[m] = dt
                if len(arrays) > 1:
                    scales[part][m] = arrays[1][j]
    return wires, slot_dtypes, scales


def split_payload(payload, *, layers: Sequence[int],
                  select: Sequence[bool], page_len: int, wire_dtype,
                  pos_mode: str = "shift",
                  src_layers: Optional[Sequence[int]] = None
                  ) -> Tuple[BlockTable, List[Page]]:
    """Wire-encode a packed {"k","v"} (M, B, Sc, Hkv, Dh) payload (or take
    the ``HostWire`` that ``encode_payload`` already started for it) and cut
    it into fixed-size pages.

    Returns ``(table, pages)`` with pages in table order (slot-major, then
    position); duplicate content yields one Page per occurrence (the pool
    deduplicates on insert). The encode runs once over each whole layer,
    so scales, and page bytes, do not depend on the paging. Under a plan
    each slot is encoded at its own dtype, which joins its pages' hash
    preamble."""
    wd = resolve_wire_dtype(wire_dtype)
    spec = wire_spec(wd)
    if page_len <= 0:
        raise ValueError(f"page_len must be positive, got {page_len}")
    if isinstance(payload, HostWire):
        wire = payload
        if wire_spec(wire.wire_dtype) != spec:
            raise ValueError(f"payload was encoded at "
                             f"{wire_spec(wire.wire_dtype)!r}, not {spec!r}")
    else:
        wire = encode_payload(payload, wd)
    wire.wait()
    M, B, Sc, Hkv, Dh = wire.shape
    wires, slot_dtypes, scales = _slot_wires(wire)
    n_pages = -(-Sc // page_len)
    grid: List[Tuple[str, ...]] = []
    pages: List[Page] = []
    for m in range(M):
        salt = b""
        if scales is not None:
            salt = _raw(scales["k"][m]).tobytes() \
                + _raw(scales["v"][m]).tobytes()
        ids = []
        for p in range(n_pages):
            start = p * page_len
            length = min(page_len, Sc - start)
            blk = {}
            for part in ("k", "v"):
                src = wires[part][m][:, start:start + length]
                if length == page_len:
                    blk[part] = src.clone(memory_format=torch.contiguous_format)
                else:
                    b = src.new_zeros((B, page_len) + tuple(src.shape[2:]))
                    b[:, :length] = src
                    blk[part] = b
            pid = page_id_for(int(layers[m]), start, length, blk["k"],
                              blk["v"], wire_dtype=slot_dtypes[m], salt=salt)
            pages.append(Page(page_id=pid, layer=int(layers[m]),
                              start=start, length=length,
                              k=blk["k"], v=blk["v"]))
            ids.append(pid)
        grid.append(tuple(ids))
    table = BlockTable(
        page_ids=tuple(grid), layers=tuple(int(i) for i in layers),
        src_layers=(None if src_layers is None
                    else tuple(int(i) for i in src_layers)),
        select=tuple(bool(b) for b in np.asarray(select).reshape(-1)),
        prefix_len=Sc, page_len=page_len, pos_mode=pos_mode,
        wire_dtype=spec, compute_dtype=_dtype_name(wire.compute_dtype),
        batch=B, kv_heads=Hkv, head_dim=Dh, scales=scales)
    return table, pages


def _fill(dst: Dict[str, torch.Tensor], ids, pages: Dict[str, Page],
          out_len: int) -> None:
    """Copy one slot's pages into its (B, out_len, Hkv, Dw) wire views;
    raises ``KeyError`` for a page absent from ``pages``."""
    for pid in ids:
        pg = pages[pid]
        stop = min(pg.start + pg.length, out_len)
        if stop <= pg.start:
            continue
        n = stop - pg.start
        dst["k"][:, pg.start:stop] = pg.k[:, :n]
        dst["v"][:, pg.start:stop] = pg.v[:, :n]


def rebuild_payload(table: BlockTable, pages: Dict[str, Page],
                    out_len: Optional[int] = None
                    ) -> Dict[str, torch.Tensor]:
    """Reassemble the host WIRE arrays of a uniform wire from resident
    pages: a zero-initialized (M, B, out_len, Hkv, Dw) stack per part
    (``out_len`` defaults to ``prefix_len``, which trims the tail page's
    padding: the rebuilt bytes are the pre-split wire). Raises ``KeyError``
    naming the first page ID absent from ``pages``."""
    out_len = table.prefix_len if out_len is None else out_len
    if as_wire_plan(table.wire_dtype) is not None:
        raise ValueError("wire dtypes vary per slot under a plan; the "
                         "stacked wire view does not exist; use "
                         "rebuild_decoded")
    M = len(table.page_ids)
    dw = _wire_trailing(table.wire_dtype, table.head_dim)
    out = {part: torch.zeros((M, table.batch, out_len, table.kv_heads, dw),
                             dtype=_wire_torch_dtype(table.wire_dtype))
           for part in ("k", "v")}
    for m, ids in enumerate(table.page_ids):
        _fill({p: out[p][m] for p in ("k", "v")}, ids, pages, out_len)
    return out


def _align(n: int, a: int = 16) -> int:
    return -(-n // a) * a


def rebuild_decoded(table: BlockTable, pages: Dict[str, Page],
                    out_len: Optional[int] = None, *,
                    device=None) -> Dict[str, torch.Tensor]:
    """Reassemble resident pages and decode them at the compute dtype on
    ``device`` (the card unless the caller asks for the CPU): a
    (M, B, out_len, Hkv, Dh) stack per part, zero past ``prefix_len``
    (``out_len`` larger than it is the scheduler's bucket-padded gather).

    The wire arrays and scales of both parts are assembled, grouped by
    wire dtype, in one host buffer (pinned for the card), uploaded in one
    copy and dequantized on the device, each dtype group in one pass.
    Handles uniform and plan tables alike."""
    out_len = table.prefix_len if out_len is None else out_len
    dev = resolve_device(device)
    dtype = getattr(torch, table.compute_dtype)
    M = len(table.page_ids)
    B, Hkv, Dh = table.batch, table.kv_heads, table.head_dim
    groups = _wire_groups(resolve_wire_dtype(table.wire_dtype), M)
    # byte layout of the buffer: per part, per group, the wire stack
    # (n, B, out_len, Hkv, Dw) and then its float32 scales (n, 1, 1, 1, 1)
    layout, off = [], 0
    for part in ("k", "v"):
        for dt, slots in groups:
            shape = (len(slots), B, out_len, Hkv, _wire_trailing(dt, Dh))
            wt = _wire_torch_dtype(dt)
            n = int(np.prod(shape)) * wt.itemsize
            s_off = _align(off + n)
            end = s_off + (4 * len(slots) if dt in _SCALED_WIRES else 0)
            layout.append((part, dt, slots, shape, wt, off, n, s_off))
            off = _align(end)
    buf = torch.zeros(off, dtype=torch.uint8,
                      pin_memory=dev.type == "cuda")

    def views(storage):
        for part, dt, slots, shape, wt, o, n, s_off in layout:
            w = storage[o:o + n].view(wt).view(shape)
            s = (storage[s_off:s_off + 4 * len(slots)].view(torch.float32)
                 .view(len(slots), 1, 1, 1, 1)
                 if dt in _SCALED_WIRES else None)
            yield part, dt, slots, w, s

    slot_views: Dict[int, Dict[str, torch.Tensor]] = {}
    for part, dt, slots, w, s in views(buf):
        for j, m in enumerate(slots):
            slot_views.setdefault(m, {})[part] = w[j]
            if s is not None:
                s[j] = table.scales[part][m]
    for m, ids in enumerate(table.page_ids):
        _fill(slot_views[m], ids, pages, out_len)
    dbuf = buf.to(dev, non_blocking=True)
    out = {part: torch.zeros((0, B, out_len, Hkv, Dh), dtype=dtype,
                             device=dev)
           for part in ("k", "v")} if not groups else {}
    for part, dt, slots, w, s in views(dbuf):
        arrays = (w, s) if s is not None else (w,)
        dec = _decode_uniform(arrays, dt, dtype, dev)
        if len(groups) == 1:
            out[part] = dec
            continue
        if part not in out:
            out[part] = torch.empty((M, B, out_len, Hkv, Dh), dtype=dtype,
                                    device=dev)
        for j, m in enumerate(slots):
            out[part][m] = dec[j]
    return out


def rebuild_shared(table: BlockTable, pages: Dict[str, Page], *,
                   device=None, states=None,
                   state_select=None) -> SharedKV:
    """The packed receiver-keyed ``SharedKV`` rebuilt from pages: the view
    the unpaged transport would have produced for the same transfer (the
    SSM states, which travel beside the pages, pass through)."""
    payload = rebuild_decoded(table, pages, device=device)
    return SharedKV(packed_kv=payload, layers=table.layers,
                    src_layers=table.src_layers,
                    select=torch.tensor(table.select, dtype=torch.bool),
                    states=states, state_select=state_select,
                    prefix_len=table.prefix_len, pos_mode=table.pos_mode)
