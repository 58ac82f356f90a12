"""PageStore: the pool + paging facade the rest of the port talks to.

One store is one receiver-side page pool plus the fixed ``page_len`` of
every table it makes. Transports attach one (``Transport(store=...)``) to
route their KV sends through the paged path; the serving scheduler gathers
admission prefixes straight out of it.

The call cycle of a transfer:

    table, novel, novel_bytes = store.ingest(payload, ...)   # pins table
    shared = store.materialize(table, device=...)            # packed view
    ...                                                      # (in flight)
    store.release(table)                                     # unpin

``ingest`` is the dedup moment: only ``novel`` pages were inserted, the
rest were already resident, so an honest wire would have shipped
``novel_bytes``. The table's pages are pinned as they are inserted, so an
eviction during the ingest cannot tear the table being built.

Pages live on the host; ``materialize`` and ``gather_prefix`` rebuild on
``device``, the card unless the caller asks for the CPU.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.core.types import SharedKV
from repro_torch.store.paging import (BlockTable, Page, rebuild_decoded,
                                      rebuild_shared, split_payload)
from repro_torch.store.pool import PagePool, PagePoolError


@dataclass
class StoreStats:
    """A point-in-time snapshot of the store (pool stats + geometry)."""
    page_len: int
    pages: int
    used_bytes: int
    capacity_bytes: int
    pinned_bytes: int
    hits: int
    misses: int
    hit_rate: float
    evictions: int
    inserts: int


class PageStore:
    """A content-addressed paged prefix store over one ``PagePool``."""

    def __init__(self, page_len: int = 16,
                 capacity_bytes: int = 1 << 30,
                 policy: str = "lru") -> None:
        if page_len <= 0:
            raise ValueError(f"page_len must be positive, got {page_len}")
        self.page_len = int(page_len)
        self.pool = PagePool(capacity_bytes, policy=policy)

    # -- the transfer cycle -------------------------------------------------
    def ingest(self, payload, *, layers: Sequence[int],
               select: Sequence[bool], wire_dtype,
               pos_mode: str = "shift",
               src_layers: Optional[Sequence[int]] = None,
               priority: float = 0.0
               ) -> Tuple[BlockTable, List[str], int]:
        """Split a packed {"k","v"} payload (or its ``HostWire``) into
        pages and insert them.

        Returns ``(table, novel_ids, novel_bytes)``: the block table (its
        pages pinned: ``release`` it when the transfer's view is no longer
        in flight), the page IDs that were not resident yet, and their
        byte total (what a dedup-aware wire ships)."""
        table, pages = split_payload(
            payload, layers=layers, select=select, page_len=self.page_len,
            wire_dtype=wire_dtype, pos_mode=pos_mode, src_layers=src_layers)
        novel: List[str] = []
        novel_bytes = 0
        for page in pages:
            if self.pool.put(page, priority=priority, pin=True):
                novel.append(page.page_id)
                novel_bytes += page.nbytes
        return table, novel, novel_bytes

    def insert_pages(self, table: BlockTable, pages: Sequence[Page], *,
                     priority: float = 0.0) -> int:
        """Receiver half of a paged wire exchange: insert the shipped
        (novel) pages, then pin the WHOLE table, the resident pages it
        dedups against included. Returns the inserted byte count. Raises
        ``PagePoolError`` if the table references a page neither resident
        nor shipped, after rolling back every pin this call took."""
        inserted = 0
        shipped = set()
        pinned: List[str] = []
        try:
            for page in pages:
                if self.pool.put(page, priority=priority, pin=True):
                    inserted += page.nbytes
                pinned.append(page.page_id)
                shipped.add(page.page_id)
            # table IDs are distinct (the hash covers the slot and span),
            # so per-ID pinning is per-reference pinning; pool.pin checks
            # every ID before it pins any
            self.pool.pin(pid for pid in table.all_ids()
                          if pid not in shipped)
        except PagePoolError:
            for pid in pinned:
                try:
                    self.pool.unpin([pid])
                except PagePoolError:
                    pass           # evicted after our pin was dropped
            raise
        return inserted

    def materialize(self, table: BlockTable, *, device=None) -> SharedKV:
        """The packed receiver-keyed ``SharedKV`` rebuilt from resident
        pages on ``device``: bit-equal to the unpaged wire's view."""
        return rebuild_shared(table, self._resident(table), device=device)

    def gather_prefix(self, table: BlockTable, bucket_len: int, *,
                      device=None) -> Dict[str, torch.Tensor]:
        """Scheduler admission gather: the prefix rebuilt from pool pages
        into a bucket-padded (M, B, bucket_len, Hkv, Dh) stack at the
        compute dtype on ``device``, bit-equal to
        ``pad_prefix(materialize(table), bucket_len).packed_kv`` (pad
        positions are zeros, real ones decode the same wire bytes)."""
        if bucket_len < table.prefix_len:
            raise ValueError(
                f"bucket {bucket_len} < prefix_len {table.prefix_len}")
        return rebuild_decoded(table, self._resident(table),
                               out_len=bucket_len, device=device)

    def pin(self, table: BlockTable) -> None:
        """Take one extra pin ref per table reference."""
        self.pool.pin(table.all_ids())

    def release(self, table: BlockTable) -> None:
        """Drop the pin refs ``ingest``/``insert_pages``/``pin`` took."""
        self.pool.unpin(table.all_ids())

    # -- introspection ------------------------------------------------------
    def _resident(self, table: BlockTable) -> Dict[str, Page]:
        return {pid: self.pool.get(pid) for pid in set(table.all_ids())}

    def resident_ids(self, limit: Optional[int] = None) -> List[str]:
        """Resident page IDs, most recently touched LAST (the pool's LRU
        order); ``limit`` keeps only the newest that many."""
        ids = self.pool.ids()
        if limit is not None and len(ids) > limit:
            ids = ids[-limit:]
        return ids

    def stats(self) -> StoreStats:
        p = self.pool.stats()
        return StoreStats(
            page_len=self.page_len, pages=p["pages"],
            used_bytes=p["used_bytes"],
            capacity_bytes=p["capacity_bytes"],
            pinned_bytes=p["pinned_bytes"], hits=p["hits"],
            misses=p["misses"], hit_rate=p["hit_rate"],
            evictions=p["evictions"], inserts=p["inserts"])
