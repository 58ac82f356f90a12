"""repro_torch.store — the paged prefix store of the port.

A content-addressed KV page store: every packed payload is split along the
sequence axis into fixed-size pages of its wire encoding, keyed by a hash
over (layer, span, wire bytes). A ``BlockTable`` maps a prefix to its page
grid, so two transfers that share a sender context share page IDs, and only
the pages a receiver's pool is missing are counted as moved.

  paging.py — Page / BlockTable, ``split_payload`` / ``rebuild_payload`` /
              ``rebuild_decoded`` / ``rebuild_shared``.
  pool.py   — ``PagePool``: byte-budgeted residency with LRU/priority
              eviction and pin refcounts for in-flight requests.
  store.py  — ``PageStore``: the pool + table facade transports attach to.

The reference's dedup frame protocol (``store/wire.py``) waits for the
port's remote transport.
"""
from repro_torch.store.paging import (BlockTable, Page, page_id_for,
                                      rebuild_payload, rebuild_shared,
                                      split_payload)
from repro_torch.store.pool import (EVICTION_POLICIES, PagePool,
                                    PagePoolError, PoolFullError,
                                    register_eviction_policy)
from repro_torch.store.store import PageStore, StoreStats

__all__ = [
    "BlockTable", "EVICTION_POLICIES", "Page", "PagePool", "PagePoolError",
    "PageStore", "PoolFullError", "StoreStats", "page_id_for",
    "rebuild_payload", "rebuild_shared", "register_eviction_policy",
    "split_payload",
]
