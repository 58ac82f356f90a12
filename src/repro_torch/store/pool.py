"""PagePool: capacity-accounted residency for content-addressed KV pages
(the reference store's pool, unchanged: it holds pages, whatever they hold).

The pool is a byte-budgeted dict of ``Page``s with three extra behaviors
the serving path needs:

  * **Eviction** — inserting past ``capacity_bytes`` evicts unpinned
    resident pages until the newcomer fits, choosing victims through a
    pluggable policy (``EVICTION_POLICIES``): "lru" (least recently
    touched first) or "priority" (lowest priority first, LRU within a
    tie).  A policy is just ``victim(pool) -> page_id``; register new
    ones with ``register_eviction_policy``.
  * **Pinning** — in-flight requests pin the pages their block table
    references (refcounted: pin twice, unpin twice).  A pinned page is
    never evicted; if eviction cannot free enough unpinned bytes the
    insert raises ``PoolFullError`` rather than silently dropping KV a
    live request still needs.
  * **Stats** — hits / misses (counted by ``missing``, the dedup query),
    evictions, and insert counts, for the dedup benchmarks and the
    session's ``dedup_summary``.
"""
from __future__ import annotations

from collections import OrderedDict
from typing import Callable, Dict, Iterable, List, Optional

from repro_torch.store.paging import Page


class PagePoolError(RuntimeError):
    """Base for pool misuse (unknown page, unbalanced unpin, ...)."""


class PoolFullError(PagePoolError):
    """Capacity exceeded and every resident page is pinned — nothing can
    be evicted to make room."""


# policy name -> victim chooser: (pool) -> page_id of an UNPINNED resident
# page (the pool guarantees at least one exists when it asks)
EVICTION_POLICIES: Dict[str, Callable[["PagePool"], str]] = {}


def register_eviction_policy(name: str):
    """Decorator registering a victim-choosing policy under ``name``."""
    def deco(fn: Callable[["PagePool"], str]):
        EVICTION_POLICIES[name] = fn
        return fn
    return deco


@register_eviction_policy("lru")
def _lru_victim(pool: "PagePool") -> str:
    """Least recently touched unpinned page (insertion/touch order)."""
    for pid in pool._pages:            # OrderedDict: oldest touch first
        if not pool.pins.get(pid):
            return pid
    raise PoolFullError("no unpinned page to evict")


@register_eviction_policy("priority")
def _priority_victim(pool: "PagePool") -> str:
    """Lowest-priority unpinned page; LRU breaks ties (iteration order of
    the OrderedDict is oldest-touch-first, and min() keeps the first of
    equal keys)."""
    best: Optional[str] = None
    best_p = None
    for pid in pool._pages:
        if pool.pins.get(pid):
            continue
        p = pool.priority.get(pid, 0.0)
        if best is None or p < best_p:
            best, best_p = pid, p
    if best is None:
        raise PoolFullError("no unpinned page to evict")
    return best


class PagePool:
    """A byte-budgeted, evicting, pin-refcounted page residency set."""

    def __init__(self, capacity_bytes: int = 1 << 30,
                 policy: str = "lru") -> None:
        if policy not in EVICTION_POLICIES:
            raise ValueError(f"unknown eviction policy {policy!r}; "
                             f"one of {sorted(EVICTION_POLICIES)}")
        self.capacity_bytes = int(capacity_bytes)
        self.policy = policy
        self._pages: "OrderedDict[str, Page]" = OrderedDict()
        self.pins: Dict[str, int] = {}
        self.priority: Dict[str, float] = {}
        self.used_bytes = 0
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self.inserts = 0

    # -- residency ----------------------------------------------------------
    def __contains__(self, page_id: str) -> bool:
        return page_id in self._pages

    def __len__(self) -> int:
        return len(self._pages)

    def ids(self) -> List[str]:
        """Resident page IDs, oldest touch first (the LRU order)."""
        return list(self._pages)

    def missing(self, page_ids: Iterable[str]) -> List[str]:
        """The dedup query: which of ``page_ids`` are NOT resident —
        deduplicated, in first-seen order (what a sender must actually
        ship).  Counts a hit per resident reference and a miss per novel
        unique page."""
        need: List[str] = []
        seen = set()
        for pid in page_ids:
            if pid in self._pages:
                self.hits += 1
            elif pid not in seen:
                self.misses += 1
                seen.add(pid)
                need.append(pid)
        return need

    def get(self, page_id: str) -> Page:
        """Fetch a resident page (touches its LRU position)."""
        try:
            self._pages.move_to_end(page_id)
            return self._pages[page_id]
        except KeyError:
            raise PagePoolError(f"page {page_id!r} is not resident "
                                "(evicted or never inserted)") from None

    # -- insertion + eviction ----------------------------------------------
    def put(self, page: Page, *, priority: float = 0.0,
            pin: bool = False) -> bool:
        """Insert (or touch) one page; returns True when the page was
        novel.  ``pin=True`` takes a pin ref atomically with the insert,
        so a just-inserted page cannot be evicted by the very next ``put``
        of the same block table.  Eviction runs before the insert when the
        newcomer would overflow ``capacity_bytes``."""
        pid = page.page_id
        if pid in self._pages:
            self._pages.move_to_end(pid)
            self.priority[pid] = max(self.priority.get(pid, 0.0), priority)
            if pin:
                self.pins[pid] = self.pins.get(pid, 0) + 1
            return False
        need = page.nbytes
        if need > self.capacity_bytes:
            raise PoolFullError(
                f"page {pid!r} ({need} B) exceeds the pool capacity "
                f"({self.capacity_bytes} B)")
        while self.used_bytes + need > self.capacity_bytes:
            self._evict_one()
        self._pages[pid] = page
        self.priority[pid] = priority
        self.used_bytes += need
        self.inserts += 1
        if pin:
            self.pins[pid] = self.pins.get(pid, 0) + 1
        return True

    def _evict_one(self) -> None:
        if not any(not self.pins.get(pid) for pid in self._pages):
            raise PoolFullError(
                f"pool over capacity ({self.used_bytes} used / "
                f"{self.capacity_bytes} B) with every page pinned")
        victim = EVICTION_POLICIES[self.policy](self)
        self._drop(victim)
        self.evictions += 1

    def _drop(self, page_id: str) -> None:
        page = self._pages.pop(page_id)
        self.used_bytes -= page.nbytes
        self.pins.pop(page_id, None)
        self.priority.pop(page_id, None)

    # -- pinning ------------------------------------------------------------
    def pin(self, page_ids: Iterable[str]) -> None:
        """Take one pin ref per REFERENCE (a table listing a page twice
        pins it twice — release symmetrically)."""
        ids = list(page_ids)
        absent = [pid for pid in ids if pid not in self._pages]
        if absent:
            raise PagePoolError(
                f"cannot pin non-resident page(s) {absent[:3]!r}...")
        for pid in ids:
            self.pins[pid] = self.pins.get(pid, 0) + 1

    def unpin(self, page_ids: Iterable[str]) -> None:
        for pid in page_ids:
            n = self.pins.get(pid, 0)
            if n <= 0:
                raise PagePoolError(
                    f"unbalanced unpin of page {pid!r} (refcount 0)")
            if n == 1:
                self.pins.pop(pid)
            else:
                self.pins[pid] = n - 1

    def pinned_bytes(self) -> int:
        return sum(self._pages[pid].nbytes for pid in self.pins
                   if pid in self._pages)

    # -- stats --------------------------------------------------------------
    def stats(self) -> dict:
        total = self.hits + self.misses
        return {
            "pages": len(self._pages),
            "used_bytes": self.used_bytes,
            "capacity_bytes": self.capacity_bytes,
            "pinned_bytes": self.pinned_bytes(),
            "hits": self.hits,
            "misses": self.misses,
            "hit_rate": (self.hits / total) if total else 0.0,
            "evictions": self.evictions,
            "inserts": self.inserts,
        }
