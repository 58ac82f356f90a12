"""Replica registry: the fabric's handle on one kv_server endpoint.

A ``Replica`` wraps everything the router needs to know about a single
receiver process: how to dial it (a lazily-built ``KVClient`` over a
``SocketChannel`` factory), whether it is currently trusted (a per-peer
``CircuitBreaker``), what it last reported about itself (the
``HealthSnapshot`` parsed from a v2 ``health_ack``), and whether WE have
severed it (``partition``/``heal`` — the client-side network-partition
simulation the chaos harness flips).

A ``ReplicaSet`` is the ordered fleet: iteration order is replica-id
order, which is what makes every router decision (and every chaos replay)
deterministic.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Callable, Dict, FrozenSet, Iterator, List, Optional

from repro_torch.comm.remote import (ChannelClosedError, RemoteProtocolError,
                               SocketChannel, parse_health_meta)
from repro_torch.comm.resilience import CircuitBreaker
from repro_torch.launch.remote_serve import KVClient


@dataclass(frozen=True)
class HealthSnapshot:
    """One parsed ``health_ack``: the routing signals a replica reported,
    stamped with WHEN we heard them (monotonic clock — staleness is a
    scoring penalty, not a parse error).  Built through
    ``remote.parse_health_meta``, so a v1 payload from an old server
    yields a valid snapshot with empty/zero routing fields — the
    mixed-version fleet just scores that replica on load-free defaults."""
    replica_id: str
    at: float                       # monotonic stamp of the probe
    answered: int = 0
    prefix_installed: bool = False
    page_ids: FrozenSet[str] = frozenset()
    pages: int = 0                  # resident page count
    capacity_bytes: int = 0
    used_bytes: int = 0
    hit_rate: float = 0.0
    queue_depth: int = 0
    slots_capacity: int = 0
    slots_occupied: int = 0

    @classmethod
    def from_meta(cls, replica_id: str, meta: Dict, *,
                  at: float) -> "HealthSnapshot":
        h = parse_health_meta(meta)
        pool = h["pool"] or {}
        return cls(
            replica_id=replica_id, at=at,
            answered=h["answered"],
            prefix_installed=h["prefix_installed"],
            page_ids=frozenset(h["page_ids"]),
            pages=int(pool.get("pages", 0) or 0),
            capacity_bytes=int(pool.get("capacity_bytes", 0) or 0),
            used_bytes=int(pool.get("used_bytes", 0) or 0),
            hit_rate=float(pool.get("hit_rate", 0.0) or 0.0),
            queue_depth=h["queue_depth"],
            slots_capacity=h["slots"]["capacity"],
            slots_occupied=h["slots"]["occupied"])

    @property
    def occupancy(self) -> float:
        """Fraction of connection slots in use (0 when capacity unknown —
        a v1 server reports none and pays no load penalty for it)."""
        if self.slots_capacity <= 0:
            return 0.0
        return self.slots_occupied / self.slots_capacity


class Replica:
    """One kv_server endpoint: lazy client, breaker, last snapshot.

    The ``KVClient`` is built on first use and rebuilt after
    ``disconnect`` — a failed replica costs one dial per failover
    attempt, never a held-open dead socket.  ``partition`` severs the
    live connection AND poisons the factory (reconnects raise
    ``ChannelClosedError``) until ``heal``; from the router's seat a
    partitioned replica is indistinguishable from a dead one, which is
    the point."""

    def __init__(self, replica_id: str, host: str, port: int, *,
                 policy=None, breaker: Optional[CircuitBreaker] = None,
                 connect_timeout_s: float = 1.0,
                 io_timeout_s: Optional[float] = 10.0,
                 clock: Callable[[], float] = time.monotonic) -> None:
        # NOTE: ``SocketChannel.connect`` retries a refused dial until its
        # deadline (it exists to wait out server startup) — so this
        # timeout IS the failover latency floor when a replica is dead.
        # Keep it short; the fleet's answer to a slow peer is the next
        # replica, not a patient dial.
        self.replica_id = str(replica_id)
        self.host = host
        self.port = port
        self.policy = policy
        self.breaker = breaker if breaker is not None else CircuitBreaker()
        self.connect_timeout_s = connect_timeout_s
        self.io_timeout_s = io_timeout_s
        self._clock = clock
        self.partitioned = False
        self.snapshot: Optional[HealthSnapshot] = None
        self._client: Optional[KVClient] = None

    # -- connection lifecycle -----------------------------------------------
    def _factory(self) -> SocketChannel:
        if self.partitioned:
            raise ChannelClosedError(
                f"replica {self.replica_id!r} is partitioned")
        return SocketChannel.connect(self.host, self.port,
                                     timeout_s=self.connect_timeout_s,
                                     io_timeout_s=self.io_timeout_s)

    @property
    def client(self) -> KVClient:
        if self._client is None:
            self._client = KVClient(self._factory(),
                                    channel_factory=self._factory,
                                    policy=self.policy)
        return self._client

    def disconnect(self) -> None:
        """Drop the live connection (if any) WITHOUT a shutdown frame —
        the next operation dials fresh.  What the router does after any
        failure, and what ``partition`` does to a healthy link."""
        if self._client is not None:
            try:
                self._client.channel.close()
            except (RemoteProtocolError, OSError):
                pass
            self._client = None

    def close(self) -> None:
        """Polite teardown: send the shutdown frame, then drop."""
        if self._client is not None:
            try:
                self._client.close()
            except (RemoteProtocolError, OSError):
                pass
            self._client = None

    # -- chaos hooks ---------------------------------------------------------
    def partition(self) -> None:
        self.partitioned = True
        self.disconnect()

    def heal(self) -> None:
        self.partitioned = False

    # -- health --------------------------------------------------------------
    def probe(self) -> HealthSnapshot:
        """One health round trip, breaker-accounted: success refreshes
        ``snapshot`` (and closes a half-open breaker), failure records on
        the breaker, drops the connection, and re-raises."""
        try:
            meta = self.client.probe()
        except (RemoteProtocolError, OSError):
            self.breaker.record_failure()
            self.disconnect()
            raise
        self.breaker.record_success()
        self.snapshot = HealthSnapshot.from_meta(self.replica_id, meta,
                                                 at=self._clock())
        return self.snapshot


class ReplicaSet:
    """The fleet, ordered by replica id.  Registry only — scoring lives in
    the router, lifecycle in the chaos harness."""

    def __init__(self, replicas: Optional[List[Replica]] = None) -> None:
        self._by_id: Dict[str, Replica] = {}
        for r in replicas or []:
            self.add(r)

    def add(self, replica: Replica) -> Replica:
        if replica.replica_id in self._by_id:
            raise ValueError(
                f"duplicate replica id {replica.replica_id!r}")
        self._by_id[replica.replica_id] = replica
        return replica

    def __getitem__(self, replica_id: str) -> Replica:
        return self._by_id[replica_id]

    def __contains__(self, replica_id: str) -> bool:
        return replica_id in self._by_id

    def __len__(self) -> int:
        return len(self._by_id)

    def __iter__(self) -> Iterator[Replica]:
        for rid in sorted(self._by_id):
            yield self._by_id[rid]

    def ids(self) -> List[str]:
        return sorted(self._by_id)

    def probe_all(self) -> Dict[str, Optional[HealthSnapshot]]:
        """Probe every replica, swallowing per-replica failures (the
        breaker records them); a dead replica maps to None."""
        out: Dict[str, Optional[HealthSnapshot]] = {}
        for r in self:
            try:
                out[r.replica_id] = r.probe()
            except (RemoteProtocolError, OSError):
                out[r.replica_id] = None
        return out

    def close(self) -> None:
        for r in self:
            r.close()
