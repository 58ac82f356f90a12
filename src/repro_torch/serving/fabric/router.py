"""Health-gated affinity router: which replica serves this request?

The scoring blend (``AffinityScorer``) ranks replicas by three signals:

  affinity — fraction of the request's page ids (its ``BlockTable``,
             split ONCE sender-side via ``export_pages``) already
             resident in the replica's pool, per its last health
             snapshot.  Routing a repeat prefix back to the replica that
             holds its pages is what turns the paged dedup wire into a
             fleet-level win: the share ships ~zero bytes.
  load     — queue depth (handlers waiting on the replica's serve lock)
             and connection-slot occupancy, both straight off the v2
             health payload.
  health   — breaker state gates in TIERS (an open breaker loses to ANY
             non-open replica — quarantine is absolute, not a weight),
             half-open and stale-probe replicas pay score penalties.

Ties break on replica id, so the ranking is a pure deterministic
function of (want_ids, snapshots, breaker states, clock) — the property
the hypothesis suite pins down and the chaos replays rely on.

The ``Router`` then adds the failover rung ABOVE the session's ladder: walk
the ranking, and when a replica fails mid-request (share or generate),
re-route to the next — the share replays against the new replica's pool
through the SAME dedup handshake, so retry bytes stay bounded by what
that pool is actually missing.  Every hop is a ``DegradationEvent``.
Only when the whole fleet is exhausted does the request fall to the
local ``fallback`` session (whose own ``Resilience`` ladder may degrade
it further, down to text-only) — or raise ``FleetExhaustedError`` when
no fallback is configured.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Callable, Dict, FrozenSet, List, Optional, Sequence

import numpy as np

from repro_torch.comm.agent import Agent
from repro_torch.comm.remote import RemoteProtocolError
from repro_torch.comm.resilience import DegradationEvent
from repro_torch.core.protocol import make_selection
from repro_torch.core.types import KVCommConfig
from repro_torch.launch.remote_serve import export_pages
from repro_torch.serving.fabric.replica import (HealthSnapshot, Replica,
                                          ReplicaSet)
from repro_torch.serving.scheduler import Completion, Request

# what a failover can route around: the same set the session ladder
# catches — transport/protocol failures and raw socket errors
_FAILOVER_ERRORS = (RemoteProtocolError, OSError)


class FleetExhaustedError(RemoteProtocolError):
    """Every replica failed (or was quarantined) for one request and the
    router has no local fallback session to degrade to."""


@dataclass(frozen=True)
class RouterConfig:
    """Scoring weights + wire geometry.  Affinity dominates by default:
    a full-overlap replica beats an idle empty one unless its queue is
    deep — the dedup win is worth a short wait."""
    w_affinity: float = 1.0
    w_queue: float = 0.05          # per queued handler
    w_occupancy: float = 0.2       # times slots_occupied/slots_capacity
    w_half_open: float = 0.25      # breaker mid-recovery: probe gently
    w_stale: float = 0.25          # snapshot older than stale_after_s
    stale_after_s: float = 30.0
    probe_ttl_s: float = 1.0       # refresh snapshots older than this
    page_len: int = 16
    wire_dtype: str = "float16"
    policy: str = "affinity"       # "affinity" | "round_robin"


class AffinityScorer:
    """The deterministic scoring half of the router, separated so the
    property tests can drive it without sockets."""

    def __init__(self, config: Optional[RouterConfig] = None) -> None:
        self.config = config if config is not None else RouterConfig()

    def score(self, want_ids: FrozenSet[str],
              snapshot: Optional[HealthSnapshot],
              breaker_state: str, now: float) -> float:
        """Blend affinity, load, and health into one comparable float.
        An unknown replica (no snapshot yet) scores exactly 0 minus its
        health penalties: below any replica with resident overlap, above
        one that is loaded or distrusted."""
        cfg = self.config
        s = 0.0
        if snapshot is not None:
            if want_ids:
                overlap = len(want_ids & snapshot.page_ids)
                s += cfg.w_affinity * (overlap / len(want_ids))
            s -= cfg.w_queue * snapshot.queue_depth
            s -= cfg.w_occupancy * snapshot.occupancy
            if now - snapshot.at > cfg.stale_after_s:
                s -= cfg.w_stale
        if breaker_state == "half-open":
            s -= cfg.w_half_open
        return s

    def rank(self, replicas: Sequence[Replica], want_ids: FrozenSet[str],
             now: Optional[float] = None) -> List[Replica]:
        """Replicas in try-order.  Open-breaker replicas tier strictly
        below everything else (never chosen while a non-open one exists),
        within a tier higher score first, ties by replica id ascending."""
        if now is None:
            now = time.monotonic()
        keyed = []
        for r in replicas:
            state = r.breaker.peek()
            tier = 1 if state == "open" else 0
            s = self.score(want_ids, r.snapshot, state, now)
            keyed.append((tier, -s, r.replica_id, r))
        keyed.sort(key=lambda t: t[:3])
        return [t[3] for t in keyed]


@dataclass
class RouteRecord:
    """One routed request's accounting: who served it, how many hops it
    took to get there, and what the share actually cost on the wire."""
    rid: int
    replica_id: Optional[str]      # None: served by the local fallback
    hops: int = 0                  # failed replicas before the server
    n_bytes: int = 0
    pages_total: int = 0
    pages_sent: int = 0

    @property
    def pages_hit(self) -> int:
        return self.pages_total - self.pages_sent


class Router:
    """The fleet front-end: one sender, N replicas, affinity routing with
    failover.  ``run`` mirrors ``serve_serial``'s contract (requests in,
    ``Completion`` list + metrics out) so the conformance suite can
    compare the two token-for-token."""

    def __init__(self, sender: Agent, kvcfg: KVCommConfig,
                 replicas: ReplicaSet, *,
                 config: Optional[RouterConfig] = None,
                 fallback=None,
                 select_for: Optional[Callable] = None,
                 clock: Callable[[], float] = time.monotonic) -> None:
        self.sender = sender
        self.kvcfg = kvcfg
        self.replicas = replicas
        self.config = config if config is not None else RouterConfig()
        self.scorer = AffinityScorer(self.config)
        self.fallback = fallback   # CommSession (local ladder) or None
        self._select_for = select_for
        self._clock = clock
        self._rr = 0               # round-robin cursor
        self.routes: List[RouteRecord] = []
        self.degradations: List[DegradationEvent] = []

    # -- selection -----------------------------------------------------------
    def _select(self, calib_key: Optional[str]):
        """The frozen layer selection for this request's task: an
        explicit provider wins, else the fallback session's per-key cache
        (the calibrated path), else the prior-only selection."""
        if self._select_for is not None:
            return self._select_for(calib_key)
        if self.fallback is not None:
            return self.fallback.selection(self.kvcfg, key=calib_key)
        return make_selection(self.sender.cfg, self.kvcfg)

    # -- health --------------------------------------------------------------
    def refresh(self) -> None:
        """Re-probe replicas whose snapshot is missing or older than the
        probe TTL.  Failures are breaker-recorded and swallowed — a dead
        replica shows up as an opening breaker, not a router crash.  An
        open breaker skips the probe entirely (quarantine) until its
        reset timeout half-opens it."""
        now = self._clock()
        for r in self.replicas:
            fresh = (r.snapshot is not None
                     and now - r.snapshot.at <= self.config.probe_ttl_s)
            if fresh or not r.breaker.allow():
                continue
            try:
                r.probe()
            except _FAILOVER_ERRORS:
                pass

    # -- routing -------------------------------------------------------------
    def _order(self, want_ids: FrozenSet[str]) -> List[Replica]:
        if self.config.policy == "round_robin":
            rs = list(self.replicas)
            k = self._rr % len(rs) if rs else 0
            self._rr += 1
            rotated = rs[k:] + rs[:k]
            # quarantine still applies: open breakers go last
            return sorted(rotated,
                          key=lambda r: r.breaker.peek() == "open")
        return self.scorer.rank(list(self.replicas), want_ids,
                                now=self._clock())

    def submit(self, request: Request,
               calib_key: Optional[str] = None) -> Completion:
        """Route one request: split its KV into pages once, rank the
        fleet, then walk the ranking — share (dedup-bounded) + generate
        on each replica until one answers.  Falls to the local session
        (or raises ``FleetExhaustedError``) when every replica fails."""
        select = self._select(calib_key)
        table, pages, states, state_select = export_pages(
            self.sender, request.context[None, :], self.kvcfg, select,
            page_len=self.config.page_len,
            wire_dtype=self.config.wire_dtype)
        self.refresh()
        want = frozenset(table.all_ids())
        failed_from: Optional[str] = None
        last_err: Optional[BaseException] = None
        event: Optional[DegradationEvent] = None
        hops = 0
        t0 = time.perf_counter()
        for replica in self._order(want):
            if not replica.breaker.allow():
                continue           # quarantined: skip the doomed dial
            if failed_from is not None:
                # the previous replica died mid-request — this try IS the
                # downgrade, record it as one (stage = where we rerouted)
                event = DegradationEvent(
                    stage=f"replica:{replica.replica_id}",
                    from_stage=f"replica:{failed_from}",
                    reason=f"{type(last_err).__name__}: {last_err}",
                    attempts=getattr(last_err, "attempts", 1),
                    rid=request.rid)
                self.degradations.append(event)
            try:
                n, total, sent = replica.client.share_pages(
                    table, pages, wire_dtype=self.config.wire_dtype,
                    states=states, state_select=state_select)
                toks = replica.client.generate(request.query[None, :],
                                               max_new=request.max_new)
            except _FAILOVER_ERRORS as e:
                replica.breaker.record_failure()
                replica.disconnect()
                failed_from = replica.replica_id
                last_err = e
                hops += 1
                continue
            replica.breaker.record_success()
            self.routes.append(RouteRecord(
                rid=request.rid, replica_id=replica.replica_id, hops=hops,
                n_bytes=n, pages_total=total, pages_sent=sent))
            return Completion(rid=request.rid,
                              tokens=np.asarray(toks[0], np.int32),
                              ttft_s=time.perf_counter() - t0,
                              degradation=event)
        return self._serve_local(request, calib_key, hops, last_err, t0)

    def _serve_local(self, request: Request, calib_key: Optional[str],
                     hops: int, last_err: Optional[BaseException],
                     t0: float) -> Completion:
        """The rung below the fleet: the local fallback session's own
        ladder (serialized-local -> baseline), exactly where a
        single-replica deployment would have landed."""
        reason = ("no replica available" if last_err is None
                  else f"{type(last_err).__name__}: {last_err}")
        if self.fallback is None:
            raise FleetExhaustedError(
                f"request {request.rid}: all {len(self.replicas)} "
                f"replica(s) failed and no local fallback is configured; "
                f"last error: {reason}")
        event = DegradationEvent(
            stage="local", from_stage="fleet", reason=reason,
            attempts=max(1, hops), rid=request.rid)
        self.degradations.append(event)
        shared, _ = self.fallback.share(request.context[None, :],
                                        self.kvcfg, key=calib_key,
                                        sync=True, rid=request.rid)
        toks = [int(t[0]) for t in self.fallback.stream(
            request.query[None, :], shared, max_new=request.max_new)]
        self.routes.append(RouteRecord(rid=request.rid, replica_id=None,
                                       hops=hops))
        return Completion(rid=request.rid,
                          tokens=np.asarray(toks, np.int32),
                          ttft_s=time.perf_counter() - t0,
                          degradation=event)

    def run(self, requests: Sequence[Request], *,
            calib_key: Optional[str] = None,
            before: Optional[Callable[[int], None]] = None
            ) -> tuple:
        """Serve a request stream in rid order.  ``before(i)`` fires at
        each request boundary — the chaos harness's injection point.
        Returns (completions, metrics) shaped like ``serve_serial``."""
        completions = []
        for i, req in enumerate(sorted(requests, key=lambda r: r.rid)):
            if before is not None:
                before(i)
            completions.append(self.submit(req, calib_key=calib_key))
        return completions, self.metrics()

    # -- accounting ----------------------------------------------------------
    def metrics(self) -> Dict:
        """Fleet accounting over every routed request so far: per-replica
        served counts (occupancy spread), failover hops, and the dedup
        ledger (pages referenced vs actually shipped)."""
        served: Dict[str, int] = {rid: 0 for rid in self.replicas.ids()}
        local = 0
        for rec in self.routes:
            if rec.replica_id is None:
                local += 1
            else:
                served[rec.replica_id] = served.get(rec.replica_id, 0) + 1
        total = sum(r.pages_total for r in self.routes)
        sent = sum(r.pages_sent for r in self.routes)
        return {
            "requests": len(self.routes),
            "served": served,
            "local": local,
            "failovers": sum(r.hops for r in self.routes),
            "bytes": sum(r.n_bytes for r in self.routes),
            "pages_total": total,
            "pages_sent": sent,
            "page_hit_rate": ((total - sent) / total) if total else 0.0,
        }

    def close(self) -> None:
        self.replicas.close()
