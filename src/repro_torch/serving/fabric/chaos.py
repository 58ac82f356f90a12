"""Fleet-level chaos: scripted replica kill/restart/partition schedules.

The frame-level chaos harness (``FaultSchedule``/``FaultyChannel``)
injects faults at FRAME boundaries inside one connection; this one injects them
at REQUEST boundaries across a fleet of real ``KVServer`` processes:

  kill      — ``KVServer.stop()``: listener closed, every live
              connection severed (handlers release their pinned tables
              on the way out), threads joined.
  restart   — a fresh ``KVServer`` bound to the SAME port (the listener
              sets SO_REUSEADDR), built by the caller's factory — which
              decides whether the page pool survives (warm restart) or
              starts empty (cold, the default in tests: the harsher
              case for dedup accounting).
  partition — client-side severance via ``Replica.partition()``: the
              server is healthy but unreachable from the router, the
              classic asymmetric network split.
  heal      — undo a partition.

Schedules are explicit event lists or seeded-random
(``FleetSchedule.random``), and the random generator only emits LEGAL
transitions (no killing a dead replica, no healing an unpartitioned
one), so every seed replays an identical, executable fleet history —
the determinism the conformance suite sweeps over.
"""
from __future__ import annotations

import random
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence

from repro_torch.launch.remote_serve import KVServer
from repro_torch.serving.fabric.replica import ReplicaSet

FLEET_ACTIONS = ("kill", "restart", "partition", "heal")


@dataclass(frozen=True)
class FleetEvent:
    """One scripted fleet mutation, fired BEFORE request ``at_request``
    is routed (as in the frame-level harness, the index IS the injection
    point)."""
    at_request: int
    action: str
    replica: str

    def __post_init__(self) -> None:
        if self.action not in FLEET_ACTIONS:
            raise ValueError(f"unknown fleet action {self.action!r}; "
                             f"one of {FLEET_ACTIONS}")


class FleetSchedule:
    """A deterministic request-boundary -> [FleetEvent] map.  Multiple
    events may share a boundary; they apply in list order."""

    def __init__(self, events: Sequence[FleetEvent] = ()) -> None:
        self.events = list(events)
        self._by_req: Dict[int, List[FleetEvent]] = {}
        for ev in self.events:
            self._by_req.setdefault(ev.at_request, []).append(ev)
        self.fired: List[FleetEvent] = []

    @classmethod
    def random(cls, seed: int, n_requests: int,
               replica_ids: Sequence[str], rate: float = 0.25,
               actions: Sequence[str] = FLEET_ACTIONS) -> "FleetSchedule":
        """Seeded random schedule over ``n_requests`` boundaries.  Each
        boundary independently fires one event with probability
        ``rate``, choosing uniformly among the LEGAL (action, replica)
        pairs given the simulated fleet state — so the emitted script is
        always executable and the same seed always yields the same
        script."""
        rng = random.Random(seed)
        up = {rid: True for rid in replica_ids}
        split = {rid: False for rid in replica_ids}
        events: List[FleetEvent] = []
        for i in range(n_requests):
            if rng.random() >= rate:
                continue
            legal = []
            for rid in sorted(up):
                if "kill" in actions and up[rid]:
                    legal.append(("kill", rid))
                if "restart" in actions and not up[rid]:
                    legal.append(("restart", rid))
                if "partition" in actions and up[rid] and not split[rid]:
                    legal.append(("partition", rid))
                if "heal" in actions and split[rid]:
                    legal.append(("heal", rid))
            if not legal:
                continue
            action, rid = legal[rng.randrange(len(legal))]
            if action == "kill":
                up[rid] = False
            elif action == "restart":
                up[rid] = True
            elif action == "partition":
                split[rid] = True
            else:
                split[rid] = False
            events.append(FleetEvent(at_request=i, action=action,
                                     replica=rid))
        return cls(events)

    def at(self, request_index: int) -> List[FleetEvent]:
        return self._by_req.get(request_index, [])

    def __len__(self) -> int:
        return len(self.events)


class FleetHarness:
    """Owns the live servers of a fleet and applies a ``FleetSchedule``
    to them.  Pass ``harness.before`` as ``Router.run(before=...)`` and
    the scripted events fire at exactly their request boundaries.

    ``make_server(replica_id, port)`` rebuilds a killed replica's server
    on its original port (restart); the factory owns the store policy —
    return a server with a fresh ``PageStore`` for a cold restart."""

    def __init__(self, replicas: ReplicaSet,
                 servers: Dict[str, KVServer],
                 make_server: Optional[
                     Callable[[str, int], KVServer]] = None,
                 schedule: Optional[FleetSchedule] = None) -> None:
        missing = set(replicas.ids()) - set(servers)
        if missing:
            raise ValueError(f"no server for replica(s) {sorted(missing)}")
        self.replicas = replicas
        self.servers = dict(servers)
        self.make_server = make_server
        self.schedule = schedule if schedule is not None \
            else FleetSchedule()
        self._ports = {rid: srv.port for rid, srv in servers.items()}
        self._up = {rid: False for rid in servers}

    def start(self) -> None:
        for rid in sorted(self.servers):
            self.servers[rid].start()
            self._up[rid] = True

    # -- event application ---------------------------------------------------
    def apply(self, event: FleetEvent) -> None:
        rid = event.replica
        if rid not in self.servers:
            raise ValueError(f"event names unknown replica {rid!r}")
        if event.action == "kill":
            if self._up[rid]:
                self.servers[rid].stop()
                self._up[rid] = False
                # the router's cached connection is now a dead socket;
                # drop it so the failure surfaces at dial, not mid-frame
                self.replicas[rid].disconnect()
        elif event.action == "restart":
            if not self._up[rid]:
                if self.make_server is None:
                    raise ValueError(
                        "restart scheduled but no make_server factory")
                srv = self.make_server(rid, self._ports[rid])
                srv.start()
                self.servers[rid] = srv
                self._up[rid] = True
        elif event.action == "partition":
            self.replicas[rid].partition()
        else:                      # heal
            self.replicas[rid].heal()
        self.schedule.fired.append(event)

    def before(self, request_index: int) -> None:
        """The ``Router.run`` hook: fire every event scheduled at this
        request boundary."""
        for ev in self.schedule.at(request_index):
            self.apply(ev)

    # -- introspection / teardown --------------------------------------------
    def up_ids(self) -> List[str]:
        return sorted(r for r, up in self._up.items() if up)

    def stores(self) -> Dict[str, object]:
        """Each LIVE server's page store (killed replicas' stores are
        gone with their servers) — what the leak checks sweep."""
        return {rid: self.servers[rid].store
                for rid in self.up_ids()
                if self.servers[rid].store is not None}

    def stop(self) -> None:
        for rid in sorted(self.servers):
            if self._up[rid]:
                self.servers[rid].stop()
                self._up[rid] = False
