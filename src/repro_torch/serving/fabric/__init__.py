"""The multi-replica KV serving fabric of the port.

The resilience layer (health frames, breakers, degradation events) and
the paged dedup wire assembled into a fleet: ``Replica`` / ``ReplicaSet``
wrap ``KVServer`` endpoints, ``AffinityScorer`` / ``Router`` send each
request to the replica that already holds its pages (failing over, dedup
bounded, when one dies), ``SchedulerPool`` serves a mixed-``calib_key``
stream with one slot table per selection, and ``FleetSchedule`` /
``FleetHarness`` replay scripted kill / restart / partition events
against the live servers.
"""
from repro_torch.serving.fabric.chaos import (FLEET_ACTIONS, FleetEvent,
                                        FleetHarness, FleetSchedule)
from repro_torch.serving.fabric.pools import SchedulerPool
from repro_torch.serving.fabric.replica import (HealthSnapshot, Replica,
                                          ReplicaSet)
from repro_torch.serving.fabric.router import (AffinityScorer,
                                         FleetExhaustedError, RouteRecord,
                                         Router, RouterConfig)

__all__ = [
    "AffinityScorer", "FLEET_ACTIONS", "FleetEvent", "FleetExhaustedError",
    "FleetHarness", "FleetSchedule", "HealthSnapshot", "Replica",
    "ReplicaSet", "RouteRecord", "Router", "RouterConfig", "SchedulerPool",
]
