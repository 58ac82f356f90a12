"""The port's serving fabric (``repro_torch.serving.fabric``) on bridged
float32 ``tiny_params``: the ``AffinityScorer`` laws of
``tests/test_fabric.py`` and the port's ranking equal to the reference's on
the same generated snapshots; health-payload versioning; the fleet
conformance cases (a clean fleet's affinity dedup, a kill mid-stream, a
partition and heal, the whole fleet down falling to the local ladder, two
seeded chaos schedules), where the port ``Router`` and the reference
``Router`` each drive a fleet of live ``KVServer`` replicas on 127.0.0.1
under the same ``FleetSchedule``, and their routes, hops, ``metrics()``,
degradation events and tokens must be equal (the tokens also equal the
port's ``serve_serial``); and ``SchedulerPool`` against one ``Scheduler``
per key. Breakers and routers run on a frozen clock, so every replay is
deterministic."""
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import repro.comm.resilience as jres
import repro.serving.fabric as jfab
from _torch_bridge import port_cfg, port_params
from repro.comm import Agent as JAgent
from repro.comm.session import CommSession as JSession
from repro.core.types import KVCommConfig as JKVCommConfig
from repro.serving.scheduler import Request as JRequest
from repro_torch.comm import Agent, CommSession
from repro_torch.comm.remote import (HEALTH_META_VERSION, build_health_meta,
                                     parse_health_meta)
from repro_torch.comm.resilience import CircuitBreaker
from repro_torch.core.types import KVCommConfig
from repro_torch.launch.remote_serve import KVServer
from repro_torch.serving.fabric import (FleetEvent, FleetExhaustedError,
                                        FleetHarness, FleetSchedule,
                                        HealthSnapshot, Replica, ReplicaSet,
                                        Router, RouterConfig, SchedulerPool)
from repro_torch.serving.fabric.router import AffinityScorer
from repro_torch.serving.scheduler import (Request, Scheduler,
                                           SchedulerConfig, serve_serial)
from repro_torch.store import PageStore

KVCFG = KVCommConfig(ratio=0.5, selector="prior_only")
JKVCFG = JKVCommConfig(ratio=0.5, selector="prior_only")
FROZEN = lambda: 0.0                                      # noqa: E731


@pytest.fixture(scope="module")
def pair(tiny_cfg, tiny_params):
    return port_cfg(tiny_cfg), port_params(tiny_params)


def _agent(name, pair, tok):
    return Agent(name, pair[0], pair[1], tok)


def _requests(rng, n, *, vocab, ctx_len=7, q_len=4, max_new=3, repeats=1):
    reqs = []
    for i in range(n):
        if i % repeats == 0 or not reqs:
            ctx = rng.integers(4, vocab, (ctx_len,)).astype(np.int32)
        else:
            ctx = reqs[-1].context
        reqs.append(Request(
            rid=i, context=ctx,
            query=rng.integers(4, vocab, (q_len,)).astype(np.int32),
            max_new=max_new))
    return reqs


# ---------------------------------------------------------------------------
# the scorer's laws, and its ranking against the reference's
# ---------------------------------------------------------------------------
def _fake_replica(mod, rid, *, page_ids=(), queue=0, occupied=0, capacity=8,
                  state="closed", at=0.0):
    r = mod.Replica(rid, "127.0.0.1", 1)      # never dialed
    r.snapshot = mod.HealthSnapshot(
        replica_id=rid, at=at, page_ids=frozenset(page_ids),
        queue_depth=queue, slots_occupied=occupied,
        slots_capacity=capacity)
    if state == "open":
        r.breaker.state = "open"
        r.breaker._opened_at = 1e18           # never half-opens here
    elif state == "half-open":
        r.breaker.state = "half-open"
    return r


class _Port:
    Replica, HealthSnapshot = Replica, HealthSnapshot


@st.composite
def _fleet_specs(draw):
    n = draw(st.integers(2, 5))
    pages = [f"p{j}" for j in range(8)]
    specs = [{"rid": f"r{i}",
              "page_ids": draw(st.sets(st.sampled_from(pages), max_size=8)),
              "queue": draw(st.integers(0, 5)),
              "occupied": draw(st.integers(0, 8)),
              "at": draw(st.sampled_from([0.0, -40.0])),
              "state": draw(st.sampled_from(
                  ["closed", "open", "half-open"]))} for i in range(n)]
    want = draw(st.sets(st.sampled_from(pages), min_size=1, max_size=8))
    return specs, frozenset(want)


class TestAffinityScorerLaws:
    def test_monotone_in_overlap(self):
        sc = AffinityScorer()
        want = frozenset(f"p{i}" for i in range(6))
        prev = -1e9
        for k in range(7):
            snap = HealthSnapshot(replica_id="r", at=0.0,
                                  page_ids=frozenset(sorted(want)[:k]))
            s = sc.score(want, snap, "closed", now=0.0)
            assert s >= prev
            prev = s

    @given(_fleet_specs())
    @settings(max_examples=40, deadline=None)
    def test_rank_equals_reference_and_is_deterministic(self, spec):
        """The ranking is a pure function of (want_ids, snapshots, breaker
        states, clock): the port's equals the reference's."""
        specs, want = spec
        got = [[r.replica_id for r in AffinityScorer().rank(
            [_fake_replica(_Port, **s) for s in specs], want, now=10.0)]
            for _ in range(2)]
        ref = [r.replica_id for r in jfab.AffinityScorer().rank(
            [_fake_replica(jfab, **s) for s in specs], want, now=10.0)]
        assert got[0] == got[1] == ref

    @given(_fleet_specs())
    @settings(max_examples=40, deadline=None)
    def test_open_breaker_never_beats_a_healthy_replica(self, spec):
        specs, want = spec
        order = AffinityScorer().rank(
            [_fake_replica(_Port, **s) for s in specs], want, now=10.0)
        states = {s["rid"]: s["state"] for s in specs}
        seen_open = False
        for r in order:
            if states[r.replica_id] == "open":
                seen_open = True
            else:
                assert not seen_open

    @given(st.integers(2, 6))
    @settings(max_examples=20, deadline=None)
    def test_ties_break_by_replica_id(self, n):
        fleet = [_fake_replica(_Port, f"r{i}", page_ids={"p0"})
                 for i in reversed(range(n))]
        order = [r.replica_id for r in AffinityScorer().rank(
            fleet, frozenset({"p0"}), now=10.0)]
        assert order == sorted(order)

    @given(_fleet_specs(), st.integers(0, 7))
    @settings(max_examples=40, deadline=None)
    def test_adding_overlap_never_demotes(self, spec, extra):
        specs, want = spec
        page = f"p{extra}"
        want = want | {page}
        sc = AffinityScorer()
        before = [r.replica_id for r in sc.rank(
            [_fake_replica(_Port, **s) for s in specs], want, now=10.0)]
        boosted = [_fake_replica(_Port, **{
            **s, "page_ids": set(s["page_ids"]) | {page}
            if s["rid"] == specs[0]["rid"] else s["page_ids"]})
            for s in specs]
        after = [r.replica_id for r in sc.rank(boosted, want, now=10.0)]
        assert after.index(specs[0]["rid"]) <= before.index(specs[0]["rid"])


class TestHealthVersioning:
    def test_v1_payload_parses_with_defaults(self):
        v1 = {"answered": 3, "prefix_installed": True,
              "pool": {"pages": 2, "hit_rate": 0.5}}
        h = parse_health_meta(v1)
        assert h["health_version"] == 1 and h["answered"] == 3
        assert h["page_ids"] == [] and h["queue_depth"] == 0
        assert h["slots"] == {"capacity": 0, "occupied": 0}
        snap = HealthSnapshot.from_meta("r0", v1, at=1.0)
        assert snap.pages == 2 and snap.occupancy == 0.0

    def test_snapshot_fields_match_reference(self):
        meta = build_health_meta(answered=2, prefix_installed=True,
                                 pool={"pages": 3, "capacity_bytes": 10,
                                       "used_bytes": 4, "hit_rate": 0.25},
                                 page_ids=["b", "a"], queue_depth=1,
                                 slots_capacity=4, slots_occupied=2)
        got = HealthSnapshot.from_meta("r1", meta, at=2.0)
        want = jfab.HealthSnapshot.from_meta("r1", meta, at=2.0)
        fields = [f for f in HealthSnapshot.__dataclass_fields__]
        assert fields == list(want.__dataclass_fields__)
        assert [getattr(got, f) for f in fields] == \
            [getattr(want, f) for f in fields]
        assert got.occupancy == want.occupancy == 0.5

    def test_future_payload_keys_are_ignored(self):
        meta = build_health_meta(answered=1, prefix_installed=False)
        meta["health_version"] = HEALTH_META_VERSION + 1
        meta["wholly_new_signal"] = {"x": 1}
        h = parse_health_meta(meta)
        assert h["answered"] == 1 and "wholly_new_signal" not in h

    def test_malformed_nested_values_degrade_not_raise(self):
        h = parse_health_meta({"answered": "nan?", "slots": "broken",
                               "page_ids": 7, "pool": ["not", "a", "dict"]})
        assert h["answered"] == 0 and h["pool"] is None
        assert h["page_ids"] == []
        with pytest.raises(Exception):
            parse_health_meta(["not", "a", "dict"])

    def test_live_probe_carries_routing_signals(self, pair, tok):
        from repro_torch.core.protocol import make_selection
        srv = KVServer(_agent("r", pair, tok), store=PageStore(page_len=4),
                       max_conns=4)
        srv.start()
        rep = Replica("r0", srv.host, srv.port, connect_timeout_s=2.0)
        try:
            snap = rep.probe()
            assert snap.slots_capacity == 4 and snap.slots_occupied == 1
            assert snap.queue_depth == 0 and snap.pages == 0
            ctx = np.random.default_rng(1).integers(
                4, pair[0].vocab_size, (2, 7)).astype(np.int32)
            rep.client.share_paged(_agent("s", pair, tok), ctx, KVCFG,
                                   make_selection(pair[0], KVCFG),
                                   page_len=4, wire_dtype="float32")
            snap = rep.probe()
            assert snap.pages > 0 and len(snap.page_ids) == snap.pages
            assert snap.prefix_installed and rep.breaker.state == "closed"
        finally:
            rep.close()
            srv.stop()


# ---------------------------------------------------------------------------
# the fleet: the port Router and the reference Router on live servers
# ---------------------------------------------------------------------------
class _Fleet:
    """n live port KVServers, a harness and one router (the port's or the
    reference's) on a frozen clock; every server ever built is kept for
    the leak check."""

    def __init__(self, side, pair, tok, tiny_cfg, tiny_params, *, n=2,
                 events=(), fallback=True):
        R = side == "ref"
        mod = jfab if R else None
        self.all_servers = []

        def build(rid, port=0):
            srv = KVServer(_agent(f"recv-{rid}", pair, tok), port=port,
                           store=PageStore(page_len=4))
            self.all_servers.append(srv)
            return srv

        servers = {}
        self.replicas = (jfab.ReplicaSet if R else ReplicaSet)()
        for i in range(n):
            rid = f"r{i}"
            servers[rid] = build(rid)
            self.replicas.add((mod.Replica if R else Replica)(
                rid, servers[rid].host, servers[rid].port,
                breaker=(jres.CircuitBreaker if R else CircuitBreaker)(
                    clock=FROZEN),
                connect_timeout_s=0.25, io_timeout_s=10.0, clock=FROZEN))
        self.schedule = (jfab.FleetSchedule if R else FleetSchedule)(
            [(jfab.FleetEvent if R else FleetEvent)(*e) for e in events])
        self.harness = (jfab.FleetHarness if R else FleetHarness)(
            self.replicas, servers, build, self.schedule)
        self.harness.start()
        cfg = dict(wire_dtype="float32", page_len=4, probe_ttl_s=0.0)
        if R:
            fb = JSession(JAgent("s-fb", tiny_cfg, tiny_params, tok),
                          JAgent("r-fb", tiny_cfg, tiny_params, tok)) \
                if fallback else None
            self.router = jfab.Router(
                JAgent("sender", tiny_cfg, tiny_params, tok), JKVCFG,
                self.replicas, config=jfab.RouterConfig(**cfg),
                fallback=fb, clock=FROZEN)
        else:
            fb = CommSession(_agent("s-fb", pair, tok),
                             _agent("r-fb", pair, tok)) if fallback else None
            self.router = Router(_agent("sender", pair, tok), KVCFG,
                                 self.replicas, config=RouterConfig(**cfg),
                                 fallback=fb, clock=FROZEN)
        self.side = side

    def run(self, reqs):
        if self.side == "ref":
            reqs = [JRequest(rid=r.rid, context=r.context, query=r.query,
                             max_new=r.max_new) for r in reqs]
        try:
            comps, metrics = self.router.run(reqs,
                                             before=self.harness.before)
        finally:
            self.router.close()
            self.harness.stop()
        for srv in self.all_servers:
            assert srv.store.stats().pinned_bytes == 0, "a leaked pin"
        ev = lambda e: None if e is None else (          # noqa: E731
            e.stage, e.from_stage, e.rid)
        return {
            "tokens": [np.asarray(c.tokens).tolist() for c in comps],
            "completion_events": [ev(c.degradation) for c in comps],
            "routes": [(r.rid, r.replica_id, r.hops, r.n_bytes,
                        r.pages_total, r.pages_sent)
                       for r in self.router.routes],
            "events": [ev(e) for e in self.router.degradations],
            "metrics": metrics,
            "fired": [(e.at_request, e.action, e.replica)
                      for e in self.schedule.fired]}


def _conform(pair, tok, tiny_cfg, tiny_params, reqs, **kw):
    out = {side: _Fleet(side, pair, tok, tiny_cfg, tiny_params, **kw)
           .run(reqs) for side in ("port", "ref")}
    assert out["port"] == out["ref"]
    sess = CommSession(_agent("s", pair, tok), _agent("r", pair, tok))
    serial, _ = serve_serial(sess, reqs, KVCFG)
    assert out["port"]["tokens"] == [c.tokens.tolist() for c in serial]
    return out["port"]


class TestFleetConformance:
    def test_clean_fleet_affinity_dedup(self, pair, tok, tiny_cfg,
                                        tiny_params):
        reqs = _requests(np.random.default_rng(0), 6,
                         vocab=pair[0].vocab_size, repeats=3)
        out = _conform(pair, tok, tiny_cfg, tiny_params, reqs)
        m = out["metrics"]
        assert m["failovers"] == 0 and m["local"] == 0
        assert m["pages_sent"] < m["pages_total"] and out["events"] == []

    def test_kill_midstream_fails_over(self, pair, tok, tiny_cfg,
                                       tiny_params):
        reqs = _requests(np.random.default_rng(1), 5,
                         vocab=pair[0].vocab_size, repeats=5)
        out = _conform(pair, tok, tiny_cfg, tiny_params, reqs,
                       events=[(2, "kill", "r0")])
        assert out["metrics"]["failovers"] >= 1
        assert out["metrics"]["local"] == 0
        assert all(e[1].startswith("replica:") for e in out["events"])
        hop = min(r[0] for r in out["routes"] if r[2])
        later = [r for r in out["routes"] if r[0] > hop]
        assert later and all(r[5] == 0 for r in later)

    def test_partition_and_heal(self, pair, tok, tiny_cfg, tiny_params):
        reqs = _requests(np.random.default_rng(2), 5,
                         vocab=pair[0].vocab_size, repeats=2)
        out = _conform(pair, tok, tiny_cfg, tiny_params, reqs,
                       events=[(1, "partition", "r0"), (3, "heal", "r0")])
        assert out["metrics"]["local"] == 0
        assert out["metrics"]["served"]["r1"] >= 2

    def test_whole_fleet_down_falls_to_the_local_ladder(self, pair, tok,
                                                        tiny_cfg,
                                                        tiny_params):
        reqs = _requests(np.random.default_rng(3), 3,
                         vocab=pair[0].vocab_size)
        out = _conform(pair, tok, tiny_cfg, tiny_params, reqs,
                       events=[(1, "kill", "r0"), (1, "kill", "r1")])
        assert out["metrics"]["local"] == 2
        assert out["completion_events"][0] is None
        assert out["completion_events"][1][:2] == ("local", "fleet")

    def test_no_fallback_raises_fleet_exhausted(self, pair, tok, tiny_cfg,
                                                tiny_params):
        fleet = _Fleet("port", pair, tok, tiny_cfg, tiny_params, n=1,
                       fallback=False)
        try:
            fleet.harness.apply(FleetEvent(0, "kill", "r0"))
            req = _requests(np.random.default_rng(4), 1,
                            vocab=pair[0].vocab_size)[0]
            with pytest.raises(FleetExhaustedError):
                fleet.router.submit(req)
        finally:
            fleet.router.close()
            fleet.harness.stop()

    @pytest.mark.parametrize("seed", [7, 23])
    def test_seeded_chaos_schedules(self, pair, tok, tiny_cfg, tiny_params,
                                    seed):
        sched = FleetSchedule.random(seed, 6, ["r0", "r1"], rate=0.5)
        ref = jfab.FleetSchedule.random(seed, 6, ["r0", "r1"], rate=0.5)
        events = [(e.at_request, e.action, e.replica) for e in sched.events]
        assert events == [(e.at_request, e.action, e.replica)
                          for e in ref.events] and events
        reqs = _requests(np.random.default_rng(seed), 6,
                         vocab=pair[0].vocab_size, repeats=2, max_new=2)
        out = _conform(pair, tok, tiny_cfg, tiny_params, reqs,
                       events=events)
        assert out["fired"] == events
        assert len(out["events"]) >= sum(
            1 for r in out["routes"] if r[2] or r[1] is None)


# ---------------------------------------------------------------------------
# calib_key scheduler pools
# ---------------------------------------------------------------------------
class TestSchedulerPool:
    def test_two_selections_match_their_own_schedulers(self, pair, tok):
        sess = CommSession(_agent("s", pair, tok), _agent("r", pair, tok))
        sess._sel_cache[("front", KVCFG)] = torch.tensor(
            [True, True, False, False])
        sess._sel_cache[("back", KVCFG)] = torch.tensor(
            [False, False, True, True])
        reqs = _requests(np.random.default_rng(4), 6,
                         vocab=pair[0].vocab_size, max_new=3)
        cfg = SchedulerConfig(capacity=2, prefix_bucket=8, query_bucket=4,
                              decode_backend="kernel")
        pool = SchedulerPool(sess, KVCFG, config=cfg)
        for i, r in enumerate(reqs):
            pool.submit(r, calib_key="front" if i % 2 == 0 else "back")
        assert pool.pending == 6
        comps, metrics = pool.run()
        assert metrics["pools"] == 2 and pool.pending == 0
        assert [c.rid for c in comps] == [r.rid for r in reqs]
        got = {c.rid: c.tokens.tolist() for c in comps}
        for key, pick in (("front", 0), ("back", 1)):
            own = CommSession(_agent("s", pair, tok), _agent("r", pair, tok))
            own._sel_cache[(key, KVCFG)] = sess.selection(KVCFG, key=key)
            sub = [r for i, r in enumerate(reqs) if i % 2 == pick]
            want, _ = Scheduler(own, KVCFG, calib_key=key,
                                config=cfg).run(sub)
            assert [got[c.rid] for c in want] == \
                [c.tokens.tolist() for c in want]
            assert metrics["per_key"][key]["steps"] > 0

    def test_schedulers_persist_across_runs(self, pair, tok):
        sess = CommSession(_agent("s", pair, tok), _agent("r", pair, tok))
        pool = SchedulerPool(sess, KVCFG)
        rng = np.random.default_rng(5)
        for batch in range(2):
            for req in _requests(rng, 2, vocab=pair[0].vocab_size,
                                 max_new=2):
                req.rid += batch * 2
                pool.submit(req)
            comps, _ = pool.run()
            assert len(comps) == 2
        assert len(pool._schedulers) == 1
