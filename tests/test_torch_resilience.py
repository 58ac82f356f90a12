"""The port's resilience layer: retry policies, the circuit breaker, the
chaos harness, recovery of the unpaged and paged exchanges, the session's
degradation ladder and the scheduler's quarantine, held to the reference
package where both answer.

Port counterparts of every class of ``tests/test_resilience.py`` run on
bridged float32 ``tiny_params``. Across packages: ``FaultSchedule.random``
gives the reference's faults for seeds 0-49; one fault script replayed
through both packages' ``RemoteTransport`` gives the same attempts, writes,
resets and bytes and byte-identical frames; one script through both
packages' ``Scheduler`` under ``default_resilience`` gives the same
``DegradationEvent`` list, per-request bytes and tokens. A truncate at
every frame of a streamed share, each followed by a retry, leaves the
received K/V bit-equal to a clean share. Every comparison is exact."""
import random
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.comm.remote as jremote
import repro.comm.resilience as jres
from _torch_bridge import port_cfg, port_params
from repro.comm import Agent as JAgent
from repro.comm import CommSession as JSession
from repro.core.types import KVCommConfig as JKVCommConfig
from repro.serving.scheduler import Request as JRequest
from repro.serving.scheduler import Scheduler as JScheduler
from repro.serving.scheduler import SchedulerConfig as JSchedulerConfig
from repro.store import PageStore as JPageStore
from repro_torch.comm import Agent, CommSession, SerializedTransport
from repro_torch.comm.remote import (ChannelClosedError, ChannelTimeoutError,
                                     FileChannel, FrameCorruptError,
                                     HeaderCorruptError, KVStreamSender,
                                     LoopbackChannel,
                                     PayloadMismatchError,
                                     RemoteProtocolError, RemoteTransport,
                                     SocketChannel, encode_frame, read_frame)
from repro_torch.comm.resilience import (CircuitBreaker, CircuitOpenError,
                                         DegradationEvent, Fault,
                                         FaultSchedule, FaultyChannel,
                                         Resilience, RetriesExhaustedError,
                                         RetryPolicy, default_resilience)
from repro_torch.core.types import KVCommConfig
from repro_torch.serving.scheduler import (Request, Scheduler,
                                           SchedulerConfig, serve_serial)
from repro_torch.store import PageStore

KVCFG = KVCommConfig(ratio=0.5, selector="prior_only")
JKVCFG = JKVCommConfig(ratio=0.5, selector="prior_only")
# never sleeps: recovery tests care about attempts and resets, not pacing
FAST = RetryPolicy(max_attempts=3, backoff_s=0.0, jitter=0.0)
SELECT = np.array([True, False, True, True])


@pytest.fixture(scope="module")
def pair(tiny_cfg, tiny_params):
    return port_cfg(tiny_cfg), port_params(tiny_params)


def _ctx_qry(cfg, seed=1, B=2, Sc=7, Sq=4):
    rng = np.random.default_rng(seed)
    return (rng.integers(4, cfg.vocab_size, (B, Sc)).astype(np.int32),
            rng.integers(4, cfg.vocab_size, (B, Sq)).astype(np.int32))


def _session(pair, tok, transport, resilience=None):
    cfg, params = pair
    return CommSession(Agent("s", cfg, params, tok),
                       Agent("r", cfg, params, tok), transport,
                       resilience=resilience)


class _DeadChannel(LoopbackChannel):
    """Every write fails: the peer is gone and stays gone."""

    def __init__(self):
        super().__init__()
        self.write_attempts = 0

    def write(self, data):
        self.write_attempts += 1
        raise ChannelClosedError("peer is gone")


# ---------------------------------------------------------------------------
# RetryPolicy
# ---------------------------------------------------------------------------
class TestRetryPolicy:
    def test_succeeds_after_transient_failures(self):
        calls, retries = [], []

        def fn(attempt):
            calls.append(attempt)
            if attempt < 2:
                raise ChannelClosedError("transient")
            return "ok"

        out = RetryPolicy(max_attempts=3, backoff_s=0.0).run(
            fn, on_retry=lambda a, e: retries.append(a),
            sleep=lambda s: None)
        assert out == "ok" and calls == [0, 1, 2] and retries == [0, 1]

    def test_exhaustion_raises_typed_with_cause(self):
        def fn(attempt):
            raise FrameCorruptError("bit flip")

        with pytest.raises(RetriesExhaustedError) as ei:
            RetryPolicy(max_attempts=2, backoff_s=0.0).run(
                fn, describe="test op", sleep=lambda s: None)
        assert ei.value.attempts == 2
        assert isinstance(ei.value.last, FrameCorruptError)
        assert isinstance(ei.value.__cause__, FrameCorruptError)
        assert isinstance(ei.value, RemoteProtocolError)

    def test_non_retriable_passes_through_untouched(self):
        calls = []

        def fn(attempt):
            calls.append(attempt)
            raise PayloadMismatchError("the peer will always say this")

        with pytest.raises(PayloadMismatchError):
            RetryPolicy(max_attempts=5, backoff_s=0.0).run(
                fn, sleep=lambda s: None)
        assert calls == [0]

    def test_backoff_matches_reference_per_seed(self):
        """The jittered sleeps are the reference policy's, draw for draw."""
        for seed in range(5):
            p = RetryPolicy(backoff_s=0.1, jitter=0.5, seed=seed)
            q = jres.RetryPolicy(backoff_s=0.1, jitter=0.5, seed=seed)
            rp, rq = random.Random(seed), random.Random(seed)
            assert [p.backoff(i, rp) for i in range(6)] == \
                [q.backoff(i, rq) for i in range(6)]
        q = RetryPolicy(backoff_s=0.1, backoff_mult=2.0, max_backoff_s=0.3,
                        jitter=0.0)
        assert [q.backoff(i, random.Random(0)) for i in range(3)] \
            == [pytest.approx(0.1), pytest.approx(0.2), pytest.approx(0.3)]

    def test_sleeps_between_attempts(self):
        slept = []

        def fn(attempt):
            if attempt == 0:
                raise ChannelClosedError("x")
            return attempt

        RetryPolicy(max_attempts=2, backoff_s=0.05, jitter=0.0).run(
            fn, sleep=slept.append)
        assert slept == [pytest.approx(0.05)]

    def test_deadline_cuts_retries_short(self):
        now = [0.0]

        def fn(attempt):
            now[0] += 1.0
            raise ChannelClosedError("slow failure")

        with pytest.raises(RetriesExhaustedError) as ei:
            RetryPolicy(max_attempts=10, backoff_s=0.0,
                        deadline_s=2.5).run(
                fn, sleep=lambda s: None, clock=lambda: now[0])
        assert ei.value.attempts == 3

    def test_invalid_max_attempts_rejected(self):
        with pytest.raises(ValueError):
            RetryPolicy(max_attempts=0)


# ---------------------------------------------------------------------------
# CircuitBreaker
# ---------------------------------------------------------------------------
class TestCircuitBreaker:
    def test_opens_after_threshold_consecutive_failures(self):
        now = [0.0]
        b = CircuitBreaker(failure_threshold=3, reset_timeout_s=10.0,
                           clock=lambda: now[0])
        for _ in range(2):
            b.record_failure()
        assert b.state == "closed" and b.allow()
        b.record_failure()
        assert b.state == "open" and not b.allow()

    def test_success_resets_the_consecutive_count(self):
        b = CircuitBreaker(failure_threshold=2)
        b.record_failure()
        b.record_success()
        b.record_failure()
        assert b.state == "closed"

    def test_half_open_admits_one_probe_then_closes(self):
        now = [0.0]
        b = CircuitBreaker(failure_threshold=1, reset_timeout_s=5.0,
                           clock=lambda: now[0])
        b.record_failure()
        assert not b.allow()
        now[0] = 6.0
        assert b.peek() == "half-open"     # peek takes no trial slot
        assert b.allow() and b.state == "half-open"
        assert not b.allow()
        b.record_success()
        assert b.state == "closed" and b.allow()

    def test_half_open_failure_reopens_and_restarts_timer(self):
        now = [0.0]
        b = CircuitBreaker(failure_threshold=1, reset_timeout_s=5.0,
                           clock=lambda: now[0])
        b.record_failure()
        now[0] = 6.0
        assert b.allow()
        b.record_failure()
        assert b.state == "open" and not b.allow()
        now[0] = 10.0
        assert not b.allow()
        now[0] = 12.0
        assert b.allow()


# ---------------------------------------------------------------------------
# the chaos harness
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("seed", range(50))
def test_random_schedule_matches_reference(seed):
    """A chaos replay is comparable across packages only if the fault hits
    the same frame: the same seed draws the reference's fault list."""
    n_ops, rate = 8 + seed % 24, (0.1, 0.3, 0.5, 0.9)[seed % 4]
    got = FaultSchedule.random(seed, n_ops, rate, delay_s=0.01)
    want = jres.FaultSchedule.random(seed, n_ops, rate, delay_s=0.01)
    as_tuples = lambda fs: [(f.op, f.kind, f.frac, f.delay_s)   # noqa: E731
                            for _, f in sorted(fs._by_op.items())]
    assert as_tuples(got) == as_tuples(want)


class TestFaultSchedule:
    def test_same_seed_same_schedule(self):
        a = FaultSchedule.random(seed=42, n_ops=32, rate=0.4)
        b = FaultSchedule.random(seed=42, n_ops=32, rate=0.4)
        assert a._by_op == b._by_op and len(a) > 0

    def test_different_seeds_differ(self):
        a = FaultSchedule.random(seed=1, n_ops=64, rate=0.5)
        b = FaultSchedule.random(seed=2, n_ops=64, rate=0.5)
        assert a._by_op != b._by_op

    def test_duplicate_op_rejected(self):
        with pytest.raises(ValueError):
            FaultSchedule([Fault(3, "drop"), Fault(3, "corrupt")])

    def test_unknown_kind_rejected(self):
        with pytest.raises(ValueError):
            Fault(0, "gremlins")

    def test_pop_moves_to_fired(self):
        fs = FaultSchedule([Fault(1, "drop")])
        assert fs.pop(0) is None and len(fs) == 1
        f = fs.pop(1)
        assert f is not None and fs.fired == [f] and len(fs) == 0


class TestFaultyChannel:
    def _frame(self):
        return encode_frame("blob", {"n": 1},
                            {"x": np.arange(64, dtype=np.float32)})

    def test_disconnect_raises_and_breaks(self):
        ch = FaultyChannel(LoopbackChannel(),
                           FaultSchedule([Fault(0, "disconnect")]))
        with pytest.raises(ChannelClosedError):
            ch.write(self._frame())
        with pytest.raises(ChannelClosedError):
            ch.write(self._frame())
        assert ch.writes == 2 and ch.bytes_written == 0

    def test_drop_vanishes_frame_reader_sees_closed(self):
        ch = FaultyChannel(LoopbackChannel(),
                           FaultSchedule([Fault(0, "drop")]))
        ch.write(self._frame())
        with pytest.raises(ChannelClosedError):
            read_frame(ch)

    def test_truncate_is_the_mid_frame_kill(self):
        frame = self._frame()
        ch = FaultyChannel(LoopbackChannel(),
                           FaultSchedule([Fault(0, "truncate", frac=0.5)]))
        ch.write(frame)
        assert 0 < ch.bytes_written < len(frame)
        with pytest.raises(ChannelClosedError):
            read_frame(ch)

    def test_corrupt_fails_the_checksum(self):
        ch = FaultyChannel(LoopbackChannel(),
                           FaultSchedule([Fault(0, "corrupt", frac=0.5)]))
        ch.write(self._frame())
        with pytest.raises((FrameCorruptError, HeaderCorruptError)):
            read_frame(ch)

    def test_reset_heals_and_drains_residue(self):
        frame = self._frame()
        ch = FaultyChannel(LoopbackChannel(),
                           FaultSchedule([Fault(0, "truncate", frac=0.3)]))
        ch.write(frame)
        ch.reset()
        assert ch.resets == 1 and len(ch.inner) == 0
        ch.write(frame)
        kind, meta, _ = read_frame(ch)
        assert kind == "blob" and meta["n"] == 1

    def test_clean_channel_is_transparent(self):
        frame = self._frame()
        ch = FaultyChannel(LoopbackChannel())
        ch.write(frame)
        assert read_frame(ch)[0] == "blob"
        assert ch.writes == 1 and ch.bytes_written == len(frame)

    def test_delay_lands_the_frame_late(self):
        ch = FaultyChannel(LoopbackChannel(), FaultSchedule(
            [Fault(0, "delay", delay_s=0.05)]))
        t0 = time.monotonic()
        ch.write(self._frame())
        assert time.monotonic() - t0 >= 0.05
        assert read_frame(ch)[0] == "blob"


# ---------------------------------------------------------------------------
# recovery: the unpaged exchange
# ---------------------------------------------------------------------------
class TestUnpagedRecovery:
    @pytest.mark.parametrize("chunk_bytes", [None, 256])
    @pytest.mark.parametrize("kind", ["drop", "truncate", "corrupt",
                                      "disconnect"])
    def test_recovers_bit_identical(self, pair, tok, kind, chunk_bytes):
        ctx, qry = _ctx_qry(pair[0])
        clean = _session(pair, tok, RemoteTransport("float32"))
        shared, _ = clean.share(ctx, KVCFG)
        ref = clean.generate(qry, shared, max_new=3)
        faulty = FaultyChannel(LoopbackChannel(),
                               FaultSchedule([Fault(0, kind, frac=0.5)]))
        sess = _session(pair, tok, RemoteTransport(
            "float32", channel=faulty, policy=FAST,
            chunk_bytes=chunk_bytes))
        shared2, _ = sess.share(ctx, KVCFG)
        np.testing.assert_array_equal(
            sess.generate(qry, shared2, max_new=3), ref)
        rec = sess.transport.log[-1]
        assert rec.attempts == 2 and rec.degradation is None
        assert len(faulty.schedule) == 0 and faulty.resets == 1
        assert sess.last_degradation is None

    def test_without_policy_the_typed_error_propagates(self, pair, tok):
        faulty = FaultyChannel(LoopbackChannel(),
                               FaultSchedule([Fault(0, "disconnect")]))
        sess = _session(pair, tok, RemoteTransport("float32",
                                                   channel=faulty))
        with pytest.raises(ChannelClosedError):
            sess.share(_ctx_qry(pair[0])[0], KVCFG)

    def test_exhausted_policy_raises_retries_exhausted(self, pair, tok):
        sess = _session(pair, tok, RemoteTransport(
            "float32", channel=_DeadChannel(), policy=FAST))
        with pytest.raises(RetriesExhaustedError) as ei:
            sess.share(_ctx_qry(pair[0])[0], KVCFG)
        assert ei.value.attempts == FAST.max_attempts

    def test_channel_factory_reconnects_between_attempts(self, pair, tok):
        """With a factory the retry gets a fresh channel (the old one is
        closed), as a socket reconnect would."""
        made = []

        def factory():
            made.append(FaultyChannel(LoopbackChannel(), FaultSchedule(
                [Fault(0, "disconnect")] if not made else [])))
            return made[-1]

        sess = _session(pair, tok, RemoteTransport(
            "float32", channel_factory=factory, policy=FAST))
        shared, _ = sess.share(_ctx_qry(pair[0])[0], KVCFG)
        assert shared is not None and len(made) == 2
        assert sess.transport.channel is made[1]
        assert sess.transport.last.attempts == 2


@pytest.mark.parametrize("chunk_bytes", [200, 700])
def test_streamed_retry_at_every_frame_is_bit_equal(pair, chunk_bytes):
    """A truncate at each frame index of a streamed share, then a retry
    under a fresh sid: the assembled K/V equal a clean share's bit for bit
    (a half-filled buffer of the aborted stream never leaks into the
    retried one)."""
    cfg, _ = pair
    rng = np.random.default_rng(3)
    kv = {p: torch.from_numpy(rng.standard_normal((4, 2, 13, 2, 16))
                              .astype(np.float32)) for p in ("k", "v")}
    select = torch.from_numpy(SELECT)
    clean = RemoteTransport("float32", chunk_bytes=chunk_bytes)
    want = clean.send(cfg, KVCFG, kv, select)
    n_frames = KVStreamSender(KVCFG, kv, select, wire_dtype="float32",
                              chunk_bytes=chunk_bytes).n_frames
    assert n_frames > 4
    for op in range(n_frames):
        faulty = FaultyChannel(LoopbackChannel(), FaultSchedule(
            [Fault(op, "truncate", frac=0.6)]))
        tr = RemoteTransport("float32", channel=faulty, policy=FAST,
                             chunk_bytes=chunk_bytes)
        got = tr.send(cfg, KVCFG, kv, select)
        assert tr.last.attempts == 2 and faulty.writes == op + 1 + n_frames
        for p in ("k", "v"):
            assert torch.equal(got.packed_kv[p], want.packed_kv[p])
        assert tr.last.n_bytes == clean.last.n_bytes


# ---------------------------------------------------------------------------
# recovery: the paged three-frame handshake
# ---------------------------------------------------------------------------
class TestPagedRecovery:
    def _paged_session(self, pair, tok, schedule, policy=FAST,
                       capacity=1 << 30):
        faulty = FaultyChannel(LoopbackChannel(), schedule)
        store = PageStore(page_len=4, capacity_bytes=capacity)
        tr = RemoteTransport("float32", channel=faulty, policy=policy,
                             store=store)
        return _session(pair, tok, tr), faulty, store

    @pytest.mark.parametrize("op", [0, 1, 2],
                             ids=["page_query", "page_need", "page_data"])
    def test_cold_share_recovers_at_every_frame(self, pair, tok, op):
        ctx, qry = _ctx_qry(pair[0])
        clean = _session(pair, tok, RemoteTransport("float32"))
        shared, _ = clean.share(ctx, KVCFG)
        ref = clean.generate(qry, shared, max_new=3)
        sess, faulty, store = self._paged_session(
            pair, tok, FaultSchedule([Fault(op, "truncate", frac=0.5)]))
        shared2, _ = sess.share(ctx, KVCFG)
        np.testing.assert_array_equal(
            sess.generate(qry, shared2, max_new=3), ref)
        assert sess.transport.log[-1].attempts == 2
        sess.transport.release_table()
        assert store.stats().pinned_bytes == 0

    @pytest.mark.parametrize("op", [3, 4, 5],
                             ids=["page_query", "page_need", "page_data"])
    def test_repeat_share_retry_ships_zero_pages(self, pair, tok, op):
        ctx, qry = _ctx_qry(pair[0])
        sess, faulty, store = self._paged_session(
            pair, tok, FaultSchedule([Fault(op, "disconnect")]))
        shared1, _ = sess.share(ctx, KVCFG)
        ref = sess.generate(qry, shared1, max_new=3)
        shared2, _ = sess.share(ctx, KVCFG)
        np.testing.assert_array_equal(
            sess.generate(qry, shared2, max_new=3), ref)
        rec = sess.transport.log[-1]
        assert rec.attempts == 2
        assert rec.pages_sent == 0 and rec.pages_hit == rec.pages_total
        assert rec.n_bytes == 0
        assert len(faulty.schedule) == 0
        sess.transport.release_table()
        assert store.stats().pinned_bytes == 0

    def test_handshake_death_leaks_no_pins(self, pair, tok):
        ctx, _ = _ctx_qry(pair[0])
        sess, faulty, store = self._paged_session(
            pair, tok, FaultSchedule([Fault(2, "truncate", frac=0.4)]),
            policy=None)
        with pytest.raises(RemoteProtocolError):
            sess.share(ctx, KVCFG)
        assert store.stats().pinned_bytes == 0
        faulty.reset()
        shared, _ = sess.share(ctx, KVCFG)
        assert shared is not None
        sess.transport.release_table()
        assert store.stats().pinned_bytes == 0

    def test_pool_overflow_mid_insert_rolls_back_pins(self, pair, tok):
        from repro_torch.store import PagePoolError
        ctx1, _ = _ctx_qry(pair[0], seed=1)
        ctx2, _ = _ctx_qry(pair[0], seed=2)
        sess, _, store = self._paged_session(pair, tok, FaultSchedule(),
                                             policy=None)
        sess.share(ctx1, KVCFG)
        used = store.stats().used_bytes
        sess2, _, store2 = self._paged_session(
            pair, tok, FaultSchedule(), policy=None, capacity=used)
        sess2.share(ctx1, KVCFG)
        pinned_before = store2.stats().pinned_bytes
        assert pinned_before == used
        with pytest.raises(PagePoolError):
            sess2.share(ctx2, KVCFG)
        assert store2.stats().pinned_bytes == pinned_before
        sess2.transport.release_table()
        assert store2.stats().pinned_bytes == 0


# ---------------------------------------------------------------------------
# one fault script through both packages' RemoteTransport
# ---------------------------------------------------------------------------
class _Recording:
    """Keeps every frame handed to the loopback it is mixed into."""

    def __init__(self):
        super().__init__()
        self.frames = []

    def write(self, data):
        self.frames.append(bytes(data))
        super().write(data)


class _Tape(_Recording, LoopbackChannel):
    pass


class _JTape(_Recording, jremote.LoopbackChannel):
    pass


def _replay(make_tr, tape, faulty, send, n_sends):
    outcomes = []
    tr = make_tr()
    for _ in range(n_sends):
        try:
            send(tr)
            outcomes.append(("ok", tr.log[-1].attempts, tr.log[-1].n_bytes,
                             tr.log[-1].pages_sent))
        except RuntimeError as e:       # either package's protocol error
            outcomes.append((type(e).__name__, getattr(e, "attempts", 1)))
            if hasattr(faulty, "reset"):
                faulty.reset()
    return outcomes, faulty.writes, faulty.bytes_written, faulty.resets, \
        [(f.op, f.kind) for f in faulty.schedule.fired], tape.frames


@pytest.mark.parametrize("mode", ["streamed", "monolithic", "paged"])
@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_fault_replay_matches_reference_transport(pair, mode, seed):
    """The same seeded fault script through both packages'
    RemoteTransport: the same outcomes and attempts, writes, bytes handed
    to the channel, resets, and byte-identical frames."""
    cfg, _ = pair
    rng = np.random.default_rng(10 + seed)
    x = {p: rng.standard_normal((4, 2, 9, 2, 16)).astype(np.float32)
         for p in ("k", "v")}
    tkv = {p: torch.from_numpy(a) for p, a in x.items()}
    jkv = {p: jnp.asarray(a) for p, a in x.items()}
    chunk = None if mode == "monolithic" else 300
    kinds = ("drop", "truncate", "corrupt", "disconnect")
    pol = dict(max_attempts=3, backoff_s=0.0, jitter=0.0)
    runs = {}
    for side in ("port", "ref"):
        R = jres if side == "ref" else None
        tape = _JTape() if side == "ref" else _Tape()
        sched = (jres.FaultSchedule if R else FaultSchedule).random(
            seed, 60, 0.3, kinds=kinds)
        faulty = (jres.FaultyChannel if R else FaultyChannel)(tape, sched)
        policy = (jres.RetryPolicy if R else RetryPolicy)(**pol)
        if R:
            make = lambda: jremote.RemoteTransport(         # noqa: E731
                "int8", channel=faulty, policy=policy, chunk_bytes=chunk,
                store=JPageStore(page_len=4) if mode == "paged" else None)
            send = lambda tr: tr.send(None, JKVCFG, jkv,    # noqa: E731
                                      jnp.asarray(SELECT))
        else:
            make = lambda: RemoteTransport(                  # noqa: E731
                "int8", channel=faulty, policy=policy, chunk_bytes=chunk,
                store=PageStore(page_len=4) if mode == "paged" else None)
            send = lambda tr: tr.send(cfg, KVCFG, tkv,      # noqa: E731
                                      torch.from_numpy(SELECT))
        runs[side] = _replay(make, tape, faulty, send, 6)
    assert runs["port"][:5] == runs["ref"][:5]
    assert runs["port"][5] == runs["ref"][5]
    assert runs["port"][4], "the script fired no fault"


# ---------------------------------------------------------------------------
# the degradation ladder
# ---------------------------------------------------------------------------
class TestDegradationLadder:
    def test_serialized_rung_serves_the_exact_fallback_tokens(self, pair,
                                                              tok):
        ctx, qry = _ctx_qry(pair[0])
        ref_sess = _session(pair, tok, SerializedTransport("float32"))
        ref_shared, _ = ref_sess.share(ctx, KVCFG)
        ref = ref_sess.generate(qry, ref_shared, max_new=3)
        res = Resilience(fallbacks=[
            ("serialized", SerializedTransport("float32")),
            ("baseline", None)])
        sess = _session(pair, tok, RemoteTransport(
            "float32", channel=_DeadChannel(),
            policy=RetryPolicy(max_attempts=2, backoff_s=0.0, jitter=0.0)),
            resilience=res)
        shared, _ = sess.share(ctx, KVCFG, rid=7)
        assert shared is not None
        np.testing.assert_array_equal(
            sess.generate(qry, shared, max_new=3), ref)
        ev = sess.last_degradation
        assert ev is not None and ev.stage == "serialized"
        assert ev.rid == 7 and ev.attempts == 2
        assert "RetriesExhaustedError" in ev.reason
        rec = sess.transport.log[-1]
        assert rec.degradation is ev and rec.n_bytes > 0
        assert res.fallbacks[0][1].log == []
        assert sess.degradations == [ev]

    def test_baseline_rung_is_text_only_zero_bytes(self, pair, tok):
        ctx, qry = _ctx_qry(pair[0])
        sess = _session(pair, tok,
                        RemoteTransport("float32", channel=_DeadChannel()),
                        resilience=Resilience())
        shared, _ = sess.share(ctx, KVCFG, rid=3)
        assert shared is None
        rec = sess.transport.log[-1]
        assert rec.n_bytes == 0 and rec.wire_dtype == "none"
        assert rec.degradation.stage == "baseline"
        assert sess.last_degradation.rid == 3
        toks = sess.generate(qry, None, max_new=2)
        assert toks.shape == (ctx.shape[0], 2)

    def test_healthy_share_clears_last_degradation(self, pair, tok):
        ctx, _ = _ctx_qry(pair[0])
        sess = _session(pair, tok, RemoteTransport("float32"),
                        resilience=Resilience())
        sess.degradations.append(DegradationEvent(stage="baseline"))
        sess.last_degradation = sess.degradations[-1]
        shared, _ = sess.share(ctx, KVCFG)
        assert shared is not None and sess.last_degradation is None

    def test_breaker_quarantines_the_sender(self, pair, tok):
        ctx, _ = _ctx_qry(pair[0])
        now = [0.0]
        breaker = CircuitBreaker(failure_threshold=1, reset_timeout_s=60.0,
                                 clock=lambda: now[0])
        dead = _DeadChannel()
        sess = _session(pair, tok, RemoteTransport("float32", channel=dead),
                        resilience=Resilience(breaker=breaker))
        sess.share(ctx, KVCFG)
        first = dead.write_attempts
        assert first >= 1 and breaker.state == "open"
        shared, _ = sess.share(ctx, KVCFG)
        assert shared is None and dead.write_attempts == first
        assert "circuit" in sess.last_degradation.reason
        now[0] = 120.0
        sess.share(ctx, KVCFG)
        assert dead.write_attempts == first + 1

    def test_transport_level_breaker_short_circuits(self, pair, tok):
        now = [0.0]
        breaker = CircuitBreaker(failure_threshold=1, reset_timeout_s=60.0,
                                 clock=lambda: now[0])
        dead = _DeadChannel()
        sess = _session(pair, tok, RemoteTransport(
            "float32", channel=dead, breaker=breaker))
        ctx, _ = _ctx_qry(pair[0])
        with pytest.raises(ChannelClosedError):
            sess.share(ctx, KVCFG)
        with pytest.raises(CircuitOpenError):
            sess.share(ctx, KVCFG)
        assert dead.write_attempts == 1

    def test_ladder_without_baseline_reraises(self, pair, tok):
        """Every rung failed and none is terminal: the primary's error
        propagates."""
        res = Resilience(fallbacks=[("serialized", RemoteTransport(
            "float32", channel=_DeadChannel()))])
        sess = _session(pair, tok,
                        RemoteTransport("float32", channel=_DeadChannel()),
                        resilience=res)
        with pytest.raises(ChannelClosedError):
            sess.share(_ctx_qry(pair[0])[0], KVCFG)

    def test_share_mapped_degrades_too(self, pair, tok):
        ctx, _ = _ctx_qry(pair[0])
        sess = _session(pair, tok,
                        RemoteTransport("float32", channel=_DeadChannel()),
                        resilience=default_resilience("float32"))
        shared, asg = sess.share_mapped(ctx, KVCFG, policy="identity",
                                        rid=5)
        assert shared is not None and shared.layers == asg.dst
        assert sess.last_degradation.stage == "serialized"
        assert sess.last_degradation.rid == 5


# ---------------------------------------------------------------------------
# the scheduler: degraded admissions and the quarantine, across packages
# ---------------------------------------------------------------------------
# monolithic frames (one write per attempt, two attempts): rid 1 recovers
# on its second attempt, rids 2 and 3 exhaust (serialized rung) and open
# the breaker, rid 4 is quarantined
SCRIPT = [Fault(1, "truncate"), Fault(3, "disconnect"), Fault(4, "disconnect"),
          Fault(5, "drop"), Fault(6, "drop")]


def _requests(cfg, n=5):
    rng = np.random.default_rng(9)
    return [Request(rid=i, context=rng.integers(4, cfg.vocab_size, 5 + i)
                    .astype(np.int32),
                    query=rng.integers(4, cfg.vocab_size, 4)
                    .astype(np.int32), max_new=3) for i in range(n)]


def _event_tuple(ev):
    return (ev.stage, ev.from_stage, ev.attempts, ev.rid,
            ev.reason.split(":")[0])


def _scheduler_run(side, pair, tiny_cfg, tiny_params, tok, reqs, ladder):
    R = side == "ref"
    mod = jres if R else None
    faults = [(mod.Fault if R else Fault)(f.op, f.kind, f.frac)
              for f in SCRIPT]
    faulty = (jres.FaultyChannel if R else FaultyChannel)(
        (jremote.LoopbackChannel if R else LoopbackChannel)(),
        (jres.FaultSchedule if R else FaultSchedule)(faults))
    policy = (jres.RetryPolicy if R else RetryPolicy)(
        max_attempts=2, backoff_s=0.0, jitter=0.0)
    breaker = (jres.CircuitBreaker if R else CircuitBreaker)(
        failure_threshold=2, reset_timeout_s=1e9)
    if ladder == "default":
        res = (jres.default_resilience if R else default_resilience)(
            "float32", breaker=breaker)
    else:
        res = (jres.Resilience if R else Resilience)(
            fallbacks=[("baseline", None)], breaker=breaker)
    tr = (jremote.RemoteTransport if R else RemoteTransport)(
        "float32", channel=faulty, policy=policy, chunk_bytes=None)
    if R:
        sess = JSession(JAgent("s", tiny_cfg, tiny_params, tok),
                        JAgent("r", tiny_cfg, tiny_params, tok), tr,
                        resilience=res)
        sched = JScheduler(sess, JKVCFG, config=JSchedulerConfig(
            capacity=2, prefix_bucket=8, query_bucket=4))
        comps, _ = sched.run([JRequest(rid=r.rid, context=r.context,
                                       query=r.query, max_new=r.max_new)
                              for r in reqs])
    else:
        sess = _session(pair, tok, tr, resilience=res)
        comps, _ = Scheduler(sess, KVCFG, config=SchedulerConfig(
            capacity=2, prefix_bucket=8, query_bucket=4)).run(reqs)
    return ([c.tokens.tolist() for c in comps],
            [None if c.degradation is None else _event_tuple(c.degradation)
             for c in comps],
            [_event_tuple(e) for e in sess.degradations],
            [(r.n_bytes, r.attempts, r.wire_dtype) for r in tr.log],
            (faulty.writes, faulty.bytes_written, faulty.resets))


@pytest.mark.parametrize("ladder", ["default", "baseline"])
def test_scheduler_degradations_match_reference(pair, tiny_cfg, tiny_params,
                                                tok, ladder):
    reqs = _requests(pair[0])
    got = _scheduler_run("port", pair, tiny_cfg, tiny_params, tok, reqs,
                         ladder)
    want = _scheduler_run("ref", pair, tiny_cfg, tiny_params, tok, reqs,
                          ladder)
    assert got == want
    stages = [None if e is None else e[0] for e in got[1]]
    rung = "serialized" if ladder == "default" else "baseline"
    assert stages == [None, None, rung, rung, rung]
    assert got[1][4][4] == "CircuitOpenError"
    assert [a for _, a, _ in got[3]][:2] == [1, 2]


def test_text_only_rows_answer_like_no_prefix_and_spare_neighbours(
        pair, tok):
    """A baseline row (zero prefix masked by prefix_lens=0) answers like
    prefill(query, None); the rows beside it answer as in a clean run, on
    both decode backends."""
    cfg, params = pair
    reqs = _requests(cfg)
    clean = _session(pair, tok, RemoteTransport("float32"))
    want, _ = serve_serial(clean, reqs, KVCFG)
    # a corrupt frame fails its share without breaking the channel
    dead = FaultSchedule([Fault(i, "corrupt") for i in (2, 3)])
    for backend in ("reference", "kernel"):
        sess = _session(pair, tok, RemoteTransport(
            "float32", channel=FaultyChannel(LoopbackChannel(),
                                             FaultSchedule(
                                                 list(dead._by_op.values()))),
            chunk_bytes=None), resilience=Resilience())
        got, _ = Scheduler(sess, KVCFG, config=SchedulerConfig(
            capacity=3, prefix_bucket=8, query_bucket=4,
            decode_backend=backend)).run(reqs)
        for c, w, r in zip(got, want, reqs):
            if c.rid in (2, 3):
                assert c.degradation.stage == "baseline"
                toks, _ = sess.receiver.generate(r.query[None], None,
                                                 max_new=r.max_new)
                assert c.tokens.tolist() == toks[0].tolist()
            else:
                assert c.degradation is None
                assert c.tokens.tolist() == w.tokens.tolist()


def test_quarantine_without_ladder_admits_text_only(pair, tok):
    """No Resilience: a share that raises is caught by the scheduler, the
    request admitted text only with a zero-byte record, and serve_serial
    reports the ladder's degradation per request."""
    cfg, _ = pair
    reqs = _requests(cfg, n=3)
    sess = _session(pair, tok, RemoteTransport(
        "float32", channel=FaultyChannel(LoopbackChannel(), FaultSchedule(
            [Fault(1, "corrupt")])), chunk_bytes=None))
    comps, _ = Scheduler(sess, KVCFG, config=SchedulerConfig(
        capacity=2, prefix_bucket=8, query_bucket=4)).run(reqs)
    assert [c.degradation is not None for c in comps] == [False, True, False]
    assert comps[1].degradation.reason.startswith(
        ("FrameCorruptError", "HeaderCorruptError"))
    rec = [r for r in sess.transport.log if r.degradation is not None]
    assert len(rec) == 1 and rec[0].n_bytes == 0
    toks, _ = sess.receiver.generate(reqs[1].query[None], None, max_new=3)
    assert comps[1].tokens.tolist() == toks[0].tolist()
    ser_sess = _session(pair, tok, RemoteTransport(
        "float32", channel=_DeadChannel()), resilience=Resilience())
    ser, _ = serve_serial(ser_sess, reqs[:1], KVCFG)
    assert ser[0].degradation.stage == "baseline"


# ---------------------------------------------------------------------------
# channel timeouts
# ---------------------------------------------------------------------------
class TestChannelTimeouts:
    def test_file_channel_stall_is_typed_timeout(self, tmp_path):
        tx = FileChannel(str(tmp_path), timeout_s=0.3)
        rx = FileChannel(str(tmp_path), timeout_s=0.3)
        tx.write(encode_frame("a", {}, {}))
        assert read_frame(rx)[0] == "a"
        with pytest.raises(ChannelTimeoutError):
            read_frame(rx)
        assert issubclass(ChannelTimeoutError, ChannelClosedError)

    def test_file_channel_writer_close_is_clean_close(self, tmp_path):
        tx = FileChannel(str(tmp_path), timeout_s=10.0)
        rx = FileChannel(str(tmp_path), timeout_s=10.0)
        tx.write(encode_frame("a", {}, {}))
        assert read_frame(rx)[0] == "a"
        tx.close()
        t0 = time.monotonic()
        with pytest.raises(ChannelClosedError) as ei:
            read_frame(rx)
        assert not isinstance(ei.value, ChannelTimeoutError)
        assert time.monotonic() - t0 < 5.0

    def test_socket_connect_honors_small_deadline(self):
        import socket as _socket
        probe = _socket.socket()
        probe.bind(("127.0.0.1", 0))
        port = probe.getsockname()[1]
        probe.close()
        t0 = time.monotonic()
        with pytest.raises(ChannelClosedError):
            SocketChannel.connect("127.0.0.1", port, timeout_s=0.3,
                                  retry_s=0.05)
        assert time.monotonic() - t0 < 5.0
