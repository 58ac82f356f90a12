"""The port's Scheduler against its own serve_serial (both backends, both
position modes, EOS early exit), dead-slot inertness, and the no-fallback
device rule. Complements test_torch_serving.py, which holds the slice to
the reference package."""
import numpy as np
import pytest

from _torch_bridge import port_cfg, port_params
from repro_torch.comm import (Agent, CommSession, InMemoryTransport,
                              SerializedTransport)
from repro_torch.core.types import KVCommConfig
from repro_torch.data.synthetic import SyntheticTask, TaskConfig
from repro_torch.serving.scheduler import (Scheduler, SchedulerConfig,
                                           make_requests, serve_serial)

KW = dict(ratio=0.5, selector="prior_only")
SCHED = dict(capacity=3, prefix_bucket=8, query_bucket=4)


def _stream(tok, n=6, max_new=(4, 2, 1)):
    batches = [SyntheticTask(tok, TaskConfig("retrieval", num_facts=nf,
                                             seed=11 + nf)).batch(n // 2)
               for nf in (4, 8)]
    reqs = make_requests(batches, pad=tok.PAD)[:n]
    for i, r in enumerate(reqs):
        r.max_new = max_new[i % len(max_new)]
    return reqs


@pytest.fixture(scope="module")
def bridged(tiny_cfg, tiny_params):
    return port_cfg(tiny_cfg), port_params(tiny_params)


def _session(bridged, tok, transport):
    cfg, params = bridged
    return CommSession(Agent("s", cfg, params, tok),
                       Agent("r", cfg, params, tok), transport)


@pytest.mark.parametrize("backend", ["reference", "kernel"])
@pytest.mark.parametrize("pos_mode", ["shift", "zero_unselected"])
def test_scheduler_matches_own_serve_serial(bridged, tok, backend,
                                            pos_mode):
    kvcfg = KVCommConfig(pos_mode=pos_mode, **KW)
    sess = _session(bridged, tok, SerializedTransport("float32",
                                                      packed=False))
    reqs = _stream(tok, n=5, max_new=(5, 3, 1))
    ser, _ = serve_serial(sess, reqs, kvcfg, backend="reference")
    got, _ = Scheduler(sess, kvcfg, config=SchedulerConfig(
        decode_backend=backend, **SCHED)).run(reqs)
    for a, b in zip(ser, got):
        np.testing.assert_array_equal(a.tokens, b.tokens)


def test_eos_early_exit_parity(bridged, tok):
    sess = _session(bridged, tok, InMemoryTransport())
    kvcfg = KVCommConfig(**KW)
    reqs = _stream(tok, n=6, max_new=(8, 8, 8))
    full, _ = serve_serial(sess, reqs, kvcfg)
    counts = {}
    for c in full:
        for tkn in c.tokens.tolist()[1:]:
            counts[tkn] = counts.get(tkn, 0) + 1
    eos = max(counts, key=counts.get)
    ser, _ = serve_serial(sess, reqs, kvcfg, eos_token=eos)
    got, _ = Scheduler(sess, kvcfg, config=SchedulerConfig(
        decode_backend="kernel", eos_token=eos, capacity=2, prefix_bucket=8,
        query_bucket=4)).run(reqs)
    for a, b in zip(ser, got):
        np.testing.assert_array_equal(a.tokens, b.tokens)
    assert any(len(c.tokens) < 8 for c in ser)


def test_dead_slots_are_inert(bridged, tok):
    """A retired slot's row keeps decoding garbage under a frozen write
    cursor; poisoning its buffers must not move a live row's tokens."""
    import torch
    sess = _session(bridged, tok, InMemoryTransport())
    kvcfg = KVCommConfig(**KW)
    reqs = _stream(tok, n=4, max_new=(2, 6))
    sched = Scheduler(sess, kvcfg, config=SchedulerConfig(
        decode_backend="kernel", **SCHED))
    base, _ = sched.run(reqs)
    orig = sched.session.receiver.ragged_step

    def poisoned(tokens, cache, shared, prefix_lens, active, backend):
        dead = ~active
        for e in cache["layers"]:
            e["k"][dead] = 1e4
            e["v"][dead] = -1e4
        return orig(tokens, cache, shared, prefix_lens, active, backend)

    sess.receiver.ragged_step = poisoned
    got, _ = sched.run(reqs)
    for a, b in zip(base, got):
        np.testing.assert_array_equal(a.tokens, b.tokens)
    assert torch.all(torch.isfinite(sched.state["cur_tok"].float()))


def test_entry_points_refuse_missing_card(monkeypatch):
    """No silent CPU fallback: a default (cuda) request with no card
    raises; the CPU runs only when asked for."""
    import torch
    from repro_torch import resolve_device
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device()
    assert resolve_device("cpu").type == "cpu"
