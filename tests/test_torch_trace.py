"""The port's recorder (``repro_torch.utils.trace``) around one tiny
``Scheduler.run`` on the CPU: the span tree and its counters, an inactive
recorder that adds nothing, completions unchanged by recording, and each
span on the profiler's clock through the recording's anchor."""
import dataclasses
from collections import defaultdict

import numpy as np
import pytest
import torch

from repro_torch.comm import (Agent, CommSession, InMemoryTransport,
                              SerializedTransport)
from repro_torch.configs.registry import get_config
from repro_torch.core.types import KVCommConfig
from repro_torch.data.synthetic import SyntheticTask, TaskConfig
from repro_torch.data.tokenizer import SymbolTokenizer
from repro_torch.models import transformer as tfm
from repro_torch.serving.scheduler import (Scheduler, SchedulerConfig,
                                           make_requests)
from repro_torch.utils import trace

KVCFG = KVCommConfig(ratio=0.5, selector="prior_only")
STATS = {"iterations", "steps", "occupancy", "tokens"}
NAMES = {"scheduler.run", "scheduler.setup", "scheduler.admit",
         "sender.prefill", "transport.send", "wire.host_copy",
         "receiver.prefill", "scheduler.insert", "scheduler.step",
         "scheduler.host_read"}
# spans of one admission, below its scheduler.admit
ADMISSION = {"sender.prefill", "transport.send", "wire.host_copy",
             "receiver.prefill", "scheduler.insert"}
TRANSPORTS = {"int8": lambda: SerializedTransport("int8"),
              "in_memory": InMemoryTransport}


@pytest.fixture(scope="module")
def pair():
    tok = SymbolTokenizer(16, 8)
    cfg = dataclasses.replace(
        get_config("llama3.2-3b-pair"), num_layers=4, d_model=64, d_ff=128,
        num_heads=4, num_kv_heads=2, head_dim=16, vocab_size=tok.vocab_size,
        dtype="float32", tie_embeddings=False)
    batches = [SyntheticTask(tok, TaskConfig("retrieval", num_facts=nf,
                                             seed=11 + nf)).batch(3)
               for nf in (4, 8)]
    reqs = make_requests(batches, pad=tok.PAD)
    for i, r in enumerate(reqs):
        r.max_new = (4, 2, 1)[i % 3]
    return tok, cfg, tfm.init_params(cfg, 0, device="cpu"), reqs


def _scheduler(pair, transport):
    tok, cfg, params, _ = pair
    sess = CommSession(Agent("s", cfg, params, tok),
                       Agent("r", cfg, params, tok), TRANSPORTS[transport]())
    return Scheduler(sess, KVCFG, config=SchedulerConfig(
        capacity=3, prefix_bucket=8, query_bucket=4))


def _recorded(pair, transport):
    with trace.recording():
        return _scheduler(pair, transport).run(pair[3])


@pytest.mark.parametrize("transport", sorted(TRANSPORTS))
def test_span_tree(pair, transport):
    reqs = pair[3]
    _, stats = _recorded(pair, transport)
    tr = stats["trace"]
    spans = {s["id"]: s for s in tr["spans"]}
    assert {s["name"] for s in spans.values()} <= NAMES
    roots = [s for s in spans.values() if s["parent"] not in spans]
    assert [s["name"] for s in roots] == ["scheduler.run"]
    root = roots[0]
    for s in spans.values():
        assert root["start_ns"] <= s["start_ns"] <= s["end_ns"] \
            <= root["end_ns"]
        assert s["stream_ms"] is None                # no card here

    def admission_of(s):
        while s["parent"] in spans:
            s = spans[s["parent"]]
            if s["name"] == "scheduler.admit":
                return s
        return None

    admits = [s for s in spans.values() if s["name"] == "scheduler.admit"]
    assert sorted(s["rid"] for s in admits) == sorted(r.rid for r in reqs)
    below = defaultdict(set)
    for s in spans.values():
        a = admission_of(s)
        if s["name"] in ADMISSION:
            assert a is not None and s["rid"] == a["rid"], s
            below[a["rid"]].add(s["name"])
        elif s["name"] != "scheduler.admit":
            assert a is None, s
    for r in reqs:
        want = {"sender.prefill", "transport.send", "receiver.prefill"}
        if r.max_new > 1:
            want.add("scheduler.insert")
        if transport == "int8":
            want.add("wire.host_copy")
        assert below[r.rid] == want
    steps = [s for s in spans.values() if s["name"] == "scheduler.step"]
    assert len(steps) == stats["steps"] > 0
    # every prefill on the CPU takes the plain core: the sender's and the
    # receiver's, one self-attention call a layer each; every ragged step
    # one one-token call a layer, on the plain core (the reference
    # backend); no experts
    L = pair[1].attn_layer_count
    assert tr["counters"] == {"admit.count": len(reqs),
                              "admit.host_syncs": 0,
                              "step.count": stats["steps"],
                              "prefill.attn_kernel": 0,
                              "prefill.attn_plain": 2 * L * len(reqs),
                              "decode.attn_kernel": 0,
                              "decode.attn_plain": L * stats["steps"],
                              "moe.grouped": 0, "moe.loop": 0,
                              "moe.assignments": 0}
    assert len(tr["anchor"]) == 2


def test_inactive_recorder_adds_nothing(pair, monkeypatch):
    made = []
    monkeypatch.setattr(trace, "Span", lambda *a: made.append(a[1]))
    monkeypatch.setattr(trace, "Events", lambda: made.append("events"))
    _, stats = _scheduler(pair, "int8").run(pair[3])
    assert set(stats) == STATS
    assert made == [] and trace._REC is None


@pytest.mark.parametrize("transport", sorted(TRANSPORTS))
def test_completions_unchanged_by_recording(pair, transport):
    off, stats_off = _scheduler(pair, transport).run(pair[3])
    on, stats_on = _recorded(pair, transport)
    assert [c.rid for c in on] == [c.rid for c in off]
    for a, b in zip(off, on):
        np.testing.assert_array_equal(a.tokens, b.tokens)
    assert {k: stats_on[k] for k in STATS} == stats_off


def test_nested_recordings_and_counters():
    with trace.recording() as rec:
        with trace.recording() as inner:
            assert inner is rec
        mark = rec.mark()
        trace.count("x", 2)
        with trace.span("a", rid=7):
            with trace.span("b"):
                trace.host_sync(3)          # not inside an admission
            with trace.span(trace.ADMISSION):
                with trace.span("c", rid=9):
                    trace.host_sync(2)
        out = rec.export(mark)
    assert trace._REC is None and not trace.active()
    assert trace.span("a") is trace.span("b")     # the shared no-op
    by = {s["name"]: s for s in out["spans"]}
    assert by["b"]["rid"] == 7 and by["b"]["parent"] == by["a"]["id"]
    assert by[trace.ADMISSION]["rid"] == 7 and by["c"]["rid"] == 9
    assert out["counters"] == {"x": 2, trace.ADMIT_SYNCS: 2}


def test_spans_on_the_profiler_clock(pair):
    from torch.profiler import ProfilerActivity, profile
    sched = _scheduler(pair, "int8")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _, stats = sched.run(pair[3])
    tr = stats["trace"]                       # the profiler turned it on
    p0, t0 = tr["anchor"]
    events = defaultdict(list)
    for e in prof.profiler.kineto_results.events():
        if e.name() in NAMES:
            events[e.name()].append(e.start_ns())
    spans = defaultdict(list)
    for s in tr["spans"]:
        spans[s["name"]].append(s["start_ns"] - p0 + t0)
    assert set(spans) == set(events)
    for name, starts in spans.items():
        assert len(starts) == len(events[name]), name
        gap = np.abs(np.sort(starts) - np.sort(events[name]))
        assert gap.max() < 2e6, (name, gap.max())


def test_threads_keep_their_own_stacks_and_lose_no_count():
    """More threads than cores counting into one recording at a short
    switch interval: no count is lost and no span of one thread nests
    under another's."""
    import os
    import sys
    import threading
    workers, each = 2 * (os.cpu_count() or 2), 2000
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with trace.recording() as rec:
            def work(i):
                with trace.span("worker", rid=i):
                    for _ in range(each):
                        trace.count("n")
                    with trace.span("inner"):
                        pass
            threads = [threading.Thread(target=work, args=(i,))
                       for i in range(workers)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60)
            assert not any(t.is_alive() for t in threads)
            out = rec.export()
    finally:
        sys.setswitchinterval(old)
    assert out["counters"] == {"n": workers * each}
    spans = {s["id"]: s for s in out["spans"]}
    for s in spans.values():
        if s["name"] == "worker":
            assert s["parent"] is None
        else:
            assert spans[s["parent"]]["rid"] == s["rid"]


@pytest.mark.parametrize("grouped", [False, True], ids=["loop", "grouped"])
def test_moe_and_decode_counters(monkeypatch, grouped):
    """mellum2-12b cut to one period (3 windowed layers, then a full one,
    experts in each) through ``Scheduler.run`` on the kernel backend: a
    ragged step's one-token calls run K1 on the full layer alone (25%),
    every MoE call counts its path and its assignments, and its expert
    computation is a ``moe.experts`` span, L of them inside each step.
    ``grouped`` sends the calls down the grouped path (its plain version
    on the CPU) as the card's bf16 calls go."""
    from repro_torch.models import layers
    tok = SymbolTokenizer(16, 8)
    cfg = get_config("mellum2-12b").reduced(
        num_experts=8, num_experts_per_tok=2, vocab_size=tok.vocab_size,
        dtype="float32")
    if grouped:
        monkeypatch.setattr(layers, "moe_on_kernel", lambda p, x, cfg: True)
    params = tfm.init_params(cfg, 0, device="cpu")
    batches = [SyntheticTask(tok, TaskConfig("retrieval", num_facts=4,
                                             seed=5)).batch(3)]
    reqs = make_requests(batches, pad=tok.PAD)
    sess = CommSession(Agent("s", cfg, params, tok),
                       Agent("r", cfg, params, tok), InMemoryTransport())
    sched = Scheduler(sess, KVCFG, config=SchedulerConfig(
        capacity=3, prefix_bucket=8, query_bucket=4,
        decode_backend="kernel"))
    with trace.recording():
        _, stats = sched.run(reqs)
    tr = stats["trace"]
    c = tr["counters"]
    L, k = cfg.attn_layer_count, cfg.num_experts_per_tok
    assert L == 4 and stats["steps"] > 0
    assert c["decode.attn_kernel"] == stats["steps"]
    assert c["decode.attn_plain"] == 3 * stats["steps"]
    calls = c["moe.grouped"] + c["moe.loop"]
    assert c["moe.grouped" if grouped else "moe.loop"] == calls > 0
    assert c["moe.assignments"] % k == 0 and c["moe.assignments"] >= k * calls
    by_id = {s["id"]: s for s in tr["spans"]}
    moe = [s for s in tr["spans"] if s["name"] == "moe.experts"]
    assert len(moe) == calls
    in_step = [s for s in moe
               if by_id[s["parent"]]["name"] == "scheduler.step"]
    assert len(in_step) == L * stats["steps"]
