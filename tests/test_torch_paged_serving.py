"""Paged admission in the port's continuous-batching scheduler: the slot
insert that takes its prefix from a page-table gather equals the plain
insert, and the scheduler over a store-attached transport is token-identical
to its own unpaged run and to the reference's Scheduler with a
``PageStore(page_len=4)``, with the same dedup summary."""
import numpy as np
import pytest
import torch

import repro.store as jstore
from _torch_bridge import port_cfg, port_params
from repro.comm import Agent as JAgent
from repro.comm import CommSession as JSession
from repro.comm import InMemoryTransport as JInMemory
from repro.comm import SerializedTransport as JSerialized
from repro.core.types import KVCommConfig as JKVCommConfig
from repro.serving.scheduler import Request as JRequest
from repro.serving.scheduler import Scheduler as JScheduler
from repro.serving.scheduler import SchedulerConfig as JSchedulerConfig
from repro_torch.comm import (Agent, CommSession, InMemoryTransport,
                              SerializedTransport)
from repro_torch.core import protocol
from repro_torch.core.types import KVCommConfig
from repro_torch.data.synthetic import SyntheticTask, TaskConfig
from repro_torch.models import transformer as tfm
from repro_torch.serving.scheduler import (Request, Scheduler,
                                           SchedulerConfig, make_requests)
from repro_torch.store import PageStore

KW = dict(ratio=0.5, selector="prior_only")
SCHED = dict(capacity=3, prefix_bucket=8, query_bucket=4)


@pytest.fixture(scope="module")
def bridged(tiny_cfg, tiny_params):
    return port_cfg(tiny_cfg), port_params(tiny_params)


def _session(bridged, tok, transport):
    cfg, params = bridged
    return CommSession(Agent("s", cfg, params, tok),
                       Agent("r", cfg, params, tok), transport)


def _stream(tok):
    """Three distinct contexts, each asked twice (another query each time),
    with ragged budgets: the second ask of a context hits every page."""
    batches = [SyntheticTask(tok, TaskConfig("retrieval", num_facts=nf,
                                             seed=11 + nf)).batch(3)
               for nf in (4, 8)]
    base = make_requests(batches, pad=tok.PAD)
    reqs = []
    for i in range(6):
        ctx, qry = base[i // 2].context, base[(i * 5) % len(base)].query
        reqs.append(Request(rid=i, context=ctx, query=qry,
                            max_new=(4, 3, 1)[i % 3]))
    return reqs


def test_cache_insert_row_paged_equals_plain(bridged, tok):
    """The row prefilled at prefix bucket 16 goes into a table of prefix
    24, once from its own prefix and once from the store's gather."""
    cfg, params = bridged
    kvcfg = KVCommConfig(**KW)
    rng = np.random.default_rng(0)
    ctx = torch.from_numpy(rng.integers(4, tok.vocab_size, (1, 11)))
    kv = protocol.sender_prefill(params, cfg, ctx)
    select = protocol.make_selection(cfg, kvcfg)
    tr = InMemoryTransport(store=PageStore(page_len=4))
    shared = tr.send(cfg, kvcfg, kv, select)
    qry = torch.from_numpy(rng.integers(4, tok.vocab_size, (1, 4)))
    row = protocol.receiver_prefill(params, cfg, qry,
                                    protocol.pad_prefix(shared, 16),
                                    max_new=3).cache
    zero = protocol.pack_shared(kvcfg, {p: torch.zeros(
        (cfg.attn_layer_count, 3, 24, cfg.num_kv_heads,
         cfg.resolved_head_dim)) for p in ("k", "v")}, select)
    tables = [tfm.init_cache(cfg, 3, 7, shared=zero, device="cpu")
              for _ in range(2)]
    geom = dict(src_prefix=16, dst_prefix=24, row_max_len=7)
    tfm.cache_insert_row(tables[0], row, 1, **geom)
    prefix = tr.store.gather_prefix(tr.last_table, 16, device="cpu")
    tfm.cache_insert_row_paged(cfg, tables[1], row, 1, prefix,
                               layers=shared.layers, **geom)
    for a, b in zip(*(t["layers"] for t in tables)):
        for p in ("k", "v"):
            assert torch.equal(a[p], b[p])
    with pytest.raises(ValueError, match="packed cache"):
        tfm.cache_insert_row_paged(cfg, tables[1], row, 1, prefix,
                                   layers=(0,), **geom)


TRANSPORTS = {
    "mem": (lambda s: InMemoryTransport(store=s),
            lambda s: JInMemory(store=s)),
    "ser_float32": (lambda s: SerializedTransport("float32", store=s),
                    lambda s: JSerialized("float32", store=s)),
}


@pytest.mark.parametrize("name", sorted(TRANSPORTS))
def test_paged_scheduler_matches_unpaged_and_reference(
        tiny_cfg, tiny_params, bridged, tok, name):
    ours, theirs = TRANSPORTS[name]
    reqs = _stream(tok)
    kvcfg = KVCommConfig(**KW)
    unpaged, _ = Scheduler(_session(bridged, tok, ours(None)), kvcfg,
                           config=SchedulerConfig(**SCHED)).run(reqs)
    sess = _session(bridged, tok, ours(PageStore(page_len=4)))
    got, _ = Scheduler(sess, kvcfg, config=SchedulerConfig(
        decode_backend="kernel", **SCHED)).run(reqs)
    jsess = JSession(JAgent("s", tiny_cfg, tiny_params, tok),
                     JAgent("r", tiny_cfg, tiny_params, tok),
                     theirs(jstore.PageStore(page_len=4)))
    ref, _ = JScheduler(jsess, JKVCommConfig(**KW),
                        config=JSchedulerConfig(**SCHED)).run(
        [JRequest(rid=r.rid, context=r.context, query=r.query,
                  max_new=r.max_new) for r in reqs])
    assert [c.rid for c in got] == [c.rid for c in ref] == \
        [c.rid for c in unpaged]
    for a, b, c in zip(got, unpaged, ref):
        np.testing.assert_array_equal(a.tokens, b.tokens)
        np.testing.assert_array_equal(a.tokens, c.tokens)
    summary = sess.dedup_summary()
    assert summary == jsess.dedup_summary()
    assert summary["transfers"] == len(reqs)
    assert summary["hit_rate"] == 0.5      # every context's second ask


@pytest.mark.parametrize("wire", ["int8", "int4", "plan:int4,int8"])
def test_paged_lossy_wires_token_identical_to_unpaged(bridged, tok, wire):
    """Pages carry the wire's own bytes: a paged admission reads what the
    unpaged wire would have decoded, so tokens match exactly."""
    reqs = _stream(tok)
    kvcfg = KVCommConfig(**KW)
    runs = []
    for store in (None, PageStore(page_len=4)):
        sess = _session(bridged, tok, SerializedTransport(wire, store=store))
        runs.append(Scheduler(sess, kvcfg, config=SchedulerConfig(
            decode_backend="kernel", **SCHED)).run(reqs)[0])
    for a, b in zip(*runs):
        np.testing.assert_array_equal(a.tokens, b.tokens)
    assert sess.dedup_summary()["pages_sent"] > 0
