"""The whole slice: the port's continuous-batching Scheduler on the kernel
backend (its plain version on the CPU) against the reference's
serve_serial, token for token, on bridged weights and the same requests.
The port against its own serve_serial is in test_torch_scheduler.py."""
import numpy as np
import pytest

from _torch_bridge import port_cfg, port_params
from repro.comm import Agent as JAgent
from repro.comm import CommSession as JSession
from repro.comm import InMemoryTransport as JInMemory
from repro.comm import SerializedTransport as JSerialized
from repro.core.types import KVCommConfig as JKVCommConfig
from repro.serving.scheduler import serve_serial as jserve_serial
from repro_torch.comm import (Agent, CommSession, InMemoryTransport,
                              SerializedTransport)
from repro_torch.core.types import KVCommConfig
from repro_torch.data.synthetic import SyntheticTask, TaskConfig
from repro_torch.serving.scheduler import (Scheduler, SchedulerConfig,
                                           make_requests)

KW = dict(ratio=0.5, selector="prior_only")
SCHED = dict(capacity=3, prefix_bucket=8, query_bucket=4)


def _stream(tok, n=6, max_new=(4, 2, 1)):
    """Ragged contexts and ragged budgets (the reference's test stream)."""
    batches = [SyntheticTask(tok, TaskConfig("retrieval", num_facts=nf,
                                             seed=11 + nf)).batch(n // 2)
               for nf in (4, 8)]
    reqs = make_requests(batches, pad=tok.PAD)[:n]
    for i, r in enumerate(reqs):
        r.max_new = max_new[i % len(max_new)]
    return reqs


def _jax_requests(reqs):
    from repro.serving.scheduler import Request as JRequest
    return [JRequest(rid=r.rid, context=r.context, query=r.query,
                     max_new=r.max_new, answer=r.answer) for r in reqs]


@pytest.fixture(scope="module")
def bridged(tiny_cfg, tiny_params):
    return port_cfg(tiny_cfg), port_params(tiny_params)


def _session(bridged, tok, transport):
    cfg, params = bridged
    return CommSession(Agent("s", cfg, params, tok),
                       Agent("r", cfg, params, tok), transport)


@pytest.mark.parametrize("transports", [
    (lambda: InMemoryTransport(), lambda: JInMemory()),
    (lambda: InMemoryTransport(packed=False),
     lambda: JInMemory(packed=False)),
    (lambda: SerializedTransport("float32"),
     lambda: JSerialized("float32")),
], ids=["mem_packed", "mem_dense", "ser_packed"])
def test_scheduler_matches_reference_serve_serial(tiny_cfg, tiny_params,
                                                  bridged, tok, transports):
    ours_tr, ref_tr = transports
    reqs = _stream(tok)
    jsess = JSession(JAgent("s", tiny_cfg, tiny_params, tok),
                     JAgent("r", tiny_cfg, tiny_params, tok), ref_tr())
    ref, _ = jserve_serial(jsess, _jax_requests(reqs), JKVCommConfig(**KW))
    got, stats = Scheduler(
        _session(bridged, tok, ours_tr()), KVCommConfig(**KW),
        config=SchedulerConfig(decode_backend="kernel", **SCHED)).run(reqs)
    assert [c.rid for c in got] == [c.rid for c in ref]
    for a, b in zip(ref, got):
        np.testing.assert_array_equal(a.tokens, b.tokens)
    assert stats["occupancy"] > 0 and len(reqs) > SCHED["capacity"]


def test_calibrated_kvcomm_serving_matches_reference(tiny_cfg, tiny_params,
                                                     bridged, tok):
    """The launcher's path: one-sample calibration, frozen kvcomm
    selection under a task key, then the scheduler."""
    kw = dict(ratio=0.5, alpha=0.7)
    calib = SyntheticTask(tok, TaskConfig("retrieval", num_facts=6,
                                          seed=42)).batch(1)
    reqs = _stream(tok, n=4, max_new=(3, 2))
    jsess = JSession(JAgent("s", tiny_cfg, tiny_params, tok),
                     JAgent("r", tiny_cfg, tiny_params, tok), JInMemory())
    jsess.calibrate(calib["context"], calib["query"], key="t")
    ref, _ = jserve_serial(jsess, _jax_requests(reqs), JKVCommConfig(**kw),
                           calib_key="t")
    sess = _session(bridged, tok, InMemoryTransport())
    sess.calibrate(calib["context"], calib["query"], key="t")
    np.testing.assert_array_equal(
        sess.selection(KVCommConfig(**kw), key="t").numpy(),
        np.asarray(jsess.selection(JKVCommConfig(**kw), key="t")))
    got, _ = Scheduler(sess, KVCommConfig(**kw), calib_key="t",
                       config=SchedulerConfig(decode_backend="kernel",
                                              **SCHED)).run(reqs)
    for a, b in zip(ref, got):
        np.testing.assert_array_equal(a.tokens, b.tokens)
