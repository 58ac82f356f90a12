"""The port's comparison methods against the reference's, through
``CommSession.run`` on the same bridged weights (float32 tiny pair: sender
PRNGKey(0), receiver PRNGKey(1)) and the same retrieval batch of 4.

Tolerances, stated: wire bytes, FLOPs, M and the selection are identical.
A prediction is an argmax over random-weight logits, so it must be
identical wherever the reference's top-2 margin at that row is at least
MARGIN; below it, the row's receiver logits are held to LOGIT_TOL instead
(float32 through a 4-layer model, summed in another order). CIPHER's soft
embeddings, AC's hiddens and an injected forward are held to PIECE_TOL."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_bridge import port_cfg, port_params
from repro.comm import METHODS as JMETHODS
from repro.comm import Agent as JAgent
from repro.comm import CommSession as JSession
from repro.core.types import KVCommConfig as JKVCommConfig
from repro.data.synthetic import SyntheticTask, TaskConfig
from repro.models import transformer as jtfm
from repro_torch.comm import (METHODS, Agent, CommSession, get_method,
                              register)
from repro_torch.comm.methods import CommMethod
from repro_torch.core.types import KVCommConfig
from repro_torch.models import transformer as ttfm
from repro_torch.serving.engine import CommEngine

MARGIN = 1e-3
LOGIT_TOL = 1e-4
PIECE_TOL = dict(atol=1e-5, rtol=1e-5)
NLD_TOKENS = 4
KW = dict(ratio=0.5, alpha=0.7)
RUN_METHODS = sorted(JMETHODS)


@pytest.fixture(scope="module")
def pair(tiny_cfg):
    s = jtfm.init_params(tiny_cfg, jax.random.PRNGKey(0))
    r = jtfm.init_params(tiny_cfg, jax.random.PRNGKey(1))
    return tiny_cfg, s, r, port_cfg(tiny_cfg), port_params(s), port_params(r)


@pytest.fixture(scope="module")
def batch(tok):
    return SyntheticTask(tok, TaskConfig("retrieval", num_facts=4,
                                         seed=3)).batch(4)


def _sessions(pair, tok):
    jcfg, js, jr, cfg, s, r = pair
    return (JSession(JAgent("s", jcfg, js, tok), JAgent("r", jcfg, jr, tok)),
            CommSession(Agent("s", cfg, s, tok), Agent("r", cfg, r, tok)))


@pytest.fixture(scope="module")
def scores(pair, batch, tok):
    """The reference's Eq. (1) scores on one sample: both sides select from
    the same numbers, so the selection is the method's alone."""
    jsess, _ = _sessions(pair, tok)
    return np.array(jsess.calibrate(batch["context"][:1],
                                    batch["query"][:1]))


def _record_logits(agent, into, key):
    """Keep the last-position logits each predict_last sees."""
    predict = agent.predict_last

    def recorded(logits):
        into[key] = np.asarray(logits, np.float32)[:, -1]
        return predict(logits)

    agent.predict_last = recorded


def test_registry_matches_reference():
    assert set(METHODS) == set(JMETHODS)


def test_unknown_method_raises(pair, batch, tok):
    _, sess = _sessions(pair, tok)
    with pytest.raises(ValueError, match="unknown method"):
        sess.run("quantum_telepathy", batch)


def test_register_and_get_method():
    class Echo(CommMethod):
        name = "echo_test"

    try:
        assert register(Echo()) is get_method("echo_test")
    finally:
        METHODS.pop("echo_test")
    with pytest.raises(ValueError):
        register(CommMethod())


@pytest.mark.parametrize("policy", ["identity", "depth_proportional",
                                    "score_greedy"])
def test_hetero_kvcomm_matches_reference(pair, batch, tok, policy):
    """hetero_kvcomm on a 4-layer sender and a 6-layer receiver (PRNGKey 2)
    through both packages, on the reference's sender-side scores: bytes,
    FLOPs, M and the layer maps identical, predictions under the margin
    rule."""
    import dataclasses
    jcfg, js, _, cfg, s, _ = pair
    jcfg6 = dataclasses.replace(jcfg, num_layers=6)
    jr6 = jtfm.init_params(jcfg6, jax.random.PRNGKey(2))
    jsess = JSession(JAgent("s", jcfg, js, tok), JAgent("r", jcfg6, jr6, tok))
    sess = CommSession(Agent("s", cfg, s, tok),
                       Agent("r", port_cfg(jcfg6), port_params(jr6), tok))
    src_scores = np.array(jsess.calibrate_side(
        "sender", batch["context"][:1], batch["query"][:1]))
    logits = {}
    _record_logits(jsess.receiver, logits, "ref")
    _record_logits(sess.receiver, logits, "port")
    want = jsess.run("hetero_kvcomm", batch, kvcfg=JKVCommConfig(**KW),
                     scores=jnp.asarray(src_scores), layer_map=policy)
    got = sess.run("hetero_kvcomm", batch, kvcfg=KVCommConfig(**KW),
                   scores=torch.from_numpy(src_scores), layer_map=policy)
    assert (got.wire_bytes, got.flops) == (want.wire_bytes, want.flops)
    for k in ("M", "src_layers", "dst_layers"):
        assert got.extras[k] == want.extras[k], k
    top2 = np.sort(logits["ref"], axis=-1)[:, -2:]
    clear = top2[:, 1] - top2[:, 0] >= MARGIN
    np.testing.assert_array_equal(got.preds[clear],
                                  np.asarray(want.preds)[clear])
    np.testing.assert_allclose(logits["port"][~clear], logits["ref"][~clear],
                               atol=LOGIT_TOL, rtol=LOGIT_TOL)


@pytest.mark.parametrize("method", RUN_METHODS)
def test_method_matches_reference(pair, batch, tok, scores, method):
    jsess, sess = _sessions(pair, tok)
    logits = {}
    _record_logits(jsess.receiver, logits, "ref")
    _record_logits(sess.receiver, logits, "port")
    want = jsess.run(method, batch, kvcfg=JKVCommConfig(**KW),
                     scores=jnp.asarray(scores), nld_tokens=NLD_TOKENS)
    got = sess.run(method, batch, kvcfg=KVCommConfig(**KW),
                   scores=torch.from_numpy(scores), nld_tokens=NLD_TOKENS)
    assert got.wire_bytes == want.wire_bytes
    assert got.flops == want.flops
    assert got.extras.get("M") == want.extras.get("M")
    if "select" in want.extras:
        np.testing.assert_array_equal(got.extras["select"],
                                      np.asarray(want.extras["select"]))
    assert (got.transfer is None) == (want.transfer is None)
    if want.transfer is not None:
        assert got.transfer.kind == want.transfer.kind
        assert got.transfer.layers == want.transfer.layers
        assert got.transfer.context_len == want.transfer.context_len
    assert isinstance(got.preds, np.ndarray) and got.preds.shape == (4,)
    assert got.latency_s > 0
    assert got.accuracy == float(np.mean(got.preds == batch["answer"]))
    top2 = np.sort(logits["ref"], axis=-1)[:, -2:]
    clear = top2[:, 1] - top2[:, 0] >= MARGIN
    np.testing.assert_array_equal(got.preds[clear],
                                  np.asarray(want.preds)[clear])
    np.testing.assert_allclose(logits["port"][~clear], logits["ref"][~clear],
                               atol=LOGIT_TOL, rtol=LOGIT_TOL)


def test_cipher_soft_embeddings_match(pair, batch, tok):
    jsess, sess = _sessions(pair, tok)
    jtoks, jembs = jsess.sender.message(batch["context"], NLD_TOKENS)
    toks, embs = sess.sender.message(batch["context"], NLD_TOKENS)
    np.testing.assert_array_equal(toks, np.asarray(jtoks))
    assert embs.dtype == torch.float32
    assert embs.shape == (4, NLD_TOKENS, pair[3].d_model)
    np.testing.assert_allclose(embs.numpy(), np.asarray(jembs), **PIECE_TOL)


def test_ac_hiddens_match(pair, batch, tok):
    jsess, sess = _sessions(pair, tok)
    got = sess.sender.export_hiddens(batch["context"])
    want = np.asarray(jsess.sender.export_hiddens(batch["context"]))
    assert got.shape == want.shape == (4, 4, pair[3].d_model)
    np.testing.assert_allclose(got.numpy(), want, **PIECE_TOL)


@pytest.mark.parametrize("mode", ["replace", "sum", "mean"])
def test_injected_forward_matches(pair, batch, tok, mode):
    """AC's receiver forward: the sender's hiddens merged at layer 2, the
    hiddens captured before the merge, the logits after it."""
    jcfg, js, jr, cfg, s, r = pair
    jsess, sess = _sessions(pair, tok)
    vec = np.array(jsess.sender.export_hiddens(batch["context"]))
    mask = np.array([False, False, True, False])
    qry = sess.receiver.with_bos(batch["query"])
    want = jtfm.apply_model(jr, jcfg, jnp.asarray(qry), mode="train",
                            capture_hidden=True,
                            inject={"vec": jnp.asarray(vec),
                                    "mask": jnp.asarray(mask), "mode": mode})
    got = ttfm.apply_model(r, cfg, torch.from_numpy(qry).long(),
                           mode="train", capture_hidden=True,
                           inject={"vec": torch.from_numpy(vec),
                                   "mask": torch.from_numpy(mask),
                                   "mode": mode})
    np.testing.assert_allclose(got.logits.numpy(), np.asarray(want.logits),
                               **PIECE_TOL)
    np.testing.assert_allclose(got.hiddens.numpy(), np.asarray(want.hiddens),
                               **PIECE_TOL)


def test_inject_refuses_packed_cache(pair, batch, tok):
    _, sess = _sessions(pair, tok)
    kvcfg = KVCommConfig(ratio=0.5, selector="prior_only")
    shared, _ = sess.share(batch["context"], kvcfg)
    assert shared.is_packed
    cfg, r = pair[3], pair[5]
    qry = torch.from_numpy(batch["query"]).long()
    cache = ttfm.init_cache(cfg, 4, qry.shape[1], shared=shared,
                            device="cpu")
    inject = {"vec": torch.zeros(4, 4, cfg.d_model),
              "mask": torch.ones(4, dtype=torch.bool), "mode": "sum"}
    with pytest.raises(ValueError, match="dense path"):
        ttfm.apply_model(r, cfg, qry, mode="cached", cache=cache,
                         shared=shared, inject=inject)


@pytest.mark.parametrize("method", ["kvcomm", "baseline", "skyline", "nld"])
def test_engine_matches_session(pair, batch, tok, scores, method):
    cfg, s, r = pair[3:]
    eng = CommEngine(cfg, s, r, tok)
    _, sess = _sessions(pair, tok)
    kw = dict(kvcfg=KVCommConfig(**KW), scores=torch.from_numpy(scores))
    a = eng.run(method, batch, nld_tokens=NLD_TOKENS, **kw)
    b = sess.run(method, batch, nld_tokens=NLD_TOKENS, **kw)
    np.testing.assert_array_equal(a.preds, b.preds)
    assert (a.wire_bytes, a.flops, a.accuracy) == \
        (b.wire_bytes, b.flops, b.accuracy)
    assert eng.channel.total_bytes == sess.transport.total_bytes


def test_receiver_decode_continues_prefill(pair, batch, tok):
    """The eager decode step equals the cached step of generate's first
    token."""
    _, sess = _sessions(pair, tok)
    rx = sess.receiver
    out = rx.prefill(batch["query"], None, max_new=2)
    tok0 = torch.argmax(out.logits[:, -1], -1)[:, None]
    ref = rx.generate(batch["query"], None, max_new=2)[0]
    step = rx.decode(tok0, out.cache)
    np.testing.assert_array_equal(rx.predict_last(step.logits),
                                  ref[:, 1].numpy())
    assert step.logits.shape == (4, 1, pair[3].vocab_size)
