"""Heterogeneous pairs in the port against the reference's, on bridged
weights: float32 6- and 10-layer models (``test_hetero.py``'s ``_cfg``,
PRNGKey(L)), the same retrieval batch of 2.

Tolerances, stated: layer assignments, the Gaussian prior and resampled
scores, selections, layer maps and wire bytes are identical. Mapped K/V
(a sender prefill in each framework, float32) within 1e-5; receiver
logits within 1e-4. A float32 ulp of difference can move a wire code by
one step, so float16-wire K/V are held to one float16 ulp of the largest
value (2^-10 of it) and int8-wire K/V to one quantization step (absmax /
127), their logits to 1e-3. The port's same-depth identity map is bit
for bit its kvcomm."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_bridge import as_reference, port_cfg, port_params
from repro.comm import Agent as JAgent
from repro.comm import CommSession as JSession
from repro.comm import InMemoryTransport as JInMemory
from repro.comm import SerializedTransport as JSerialized
from repro.configs.registry import get_config
from repro.core import layermap as jlm
from repro.core import selection as jsel
from repro.core.types import KVCommConfig as JKVCommConfig
from repro.data.synthetic import SyntheticTask, TaskConfig
from repro.models import transformer as jtfm
from repro_torch.comm import (Agent, CommSession, InMemoryTransport,
                              SerializedTransport)
from repro_torch.core import layermap as tlm
from repro_torch.core import selection as tsel
from repro_torch.core.channel import kv_wire_bytes
from repro_torch.core.protocol import selected_layer_ids
from repro_torch.core.types import KVCommConfig
from repro_torch.launch import pairs
from repro_torch.serving.scheduler import Scheduler

POLICIES = ["identity", "depth_proportional", "score_greedy"]
KW = dict(ratio=0.5, selector="prior_only")
TRANSPORTS = {
    "mem_packed": (lambda: JInMemory(), lambda: InMemoryTransport(), 4),
    "mem_dense": (lambda: JInMemory(packed=False),
                  lambda: InMemoryTransport(packed=False), 4),
    "ser_fp16": (lambda: JSerialized("float16"),
                 lambda: SerializedTransport("float16"), 2),
    "ser_int8": (lambda: JSerialized("int8"),
                 lambda: SerializedTransport("int8"), 1),
}


def _cfg(tok, L):
    return dataclasses.replace(
        get_config("llama3.2-3b-pair"),
        num_layers=L, d_model=64, d_ff=128, num_heads=4, num_kv_heads=2,
        head_dim=16, vocab_size=tok.vocab_size, dtype="float32",
        remat=False, tie_embeddings=False)


@pytest.fixture(scope="module")
def models(tok):
    out = {}
    for L in (6, 10):
        cfg = _cfg(tok, L)
        params = jtfm.init_params(cfg, jax.random.PRNGKey(L))
        out[L] = (cfg, params, port_cfg(cfg), port_params(params))
    return out


@pytest.fixture(scope="module")
def batch(tok):
    return SyntheticTask(tok, TaskConfig("retrieval", num_facts=4,
                                         seed=11)).batch(2)


def _sessions(models, tok, L_s, L_r, transport="mem_packed"):
    make_j, make_t, _ = TRANSPORTS[transport]
    js, jr = models[L_s], models[L_r]
    return (JSession(JAgent("s", js[0], js[1], tok),
                     JAgent("r", jr[0], jr[1], tok), make_j()),
            CommSession(Agent("s", js[2], js[3], tok),
                        Agent("r", jr[2], jr[3], tok), make_t()))


def _bits(a) -> np.ndarray:
    return np.asarray(a, np.float32).view(np.uint32)


# ---------------------------------------------------------------------------
# the prior, the resampling and the three policies, exactly
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("sigma", [10.0, 2.5])
def test_gaussian_prior_and_interp_scores_bit_exact(sigma):
    rng = np.random.default_rng(0)
    for L in range(1, 49):
        prior = tsel.gaussian_prior(L, sigma=sigma).numpy()
        np.testing.assert_array_equal(
            _bits(prior), _bits(jsel.gaussian_prior(L, sigma=sigma)))
        src = prior if L % 2 else rng.random(L).astype(np.float32)
        for n in range(1, 49):
            np.testing.assert_array_equal(
                _bits(tsel.interp_scores(src, n)),
                _bits(jsel.interp_scores(src, n)))


@pytest.mark.parametrize("with_scores", [False, True])
@pytest.mark.parametrize("policy", POLICIES)
def test_assignments_match_reference_over_depths(policy, with_scores):
    """Every (L_src, L_dst) in 1..48 x 1..48, a random selection of the
    sender's layers each; scores, where given, random on both sides with
    ties (rounded to tenths)."""
    rng = np.random.default_rng(1 + POLICIES.index(policy))
    jp, tp = jlm.get_layer_map(policy), tlm.get_layer_map(policy)
    for L_s in range(1, 49):
        for L_d in range(1, 49):
            m = int(rng.integers(1, L_s + 1))
            src = sorted(rng.choice(L_s, m, replace=False).tolist())
            kw = {}
            if with_scores:
                kw = dict(src_scores=np.round(rng.random(L_s), 1),
                          dst_scores=(np.round(rng.random(L_d), 1)
                                      if L_d % 2 else None))
            want = jp.assign(src, L_s, L_d, **kw)
            got = tp.assign(src, L_s, L_d, **kw)
            assert (got.src, got.dst) == (want.src, want.dst), \
                (policy, L_s, L_d, src)
            assert (got.num_src_layers, got.num_dst_layers) == (L_s, L_d)
            np.testing.assert_array_equal(got.dst_mask(), want.dst_mask())


def test_registry_and_invariants():
    assert set(tlm.LAYER_MAPS) == set(jlm.LAYER_MAPS)
    with pytest.raises(ValueError, match="unknown layer map"):
        tlm.get_layer_map("wormhole")
    for src, dst in (((0, 1), (3, 2)), ((0,), (9,)), ((0, 1), (2,))):
        with pytest.raises(AssertionError):
            tlm.LayerAssignment(src=src, dst=dst, num_src_layers=6,
                                num_dst_layers=6)
    assert tlm.IdentityTruncate().assign([1, 4], 6, 6).is_identity


def test_deep_receiver_config_is_the_references():
    from repro.launch.pairs import deep_receiver_config
    assert as_reference(pairs.deep_receiver_config(),
                        deep_receiver_config()) \
        == dataclasses.asdict(deep_receiver_config())


# ---------------------------------------------------------------------------
# mapped sends through the session: views, bytes, logits
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("transport", sorted(TRANSPORTS))
@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("depths", [(6, 10), (10, 6)])
def test_mapped_transfer_matches_reference(models, tok, batch, depths,
                                           policy, transport):
    L_s, L_r = depths
    jsess, sess = _sessions(models, tok, L_s, L_r, transport)
    assert sess.is_hetero and jsess.is_hetero
    jshared, jasg = jsess.share_mapped(batch["context"],
                                       JKVCommConfig(**KW), policy=policy)
    shared, asg = sess.share_mapped(batch["context"], KVCommConfig(**KW),
                                    policy=policy)
    assert (asg.src, asg.dst) == (jasg.src, jasg.dst)
    rec, jrec = sess.transport.last, jsess.transport.last
    assert (rec.n_bytes, rec.layers, rec.context_len, rec.wire_dtype) == \
        (jrec.n_bytes, jrec.layers, jrec.context_len, jrec.wire_dtype)
    Sc = batch["context"].shape[1] + 1
    assert rec.n_bytes == kv_wire_bytes(
        models[L_r][2], 2, Sc, asg.num_pairs, TRANSPORTS[transport][2]) \
        + (2 * 4 * asg.num_pairs if transport == "ser_int8" else 0)
    np.testing.assert_array_equal(shared.select.numpy(),
                                  np.asarray(jshared.select))
    assert shared.is_packed == jshared.is_packed
    if shared.is_packed:
        assert (shared.layers, shared.src_layers) == \
            (jshared.layers, jshared.src_layers)
    view, jview = ((shared.packed_kv, jshared.packed_kv) if shared.is_packed
                   else (shared.kv, jshared.kv))
    for p in ("k", "v"):
        want = np.asarray(jview[p])
        top = float(np.abs(want).max())
        atol = {"ser_int8": top / 127, "ser_fp16": top * 2 ** -10}.get(
            transport, 1e-5)
        np.testing.assert_allclose(view[p].numpy(), want, atol=atol,
                                   rtol=0)
    jl = jsess.receiver.prefill(batch["query"], jshared, max_new=0).logits
    tl = sess.receiver.prefill(batch["query"], shared, max_new=0).logits
    tol = 1e-3 if transport.startswith("ser") else 1e-4
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=tol,
                               rtol=tol)


def test_packed_and_dense_mapped_logits_agree(models, tok, batch):
    _, sp = _sessions(models, tok, 6, 10, "mem_packed")
    _, sd = _sessions(models, tok, 6, 10, "mem_dense")
    kvcfg = KVCommConfig(**KW)
    a, _ = sp.share_mapped(batch["context"], kvcfg, policy="score_greedy")
    b, _ = sd.share_mapped(batch["context"], kvcfg, policy="score_greedy")
    la = sp.receiver.prefill(batch["query"], a, max_new=0).logits
    lb = sd.receiver.prefill(batch["query"], b, max_new=0).logits
    np.testing.assert_allclose(la.numpy(), lb.numpy(), atol=2e-5, rtol=0)


@pytest.mark.parametrize("transport", sorted(TRANSPORTS))
def test_identity_at_same_depth_is_kvcomm_bit_for_bit(models, tok, batch,
                                                      transport):
    _, a = _sessions(models, tok, 6, 6, transport)
    _, b = _sessions(models, tok, 6, 6, transport)
    kvcfg = KVCommConfig(**KW)
    ra = a.run("kvcomm", batch, kvcfg=kvcfg)
    rb = b.run("hetero_kvcomm", batch, kvcfg=kvcfg, layer_map="identity")
    np.testing.assert_array_equal(ra.preds, rb.preds)
    assert (ra.wire_bytes, ra.extras["M"]) == (rb.wire_bytes, rb.extras["M"])
    sa, _ = a.share(batch["context"], kvcfg)
    sb, asg = b.share_mapped(batch["context"], kvcfg, policy="identity")
    assert asg.is_identity
    la = a.receiver.prefill(batch["query"], sa, max_new=0).logits
    lb = b.receiver.prefill(batch["query"], sb, max_new=0).logits
    assert torch.equal(la, lb)


@pytest.mark.parametrize("policy", POLICIES)
def test_hetero_kvcomm_run_matches_reference(models, tok, batch, policy):
    """``CommSession.run("hetero_kvcomm")`` 6 -> 10 on the reference's
    sender-side scores: bytes, FLOPs, M, the layer maps and the receiver
    selection identical; predictions identical where the reference's top-2
    margin is >= 1e-3, logits within 1e-4 elsewhere."""
    jsess, sess = _sessions(models, tok, 6, 10)
    scores = np.array(jsess.calibrate_side("sender", batch["context"][:1],
                                           batch["query"][:1]))
    logits = {}
    for key, s in (("ref", jsess), ("port", sess)):
        predict = s.receiver.predict_last

        def recorded(lg, key=key, predict=predict):
            logits[key] = np.asarray(lg, np.float32)[:, -1]
            return predict(lg)
        s.receiver.predict_last = recorded
    kw = dict(ratio=0.5, alpha=0.7)
    want = jsess.run("hetero_kvcomm", batch, kvcfg=JKVCommConfig(**kw),
                     scores=jnp.asarray(scores), layer_map=policy)
    got = sess.run("hetero_kvcomm", batch, kvcfg=KVCommConfig(**kw),
                   scores=torch.from_numpy(scores), layer_map=policy)
    assert (got.wire_bytes, got.flops) == (want.wire_bytes, want.flops)
    for k in ("M", "policy", "src_layers", "dst_layers", "packed"):
        assert got.extras[k] == want.extras[k], k
    np.testing.assert_array_equal(got.extras["select"],
                                  np.asarray(want.extras["select"]))
    top2 = np.sort(logits["ref"], axis=-1)[:, -2:]
    clear = top2[:, 1] - top2[:, 0] >= 1e-3
    np.testing.assert_array_equal(got.preds[clear],
                                  np.asarray(want.preds)[clear])
    np.testing.assert_allclose(logits["port"], logits["ref"], atol=1e-4,
                               rtol=1e-4)


def test_byte_accounting_tracks_pairs_not_sender_m(models, tok, batch):
    """10 -> 6 identity: the sender selects 5 layers, those below depth 6
    survive; bytes follow P."""
    _, sess = _sessions(models, tok, 10, 6)
    kvcfg = KVCommConfig(**KW)
    m_sender = int(sess.side_selection("sender", kvcfg).sum())
    _, asg = sess.share_mapped(batch["context"], kvcfg, policy="identity")
    assert asg.num_pairs < m_sender
    rec = sess.transport.last
    assert rec.layers == asg.num_pairs
    assert rec.n_bytes == kv_wire_bytes(models[6][2], 2,
                                        batch["context"].shape[1] + 1,
                                        asg.num_pairs, 4)


# ---------------------------------------------------------------------------
# the session around a heterogeneous pair
# ---------------------------------------------------------------------------
def test_stream_matches_generate_through_mapped_prefix(models, tok, batch):
    _, sess = _sessions(models, tok, 6, 10)
    shared, _ = sess.share_mapped(batch["context"], KVCommConfig(**KW),
                                  policy="depth_proportional")
    toks = sess.generate(batch["query"], shared, max_new=4)
    for backend in ("reference", "kernel"):
        streamed = np.stack(list(sess.stream(batch["query"], shared,
                                             max_new=4, backend=backend)),
                            axis=1)
        np.testing.assert_array_equal(toks, streamed)


def test_refusals_on_a_hetero_pair(models, tok, batch):
    _, sess = _sessions(models, tok, 6, 10)
    kvcfg = KVCommConfig(**KW)
    with pytest.raises(ValueError, match="share_mapped"):
        sess.share(batch["context"], kvcfg)
    with pytest.raises(ValueError, match="calibrate_side"):
        sess.calibrate(batch["context"][:1], batch["query"][:1])
    with pytest.raises(ValueError, match="depth"):
        sess.attach_sender(sess.sender).send(batch["context"], kvcfg)
    for method in ("ac_replace", "ac_mean", "ac_sum"):
        with pytest.raises(ValueError, match="equal depths"):
            sess.run(method, batch)
    with pytest.raises(ValueError, match="homogeneous"):
        Scheduler(sess, kvcfg)
    with pytest.raises(ValueError, match="side"):
        sess.calibrate_side("bystander", batch["context"][:1],
                            batch["query"][:1])
    assert not _sessions(models, tok, 6, 6)[1].is_hetero


def test_geometry_mismatch_rejected(models, tok):
    cfg, params = models[6][2], models[6][3]
    bad = dataclasses.replace(models[10][2], num_kv_heads=1)
    with pytest.raises(ValueError, match="KV geometry"):
        CommSession(Agent("s", cfg, params, tok), Agent("r", bad, params,
                                                        tok))


def test_calibrate_side_and_side_selection_cache(models, tok, batch):
    jsess, sess = _sessions(models, tok, 6, 10)
    ctx, qry = batch["context"][:1], batch["query"][:1]
    s = sess.calibrate_side("sender", ctx, qry, key="t")
    r = sess.calibrate_side("receiver", ctx, qry, key="t")
    assert s.shape == (6,) and r.shape == (10,)
    assert sess.calibrate_side("sender", ctx, qry, key="t") is s
    np.testing.assert_allclose(
        s.numpy(), np.asarray(jsess.calibrate_side("sender", ctx, qry)),
        atol=1e-5)
    kvcfg = KVCommConfig(ratio=0.5, alpha=1.0, selector="kvcomm")
    sel_s = sess.side_selection("sender", kvcfg, key="t")
    assert sel_s.shape == (6,)
    assert sess.side_selection("sender", kvcfg, key="t") is sel_s
    shared, asg = sess.share_mapped(batch["context"], kvcfg,
                                    policy="score_greedy", key="t")
    assert set(asg.src) <= set(selected_layer_ids(sel_s))
    want = tlm.get_layer_map("score_greedy").assign(
        selected_layer_ids(sel_s), 6, 10, src_scores=s.numpy(),
        dst_scores=r.numpy())
    assert (asg.src, asg.dst) == (want.src, want.dst)
    assert shared.layers == asg.dst
