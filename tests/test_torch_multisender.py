"""The port's multi-sender composition (§J) against the reference's
``combine_senders``: the session mailbox (``attach_sender`` / ``combined``)
on the bridged float32 tiny pair, and ``combine_senders`` itself on the
same numpy payloads.

Tolerances, stated: inside the port, the packed mailbox view equals the
dense ``combine_senders`` view's selected slots bit for bit and drives the
receiver to logits within 2e-5 of it (the reference's own test); against
the reference (float32, summed in another order), the K/V and the
receiver's logits within 2e-5. ``combine_senders`` on identical payloads
is exact."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_bridge import port_cfg, port_params
from repro import core as jcore
from repro.comm import Agent as JAgent
from repro.comm import CommSession as JSession
from repro.core.types import KVCommConfig as JKVCommConfig
from repro.core.types import SharedKV as JSharedKV
from repro.models import transformer as jtfm
from repro_torch.comm import Agent, CommSession, SenderHandle
from repro_torch.core.channel import combine_senders
from repro_torch.core.types import KVCommConfig, SharedKV

SAME_TOL = dict(atol=2e-5, rtol=0)
REF_TOL = dict(atol=2e-5, rtol=2e-5)


@pytest.fixture(scope="module")
def pair(tiny_cfg):
    s = jtfm.init_params(tiny_cfg, jax.random.PRNGKey(0))
    r = jtfm.init_params(tiny_cfg, jax.random.PRNGKey(1))
    return tiny_cfg, s, r, port_cfg(tiny_cfg), port_params(s), port_params(r)


def _sessions(pair, tok):
    jcfg, js, jr, cfg, s, r = pair
    return (JSession(JAgent("s", jcfg, js, tok), JAgent("r", jcfg, jr, tok)),
            CommSession(Agent("s", cfg, s, tok), Agent("r", cfg, r, tok)))


def test_two_sender_session_matches_combine_senders(pair, tok):
    """Mirrors the reference's test of the same name, then holds the
    port's views and logits to the reference's combine_senders."""
    jsess, sess = _sessions(pair, tok)
    cfg = pair[3]
    kw = dict(ratio=0.7, selector="prior_only")
    kvcfg = KVCommConfig(**kw)
    select = sess.selection(kvcfg)
    jselect = jsess.selection(JKVCommConfig(**kw))
    np.testing.assert_array_equal(select.numpy(), np.asarray(jselect))
    rng = np.random.default_rng(0)
    c1 = rng.integers(4, cfg.vocab_size, (2, 6)).astype(np.int32)
    c2 = rng.integers(4, cfg.vocab_size, (2, 9)).astype(np.int32)

    h1 = sess.attach_sender(sess.sender, name="A")
    h2 = sess.attach_sender(sess.sender, name="B")
    assert isinstance(h1, SenderHandle) and h1.name == "A"
    h1.send(c1, kvcfg, select=select)
    h2.send(c2, kvcfg, select=select)
    assert [n for n, _ in sess.mailbox] == ["A", "B"]
    combined = sess.combined()

    # the port's dense composition of the same sends
    (kv1, _, p1), (kv2, _, p2) = (sess.sender.export_kv(c)
                                  for c in (c1, c2))
    dense = combine_senders([
        SharedKV(kv=kv, select=select, prefix_len=p,
                 pos_mode=kvcfg.pos_mode) for kv, p in ((kv1, p1),
                                                        (kv2, p2))])
    assert combined.is_packed
    assert combined.prefix_len == dense.prefix_len == p1 + p2
    idx = np.nonzero(select.numpy())[0]
    for p in ("k", "v"):
        np.testing.assert_array_equal(combined.packed_kv[p].numpy(),
                                      dense.kv[p].numpy()[idx])
    np.testing.assert_array_equal(combined.select.numpy(),
                                  dense.select.numpy())

    # the reference's composition of its own sends
    jparts = []
    for c in (c1, c2):
        jkv, _, jp = jsess.sender.export_kv(c)
        jparts.append(JSharedKV(kv=jkv, select=jselect, prefix_len=jp,
                                pos_mode=kvcfg.pos_mode))
    ref = jcore.combine_senders(jparts)
    for p in ("k", "v"):
        np.testing.assert_allclose(combined.packed_kv[p].numpy(),
                                   np.asarray(ref.kv[p])[idx], **REF_TOL)

    qry = rng.integers(4, cfg.vocab_size, (2, 4)).astype(np.int32)
    a = sess.receiver.prefill(qry, combined, max_new=0).logits.numpy()
    b = sess.receiver.prefill(qry, dense, max_new=0).logits.numpy()
    np.testing.assert_allclose(a, b, **SAME_TOL)
    want = np.asarray(jsess.receiver.prefill(qry, ref, max_new=0).logits)
    np.testing.assert_allclose(a, want, **REF_TOL)
    assert np.isfinite(a).all()

    assert sess.combined(clear=True).prefix_len == p1 + p2
    assert sess.mailbox == []
    with pytest.raises(ValueError, match="no sender"):
        sess.combined()


def test_handles_are_named_in_order(pair, tok):
    _, sess = _sessions(pair, tok)
    names = [sess.attach_sender(sess.sender).name for _ in range(3)]
    assert names == ["s#0", "s#1", "s#2"]


def test_mailbox_refuses_a_sender_of_other_depth(pair, tok):
    _, sess = _sessions(pair, tok)
    cfg = dataclasses.replace(pair[3], num_layers=2)
    params = dict(pair[4], layers=pair[4]["layers"][:2])
    handle = sess.attach_sender(Agent("shallow", cfg, params, tok))
    with pytest.raises(ValueError, match="depth"):
        handle.send(np.zeros((1, 3), np.int32),
                    KVCommConfig(selector="prior_only"))


def _payload(rng, L, B, P):
    return {p: rng.standard_normal((L, B, P, 2, 4)).astype(np.float32)
            for p in ("k", "v")}


def _views(part, **kw):
    """The same view in both packages: (port SharedKV, reference
    SharedKV)."""
    t = {k: ({p: torch.from_numpy(a) for p, a in v.items()}
             if isinstance(v, dict) else
             torch.from_numpy(v) if isinstance(v, np.ndarray) else v)
         for k, v in part.items()}
    j = {k: ({p: jnp.asarray(a) for p, a in v.items()}
             if isinstance(v, dict) else
             jnp.asarray(v) if isinstance(v, np.ndarray) else v)
         for k, v in part.items()}
    return SharedKV(**t, **kw), JSharedKV(**j, **kw)


def _check_same(got, want):
    assert got.is_packed == want.is_packed
    assert got.prefix_len == want.prefix_len
    assert got.layers == want.layers
    assert got.src_layers == want.src_layers
    assert got.pos_mode == want.pos_mode
    np.testing.assert_array_equal(got.select.numpy(),
                                  np.asarray(want.select))
    src_t = got.packed_kv if got.is_packed else got.kv
    src_j = want.packed_kv if want.is_packed else want.kv
    for p in ("k", "v"):
        np.testing.assert_array_equal(src_t[p].numpy(), np.asarray(src_j[p]))


@pytest.mark.parametrize("layers,src", [
    (((0, 2), (0, 2), (0, 2)), ((1, 3), (1, 3), (1, 3))),   # all agree
    (((0, 2), (0, 2)), ((1, 3), (0, 3))),                   # src differs
    (((0, 2), (1, 2), (2, 3)), (None, None, None)),         # maps differ
])
def test_combine_packed_senders_matches_reference(layers, src):
    """Identical layer maps stay packed (src_layers only when unanimous);
    differing maps fall back to the dense view with OR-combined masks."""
    rng = np.random.default_rng(1)
    L = 4
    pairs = []
    for i, (lay, sl) in enumerate(zip(layers, src)):
        P = 3 + 2 * i
        select = np.zeros(L, bool)
        select[list(lay)] = True
        pairs.append(_views({"packed_kv": _payload(rng, len(lay), 2, P),
                             "select": select},
                            layers=lay, src_layers=sl, prefix_len=P))
    got = combine_senders([t for t, _ in pairs])
    want = jcore.combine_senders([j for _, j in pairs])
    _check_same(got, want)


def test_combine_mixed_dense_and_packed_matches_reference():
    rng = np.random.default_rng(2)
    sel_a = np.array([True, False, True, False])
    sel_b = np.array([False, True, True, False])
    a = _views({"kv": _payload(rng, 4, 2, 5), "select": sel_a},
               prefix_len=5)
    b = _views({"packed_kv": _payload(rng, 2, 2, 7), "select": sel_b},
               layers=(1, 2), prefix_len=7)
    _check_same(combine_senders([a[0], b[0]]),
                jcore.combine_senders([a[1], b[1]]))


def test_combine_refuses_mixed_pos_modes():
    rng = np.random.default_rng(3)
    sel = np.ones(4, bool)
    a, _ = _views({"kv": _payload(rng, 4, 1, 2), "select": sel},
                  prefix_len=2)
    b, _ = _views({"kv": _payload(rng, 4, 1, 2), "select": sel},
                  prefix_len=2, pos_mode="zero_unselected")
    with pytest.raises(ValueError, match="pos_mode"):
        combine_senders([a, b])
    with pytest.raises(ValueError):
        combine_senders([])
