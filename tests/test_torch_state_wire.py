"""SSM states on every wire of the port, against the reference: the state
codec's arrays byte-identical to the reference's ``encode_wire`` at every
tier and plan, remote frames carrying states byte-identical to
``repro.comm.remote``'s (monolithic, streamed, states-only) and read across
frameworks, the paged ``page_data`` states block equal to
``repro.store.wire``'s, every transport's bytes and received states equal
to the reference's on the same numpy inputs, and the session paths
(Serialized int8 on RWKV6, the SSM-depth refusal, ``export_pages``'s
4-tuple).

Tolerances, stated: wire arrays, frames and counted bytes are identical;
received states are bit-equal to the reference's (the same decode of the
same wire arrays); model logits of the tiny float32 pair within 1e-4 of the
largest |logit| of the reference's."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.comm.remote as jremote
import repro.comm.transport as jtransport
import repro.store as jstore
import repro.store.wire as jwire
from _torch_bridge import port_cfg, port_params, t
from repro.comm import Agent as JAgent
from repro.comm import CommSession as JSession
from repro.configs.registry import get_config as jget_config
from repro.core.types import KVCommConfig as JKVCommConfig
from repro.launch import remote_serve as jrs
from repro.models import transformer as jtfm
from repro_torch.comm import Agent, CommSession
from repro_torch.comm import remote
from repro_torch.comm import transport as ttransport
from repro_torch.core import protocol
from repro_torch.core.types import KVCommConfig
from repro_torch.launch.remote_serve import export_pages
from repro_torch.models import transformer as tfm
from repro_torch.store import PageStore
from repro_torch.store import paging
from repro_torch.store import wire as twire

KVCFG, JKVCFG = KVCommConfig(), JKVCommConfig()
PLAN = "plan:float16,int8,int4"
TIERS = ["float32", "float16", "bfloat16", "int8", "int4", PLAN]
L_SSM, L_ATTN, B, SC, HKV, DH = 4, 3, 2, 6, 2, 8


def _bytes(a) -> bytes:
    if isinstance(a, torch.Tensor):
        return a.contiguous().view(torch.uint8).numpy().tobytes()
    return np.ascontiguousarray(np.asarray(a)).view(np.uint8).tobytes()


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


@pytest.fixture(scope="module")
def data():
    """Seeded numpy states of both layouts, a KV stack and the masks."""
    rng = np.random.default_rng(7)
    f = lambda *s: (rng.standard_normal(s) * 2).astype(np.float32)  # noqa
    rwkv = {"cm_x": f(L_SSM, B, 16), "tm_x": f(L_SSM, B, 16),
            "wkv": f(L_SSM, B, 2, 8, 8)}
    rwkv["wkv"][2] = 0.0                   # an all-zero layer: floored scale
    mamba = {"conv": f(L_SSM, B, 3, 12), "ssm": f(L_SSM, B, 4, 8, 16)}
    kv = {"k": f(L_ATTN, B, SC, HKV, DH), "v": f(L_ATTN, B, SC, HKV, DH)}
    return {"rwkv": rwkv, "mamba": mamba, "kv": kv,
            "state_select": np.array([True, False, True, True]),
            "select": np.array([True, True, True])}


def _port(d, layout):
    return ({k: t(v) for k, v in d[layout].items()}, t(d["state_select"]))


def _ref(d, layout):
    return ({k: jnp.asarray(v) for k, v in d[layout].items()},
            jnp.asarray(d["state_select"]))


# ---------------------------------------------------------------------------
# the state codec
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("wire", TIERS)
@pytest.mark.parametrize("layout", ["rwkv", "mamba"])
def test_roundtrip_states_byte_identical(data, wire, layout):
    """Each leaf's selected layers encode to the reference's arrays at the
    state wire dtype (a plan's finest tier), the counted bytes agree and
    the receiver's dense states are bit-equal, unselected layers zero."""
    states, sel = _port(data, layout)
    jstates, jsel = _ref(data, layout)
    wd = ttransport.state_wire_dtype(wire)
    assert wd == jtransport.state_wire_dtype(wire)
    idx = np.nonzero(data["state_select"])[0]
    for key, x in data[layout].items():
        got, n = ttransport.encode_wire(t(x[idx]), wd)
        want, jn = jtransport.encode_wire(jnp.asarray(x)[idx], wd)
        assert n == jn and len(got) == len(want)
        for g, w in zip(got, want):
            assert _bytes(g) == _bytes(w)
    rx, n = ttransport.roundtrip_states(states, sel, wire)
    jrx, jn = jtransport.roundtrip_states(jstates, jsel, wire)
    assert n == jn > 0
    assert list(rx) == list(jrx)
    for key in rx:
        assert rx[key].dtype == torch.float32
        assert _bytes(rx[key]) == _bytes(jrx[key])
        assert not rx[key][1].any()
    assert ttransport.payload_bytes(None, None, states, sel) \
        == jtransport.payload_bytes(None, None, jstates, jsel)
    kv = {p: t(v) for p, v in data["kv"].items()}
    jkv = {p: jnp.asarray(v) for p, v in data["kv"].items()}
    assert ttransport.payload_bytes(kv, t(data["select"]), states, sel) \
        == jtransport.payload_bytes(jkv, jnp.asarray(data["select"]),
                                    jstates, jsel)


def test_empty_state_selection_ships_nothing(data):
    states, _ = _port(data, "mamba")
    none = torch.zeros((L_SSM,), dtype=torch.bool)
    for wire in ("float16", "int8"):
        rx, n = ttransport.roundtrip_states(states, none, wire)
        assert n == 0 and all(not v.any() for v in rx.values())


# ---------------------------------------------------------------------------
# remote frames
# ---------------------------------------------------------------------------
def _inputs(data, layout, with_kv):
    states, sel = _port(data, layout)
    jstates, jsel = _ref(data, layout)
    if not with_kv:
        return (None, None, states, sel), (None, None, jstates, jsel)
    kv = {p: t(v) for p, v in data["kv"].items()}
    jkv = {p: jnp.asarray(v) for p, v in data["kv"].items()}
    return ((kv, t(data["select"]), states, sel),
            (jkv, jnp.asarray(data["select"]), jstates, jsel))


@pytest.mark.parametrize("wire", ["float32", "bfloat16", "int8", PLAN])
@pytest.mark.parametrize("layout,with_kv", [("rwkv", False),
                                            ("mamba", True)])
def test_frames_with_states_byte_identical(data, wire, layout, with_kv):
    """The monolithic ``shared_kv`` frame and the streamed begin / chunk /
    end frames are the reference's byte for byte, and each framework
    decodes the other's into the same states."""
    port_in, ref_in = _inputs(data, layout, with_kv)
    frame, n, _, _ = remote.encode_kv_transfer(KVCFG, *port_in,
                                               wire_dtype=wire)
    jframe, jn, _, _ = jremote.encode_kv_transfer(JKVCFG, *ref_in,
                                                  wire_dtype=wire)
    assert frame == jframe and n == jn
    sender = remote.KVStreamSender(KVCFG, *port_in, wire_dtype=wire,
                                   chunk_bytes=200, sid=3)
    jsender = jremote.KVStreamSender(JKVCFG, *ref_in, wire_dtype=wire,
                                     chunk_bytes=200, sid=3)
    frames = list(sender.frames())
    jframes = list(jsender.frames())
    assert [f for f, _ in frames] == [f for f, _ in jframes]
    assert [nb for _, nb in frames] == [nb for _, nb in jframes]
    # across frameworks: the reference reads the port's frame and back
    jshared, _ = jremote.decode_kv_transfer(*jremote.decode_frame(frame)[1:])
    shared, nb = remote.decode_kv_transfer(*remote.decode_frame(jframe)[1:],
                                           device="cpu")
    assert nb == n
    for key in shared.states:
        assert _bytes(shared.states[key]) == _bytes(jshared.states[key])
    assert shared.state_select.tolist() == data["state_select"].tolist()


def test_states_only_stream(data):
    """The mirror of test_remote.py::test_states_only_stream: a KV-less
    transfer streams as begin and end with no chunk and equals the
    monolithic frame leaf for leaf, in both packages alike."""
    states = {"ssm": t(np.random.default_rng(3).standard_normal(
        (4, 2, 8)).astype(np.float32))}
    sel = torch.tensor([True, False, True, False])
    got = {}
    for name, chunk in (("mono", None), ("stream", 300)):
        ch = remote.LoopbackChannel()
        n = remote.send_shared(ch, KVCFG, None, None, states=states,
                               state_select=sel, wire_dtype="float16",
                               chunk_bytes=chunk)
        frames = ch.read(len(ch))
        ch.write(frames)
        got[name] = remote.recv_shared(ch, device="cpu") + (n, frames)
        jch = jremote.LoopbackChannel()
        jremote.send_shared(jch, KVCFG, None, None,
                            states={"ssm": jnp.asarray(states["ssm"])},
                            state_select=jnp.asarray(sel.numpy()),
                            wire_dtype="float16", chunk_bytes=chunk)
        assert jch.read(len(jch)) == frames
    (mono, nm, _, _), (streamed, ns, sent, frames) = got["mono"], \
        got["stream"]
    assert ns == nm == sent > 0
    assert streamed.kv is None and streamed.prefix_len == 0
    assert torch.equal(streamed.states["ssm"], mono.states["ssm"])
    assert not mono.states["ssm"][1].any()


# ---------------------------------------------------------------------------
# the paged page_data block
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("wire", ["float16", "int8"])
def test_page_data_states_block_matches_reference(data, wire):
    port_in, ref_in = _inputs(data, "mamba", True)
    kv, select, states, sel = port_in
    jkv, jselect, jstates, jsel = ref_in
    layers = (0, 1, 2)
    table, pages = paging.split_payload(
        kv, layers=layers, select=select, page_len=4, wire_dtype=wire)
    jtable, jpages = jstore.split_payload(
        jkv, layers=layers, select=np.asarray(jselect), page_len=4,
        wire_dtype=wire)
    assert [p.page_id for p in pages] == [p.page_id for p in jpages]
    frame, n = twire.encode_page_data(5, pages, wire_dtype=wire,
                                      states=states, state_select=sel)
    jframe, jn = jwire.encode_page_data(5, jpages, wire_dtype=wire,
                                        states=jstates, state_select=jsel)
    assert frame == jframe and n == jn
    _, meta, arrays = remote.decode_frame(jframe)
    xid, got_pages, rx, rx_sel, state_bytes = twire.decode_page_data(
        meta, arrays, device="cpu")
    _, jmeta, jarrays = jremote.decode_frame(frame)
    _, _, jrx, _, jstate_bytes = jwire.decode_page_data(jmeta, jarrays)
    assert xid == 5 and len(got_pages) == len(pages)
    assert state_bytes == jstate_bytes > 0
    for key in rx:
        assert _bytes(rx[key]) == _bytes(jrx[key])
    assert rx_sel.tolist() == data["state_select"].tolist()


# ---------------------------------------------------------------------------
# every transport, on the same numpy inputs
# ---------------------------------------------------------------------------
TRANSPORTS = {
    "inmemory": (lambda m: m.InMemoryTransport(), False),
    "ser_int8": (lambda m: m.SerializedTransport("int8"), False),
    "ser_plan": (lambda m: m.SerializedTransport(PLAN), False),
    "paged_ser_fp16": (lambda m: m.SerializedTransport("float16"), True),
    "paged_inmemory": (lambda m: m.InMemoryTransport(), True),
    "rem_bf16_stream": (lambda m: m.RemoteTransport("bfloat16",
                                                     chunk_bytes=256),
                        False),
    "rem_int8_mono": (lambda m: m.RemoteTransport("int8", chunk_bytes=None),
                      False),
    "rem_paged_int8": (lambda m: m.RemoteTransport("int8"), True),
}


@pytest.mark.parametrize("name", sorted(TRANSPORTS))
@pytest.mark.parametrize("layout,with_kv", [("rwkv", False),
                                            ("mamba", True)])
def test_transport_states_match_reference(data, name, layout, with_kv):
    """Bytes, the record's layer count and the received states (and KV)
    equal the reference transport's on the same inputs."""
    import repro.comm as jcomm
    import repro_torch.comm as tcomm
    make, paged = TRANSPORTS[name]
    tr, jtr = make(tcomm), make(jcomm)
    if paged:
        tr.attach_store(PageStore(page_len=4))
        jtr.attach_store(jstore.PageStore(page_len=4))
    port_in, ref_in = _inputs(data, layout, with_kv)
    shared = tr.send(None, KVCFG, *port_in)
    jshared = jtr.send(None, JKVCFG, *ref_in)
    assert tr.last.n_bytes == jtr.last.n_bytes > 0
    assert tr.last.layers == jtr.last.layers
    assert (tr.last.pages_total, tr.last.pages_sent) == \
        (jtr.last.pages_total, jtr.last.pages_sent)
    assert list(shared.states) == list(jshared.states)
    for key in shared.states:
        assert _bytes(shared.states[key]) == _bytes(jshared.states[key])
    assert shared.state_select.tolist() == \
        _np(jshared.state_select).tolist()
    if with_kv:
        assert _bytes(shared.packed_kv["k"]) == \
            _bytes(jshared.packed_kv["k"])
    if name == "inmemory":
        assert tr.last.n_bytes == ttransport.payload_bytes(
            port_in[0], port_in[1], port_in[2], port_in[3])


# ---------------------------------------------------------------------------
# the session paths
# ---------------------------------------------------------------------------
def _jcfg(name, **kw):
    return dataclasses.replace(jget_config(name).reduced(),
                               **{"dtype": "float32", **kw})


def test_rwkv_share_over_int8_matches_reference(tok):
    """The mirror of test_int8_handles_ssm_state_leaves: ``share`` and
    ``prefill`` on RWKV6 over SerializedTransport("int8"), the bytes the
    reference counts and logits within 1e-4 of its logits."""
    import repro.comm as jcomm
    import repro_torch.comm as tcomm
    jcfg = _jcfg("rwkv6-1.6b")
    jp = jtfm.init_params(jcfg, jax.random.PRNGKey(0))
    cfg, p = port_cfg(jcfg), port_params(jp)
    jsess = JSession(JAgent("s", jcfg, jp, tok), JAgent("r", jcfg, jp, tok),
                     jcomm.SerializedTransport("int8"))
    sess = CommSession(Agent("s", cfg, p, tok), Agent("r", cfg, p, tok),
                       tcomm.SerializedTransport("int8"))
    rng = np.random.default_rng(0)
    ctx = rng.integers(2, cfg.vocab_size, (2, 8)).astype(np.int32)
    qry = rng.integers(2, cfg.vocab_size, (2, 4)).astype(np.int32)
    kvcfg = dict(ratio=0.5, selector="prior_only")
    shared, _ = sess.share(ctx, KVCommConfig(**kvcfg))
    jshared, _ = jsess.share(ctx, JKVCommConfig(**kvcfg))
    assert shared.kv is None and shared.states is not None
    assert shared.state_select.tolist() == _np(jshared.state_select).tolist()
    assert sess.transport.total_bytes == jsess.transport.total_bytes > 0
    out = sess.receiver.prefill(qry, shared, max_new=0)
    jout = jsess.receiver.prefill(qry, jshared, max_new=0)
    want = np.asarray(jout.logits)
    assert np.abs(out.logits.numpy() - want).max() \
        <= 1e-4 * np.abs(want).max()


def test_is_hetero_sees_ssm_depth_mismatch(tok):
    """The mirror of test_hetero.py::test_is_hetero_sees_ssm_depth_mismatch:
    equal attention depth with a different SSM depth is heterogeneous;
    ``share`` refuses and ``share_mapped`` drops the positional states."""
    base = port_cfg(_jcfg("zamba2-2.7b", vocab_size=tok.vocab_size))
    scfg = dataclasses.replace(base, num_layers=2, hybrid_attn_every=2)
    rcfg = dataclasses.replace(base, num_layers=3, hybrid_attn_every=3)
    assert scfg.attn_layer_count == rcfg.attn_layer_count == 1
    sp = tfm.init_params(scfg, 0, device="cpu")
    rp = tfm.init_params(rcfg, 1, device="cpu")
    sess = CommSession(Agent("s", scfg, sp, tok), Agent("r", rcfg, rp, tok))
    assert sess.is_hetero
    rng = np.random.default_rng(0)
    ctx = rng.integers(4, scfg.vocab_size, (2, 6)).astype(np.int32)
    qry = rng.integers(4, scfg.vocab_size, (2, 4)).astype(np.int32)
    kvcfg = KVCommConfig(ratio=0.5, selector="prior_only")
    with pytest.raises(ValueError, match="share_mapped"):
        sess.share(ctx, kvcfg)
    shared, _ = sess.share_mapped(ctx, kvcfg, policy="identity")
    assert shared.states is None
    out = sess.receiver.prefill(qry, shared, max_new=0)
    assert torch.isfinite(out.logits).all()
    # a same-depth pair keeps its states through share_mapped
    same = CommSession(Agent("s", scfg, sp, tok), Agent("r", scfg, sp, tok))
    kept, _ = same.share_mapped(ctx, kvcfg, policy="identity")
    assert kept.states is not None


def test_export_pages_returns_the_reference_tuple(tok):
    """``export_pages`` gives the reference's (table, pages, states,
    state_select): every SSM layer's state ships."""
    jcfg = _jcfg("zamba2-2.7b", vocab_size=tok.vocab_size)
    jp = jtfm.init_params(jcfg, jax.random.PRNGKey(0))
    cfg = port_cfg(jcfg)
    sender = Agent("s", cfg, port_params(jp), tok)
    jsender = JAgent("s", jcfg, jp, tok)
    ctx = np.random.default_rng(2).integers(4, cfg.vocab_size,
                                            (1, 9)).astype(np.int32)
    select = torch.tensor([True, False])
    table, pages, states, sel = export_pages(sender, ctx, KVCFG, select,
                                             page_len=4,
                                             wire_dtype="float16")
    jtable, jpages, jstates, jsel = jrs.export_pages(
        jsender, ctx, JKVCFG, jnp.asarray(select.numpy()), page_len=4,
        wire_dtype="float16")
    assert table.layers == jtable.layers
    assert table.num_pages == jtable.num_pages == len(pages) == len(jpages)
    assert sel.tolist() == _np(jsel).tolist() == [True] * 2
    assert list(states) == list(jstates)
    for key in states:
        want = np.asarray(jstates[key])
        assert np.abs(states[key].numpy() - want).max() \
            <= 1e-4 * max(np.abs(want).max(), 1e-30)
