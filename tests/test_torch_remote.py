"""The port's remote wire against the reference's.

Cross-framework conformance: on the same numpy K/V at float32, bf16 and
fp16, the port's ``encode_kv_transfer`` and ``KVStreamSender.frames()``
give the reference's frames byte for byte at every wire tier (fp32, fp16,
bf16, int8, int4, a ``WirePlan``), monolithic and streamed, for a
selection and for a ``LayerAssignment``; a reference sender's frames
decode in the port to the reference's own K/V bit for bit and the other
way round; the paged page_query / page_need / page_data exchange works
across frameworks with the same page IDs. Then ``tests/test_remote.py``'s
round-trip, truncation, header, payload, mutation (hypothesis, capped),
channel, FileChannel-nonce, frame-deadline and streaming classes, ported,
and ``RemoteTransport`` (mapped and paged sends, its retry policy and
breaker, the scheduler over it). Every comparison here is exact."""
import json
import os
import socket
import struct
import threading
import time
import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

import repro.comm.remote as jremote
import repro.comm.transport as jtransport
import repro.store as jstore
import repro.store.wire as jwire
from _torch_bridge import port_cfg, port_params
from repro.core.layermap import get_layer_map as jget_layer_map
from repro.core.protocol import gather_mapped as jgather_mapped
from repro.core.protocol import pack_mapped as jpack_mapped
from repro.core.types import KVCommConfig as JKVCommConfig
from repro_torch.comm import (Agent, CommSession, InMemoryTransport,
                              SerializedTransport)
from repro_torch.comm import transport as ttransport
from repro_torch.comm.remote import (
    _PREFIX, MAGIC, PROTOCOL_VERSION, ChannelClosedError,
    ChannelTimeoutError, FileChannel, FrameCorruptError, FrameTruncatedError,
    HeaderCorruptError, KVStreamAssembler, KVStreamSender, LoopbackChannel,
    PayloadMismatchError, RemoteProtocolError, RemoteTransport,
    SocketChannel, VersionSkewError, build_health_meta, decode_frame,
    decode_kv_transfer, encode_frame, encode_kv_transfer, parse_health_meta,
    read_frame, recv_shared, send_shared)
from repro_torch.core import protocol
from repro_torch.core.layermap import get_layer_map
from repro_torch.core.types import KVCommConfig
from repro_torch.store import PageStore
from repro_torch.store.paging import split_payload
from repro_torch.store.wire import (PagedReceiver, decode_page_need,
                                    encode_page_data, encode_page_query)

KVCFG = KVCommConfig(ratio=0.5, selector="prior_only")
JKVCFG = JKVCommConfig(ratio=0.5, selector="prior_only")
PLAN = "plan:float16,int8,int4"
TIERS = ["float32", "float16", "bfloat16", "int8", "int4", PLAN]
SELECT = np.array([True, False, True, True])


def small_frame() -> bytes:
    return encode_frame(
        "shared_kv",
        {"wire_dtype": "float32", "kv": None, "states": None,
         "pos_mode": "shift", "sel_mask": None},
        {"a": np.arange(12, dtype=np.float32).reshape(3, 4),
         "b": np.arange(6, dtype=np.int8)})


def _kv(dtype, seed=0, L=4, B=2, S=9):
    """(L, B, S, 2, 16) k and v at ``dtype`` for both frameworks (one
    all-zero k layer)."""
    rng = np.random.default_rng(seed)
    x = {p: (rng.standard_normal((L, B, S, 2, 16)) * (2 if p == "k" else 1))
         .astype(np.float32) for p in ("k", "v")}
    x["k"][1] = 0.0
    return ({p: jnp.asarray(a).astype(dtype) for p, a in x.items()},
            {p: torch.from_numpy(a).to(getattr(torch, dtype))
             for p, a in x.items()})


def _assignments():
    """A 4 -> 6 depth-proportional assignment of sender layers 0, 2, 3."""
    return (jget_layer_map("depth_proportional").assign([0, 2, 3], 4, 6),
            get_layer_map("depth_proportional").assign([0, 2, 3], 4, 6))


def _as_f32(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(a).astype(np.float32)


@pytest.fixture(scope="module")
def port_pair(tiny_cfg, tiny_params):
    return port_cfg(tiny_cfg), port_params(tiny_params)


@pytest.fixture(scope="module")
def kv_frame():
    """A real shared_kv frame: layers 0 and 2 of a float32 stack at an
    fp16 wire, prefix 6."""
    _, kv = _kv("float32", seed=1, S=6)
    frame, n, _, _ = encode_kv_transfer(
        KVCFG, kv, torch.tensor([True, False, True, False]),
        wire_dtype="float16")
    return frame, n


# ---------------------------------------------------------------------------
# cross-framework conformance
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("wire", TIERS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
def test_frames_byte_identical_to_reference(dtype, wire):
    """Monolithic and streamed (chunk_bytes 300: several chunks a slot),
    selected and mapped: the same frames, the same payload bytes."""
    jkv, tkv = _kv(dtype)
    jasg, tasg = _assignments()
    for jsel, tsel, ja, ta in ((jnp.asarray(SELECT), torch.from_numpy(SELECT),
                                None, None), (None, None, jasg, tasg)):
        want = jremote.encode_kv_transfer(JKVCFG, jkv, jsel, assignment=ja,
                                          wire_dtype=wire)
        got = encode_kv_transfer(KVCFG, tkv, tsel, assignment=ta,
                                 wire_dtype=wire)
        assert got == want
        jframes = list(jremote.KVStreamSender(
            JKVCFG, jkv, jsel, assignment=ja, wire_dtype=wire,
            chunk_bytes=300, sid=3).frames())
        sender = KVStreamSender(KVCFG, tkv, tsel, assignment=ta,
                                wire_dtype=wire, chunk_bytes=300, sid=3)
        frames = list(sender.frames())
        assert len(frames) == sender.n_frames > 3
        assert frames == jframes


@pytest.mark.parametrize("chunk_bytes", [None, 300])
@pytest.mark.parametrize("wire", TIERS)
def test_cross_framework_round_trip(wire, chunk_bytes):
    """A reference sender -> the port's receiver, and the port's sender ->
    the reference's receiver, over a LoopbackChannel of either side: each
    receiver's K/V equal the sender side's own decode, bit for bit (bf16
    payload)."""
    jkv, tkv = _kv("bfloat16", seed=2)
    jasg, tasg = _assignments()
    ch = jremote.LoopbackChannel()
    n = jremote.send_shared(ch, JKVCFG, jkv, assignment=jasg,
                            wire_dtype=wire, chunk_bytes=chunk_bytes)
    got, n_got = recv_shared(ch, device="cpu")
    ch = LoopbackChannel()
    n2 = send_shared(ch, KVCFG, tkv, assignment=tasg, wire_dtype=wire,
                     chunk_bytes=chunk_bytes)
    want, n_want = jremote.recv_shared(ch)
    assert n == n_got == n2 == n_want
    assert (got.layers, got.src_layers, got.prefix_len) == \
        (want.layers, want.src_layers, want.prefix_len) == \
        (tasg.dst, tasg.src, 9)
    np.testing.assert_array_equal(got.select.numpy(),
                                  np.asarray(want.select))
    for p in ("k", "v"):
        assert got.packed_kv[p].dtype == torch.bfloat16
        np.testing.assert_array_equal(_as_f32(got.packed_kv[p]),
                                      _as_f32(want.packed_kv[p]))


@pytest.mark.parametrize("wire", ["bfloat16", "int8", PLAN])
def test_paged_exchange_across_frameworks(wire):
    """The three frames between a reference sender and the port's
    receiver (and back): the same block table and page IDs on both sides,
    the need set the whole table cold and empty warm, and the rebuilt view
    the unpaged decode."""
    jkv, tkv = _kv("bfloat16", seed=3, S=37)
    jasg, tasg = _assignments()
    jpay = jgather_mapped(jkv, jasg)
    tpay = protocol.gather_mapped(tkv, tasg)
    kw = dict(layers=tasg.dst, select=tasg.dst_mask(), page_len=8,
              wire_dtype=wire, src_layers=tasg.src)
    jtable, jpages = jstore.split_payload(jpay, **kw)
    ttable, tpages = split_payload(tpay, **kw)
    assert ttable.all_ids() == jtable.all_ids()
    # reference sender -> port receiver
    store = PageStore(page_len=8)
    rx = PagedReceiver(store, device="cpu")
    for rnd in range(2):
        _, meta, arrays = decode_frame(jwire.encode_page_query(rnd, jtable))
        _, meta, _ = decode_frame(rx.handle_query(meta, arrays))
        xid, need = decode_page_need(meta)
        assert xid == rnd
        assert need == (jtable.all_ids() if rnd == 0 else [])
        by_id = {p.page_id: p for p in jpages}
        frame, nb = jwire.encode_page_data(
            rnd, [by_id[i] for i in need], wire_dtype=wire)
        shared, table, novel, _ = rx.handle_data(*decode_frame(frame)[1:])
        assert novel == nb
        assert table.meta() == jtable.meta()
        assert (shared.layers, shared.src_layers) == (tasg.dst, tasg.src)
        want, _ = jremote.decode_kv_transfer(*jremote.decode_frame(
            jremote.encode_kv_transfer(JKVCFG, jkv, assignment=jasg,
                                       wire_dtype=wire)[0])[1:])
        for p in ("k", "v"):
            np.testing.assert_array_equal(_as_f32(shared.packed_kv[p]),
                                          _as_f32(want.packed_kv[p]))
        store.release(table)
    # port sender -> reference receiver
    jrx = jwire.PagedReceiver(jstore.PageStore(page_len=8))
    _, meta, arrays = jremote.decode_frame(encode_page_query(0, ttable))
    _, meta, _ = jremote.decode_frame(jrx.handle_query(meta, arrays))
    _, need = jwire.decode_page_need(meta)
    assert need == ttable.all_ids()
    by_id = {p.page_id: p for p in tpages}
    frame, _ = encode_page_data(0, [by_id[i] for i in need],
                                wire_dtype=wire)
    jshared, jtable2, _, _ = jrx.handle_data(
        *jremote.decode_frame(frame)[1:])
    assert jtable2.all_ids() == ttable.all_ids()
    assert jshared.layers == tasg.dst


def test_host_codec_matches_reference_where_its_stream_uses_it():
    """The reference's stream sender encodes with its numpy host codec
    only for float32 payloads (and decodes every chunk with it): there the
    port's host codec is byte-identical to it; its decode matches at
    float32 and float16 outputs, bf16 through the bits."""
    rng = np.random.default_rng(4)
    x = (rng.standard_normal((3, 2, 7, 2, 16)) * 3).astype(np.float32)
    x[1] = 0.0
    for wire in ("float32", "float16", "bfloat16", "int8", "int4"):
        want, n_want = jtransport.np_encode_wire(x, wire)
        got, n_got = ttransport.np_encode_wire(x, wire)
        assert n_got == n_want and len(got) == len(want)
        for a, b in zip(got, want):
            assert a.contiguous().view(torch.uint8).numpy().tobytes() == \
                np.ascontiguousarray(b).view(np.uint8).tobytes()
        for out in ("float32", "float16", "bfloat16"):
            ref = jtransport.np_decode_wire(want, wire, out)
            dec = ttransport.np_decode_wire(got, wire, out)
            assert str(dec.dtype) == f"torch.{out}"
            np.testing.assert_array_equal(_as_f32(dec), _as_f32(ref))
    with pytest.raises(ValueError):
        ttransport.np_encode_wire(x, PLAN)


@pytest.mark.parametrize("packed", [True, False])
def test_wire_meta_and_from_wire_match_reference(packed):
    """A mapped view's ``wire_meta()`` is the reference's JSON, and
    ``from_wire`` rebuilds the packed view or scatters the dense one."""
    jkv, tkv = _kv("float32", seed=8)
    jasg, tasg = _assignments()
    jview = jpack_mapped(JKVCFG, jkv, jasg)
    view = protocol.pack_mapped(KVCFG, tkv, tasg)
    meta = dict(view.wire_meta(), packed=packed)
    assert json.dumps(view.wire_meta()) == json.dumps(jview.wire_meta())
    got = view.from_wire(meta, view.packed_kv)
    want = type(jview).from_wire(dict(jview.wire_meta(), packed=packed),
                                 jview.packed_kv)
    assert got.is_packed == packed == want.is_packed
    np.testing.assert_array_equal(got.select.numpy(),
                                  np.asarray(want.select))
    for p in ("k", "v"):
        a = got.packed_kv[p] if packed else got.kv[p]
        b = want.packed_kv[p] if packed else want.kv[p]
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


# ---------------------------------------------------------------------------
# round trips (the baseline the faults mutate)
# ---------------------------------------------------------------------------
class TestRoundTrip:
    def test_generic_frame_round_trips_exactly(self):
        arrays = {"x": np.arange(10, dtype=np.int32),
                  "y": np.ones((2, 3), np.float16),
                  "z": torch.arange(6, dtype=torch.bfloat16).reshape(2, 3)}
        kind, meta, got = decode_frame(
            encode_frame("blob", {"n": 7, "s": "hi"}, arrays))
        assert kind == "blob" and meta == {"n": 7, "s": "hi"}
        for k in ("x", "y"):
            np.testing.assert_array_equal(got[k].numpy(), arrays[k])
            assert got[k].numpy().dtype == arrays[k].dtype
        assert torch.equal(got["z"], arrays["z"])

    def test_shared_kv_frame_round_trips(self, kv_frame):
        frame, n = kv_frame
        kind, meta, arrays = decode_frame(frame)
        shared, n2 = decode_kv_transfer(meta, arrays, device="cpu")
        assert kind == "shared_kv" and n2 == n
        assert shared.is_packed and shared.layers == (0, 2)
        assert shared.prefix_len == 6

    @given(st.integers(0, 3), st.sampled_from(
        ["float32", "float16", "int8", "int32", "uint8"]))
    @settings(max_examples=20, deadline=None)
    def test_any_array_round_trips(self, ndim, dtype):
        rng = np.random.default_rng(ndim)
        shape = tuple(rng.integers(1, 5, ndim))
        arr = rng.integers(0, 100, shape).astype(dtype)
        _, _, got = decode_frame(encode_frame("blob", {}, {"a": arr}))
        np.testing.assert_array_equal(got["a"].numpy(), arr)


# ---------------------------------------------------------------------------
# the injected faults
# ---------------------------------------------------------------------------
class TestTruncation:
    def test_empty_channel_is_clean_close(self):
        with pytest.raises(ChannelClosedError):
            read_frame(LoopbackChannel())

    @pytest.mark.parametrize("cut", [1, 3, 10, 21, 40, -1])
    def test_truncated_stream_raises_typed(self, kv_frame, cut):
        frame, _ = kv_frame
        cut = len(frame) + cut if cut < 0 else cut
        ch = LoopbackChannel()
        ch.write(frame[:cut])
        with pytest.raises(FrameTruncatedError):
            read_frame(ch)

    def test_mid_decode_disconnect_over_a_real_socket(self, kv_frame):
        frame, _ = kv_frame
        a, b = socket.socketpair()
        a.sendall(frame[:len(frame) // 2])
        a.close()
        with pytest.raises(FrameTruncatedError):
            read_frame(SocketChannel(b))
        b.close()

    def test_file_channel_timeout_is_clean_close(self, tmp_path):
        ch = FileChannel(str(tmp_path), timeout_s=0.05)
        with pytest.raises(ChannelClosedError):
            read_frame(ch)


class TestHeaderFaults:
    def test_bad_magic(self, kv_frame):
        frame, _ = kv_frame
        with pytest.raises(HeaderCorruptError):
            decode_frame(b"XXXX" + frame[4:])

    def test_version_skew(self, kv_frame):
        frame, _ = kv_frame
        skew = (frame[:4] + struct.pack(">H", PROTOCOL_VERSION + 1)
                + frame[6:])
        with pytest.raises(VersionSkewError):
            decode_frame(skew)

    def test_corrupted_payload_fails_checksum(self, kv_frame):
        frame, _ = kv_frame
        flipped = bytearray(frame)
        flipped[-1] ^= 0x40
        with pytest.raises(FrameCorruptError):
            decode_frame(bytes(flipped))
        flipped = bytearray(frame)
        flipped[_PREFIX.size + 2] ^= 0x01
        with pytest.raises(FrameCorruptError):
            decode_frame(bytes(flipped))

    def test_unparsable_header_with_valid_crc(self):
        header, body = b"this is not json", b""
        frame = _PREFIX.pack(MAGIC, PROTOCOL_VERSION, len(header),
                             len(body),
                             zlib.crc32(body, zlib.crc32(header))) \
            + header + body
        with pytest.raises(HeaderCorruptError):
            decode_frame(frame)

    def test_implausible_lengths(self, kv_frame):
        frame, _ = kv_frame
        huge = frame[:6] + struct.pack(">I", 1 << 30) + frame[10:]
        with pytest.raises((HeaderCorruptError, FrameTruncatedError)):
            decode_frame(huge)


class TestPayloadFaults:
    def _frame(self, specs, body: bytes, meta=None) -> bytes:
        header = json.dumps({"kind": "blob", "meta": meta or {},
                             "arrays": specs}).encode()
        return _PREFIX.pack(MAGIC, PROTOCOL_VERSION, len(header), len(body),
                            zlib.crc32(body, zlib.crc32(header))) \
            + header + body

    def test_shape_overclaims_payload(self):
        frame = self._frame(
            [{"name": "a", "dtype": "float32", "shape": [100]}],
            np.zeros(4, np.float32).tobytes())
        with pytest.raises(PayloadMismatchError):
            decode_frame(frame)

    def test_payload_left_unaccounted(self):
        frame = self._frame(
            [{"name": "a", "dtype": "float32", "shape": [2]}],
            np.zeros(4, np.float32).tobytes())
        with pytest.raises(PayloadMismatchError):
            decode_frame(frame)

    def test_unknown_dtype(self):
        frame = self._frame(
            [{"name": "a", "dtype": "quaternion128", "shape": [1]}], b"junk")
        with pytest.raises(PayloadMismatchError):
            decode_frame(frame)

    def test_negative_dim(self):
        frame = self._frame(
            [{"name": "a", "dtype": "int8", "shape": [-4]}], b"")
        with pytest.raises(PayloadMismatchError):
            decode_frame(frame)

    def test_kv_header_lies_about_layers(self, kv_frame):
        frame, _ = kv_frame
        _, meta, arrays = decode_frame(frame)
        meta["kv"]["layers"] = [0, 1, 2]
        with pytest.raises(PayloadMismatchError):
            decode_kv_transfer(meta, arrays, device="cpu")

    def test_kv_header_lies_about_prefix_len(self, kv_frame):
        frame, _ = kv_frame
        _, meta, arrays = decode_frame(frame)
        meta["kv"]["prefix_len"] = 99
        with pytest.raises(PayloadMismatchError):
            decode_kv_transfer(meta, arrays, device="cpu")

    def test_kv_missing_scale_array(self):
        _, kv = _kv("float32", seed=5, S=5)
        frame, _, _, _ = encode_kv_transfer(
            KVCFG, kv, torch.tensor([True, False, False, True]),
            wire_dtype="int8")
        _, meta, arrays = decode_frame(frame)
        del arrays["k@scale"]
        with pytest.raises(PayloadMismatchError):
            decode_kv_transfer(meta, arrays, device="cpu")

    def test_wrong_frame_kind_for_recv_shared(self):
        ch = LoopbackChannel()
        ch.write(encode_frame("tokens", {}, {}))
        with pytest.raises(PayloadMismatchError):
            recv_shared(ch, device="cpu")

    def test_states_are_refused_until_ported(self):
        """States ride the frame once they have a mask (they are ported):
        without ``state_select`` nothing ships, as in the reference, and
        with one the frame is the reference's and decodes to them."""
        _, kv = _kv("float32", S=5)
        states = {"ssm": torch.arange(64.0).reshape(4, 2, 8)}
        sel = torch.tensor([True, False, True, False])
        bare, _, _, _ = encode_kv_transfer(KVCFG, kv, torch.from_numpy(SELECT))
        frame, _, _, _ = encode_kv_transfer(KVCFG, kv,
                                            torch.from_numpy(SELECT),
                                            states=states)
        assert frame == bare
        frame, _, _, _ = encode_kv_transfer(KVCFG, kv,
                                            torch.from_numpy(SELECT),
                                            states=states, state_select=sel)
        jframe, _, _, _ = jremote.encode_kv_transfer(
            JKVCFG, {p: jnp.asarray(kv[p].numpy()) for p in kv},
            jnp.asarray(SELECT), {"ssm": jnp.asarray(states["ssm"].numpy())},
            jnp.asarray(sel.numpy()))
        assert frame == jframe
        shared, _ = decode_kv_transfer(*decode_frame(frame)[1:],
                                       device="cpu")
        assert torch.equal(shared.states["ssm"][::2], states["ssm"][::2])
        assert not shared.states["ssm"][1::2].any()


class TestMutationProperty:
    """Any byte-level mutation of a valid frame raises a typed
    RemoteProtocolError: never a decode, never an untyped crash."""

    @given(st.data())
    @settings(max_examples=40, deadline=None,
              suppress_health_check=[HealthCheck.too_slow])
    def test_single_byte_mutation_never_decodes(self, data):
        frame = bytearray(small_frame())
        i = data.draw(st.integers(0, len(frame) - 1))
        delta = data.draw(st.integers(1, 255))
        frame[i] = (frame[i] + delta) % 256
        with pytest.raises(RemoteProtocolError):
            decode_frame(bytes(frame))

    @given(st.data())
    @settings(max_examples=30, deadline=None,
              suppress_health_check=[HealthCheck.too_slow])
    def test_random_multi_byte_mutation_never_decodes(self, data):
        frame = bytearray(small_frame())
        for _ in range(data.draw(st.integers(1, 8))):
            i = data.draw(st.integers(0, len(frame) - 1))
            delta = data.draw(st.integers(1, 255))
            frame[i] = (frame[i] + delta) % 256
        with pytest.raises(RemoteProtocolError):
            decode_frame(bytes(frame))

    @given(st.integers(0, 10_000))
    @settings(max_examples=30, deadline=None)
    def test_any_strict_prefix_raises(self, cut):
        frame = small_frame()
        ch = LoopbackChannel()
        ch.write(frame[:cut % len(frame)])
        with pytest.raises((FrameTruncatedError, ChannelClosedError)):
            read_frame(ch)


# ---------------------------------------------------------------------------
# channels
# ---------------------------------------------------------------------------
class TestChannels:
    def test_loopback_fifo_across_frames(self):
        ch = LoopbackChannel()
        ch.write(encode_frame("a", {"i": 0}, {}))
        ch.write(encode_frame("b", {"i": 1}, {}))
        assert read_frame(ch)[0] == "a"
        assert read_frame(ch)[0] == "b"

    def test_file_channel_round_trip(self, tmp_path):
        tx = FileChannel(str(tmp_path), timeout_s=1.0)
        rx = FileChannel(str(tmp_path), timeout_s=1.0)
        tx.write(small_frame())
        kind, _, arrays = read_frame(rx)
        assert kind == "shared_kv"
        np.testing.assert_array_equal(
            arrays["a"].numpy(),
            np.arange(12, dtype=np.float32).reshape(3, 4))

    def test_socket_channel_round_trip(self, kv_frame):
        frame, _ = kv_frame
        a, b = socket.socketpair()
        SocketChannel(a).write(frame)
        kind, meta, arrays = read_frame(SocketChannel(b))
        shared, _ = decode_kv_transfer(meta, arrays, device="cpu")
        assert shared.layers == (0, 2)
        a.close(), b.close()

    def test_health_meta_round_trip_and_defaults(self):
        meta = build_health_meta(answered=3, prefix_installed=True,
                                 page_ids=["a"], queue_depth=2,
                                 slots_capacity=4, slots_occupied=1)
        assert meta == jremote.build_health_meta(
            answered=3, prefix_installed=True, page_ids=["a"],
            queue_depth=2, slots_capacity=4, slots_occupied=1)
        _, got, _ = decode_frame(encode_frame("health_ack", meta, {}))
        assert parse_health_meta(got) == meta
        old = {"answered": "x", "slots": {"capacity": None}}
        assert parse_health_meta(old) == jremote.parse_health_meta(old)
        with pytest.raises(PayloadMismatchError):
            parse_health_meta([1])


class TestFileChannelNonce:
    def test_consumed_chunks_are_unlinked(self, tmp_path):
        tx = FileChannel(str(tmp_path), timeout_s=1.0)
        rx = FileChannel(str(tmp_path), timeout_s=1.0)
        for _ in range(3):
            tx.write(small_frame())
        for _ in range(3):
            assert read_frame(rx)[0] == "shared_kv"
        left = [f for f in os.listdir(tmp_path) if f.endswith(".chunk")]
        assert left == []

    def test_writer_restart_does_not_replay_stale_chunks(self, tmp_path):
        dead = FileChannel(str(tmp_path), timeout_s=0.5)
        dead.write(encode_frame("stale_a", {}, {}))
        dead.write(encode_frame("stale_b", {}, {}))
        tx = FileChannel(str(tmp_path), timeout_s=0.5)
        tx.write(encode_frame("fresh", {"ok": 1}, {}))
        rx = FileChannel(str(tmp_path), timeout_s=0.5)
        kind, meta, _ = read_frame(rx)
        assert kind == "fresh" and meta["ok"] == 1
        stale = [f for f in os.listdir(tmp_path)
                 if f.endswith(".chunk") and dead._nonce in f]
        assert stale == []

    def test_reader_locks_stream_identity_mid_stream(self, tmp_path):
        tx = FileChannel(str(tmp_path), timeout_s=0.2)
        rx = FileChannel(str(tmp_path), timeout_s=0.2)
        tx.write(encode_frame("a", {}, {}))
        assert read_frame(rx)[0] == "a"
        tx2 = FileChannel(str(tmp_path), timeout_s=0.2)
        tx2.write(encode_frame("x", {}, {}))
        with pytest.raises(RemoteProtocolError):
            read_frame(rx)

    def test_clean_close_after_the_last_chunk(self, tmp_path):
        tx = FileChannel(str(tmp_path), timeout_s=1.0)
        rx = FileChannel(str(tmp_path), timeout_s=1.0)
        tx.write(small_frame())
        tx.close()
        assert read_frame(rx)[0] == "shared_kv"
        t0 = time.monotonic()
        with pytest.raises(ChannelClosedError) as e:
            read_frame(rx)
        assert not isinstance(e.value, ChannelTimeoutError)
        assert time.monotonic() - t0 < 0.9

    def test_fresh_pair_still_round_trips_transfers(self, tmp_path,
                                                    kv_frame):
        frame, _ = kv_frame
        tx = FileChannel(str(tmp_path), timeout_s=2.0)
        rx = FileChannel(str(tmp_path), timeout_s=2.0)
        tx.write(frame)
        kind, meta, arrays = read_frame(rx)
        shared, _ = decode_kv_transfer(meta, arrays, device="cpu")
        assert kind == "shared_kv" and shared.layers == (0, 2)


# ---------------------------------------------------------------------------
# streamed frames
# ---------------------------------------------------------------------------
class TestStreaming:
    def _kv(self):
        _, kv = _kv("float32", seed=11, S=8)
        return kv, torch.tensor([True, False, True, False])

    @pytest.mark.parametrize("wire_dtype", ["float32", "float16", "int8",
                                            "int4", "plan:float16,int4"])
    def test_streamed_equals_monolithic(self, wire_dtype):
        kv, select = self._kv()
        mono_ch, stream_ch = LoopbackChannel(), LoopbackChannel()
        n_mono = send_shared(mono_ch, KVCFG, kv, select,
                             wire_dtype=wire_dtype)
        n_stream = send_shared(stream_ch, KVCFG, kv, select,
                               wire_dtype=wire_dtype, chunk_bytes=300)
        assert n_stream == n_mono
        mono, nm = recv_shared(mono_ch, device="cpu")
        streamed, ns = recv_shared(stream_ch, device="cpu")
        assert nm == n_mono and ns == n_stream
        assert streamed.layers == mono.layers == (0, 2)
        assert streamed.prefix_len == mono.prefix_len == 8
        for part in ("k", "v"):
            assert torch.equal(streamed.packed_kv[part],
                               mono.packed_kv[part])

    def test_chunk_frames_are_bounded(self):
        kv, select = self._kv()
        sender = KVStreamSender(KVCFG, kv, select, wire_dtype="float16",
                                chunk_bytes=512)
        frames = list(sender.frames())
        assert len(frames) == sender.n_frames > 3
        kinds = []
        for frame, _ in frames:
            kind, _, arrays = decode_frame(frame)
            kinds.append(kind)
            if kind == "kv_stream_chunk":
                assert sum(a.numel() * a.element_size()
                           for a in arrays.values()) <= 512
        assert kinds[0] == "kv_stream_begin"
        assert kinds[-1] == "kv_stream_end"
        assert all(k == "kv_stream_chunk" for k in kinds[1:-1])

    def _stream_frames(self, wire_dtype="int8", sid=0):
        kv, select = self._kv()
        sender = KVStreamSender(KVCFG, kv, select, wire_dtype=wire_dtype,
                                chunk_bytes=300, sid=sid)
        return [decode_frame(f) for f, _ in sender.frames()]

    def test_out_of_order_chunk_raises(self):
        frames = self._stream_frames()
        asm = KVStreamAssembler(device="cpu")
        asm.feed(*frames[0])
        with pytest.raises(PayloadMismatchError):
            asm.feed(*frames[2])

    def test_wrong_sid_mid_stream_raises(self):
        frames = self._stream_frames(sid=3)
        asm = KVStreamAssembler(device="cpu")
        asm.feed(*frames[0])
        kind, meta, arrays = frames[1]
        with pytest.raises(PayloadMismatchError):
            asm.feed(kind, dict(meta, sid=4), arrays)

    def test_short_coverage_at_end_raises(self):
        frames = self._stream_frames()
        asm = KVStreamAssembler(device="cpu")
        for frame in frames[:-2]:
            asm.feed(*frame)
        with pytest.raises(PayloadMismatchError):
            asm.feed(*frames[-1])
        assert not asm.active

    def test_missing_array_in_chunk_raises(self):
        frames = self._stream_frames()
        asm = KVStreamAssembler(device="cpu")
        asm.feed(*frames[0])
        kind, meta, arrays = frames[1]
        arrays = {k: v for k, v in arrays.items() if k != "v@scale"}
        with pytest.raises(PayloadMismatchError):
            asm.feed(kind, meta, arrays)

    def test_chunk_without_begin_raises(self):
        frames = self._stream_frames()
        with pytest.raises(PayloadMismatchError):
            KVStreamAssembler(device="cpu").feed(*frames[1])

    def test_abandoned_stream_replay_is_idempotent(self):
        asm = KVStreamAssembler(device="cpu")
        for frame in self._stream_frames(sid=0)[:3]:
            assert asm.feed(*frame) is None
        assert asm.active
        out = None
        for frame in self._stream_frames(sid=1):
            out = asm.feed(*frame)
        shared, _ = out
        kv, select = self._kv()
        ch = LoopbackChannel()
        send_shared(ch, KVCFG, kv, select, wire_dtype="int8")
        mono, _ = recv_shared(ch, device="cpu")
        for part in ("k", "v"):
            assert torch.equal(shared.packed_kv[part], mono.packed_kv[part])

    def test_remote_transport_streams_by_default(self, port_pair):
        cfg, _ = port_pair
        kv, select = self._kv()
        t_stream = RemoteTransport("int8", chunk_bytes=300)
        t_mono = RemoteTransport("int8", chunk_bytes=None)
        s1 = t_stream.send(cfg, KVCFG, kv, select)
        s2 = t_mono.send(cfg, KVCFG, kv, select)
        assert t_stream.last.n_bytes == t_mono.last.n_bytes
        assert t_stream.last.frame_bytes > t_mono.last.frame_bytes
        for part in ("k", "v"):
            assert torch.equal(s1.packed_kv[part], s2.packed_kv[part])
        r = t_stream.last
        assert r.serialize_s > 0 and r.deserialize_s > 0
        assert r.attempts == 1 and r.degradation is None
        assert r.serialize_s + r.channel_s + r.deserialize_s \
            <= r.latency_s + 1e-6


class TestFrameDeadline:
    def test_trickling_peer_trips_frame_deadline(self, kv_frame):
        frame, _ = kv_frame
        a, b = socket.socketpair()
        stop = threading.Event()

        def trickle():
            for i in range(len(frame)):
                if stop.is_set():
                    return
                try:
                    a.sendall(frame[i:i + 1])
                except OSError:
                    return
                stop.wait(0.05)

        th = threading.Thread(target=trickle)
        th.start()
        ch = SocketChannel(b, frame_timeout_s=0.3)
        t0 = time.monotonic()
        try:
            with pytest.raises(ChannelTimeoutError):
                read_frame(ch)
            assert 0.2 <= time.monotonic() - t0 < 2.0
        finally:
            stop.set()
            th.join()
            ch.close()
            a.close()

    def test_idle_between_frames_does_not_trip(self, kv_frame):
        frame, _ = kv_frame
        a, b = socket.socketpair()
        tx, rx = SocketChannel(a), SocketChannel(b, frame_timeout_s=0.3)
        try:
            tx.write(frame)
            assert read_frame(rx)[0] == "shared_kv"
            time.sleep(0.45)
            tx.write(frame)
            assert read_frame(rx)[0] == "shared_kv"
        finally:
            tx.close()
            rx.close()

    def test_fast_peer_unaffected_by_deadline(self, kv_frame):
        frame, _ = kv_frame
        a, b = socket.socketpair()
        tx, rx = SocketChannel(a), SocketChannel(b, frame_timeout_s=5.0)
        try:
            for _ in range(3):
                tx.write(frame)
            for _ in range(3):
                kind, meta, arrays = read_frame(rx)
                shared, _ = decode_kv_transfer(meta, arrays, device="cpu")
                assert shared.layers == (0, 2)
        finally:
            tx.close()
            rx.close()


# ---------------------------------------------------------------------------
# RemoteTransport
# ---------------------------------------------------------------------------
def test_policy_and_breaker_are_honoured():
    """A ``policy`` retries a disconnect over the reset channel; an open
    ``breaker`` raises CircuitOpenError without writing a frame."""
    from repro_torch.comm.resilience import (CircuitBreaker,
                                             CircuitOpenError, Fault,
                                             FaultSchedule, FaultyChannel,
                                             RetryPolicy)
    _, kv = _kv("float32", seed=2)
    select = torch.from_numpy(SELECT)
    faulty = FaultyChannel(LoopbackChannel(),
                           FaultSchedule([Fault(0, "disconnect")]))
    tr = RemoteTransport("int8", channel=faulty,
                         policy=RetryPolicy(backoff_s=0.0, jitter=0.0))
    got = tr.send(None, KVCFG, kv, select)
    want = RemoteTransport("int8").send(None, KVCFG, kv, select)
    for p in ("k", "v"):
        assert torch.equal(got.packed_kv[p], want.packed_kv[p])
    assert tr.last.attempts == 2 and faulty.resets == 1
    breaker = CircuitBreaker(failure_threshold=1, reset_timeout_s=1e9)
    breaker.record_failure()
    quiet = FaultyChannel(LoopbackChannel())
    with pytest.raises(CircuitOpenError):
        RemoteTransport("int8", channel=quiet, breaker=breaker).send(
            None, KVCFG, kv, select)
    assert quiet.writes == 0


@pytest.mark.parametrize("chunk_bytes", [None, 300])
@pytest.mark.parametrize("wire", ["float32", "int8", PLAN])
def test_remote_mapped_send_equals_serialized(port_pair, wire, chunk_bytes):
    """A mapped send over the remote wire hands over the serialized
    transport's view and bytes, with the frame fields stamped."""
    cfg, _ = port_pair
    _, kv = _kv("float32", seed=6, S=11)
    _, asg = _assignments()
    tr = RemoteTransport(wire, chunk_bytes=chunk_bytes)
    ser = SerializedTransport(wire)
    got = tr.send(cfg, KVCFG, kv, None, assignment=asg)
    want = ser.send(cfg, KVCFG, kv, None, assignment=asg)
    assert (got.layers, got.src_layers) == (asg.dst, asg.src)
    for p in ("k", "v"):
        assert torch.equal(got.packed_kv[p], want.packed_kv[p])
    r = tr.last
    assert (r.n_bytes, r.layers, r.context_len, r.wire_dtype) == \
        (ser.last.n_bytes, 3, 11, ser.last.wire_dtype)
    assert r.frame_bytes > r.n_bytes and r.attempts == 1


@pytest.mark.parametrize("wire", ["bfloat16", "int8"])
def test_remote_paged_send_dedups_and_matches_unpaged(port_pair, wire):
    """Two sends of one context through a PageStore: the first ships every
    page, the second none (a hit rate of 1); both views equal the unpaged
    remote view; a mapped paged send keeps its provenance; sync=False is
    eager here and gives the same record."""
    cfg, _ = port_pair
    _, kv = _kv("float32", seed=7, S=21)
    select = torch.from_numpy(SELECT)
    plain = RemoteTransport(wire).send(cfg, KVCFG, kv, select)
    store = PageStore(page_len=8)
    tr = RemoteTransport(wire, store=store)
    for rnd, sync in ((0, True), (1, False)):
        shared = tr.send(cfg, KVCFG, kv, select, sync=sync)
        r = tr.log[-1]
        assert r.pages_total == 3 * 3
        assert r.pages_sent == (9 if rnd == 0 else 0)
        assert r.hit_rate == (0.0 if rnd == 0 else 1.0)
        for p in ("k", "v"):
            assert torch.equal(shared.packed_kv[p], plain.packed_kv[p])
        assert tr.last_table is not None
    _, asg = _assignments()
    mapped = tr.send(cfg, KVCFG, kv, None, assignment=asg)
    assert (mapped.layers, mapped.src_layers) == (asg.dst, asg.src)
    assert tr.last_table.src_layers == asg.src
    tr.release_table()
    assert store.stats().pinned_bytes == 0


def test_scheduler_over_remote_matches_in_memory(port_pair, tok):
    """The continuous-batching scheduler over a float32 RemoteTransport,
    streamed and paged, gives the in-memory stream's tokens (a float32
    wire of float32 KV is lossless)."""
    from repro_torch.data.synthetic import SyntheticTask, TaskConfig
    from repro_torch.serving.scheduler import (Scheduler, SchedulerConfig,
                                               make_requests)
    cfg, params = port_pair
    batches = [SyntheticTask(tok, TaskConfig("retrieval", num_facts=nf,
                                             seed=20 + nf)).batch(2)
               for nf in (3, 5)]
    reqs = make_requests(batches, max_new=3, pad=tok.PAD)
    out = {}
    for name, tr in (("mem", InMemoryTransport()),
                     ("remote", RemoteTransport("float32", chunk_bytes=256)),
                     ("paged", RemoteTransport(
                         "float32", store=PageStore(page_len=4)))):
        sess = CommSession(Agent("s", cfg, params, tok),
                           Agent("r", cfg, params, tok), tr)
        comps, _ = Scheduler(sess, KVCFG, config=SchedulerConfig(
            capacity=2, prefix_bucket=8, query_bucket=4)).run(reqs)
        out[name] = [c.tokens.tolist() for c in comps]
    assert out["remote"] == out["mem"] == out["paged"]
