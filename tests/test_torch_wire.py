"""The port's wire codec and transports against the reference: wire arrays
byte-identical to the reference's encode_wire at float32, bfloat16 and
float16 inputs (so a reference sender and a port receiver can talk; at
float32 also to np_encode_wire), int4 and WirePlan wires, measured bytes
equal to the analytic count, and the int8 wire held to a relative logit
bound (not argmax: random-init tiny_params has near-tied top logits)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_bridge import port_cfg, port_params, t
from repro import core as jcore
from repro.comm import Agent as JAgent
from repro.comm import CommSession as JSession
from repro.comm.transport import SerializedTransport as JSerialized
from repro.comm.transport import WirePlan as JWirePlan
from repro.comm.transport import decode_wire as jdecode_wire
from repro.comm.transport import device_wire_roundtrip as jdevice_roundtrip
from repro.comm.transport import encode_wire as jencode_wire
from repro.comm.transport import np_encode_wire
from repro.core.types import KVCommConfig as JKVCommConfig
from repro_torch.comm import Agent, CommSession
from repro_torch.comm.transport import (InMemoryTransport,
                                        SerializedTransport, WirePlan,
                                        as_wire_plan, decode_wire,
                                        device_wire_roundtrip, encode_wire,
                                        resolve_wire_dtype, wire_array_count,
                                        wire_has_scales, wire_spec)
from repro_torch.core import protocol
from repro_torch.core.channel import kv_wire_bytes
from repro_torch.core.types import KVCommConfig

WIRES = ["float32", "float16", "bfloat16", "int8"]
KW = dict(ratio=0.5, selector="prior_only")


def _bytes(a) -> bytes:
    if isinstance(a, torch.Tensor):
        return a.contiguous().view(torch.uint8).numpy().tobytes()
    return np.ascontiguousarray(a).view(np.uint8).tobytes()


@pytest.mark.parametrize("wire", WIRES)
def test_wire_arrays_byte_identical(wire):
    rng = np.random.default_rng(3)
    x = (rng.standard_normal((3, 2, 7, 2, 16)) * 3).astype(np.float32)
    x[1] = 0.0                          # an all-zero layer: floored scale
    x[2, 0, 0, 0, :4] = [0.5, -0.5, 1.5, 2.5]   # half-even rounding cases
    ref_arrays, ref_n = np_encode_wire(x, wire)
    got, n = encode_wire(t(x), wire)
    assert n == ref_n and len(got) == len(ref_arrays)
    for g, r in zip(got, ref_arrays):
        assert tuple(g.shape) == r.shape
        assert _bytes(g) == _bytes(r)
    back = decode_wire(got, wire, torch.float32, "cpu")
    tol = {"float32": 0, "float16": 1e-3, "bfloat16": 8e-3,
           "int8": 1.0 / 127}[wire]
    np.testing.assert_allclose(back.numpy(), x,
                               atol=tol * np.abs(x).max() + 1e-12)


PLAN = "plan:float16,int4,int8"
TIERS = ["int8", "int4", PLAN, "float16", "bfloat16", "float32"]


def _payload(dtype, seed=3, shape=(3, 2, 37, 2, 16)):
    """A stacked payload with an all-zero layer (a floored scale, and at
    float16 a zero scale) and half-even ties, as a float32 numpy array and
    the same values at ``dtype`` for each framework."""
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal(shape) * 3).astype(np.float32)
    x[1] = 0.0
    x[2, 0, 0, 0, :4] = [0.5, -0.5, 1.5, 2.5]
    return jnp.asarray(x).astype(dtype), t(x).to(getattr(torch, dtype))


@pytest.mark.parametrize("wire", TIERS)
@pytest.mark.parametrize("dtype", ["bfloat16", "float16", "float32"])
def test_wire_arrays_match_reference_encode_wire(dtype, wire):
    """The codec computes in the payload's own dtype, as the reference's
    encode_wire does: arrays and scales byte-identical at bf16 and fp16
    too (a float32 upcast gives other scales and codes there)."""
    jx, x = _payload(dtype)
    ref_arrays, ref_n = jencode_wire(jx, wire)
    got, n = encode_wire(x, wire)
    assert n == ref_n and len(got) == len(ref_arrays) \
        == wire_array_count(wire)
    for g, r in zip(got, ref_arrays):
        assert tuple(g.shape) == r.shape
        assert _bytes(g) == _bytes(r)
    # decode values equal, and the device roundtrip equals decode(encode)
    back = decode_wire(got, wire, x.dtype, "cpu")
    want = np.asarray(jdecode_wire(ref_arrays, wire, jx.dtype)
                      .astype(jnp.float32))
    np.testing.assert_array_equal(back.float().numpy(), want)
    assert torch.equal(device_wire_roundtrip(x, wire, x.dtype), back)
    np.testing.assert_array_equal(
        np.asarray(jdevice_roundtrip(jx, wire, jx.dtype)
                   .astype(jnp.float32)), want)


def test_int4_needs_even_head_dim():
    with pytest.raises(ValueError, match="even trailing"):
        encode_wire(torch.zeros((1, 1, 2, 1, 3)), "int4")


@pytest.mark.parametrize("n", range(1, 13))
def test_wire_plan_from_scores_matches_reference(n):
    """Including n = 6, where rounding the two fractions on their own
    would overshoot the int8 byte bound."""
    rng = np.random.default_rng(n)
    scores = rng.standard_normal(n + 3)
    select = np.zeros(n + 3, bool)
    select[rng.choice(n + 3, n, replace=False)] = True
    for kw in ({}, dict(top_frac=0.5, low_frac=0.25)):
        got = WirePlan.from_scores(scores, select=select, **kw)
        want = JWirePlan.from_scores(scores, select=select, **kw)
        assert got.dtypes == want.dtypes
        assert (got.n_scaled(), got.state_dtype) == (want.n_scaled(),
                                                     want.state_dtype)
    # the default tiers never ship more than a uniform int8 wire
    assert WirePlan.from_scores(scores, select=select).payload_bits() \
        <= 8 * n
    assert WirePlan.from_scores(scores[:0]).dtypes == ()


def test_wire_spec_parse_roundtrip():
    plan = WirePlan(("float16", "int4", "int8", "int4"))
    assert plan.spec == "plan:float16,int4,int8,int4"
    assert WirePlan.parse(plan.spec) == plan
    assert resolve_wire_dtype(plan.spec) == plan == as_wire_plan(plan)
    assert plan.groups() == [("float16", [0]), ("int4", [1, 3]),
                             ("int8", [2])]
    assert wire_spec(plan) == plan.spec and wire_spec("int4") == "int4"
    assert as_wire_plan("int8") is None
    assert wire_has_scales(plan) and not wire_has_scales(WirePlan(()))
    assert wire_array_count(plan) == 5 and wire_array_count(WirePlan(())) == 1
    for bad in ("int2", "plan:float16,int3", 8):
        with pytest.raises(ValueError):
            resolve_wire_dtype(bad)


def _setup(tiny_cfg, tiny_params, tok):
    cfg, params = port_cfg(tiny_cfg), port_params(tiny_params)
    rng = np.random.default_rng(4)
    ctx = rng.integers(4, tok.vocab_size, (2, 9)).astype(np.int32)
    qry = rng.integers(4, tok.vocab_size, (2, 5)).astype(np.int32)
    return cfg, params, ctx, qry


@pytest.mark.parametrize("wire", WIRES)
@pytest.mark.parametrize("packed", [True, False], ids=["packed", "dense"])
def test_measured_bytes_match_analytic(tiny_cfg, tiny_params, tok, wire,
                                       packed):
    cfg, params, ctx, qry = _setup(tiny_cfg, tiny_params, tok)
    kv, _ = protocol.sender_prefill(params, cfg, t(ctx).long())
    select = protocol.make_selection(cfg, KVCommConfig(**KW))
    M = int(select.sum())
    tr = SerializedTransport(wire, packed=packed)
    shared = tr.send(cfg, KVCommConfig(**KW), kv, select)
    isz = {"float32": 4, "float16": 2, "bfloat16": 2, "int8": 1}[wire]
    scales = 2 * 4 * M if wire == "int8" else 0
    assert tr.last.n_bytes == kv_wire_bytes(cfg, 2, 9, M, isz) + scales
    assert tr.last.latency_s > 0 and shared.is_packed == packed
    mem = InMemoryTransport(packed=packed)
    mem.send(cfg, KVCommConfig(**KW), kv, select)
    assert mem.last.n_bytes == kv_wire_bytes(cfg, 2, 9, M, 4)
    # the reference's serialized transport counts the same bytes
    jtr = JSerialized(wire, packed=packed)
    jkv, _ = jcore.sender_prefill(tiny_params, tiny_cfg, jnp.asarray(ctx))
    jtr.send(tiny_cfg, JKVCommConfig(**KW), jkv,
             jcore.make_selection(tiny_cfg, JKVCommConfig(**KW)))
    assert jtr.last.n_bytes == tr.last.n_bytes


@pytest.mark.parametrize("packed", [True, False], ids=["packed", "dense"])
def test_int8_wire_logits_bounded(tiny_cfg, tiny_params, tok, packed):
    """Receiver logits through the int8 wire stay within 5% (relative to
    the largest logit) of the float32 wire's, and agree with the
    reference's int8 path within 1e-4."""
    cfg, params, ctx, qry = _setup(tiny_cfg, tiny_params, tok)
    kvcfg = KVCommConfig(**KW)
    kv, _ = protocol.sender_prefill(params, cfg, t(ctx).long())
    select = protocol.make_selection(cfg, kvcfg)
    logits = {}
    for wire in ("float32", "int8"):
        sh = SerializedTransport(wire, packed=packed).send(cfg, kvcfg, kv,
                                                           select)
        logits[wire] = protocol.receiver_prefill(params, cfg, t(qry).long(),
                                                 sh, max_new=1).logits
    ref = logits["float32"]
    rel = (logits["int8"] - ref).abs().max() / ref.abs().max()
    assert float(rel) <= 0.05
    jk = JKVCommConfig(**KW)
    jkv, _ = jcore.sender_prefill(tiny_params, tiny_cfg, jnp.asarray(ctx))
    jsh = JSerialized("int8", packed=packed).send(
        tiny_cfg, jk, jkv, jcore.make_selection(tiny_cfg, jk))
    jl = jcore.receiver_prefill(tiny_params, tiny_cfg, jnp.asarray(qry),
                                jsh, max_new=1).logits
    np.testing.assert_allclose(logits["int8"].numpy(), np.asarray(jl),
                               atol=1e-4, rtol=1e-4)


def test_deferred_stamps_settle(tiny_cfg, tiny_params, tok):
    cfg, params, ctx, _ = _setup(tiny_cfg, tiny_params, tok)
    kv, _ = protocol.sender_prefill(params, cfg, t(ctx).long())
    select = protocol.make_selection(cfg, KVCommConfig(**KW))
    tr = InMemoryTransport(sync=False)
    tr.send(cfg, KVCommConfig(**KW), kv, select)
    tr.send(cfg, KVCommConfig(**KW), kv, select)
    assert all(r.latency_s == 0.0 for r in tr.log)
    assert tr.poll_latency() == 2      # CPU transfers are already done
    assert all(r.latency_s > 0 for r in tr.log)
    with pytest.raises(ValueError, match="wire_dtype"):
        SerializedTransport("int2")


@pytest.mark.parametrize("packed", [True, False], ids=["packed", "dense"])
@pytest.mark.parametrize("wire", ["int4", PLAN])
def test_int4_and_plan_bytes_and_logits(tiny_cfg, tiny_params, tok, wire,
                                        packed):
    """int4 and plan wires: bytes equal to the analytic count plus the
    scales and to the reference's, receiver logits equal to the
    reference's through the same wire within 1e-4."""
    cfg, params, ctx, qry = _setup(tiny_cfg, tiny_params, tok)
    kvcfg = KVCommConfig(ratio=0.75, selector="prior_only")
    kv, _ = protocol.sender_prefill(params, cfg, t(ctx).long())
    select = protocol.make_selection(cfg, kvcfg)
    M = int(select.sum())
    plan = as_wire_plan(wire) or WirePlan(("int4",) * M)
    tr = SerializedTransport(wire, packed=packed)
    sh = tr.send(cfg, kvcfg, kv, select)
    assert tr.last.wire_dtype == wire_spec(wire)
    assert tr.last.n_bytes == kv_wire_bytes(cfg, 2, 9, M, plan=plan) \
        + 2 * 4 * plan.n_scaled()
    jk = JKVCommConfig(ratio=0.75, selector="prior_only")
    jkv, _ = jcore.sender_prefill(tiny_params, tiny_cfg, jnp.asarray(ctx))
    jtr = JSerialized(wire, packed=packed)
    jsh = jtr.send(tiny_cfg, jk, jkv, jcore.make_selection(tiny_cfg, jk))
    assert jtr.last.n_bytes == tr.last.n_bytes
    got = protocol.receiver_prefill(params, cfg, t(qry).long(), sh,
                                    max_new=1).logits
    want = jcore.receiver_prefill(tiny_params, tiny_cfg, jnp.asarray(qry),
                                  jsh, max_new=1).logits
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                               rtol=1e-4)


def test_session_wire_plan_matches_reference(tiny_cfg, tiny_params, tok):
    """The calibrated plan and the prior-only plan, port and reference."""
    cfg, params = port_cfg(tiny_cfg), port_params(tiny_params)
    ctx = np.random.default_rng(5).integers(4, tok.vocab_size, (1, 9))
    qry = np.random.default_rng(6).integers(4, tok.vocab_size, (1, 5))
    sess = CommSession(Agent("s", cfg, params, tok),
                       Agent("r", cfg, params, tok))
    jsess = JSession(JAgent("s", tiny_cfg, tiny_params, tok),
                     JAgent("r", tiny_cfg, tiny_params, tok))
    sess.calibrate(ctx, qry, key="t")
    jsess.calibrate(ctx, qry, key="t")
    for kw, key in ((dict(ratio=0.75, alpha=0.7), "t"),
                    (dict(ratio=1.0, selector="prior_only"), None)):
        got = sess.wire_plan(KVCommConfig(**kw), key=key)
        want = jsess.wire_plan(JKVCommConfig(**kw), key=key)
        assert got.dtypes == want.dtypes and len(got) > 0
