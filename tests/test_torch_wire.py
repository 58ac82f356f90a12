"""The port's wire codec and transports against the reference: wire arrays
byte-identical to np_encode_wire (so a reference sender and a port
receiver can talk), measured bytes equal to the analytic count, and the
int8 wire held to a relative logit bound (not argmax: random-init
tiny_params has near-tied top logits)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_bridge import port_cfg, port_params, t
from repro import core as jcore
from repro.comm.transport import SerializedTransport as JSerialized
from repro.comm.transport import np_encode_wire
from repro.core.types import KVCommConfig as JKVCommConfig
from repro_torch.comm.transport import (InMemoryTransport,
                                        SerializedTransport, decode_wire,
                                        encode_wire)
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
    kv = protocol.sender_prefill(params, cfg, t(ctx).long())
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
    kv = protocol.sender_prefill(params, cfg, t(ctx).long())
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
    kv = protocol.sender_prefill(params, cfg, t(ctx).long())
    select = protocol.make_selection(cfg, KVCommConfig(**KW))
    tr = InMemoryTransport(sync=False)
    tr.send(cfg, KVCommConfig(**KW), kv, select)
    tr.send(cfg, KVCommConfig(**KW), kv, select)
    assert all(r.latency_s == 0.0 for r in tr.log)
    assert tr.poll_latency() == 2      # CPU transfers are already done
    assert all(r.latency_s > 0 for r in tr.log)
    with pytest.raises(ValueError, match="wire_dtype"):
        SerializedTransport("int4")
