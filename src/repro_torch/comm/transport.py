"""Transports: how KV moves from sender to receiver, with exact byte
accounting, and the wire codec.

``send`` takes the sender's full per-layer KV stack plus the selection mask
and returns the receiver-side ``SharedKV`` (packed by default), appending a
latency-stamped ``TransferRecord``.

  InMemoryTransport   — hand-over of device tensors; bytes are the
                        analytic size of the selected layers.
  SerializedTransport — materializes the wire on the host (fp32 / fp16 /
                        bf16, or int8 with per-layer symmetric scales),
                        counts its bytes and decodes it back. The wire
                        arrays are byte-identical to the reference codec
                        (``np_encode_wire``), so the two can talk.

Not ported yet: int4 and per-layer ``WirePlan`` wires, the paged store,
mapped (heterogeneous) sends and the remote transport.
"""
from __future__ import annotations

import abc
import time
from typing import List, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.channel import TransferRecord
from repro_torch.core.protocol import (build_packed, build_shared,
                                       gather_selected, pack_shared,
                                       selected_layer_ids)
from repro_torch.core.types import KVCommConfig, SharedKV

_WIRE_DTYPES = {"float32": torch.float32, "float16": torch.float16,
                "bfloat16": torch.bfloat16, "int8": torch.int8}


def _check_wire(wire_dtype: str) -> str:
    if wire_dtype not in _WIRE_DTYPES:
        raise ValueError(f"unsupported wire_dtype {wire_dtype!r}; expected "
                         f"one of {sorted(_WIRE_DTYPES)}")
    return wire_dtype


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def encode_wire(x: torch.Tensor, wire_dtype: str):
    """Cast one stacked array (leading layer axis) to its wire form on the
    host. Returns ``((cpu tensors...), n_bytes)``: one array for float
    wires; for int8 the quantized values and the per-layer float32 scales
    (absmax over all but the leading axis, floored at 1e-8, over 127;
    round-half-even, clipped to +-127), both counted."""
    if _check_wire(wire_dtype) == "int8":
        xf = x.float()
        absmax = xf.abs().amax(dim=tuple(range(1, x.dim())), keepdim=True)
        scale = absmax.clamp_min(1e-8) / 127.0
        q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
        q, scale = q.cpu(), scale.cpu()
        return (q, scale), _nbytes(q) + _nbytes(scale)
    wire = x.to(_WIRE_DTYPES[wire_dtype]).cpu()
    return (wire,), _nbytes(wire)


def decode_wire(wire, wire_dtype: str, dtype: torch.dtype,
                device) -> torch.Tensor:
    """Inverse of ``encode_wire`` at the compute dtype on ``device``
    (int8 dequantizes through float32)."""
    if _check_wire(wire_dtype) == "int8":
        q, s = wire
        return (q.to(device).float() * s.to(device)).to(dtype)
    return wire[0].to(device).to(dtype)


def roundtrip_kv(payload, wire_dtype: str, dtype, device):
    """Encode and decode a gathered {"k","v"} payload; returns (receiver
    payload, counted bytes)."""
    out, n = {}, 0
    for part in ("k", "v"):
        wire, nb = encode_wire(payload[part], wire_dtype)
        n += nb
        out[part] = decode_wire(wire, wire_dtype, dtype, device)
    return out, n


def selected_count(select) -> int:
    return 0 if select is None else int(select.sum())


def payload_bytes(kv, select) -> int:
    """Analytic bytes of the selected subset of a KV stack at its dtype."""
    _, B, Sc, Hkv, Dh = kv["k"].shape
    return (2 * selected_count(select) * B * Sc * Hkv * Dh
            * kv["k"].element_size())


class Transport(abc.ABC):
    """A byte-accounted link M_s -> M_r.

    ``sync=True`` stamps each record with the device-synced wall clock of
    the transfer; ``sync=False`` records a CUDA event instead and leaves
    the stamp to ``poll_latency`` / ``flush_latency``, so the serving loop
    never waits on the card to account a transfer."""

    def __init__(self, packed: bool = True, sync: bool = True) -> None:
        self.log: List[TransferRecord] = []
        self.packed = packed
        self.sync = sync
        self._pending: List[tuple] = []     # (record, t0, event or None)

    @property
    def total_bytes(self) -> int:
        return sum(r.n_bytes for r in self.log)

    @property
    def last(self) -> TransferRecord:
        return self.log[-1]

    def flush_latency(self) -> int:
        """Settle every deferred stamp (blocks on the recorded events)."""
        n = len(self._pending)
        for rec, t0, ev in self._pending:
            if ev is not None:
                ev.synchronize()
            rec.latency_s = time.perf_counter() - t0
        self._pending.clear()
        return n

    def poll_latency(self) -> int:
        """Stamp only the deferred records whose transfers have drained."""
        still, n = [], 0
        for rec, t0, ev in self._pending:
            if ev is None or ev.query():
                rec.latency_s = time.perf_counter() - t0
                n += 1
            else:
                still.append((rec, t0, ev))
        self._pending = still
        return n

    def send(self, cfg: ModelConfig, kvcfg: KVCommConfig, kv, select,
             sync: Optional[bool] = None) -> SharedKV:
        """Move the selected KV across; return the receiver-side view and
        record a TransferRecord."""
        do_sync = self.sync if sync is None else sync
        if do_sync:
            self.flush_latency()
        cuda = kv["k"].device.type == "cuda"
        t0 = time.perf_counter()
        shared = self._send(cfg, kvcfg, kv, select)
        if do_sync:
            if cuda:
                torch.cuda.synchronize(kv["k"].device)
            self.log[-1].latency_s = time.perf_counter() - t0
        else:
            ev = None
            if cuda:
                ev = torch.cuda.Event()
                ev.record()
            self._pending.append((self.log[-1], t0, ev))
        return shared

    @abc.abstractmethod
    def _send(self, cfg: ModelConfig, kvcfg: KVCommConfig, kv,
              select) -> SharedKV:
        """Transport-specific transfer; must append a TransferRecord."""

    def _record_kv(self, n_bytes: int, select, prefix_len: int,
                   wire_dtype: str) -> None:
        self.log.append(TransferRecord(
            kind="kv", n_bytes=n_bytes, layers=selected_count(select),
            context_len=prefix_len, wire_dtype=wire_dtype))


class InMemoryTransport(Transport):
    """In-process hand-over of the sender's device tensors (packed mode
    gathers the M selected layers). Bytes are the analytic payload size at
    the KV's own dtype."""

    def _send(self, cfg, kvcfg, kv, select) -> SharedKV:
        build = pack_shared if self.packed else build_shared
        shared = build(kvcfg, kv, select)
        self._record_kv(payload_bytes(kv, select), select, shared.prefix_len,
                        wire_dtype="model")
        return shared


class SerializedTransport(Transport):
    """Materializes the wire payload on the host and counts its bytes.

    The selected layers are gathered, encoded at ``wire_dtype`` ("float16"
    default, "bfloat16", "float32" or "int8"), measured and decoded back at
    the compute dtype on the KV's device. Dense mode scatters the decoded
    payload into a zero-padded (L, ...) stack."""

    def __init__(self, wire_dtype: str = "float16", packed: bool = True,
                 sync: bool = True) -> None:
        super().__init__(packed=packed, sync=sync)
        self.wire_dtype = _check_wire(wire_dtype)

    def _send(self, cfg, kvcfg, kv, select) -> SharedKV:
        prefix_len = int(kv["k"].shape[2])
        layers = selected_layer_ids(select)
        rx, n_bytes = roundtrip_kv(gather_selected(kv, select),
                                   self.wire_dtype, kv["k"].dtype,
                                   kv["k"].device)
        if self.packed:
            shared = build_packed(kvcfg, rx, layers, prefix_len,
                                  select=select)
        else:
            dense = {}
            for part in ("k", "v"):
                dense[part] = torch.zeros_like(kv[part])
                for m, l in enumerate(layers):
                    dense[part][l] = rx[part][m]
            shared = build_shared(kvcfg, dense, select)
        self._record_kv(n_bytes, select, prefix_len,
                        wire_dtype=self.wire_dtype)
        return shared
