"""Transports: how KV moves from sender to receiver, with exact byte
accounting, and the wire codec.

``send`` takes the sender's full per-layer KV stack plus the selection mask
and returns the receiver-side ``SharedKV`` (packed by default), appending a
latency-stamped ``TransferRecord``.

  InMemoryTransport   — hand-over of device tensors; bytes are the
                        analytic size of the selected layers.
  SerializedTransport — materializes the wire on the host (fp32 / fp16 /
                        bf16, int8 or nibble-packed int4 with per-layer
                        symmetric scales, or a per-layer ``WirePlan``),
                        counts its bytes and decodes it back.

The codec computes what the reference's ``encode_wire`` computes, in the
payload's own dtype (absmax, scale, division and rounding), so its arrays
are byte-identical to the reference's at every input dtype. The
reference's streamed remote frames use its host codec ``np_encode_wire``
only for float32 payloads, where the two codecs agree, and ``encode_wire``
for every other dtype; so this one codec gives the peer's frames at every
dtype (``np_encode_wire`` / ``np_decode_wire`` here are it, run on the
host).

With a ``PageStore`` attached (``store=``), every KV send goes through the
content-addressed paged path (``repro_torch.store``): only the pages the
store's pool is missing are counted as moved, and the record carries the
pages_total / pages_sent / pages_hit breakdown. ``send(sync=False)`` builds
the receiver view on the device and parks the hashing until
``last_table``, ``poll_latency`` or ``flush_latency`` needs it.

``send(..., assignment=LayerAssignment)`` is the heterogeneous path: the
wire carries exactly the assignment's P sender layers, keyed by receiver
slot, and the record's ``layers`` and bytes track P. ``RemoteTransport``
(``repro_torch.comm.remote``) frames the same payload through a byte
channel.

SSM states (the state-sharing analogue for attention-free layers) ride
beside the KV on every transport: the selected layers of each state leaf
are encoded at ``state_wire_dtype`` (the wire dtype, or a plan's finest
tier) and counted, and the receiver gets the dense stack with the
unselected layers zeroed (``roundtrip_states``). The in-memory hand-over
passes them through at their analytic bytes. Sequence-axis paging does not
apply to a fixed-size state, so a paged send ships the states beside its
pages.
"""
from __future__ import annotations

import abc
import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.channel import TransferRecord
from repro_torch.core.layermap import LayerAssignment
from repro_torch.core.protocol import (build_mapped, build_packed,
                                       build_shared, gather_mapped,
                                       gather_selected, pack_mapped,
                                       pack_shared, scatter_mapped,
                                       selected_layer_ids)
from repro_torch.core.types import KVCommConfig, SharedKV
from repro_torch.utils import trace

_WIRE_DTYPES = {"float32": torch.float32, "float16": torch.float16,
                "bfloat16": torch.bfloat16, "int8": torch.int8}
# int4 has no torch dtype: it travels nibble-packed in uint8 (two values per
# byte along the trailing head-dim axis) with a per-layer float32 scale
_WIRE_BITS = {"float32": 32, "bfloat16": 16, "float16": 16, "int8": 8,
              "int4": 4}
# wires whose payload carries a per-layer float32 scale array
_SCALED_WIRES = ("int8", "int4")
_QMAX = {"int8": 127.0, "int4": 7.0}
# finest -> coarsest; a plan ships side-band state leaves at its finest tier
_TIER_ORDER = ("float32", "bfloat16", "float16", "int8", "int4")
_PLAN_PREFIX = "plan:"


@dataclass(frozen=True)
class WirePlan:
    """A per-layer wire precision plan: ``dtypes[m]`` is the wire dtype of
    the m-th selected (packed-order) layer slot. Wherever a uniform wire
    dtype string travels (``TransferRecord``, ``BlockTable``) a plan
    travels as its spec string ``"plan:float16,int8,int4"``."""

    dtypes: tuple

    def __post_init__(self):
        object.__setattr__(self, "dtypes", tuple(self.dtypes))
        for d in self.dtypes:
            if d not in _WIRE_BITS:
                raise ValueError(f"unknown wire dtype {d!r} in plan; "
                                 f"expected one of {sorted(_WIRE_BITS)}")

    def __len__(self) -> int:
        return len(self.dtypes)

    @property
    def spec(self) -> str:
        return _PLAN_PREFIX + ",".join(self.dtypes)

    @classmethod
    def parse(cls, spec: str) -> "WirePlan":
        if not spec.startswith(_PLAN_PREFIX):
            raise ValueError(f"not a wire-plan spec: {spec!r}")
        body = spec[len(_PLAN_PREFIX):]
        return cls(tuple(d for d in body.split(",") if d))

    @classmethod
    def from_scores(cls, scores, select=None, *, top_frac: float = 0.25,
                    low_frac: float = 0.5, top_dtype: str = "float16",
                    mid_dtype: str = "int8",
                    low_dtype: str = "int4") -> "WirePlan":
        """Allocate precision by calibration score: the top ``top_frac`` of
        the selected slots at ``top_dtype``, the bottom ``low_frac`` at
        ``low_dtype``, the rest at ``mid_dtype``. ``scores`` spans the
        sender's full depth; ``select`` is the frozen selection mask (None:
        every layer is a slot). The low count is floored at twice the top
        count, so with the default 16/8/4-bit tiers a plan never ships more
        than a uniform int8 wire at any slot count (rounding the fractions
        independently overshoots at n = 6)."""
        scores = np.asarray(scores, dtype=np.float64).reshape(-1)
        if select is not None:
            slots = np.nonzero(np.asarray(select).reshape(-1))[0]
            scores = scores[slots]
        n = int(scores.shape[0])
        if n == 0:
            return cls(())
        order = np.argsort(-scores, kind="stable")
        n_top = int(round(top_frac * n))
        # every 16-bit top slot is paid for by two 4-bit low slots
        # (16 + 2 * 4 = 3 * 8), or the int8 byte bound breaks
        n_low = min(max(int(round(low_frac * n)), 2 * n_top), n - n_top)
        dtypes = [mid_dtype] * n
        for i in order[:n_top]:
            dtypes[int(i)] = top_dtype
        if n_low:
            for i in order[n - n_low:]:
                dtypes[int(i)] = low_dtype
        return cls(tuple(dtypes))

    def groups(self) -> List[Tuple[str, List[int]]]:
        """Slots grouped by dtype, in order of first occurrence: the layout
        of a plan-encoded wire tuple."""
        out: Dict[str, List[int]] = {}
        for m, d in enumerate(self.dtypes):
            out.setdefault(d, []).append(m)
        return list(out.items())

    @property
    def state_dtype(self) -> str:
        """Wire dtype for side-band state leaves: the finest tier present
        in the plan."""
        if not self.dtypes:
            return "float16"
        return min(set(self.dtypes), key=_TIER_ORDER.index)

    def n_scaled(self) -> int:
        """How many slots carry a per-layer scale (int8/int4)."""
        return sum(1 for d in self.dtypes if d in _SCALED_WIRES)

    def payload_bits(self) -> int:
        """Sum of per-value bit widths across slots (scales excluded)."""
        return sum(_WIRE_BITS[d] for d in self.dtypes)


def resolve_wire_dtype(wire_dtype):
    """A plain wire dtype name passes through, a ``"plan:..."`` spec parses
    to a ``WirePlan``, a ``WirePlan`` passes as it is; anything else
    raises ``ValueError``."""
    if isinstance(wire_dtype, WirePlan):
        return wire_dtype
    if isinstance(wire_dtype, str):
        if wire_dtype.startswith(_PLAN_PREFIX):
            return WirePlan.parse(wire_dtype)
        if wire_dtype in _WIRE_BITS:
            return wire_dtype
    raise ValueError(f"unsupported wire_dtype: {wire_dtype!r}; expected "
                     f"one of {sorted(_WIRE_BITS)} or a 'plan:...' spec")


def wire_spec(wire_dtype) -> str:
    """The JSON-safe string form of a wire dtype or plan."""
    wd = resolve_wire_dtype(wire_dtype)
    return wd.spec if isinstance(wd, WirePlan) else wd


def as_wire_plan(wire_dtype) -> Optional[WirePlan]:
    """The ``WirePlan`` behind a wire dtype argument, or None for a uniform
    dtype."""
    wd = resolve_wire_dtype(wire_dtype)
    return wd if isinstance(wd, WirePlan) else None


def wire_has_scales(wire_dtype) -> bool:
    """Whether this wire ships per-layer float32 scale side-bands."""
    wd = resolve_wire_dtype(wire_dtype)
    if isinstance(wd, WirePlan):
        return len(wd) > 0
    return wd in _SCALED_WIRES


def state_wire_dtype(wire_dtype) -> str:
    """The uniform dtype state leaves travel at on this wire: the wire
    dtype itself, or a plan's finest tier (a per-slot plan does not index
    the full-depth state stacks)."""
    wd = resolve_wire_dtype(wire_dtype)
    return wd.state_dtype if isinstance(wd, WirePlan) else wd


def wire_array_count(wire_dtype) -> int:
    """How many arrays ``encode_wire`` emits for one stacked payload part."""
    wd = resolve_wire_dtype(wire_dtype)
    if isinstance(wd, WirePlan):
        if not len(wd):
            return 1    # empty-selection sentinel: one empty array
        return sum(2 if d in _SCALED_WIRES else 1 for d, _ in wd.groups())
    return 2 if wd in _SCALED_WIRES else 1


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _take(x: torch.Tensor, slots) -> torch.Tensor:
    """x[slots] along the leading axis by stacking views (indexing with a
    host list would copy the index to the card and wait for the stream)."""
    slots = list(slots)
    if slots == list(range(x.shape[0])):
        return x
    return torch.stack([x[i] for i in slots]) if slots else x[:0]


def _pack_int4(q: torch.Tensor) -> torch.Tensor:
    """Nibble-pack int8 values in [-8, 7] pairwise along the LAST axis into
    uint8 of half the trailing extent; the sequence axis is untouched, so
    page slicing works on packed wires unchanged."""
    if q.shape[-1] % 2:
        raise ValueError("int4 wire requires an even trailing (head_dim) "
                         f"axis; got shape {tuple(q.shape)}")
    lo = (q[..., 0::2] & 0x0F).to(torch.uint8)
    hi = (q[..., 1::2] & 0x0F).to(torch.uint8)
    return lo | (hi << 4)


def _unpack_int4(p: torch.Tensor) -> torch.Tensor:
    """Inverse of ``_pack_int4``: int8 values, twice the trailing extent."""
    lo = (p & 0x0F).to(torch.int8)
    hi = ((p >> 4) & 0x0F).to(torch.int8)
    pairs = torch.stack([lo, hi], dim=-1)
    pairs = torch.where(pairs > 7, pairs - 16, pairs)     # sign-extend
    return pairs.reshape(tuple(p.shape[:-1]) + (p.shape[-1] * 2,))


def _quantize(x: torch.Tensor, wire: str):
    """Symmetric per-layer quantization in the payload's own dtype, as the
    reference's ``encode_wire`` does: absmax over all but the leading axis,
    floored at 1e-8, over 127 (int8) or 7 (int4), then round-half-even of
    x / scale, clipped. A layer whose scale is 0 (all zeros at float16,
    where 1e-8 rounds to 0) gives 0 / 0 = NaN, which the reference's cast
    to int8 turns into 0; so does this. Returns (int8 codes, float32
    scales of shape (M, 1, ...)).

    qmax divides as a tensor filled on x's device: PyTorch's CUDA division
    by a Python scalar multiplies by its reciprocal, which moves the
    scale's last bit away from the CPU's (and the reference's) true
    division."""
    qmax = _QMAX[wire]
    absmax = x.abs().amax(dim=tuple(range(1, x.dim())), keepdim=True)
    scale = absmax.clamp_min(1e-8) / torch.full_like(absmax, qmax)
    q = torch.nan_to_num(torch.round(x / scale), nan=0.0)
    return q.clamp(-qmax, qmax).to(torch.int8), scale.float()


def _encode_uniform(x: torch.Tensor, wire: str) -> Tuple[torch.Tensor, ...]:
    """One uniform wire dtype's arrays, on x's device."""
    if wire in _SCALED_WIRES:
        q, scale = _quantize(x, wire)
        return (q if wire == "int8" else _pack_int4(q), scale)
    return (x.to(_WIRE_DTYPES[wire]),)


def _wire_groups(wd, n: int) -> List[Tuple[str, List[int]]]:
    """(dtype, slots) groups of a resolved wire dtype over n slots."""
    if isinstance(wd, WirePlan):
        if len(wd) != n:
            raise ValueError(f"wire plan covers {len(wd)} slots but payload "
                             f"has {n} layers")
        return wd.groups()
    return [(wd, list(range(n)))]


def _encode_arrays(x: torch.Tensor, wd) -> Tuple[torch.Tensor, ...]:
    """The wire tuple of one stacked array on its own device. A plan
    encodes each dtype group with the uniform codec and concatenates the
    group tuples in ``plan.groups()`` order; an empty plan ships one
    zero-element float16 array."""
    groups = _wire_groups(wd, x.shape[0])
    if not groups:
        return (torch.zeros(x.shape, dtype=torch.float16, device=x.device),)
    return tuple(a for dt, slots in groups
                 for a in _encode_uniform(_take(x, slots), dt))


def encode_wire(x: torch.Tensor, wire_dtype):
    """Cast one stacked array (leading layer axis) to its wire form on the
    host. Returns ``((cpu tensors...), n_bytes)``: one array for a float
    wire, (codes, per-layer float32 scales) for int8 and int4 (int4
    nibble-packed along the trailing axis), the group tuples one after
    another for a plan; scales are counted. From the card each array's
    copy blocks the host until the stream has drained."""
    arrays = _encode_arrays(x, resolve_wire_dtype(wire_dtype))
    with trace.span("wire.host_copy"):
        host = tuple(a.cpu() for a in arrays)
    if x.device.type == "cuda":
        trace.host_sync(len(arrays))
    return host, sum(_nbytes(a) for a in host)


def _to_device(arrays, device) -> Tuple[torch.Tensor, ...]:
    """The wire arrays on ``device``; from host memory to the card each
    copy blocks the host until the stream has drained."""
    syncs = sum(a.device.type == "cpu" for a in arrays) \
        if torch.device(device).type == "cuda" else 0
    if not syncs:
        return tuple(a.to(device) for a in arrays)
    with trace.span("wire.host_copy"):
        out = tuple(a.to(device) for a in arrays)
    trace.host_sync(syncs)
    return out


def _decode_uniform(arrays, wire: str, dtype, device) -> torch.Tensor:
    if wire in _SCALED_WIRES:
        q, s = _to_device(arrays, device)
        if wire == "int4":
            q = _unpack_int4(q)
        return (q.float() * s).to(dtype)
    return _to_device(arrays[:1], device)[0].to(dtype)


def decode_wire(wire, wire_dtype, dtype: torch.dtype,
                device) -> torch.Tensor:
    """Inverse of ``encode_wire`` at the compute dtype on ``device``
    (int8 and int4 dequantize through float32)."""
    wd = resolve_wire_dtype(wire_dtype)
    if not isinstance(wd, WirePlan):
        return _decode_uniform(wire, wd, dtype, device)
    if not len(wd):
        return _to_device(wire[:1], device)[0].to(dtype)
    it = iter(wire)
    out = None
    for dt, slots in wd.groups():
        arrays = (next(it), next(it)) if dt in _SCALED_WIRES else (next(it),)
        part = _decode_uniform(arrays, dt, dtype, device)
        if out is None:
            out = part.new_zeros((len(wd),) + tuple(part.shape[1:]))
        for j, m in enumerate(slots):
            out[m] = part[j]
    return out


def _host_tensor(a) -> torch.Tensor:
    return a.cpu() if isinstance(a, torch.Tensor) else torch.from_numpy(
        np.ascontiguousarray(a))


def np_encode_wire(x, wire_dtype):
    """The host codec for one uniform wire dtype: ``encode_wire`` run on
    the CPU over a host array (numpy or tensor). Returns ((CPU tensors),
    n_bytes). The reference's numpy host codec computes at float32 and so
    equals its ``encode_wire`` only on float32 payloads, the only ones its
    stream sender encodes with it; this one equals ``encode_wire`` at every
    dtype."""
    wd = resolve_wire_dtype(wire_dtype)
    if isinstance(wd, WirePlan):
        raise ValueError("np_encode_wire takes a uniform wire dtype; plan "
                         "wires encode slot by slot")
    wire = _encode_uniform(_host_tensor(x), wd)
    return wire, sum(_nbytes(a) for a in wire)


def np_decode_wire(wire, wire_dtype, dtype) -> torch.Tensor:
    """The host decoder for one uniform wire dtype: ``decode_wire`` on the
    CPU (int8 and int4 through a float32 product, then one cast), bit-equal
    to the decode on the card. ``dtype`` is a torch dtype or its name."""
    wd = resolve_wire_dtype(wire_dtype)
    if isinstance(wd, WirePlan):
        raise ValueError("np_decode_wire takes a uniform wire dtype; plan "
                         "wires decode slot by slot")
    if isinstance(dtype, str):
        dtype = getattr(torch, dtype)
    return _decode_uniform(tuple(_host_tensor(a) for a in wire), wd, dtype,
                           "cpu")


def device_wire_roundtrip(x: torch.Tensor, wire_dtype, dtype) -> torch.Tensor:
    """``decode_wire(encode_wire(x))`` without leaving x's device: the same
    arithmetic with no host copy (nibble packing cannot change a value, so
    it is skipped). The deferred paged send builds its receiver view with
    this while the hashing waits."""
    wd = resolve_wire_dtype(wire_dtype)
    if isinstance(wd, WirePlan):
        if not len(wd):
            return x.to(torch.float16).to(dtype)
        out = torch.zeros(x.shape, dtype=dtype, device=x.device)
        for dt, slots in _wire_groups(wd, x.shape[0]):
            part = device_wire_roundtrip(_take(x, slots), dt, dtype)
            for j, m in enumerate(slots):
                out[m] = part[j]
        return out
    if wd in _SCALED_WIRES:
        q, scale = _quantize(x, wd)
        return (q.float() * scale).to(dtype)
    return x.to(_WIRE_DTYPES[wd]).to(dtype)


def roundtrip_kv(payload, wire_dtype, dtype, device):
    """Encode and decode a gathered {"k","v"} payload; returns (receiver
    payload, counted bytes)."""
    out, n = {}, 0
    for part in ("k", "v"):
        wire, nb = encode_wire(payload[part], wire_dtype)
        n += nb
        out[part] = decode_wire(wire, wire_dtype, dtype, device)
    return out, n


def roundtrip_states(states, state_select, wire_dtype):
    """Encode the selected SSM layers of every state leaf at
    ``state_wire_dtype`` and decode them back; returns (the receiver's
    dense states, unselected layers zeroed; the counted bytes)."""
    if states is None or state_select is None:
        return states, 0
    wd = state_wire_dtype(wire_dtype)
    sel = selected_layer_ids(state_select)
    out, counted = {}, 0
    for key, x in states.items():
        wire, n = encode_wire(_take(x, sel), wd)
        counted += n
        part = decode_wire(wire, wd, x.dtype, x.device)
        dense = torch.zeros_like(x)
        for j, m in enumerate(sel):
            dense[m] = part[j]
        out[key] = dense
    return out, counted


@dataclass
class HostWire:
    """The wire arrays of one packed {"k","v"} payload on the host, per
    dtype group (``groups``: (dtype, slots)). On the card the encode runs on
    the device and the arrays are copied into pinned buffers without
    blocking; ``event`` marks the end of those copies."""
    wire_dtype: object                  # resolved: a name or a WirePlan
    groups: List[Tuple[str, List[int]]]
    arrays: Dict[str, List[Tuple[torch.Tensor, ...]]]   # part -> per group
    shape: Tuple[int, ...]              # (M, B, Sc, Hkv, Dh)
    compute_dtype: torch.dtype
    event: Optional[object] = None

    def ready(self) -> bool:
        """Whether the copies to the host have landed (never blocks)."""
        return self.event is None or self.event.query()

    def wait(self) -> None:
        if self.event is not None:
            with trace.span("wire.host_copy"):
                self.event.synchronize()
            trace.host_sync()


def encode_payload(payload, wire_dtype) -> HostWire:
    """Encode a packed {"k","v"} (M, B, Sc, Hkv, Dh) payload on its device
    and start the copies of its wire arrays to the host. Nothing here waits
    for the card: read the arrays after ``wait()`` (or once ``ready()``)."""
    wd = resolve_wire_dtype(wire_dtype)
    shape = tuple(int(d) for d in payload["k"].shape)
    groups = _wire_groups(wd, shape[0])
    cuda = payload["k"].device.type == "cuda"

    def to_host(a):
        if not cuda:
            return a.clone()
        h = torch.empty(a.shape, dtype=a.dtype, pin_memory=True)
        h.copy_(a, non_blocking=True)
        return h

    arrays = {part: [tuple(to_host(a) for a in
                           _encode_uniform(_take(payload[part], slots), dt))
                     for dt, slots in groups] for part in ("k", "v")}
    event = None
    if cuda:
        event = torch.cuda.Event()
        event.record()
    return HostWire(wire_dtype=wd, groups=groups, arrays=arrays, shape=shape,
                    compute_dtype=payload["k"].dtype, event=event)


def selected_count(select) -> int:
    return 0 if select is None else int(select.sum())


def payload_bytes(kv, select, states=None, state_select=None,
                  itemsize: Optional[int] = None) -> int:
    """Analytic bytes of the selected subset of a KV stack at its dtype
    (``itemsize`` overrides it), plus the selected share of the SSM
    states."""
    n = 0
    if kv is not None:
        _, B, Sc, Hkv, Dh = kv["k"].shape
        isz = itemsize if itemsize is not None else kv["k"].element_size()
        n += 2 * selected_count(select) * B * Sc * Hkv * Dh * isz
    if states is not None and state_select is not None:
        leaves = list(states.values())
        total = sum(_nbytes(x) for x in leaves)
        n += int(total * selected_count(state_select)
                 / max(leaves[0].shape[0], 1))
    return n


def _device_of(kv, states) -> torch.device:
    """The device a transfer's tensors live on."""
    if kv is not None:
        return kv["k"].device
    if states:
        return next(iter(states.values())).device
    return torch.device("cpu")


def assignment_bytes(kv, assignment: LayerAssignment,
                     itemsize: Optional[int] = None) -> int:
    """Analytic bytes of a mapped (heterogeneous) KV transfer: exactly the
    P assigned pairs cross, even when the sender selected more."""
    if kv is None or assignment.num_pairs == 0:
        return 0
    _, B, Sc, Hkv, Dh = kv["k"].shape
    isz = itemsize if itemsize is not None else kv["k"].element_size()
    return 2 * assignment.num_pairs * B * Sc * Hkv * Dh * isz


def _mapped_or_selected(kv, select, assignment):
    """(payload, receiver layers, sender provenance, receiver mask, layer
    count) of a send: the assignment's pairs, or the selected layers."""
    if assignment is not None:
        return (gather_mapped(kv, assignment), tuple(assignment.dst),
                tuple(assignment.src),
                torch.from_numpy(assignment.dst_mask()),
                assignment.num_pairs)
    layers = selected_layer_ids(select)
    return gather_selected(kv, select), layers, None, select, len(layers)


class Transport(abc.ABC):
    """A byte-accounted link M_s -> M_r.

    ``sync=True`` stamps each record with the device-synced wall clock of
    the transfer; ``sync=False`` records a pair of CUDA events around it
    instead and leaves the stamp to ``poll_latency`` / ``flush_latency``,
    so the serving loop never waits on the card to account a transfer: the
    stamp is then the transfer's time on the stream (on the CPU, the host's
    clock up to the settling call)."""

    def __init__(self, packed: bool = True, sync: bool = True,
                 store=None) -> None:
        self.log: List[TransferRecord] = []
        self.packed = packed
        self.sync = sync
        self._pending: List[tuple] = []     # (record, t0, event or None)
        # paged prefix store (repro_torch.store.PageStore): when attached,
        # every KV send goes through the content-addressed paged path
        self.store = store
        # the last paged send's BlockTable, pinned in the store until the
        # next paged send (or release_table); the scheduler gathers
        # admission prefixes from it through the settling property below
        self._last_table = None
        # deferred paged ingests of sync=False sends: (thunk, HostWire);
        # the thunk hashes the host wire and inserts the pages
        self._pending_ingest: List[tuple] = []

    @property
    def last_table(self):
        """The last paged send's (pinned) BlockTable. Reading it settles
        the deferred ingests first: the first use of the table is where an
        async send must land in the pool."""
        self._settle_ingests()
        return self._last_table

    def _settle_ingests(self) -> int:
        """Run every deferred ingest, in send order (pool dedup and table
        swaps depend on it). Returns the number settled."""
        n = len(self._pending_ingest)
        while self._pending_ingest:
            thunk, _ = self._pending_ingest.pop(0)
            thunk()
        return n

    def attach_store(self, store) -> None:
        """Attach (or replace) the paged prefix store."""
        self.release_table()
        self.store = store

    def release_table(self) -> None:
        """Unpin the last paged send's block table."""
        self._settle_ingests()
        if self._last_table is not None and self.store is not None:
            self.store.release(self._last_table)
        self._last_table = None

    def _swap_table(self, table) -> None:
        prev, self._last_table = self._last_table, table
        if prev is not None:
            self.store.release(prev)

    @property
    def total_bytes(self) -> int:
        return sum(r.n_bytes for r in self.log)

    @property
    def last(self) -> TransferRecord:
        return self.log[-1]

    def flush_latency(self) -> int:
        """Run the deferred ingests and settle every deferred stamp (blocks
        on the recorded events)."""
        self._settle_ingests()
        n = len(self._pending)
        for rec, t0, ev in self._pending:
            rec.latency_s = (ev.ms() * 1e-3 if ev is not None
                             else time.perf_counter() - t0)
        self._pending.clear()
        return n

    def poll_latency(self) -> int:
        """Never blocks: run the deferred ingests whose host copies have
        landed (the longest ready prefix: pool order), and stamp the
        deferred records whose transfers have drained."""
        while self._pending_ingest and self._pending_ingest[0][1].ready():
            thunk, _ = self._pending_ingest.pop(0)
            thunk()
        still, n = [], 0
        for rec, t0, ev in self._pending:
            if ev is None or ev.done():
                rec.latency_s = (ev.ms() * 1e-3 if ev is not None
                                 else time.perf_counter() - t0)
                n += 1
            else:
                still.append((rec, t0, ev))
        self._pending = still
        return n

    def send(self, cfg: ModelConfig, kvcfg: KVCommConfig, kv, select,
             states=None, state_select=None,
             assignment: Optional[LayerAssignment] = None,
             sync: Optional[bool] = None) -> SharedKV:
        """Move the selected KV (and the selected SSM states) across;
        return the receiver-side view and record a TransferRecord.

        ``assignment`` switches on the heterogeneous path: the wire carries
        the assignment's sender layers (``src``, possibly fewer than the
        sender selected) and the view is keyed by its receiver slots
        (``dst``); the record's ``layers`` is the mapped pair count."""
        do_sync = self.sync if sync is None else sync
        if do_sync:
            self.flush_latency()
        dev = _device_of(kv, states)
        cuda = dev.type == "cuda"
        t0 = time.perf_counter()
        # a deferred stamp on the card is the stream time between these
        # two events, which the span reports too
        ev = trace.Events() if cuda and not do_sync else None
        with trace.span("transport.send", stream=ev or cuda):
            shared = self._dispatch(cfg, kvcfg, kv, select, states,
                                    state_select, assignment, do_sync)
            if ev is not None:
                ev.stop()
        if do_sync:
            if cuda:
                torch.cuda.synchronize(dev)
            self.log[-1].latency_s = time.perf_counter() - t0
        else:
            self._pending.append((self.log[-1], t0, ev))
        return shared

    def _dispatch(self, cfg, kvcfg, kv, select, states, state_select,
                  assignment, do_sync) -> SharedKV:
        if self.store is not None and kv is not None:
            # a transport whose own paged exchange reads host bytes
            # (RemoteTransport's), and a send with states, keep the eager
            # ingest under sync=False
            if do_sync or states is not None \
                    or type(self)._send_paged is not Transport._send_paged:
                return self._send_paged(kvcfg, kv, select, states,
                                        state_select, assignment)
            return self._send_paged_deferred(kvcfg, kv, select, assignment)
        if assignment is not None:
            return self._send_mapped(cfg, kvcfg, kv, assignment, states,
                                     state_select)
        return self._send(cfg, kvcfg, kv, select, states, state_select)

    @abc.abstractmethod
    def _send(self, cfg: ModelConfig, kvcfg: KVCommConfig, kv, select,
              states=None, state_select=None) -> SharedKV:
        """Transport-specific transfer; must append a TransferRecord."""

    def _send_mapped(self, cfg: ModelConfig, kvcfg: KVCommConfig, kv,
                     assignment: LayerAssignment, states=None,
                     state_select=None) -> SharedKV:
        """Heterogeneous transfer under a ``LayerAssignment``; must append a
        TransferRecord whose ``layers`` is the mapped pair count. A
        subclass that only implements ``_send`` cannot serve it."""
        raise NotImplementedError(
            f"{type(self).__name__} does not support mapped "
            "(heterogeneous) transfers; override _send_mapped")

    # -- the paged (content-addressed) path --------------------------------
    def _paged_wire_dtype(self, kv):
        """The wire dtype (or plan) the store pages at: the transport's
        own, or for the in-memory hand-over the model's dtype (lossless),
        float32 where that dtype has no wire form."""
        wd = getattr(self, "wire_dtype", None)
        if wd is not None:
            return wd
        name = str(kv["k"].dtype).replace("torch.", "")
        return name if name in _WIRE_DTYPES else "float32"

    def _paged_states(self, states, state_select):
        """States ride beside the paged KV: a wire-dtype transport
        round-trips them through the codec, the in-memory hand-over passes
        them through at their analytic bytes. Returns (states, bytes)."""
        wd = getattr(self, "wire_dtype", None)
        if wd is None:
            return states, payload_bytes(None, None, states, state_select)
        return roundtrip_states(states, state_select, wd)

    def _record_paged(self, rec: TransferRecord, table, novel,
                      novel_bytes: int) -> None:
        rec.n_bytes = novel_bytes + table.scale_nbytes
        rec.pages_total = table.num_pages
        rec.pages_sent = len(novel)
        rec.pages_hit = table.num_pages - len(novel)

    def _send_paged(self, kvcfg: KVCommConfig, kv, select, states=None,
                    state_select=None,
                    assignment: Optional[LayerAssignment] = None
                    ) -> SharedKV:
        """Gather the selected (or assignment-mapped) payload, ingest it
        into the attached store (dedup against the pool happens there) and
        materialize the receiver view back out of the pool, so the receiver
        consumes what the pages hold. Counted bytes are the novel pages
        plus the scales and the states."""
        self._settle_ingests()      # older deferred ingests land first
        payload, layers, src_layers, sel_mask, count = _mapped_or_selected(
            kv, select, assignment)
        table, novel, novel_bytes = self.store.ingest(
            payload, layers=layers, select=sel_mask,
            wire_dtype=self._paged_wire_dtype(kv), pos_mode=kvcfg.pos_mode,
            src_layers=src_layers)
        # ingest pinned the table: release it if anything fails before the
        # swap, so an aborted send leaks no refcounts into the pool
        try:
            rx_states, state_bytes = self._paged_states(states,
                                                        state_select)
            shared = self.store.materialize(table, device=kv["k"].device,
                                            states=rx_states,
                                            state_select=state_select)
            if not self.packed:
                shared = shared.to_dense()
            self._swap_table(table)
        except BaseException:
            self.store.release(table)
            raise
        rec = TransferRecord(kind="kv", n_bytes=0, layers=count,
                             context_len=table.prefix_len,
                             wire_dtype=self._wire_spec())
        self._record_paged(rec, table, novel, novel_bytes)
        rec.n_bytes += state_bytes
        self.log.append(rec)
        return shared

    def _send_paged_deferred(self, kvcfg: KVCommConfig, kv, select,
                             assignment: Optional[LayerAssignment] = None
                             ) -> SharedKV:
        """``sync=False`` paged send that never waits for the card: the
        receiver view is a device codec roundtrip (bit-identical to what
        ``PageStore.materialize`` rebuilds), the wire is encoded on the
        device and copied to pinned host memory behind an event, and the
        hashing and pool insert are parked as a thunk. The record is logged
        now with zeroed page counts; the thunk fills them in."""
        self._settle_ingests()
        payload, layers, src_layers, sel_mask, count = _mapped_or_selected(
            kv, select, assignment)
        wd = self._paged_wire_dtype(kv)
        prefix_len = int(kv["k"].shape[2])
        rx = {part: device_wire_roundtrip(payload[part], wd, kv["k"].dtype)
              for part in ("k", "v")}
        if assignment is not None:
            shared = build_mapped(kvcfg, rx, assignment, prefix_len)
        else:
            shared = build_packed(kvcfg, rx, layers, prefix_len,
                                  select=select)
        if not self.packed:
            shared = shared.to_dense()
        rec = TransferRecord(kind="kv", n_bytes=0, layers=count,
                             context_len=prefix_len,
                             wire_dtype=self._wire_spec())
        self.log.append(rec)
        wire = encode_payload(payload, wd)

        def ingest():
            table, novel, novel_bytes = self.store.ingest(
                wire, layers=layers, select=sel_mask, wire_dtype=wd,
                pos_mode=kvcfg.pos_mode, src_layers=src_layers)
            try:
                self._swap_table(table)
            except BaseException:
                self.store.release(table)
                raise
            self._record_paged(rec, table, novel, novel_bytes)

        self._pending_ingest.append((ingest, wire))
        return shared

    def send_text(self, token_count: int, bytes_per_token: int = 2) -> int:
        """Account a natural-language transfer (NLD ids, or CIPHER's soft
        tokens at ``bytes_per_token`` each); returns its bytes."""
        n = token_count * bytes_per_token
        self.log.append(TransferRecord("text", n, 0, token_count))
        return n

    def send_hidden(self, batch: int, d_model: int, itemsize: int = 2) -> int:
        """Account an activation transfer: one d_model vector per sample
        (Ramesh & Li 2025); returns its bytes."""
        n = batch * d_model * itemsize
        self.log.append(TransferRecord("hidden", n, 1, 1))
        return n

    def _wire_spec(self) -> str:
        """The record's string form of this transport's wire dtype ("model"
        for the dtype-less in-memory hand-over)."""
        wd = getattr(self, "wire_dtype", None)
        return "model" if wd is None else wire_spec(wd)

    def _record_kv(self, n_bytes: int, select, prefix_len: int,
                   wire_dtype: str) -> None:
        self.log.append(TransferRecord(
            kind="kv", n_bytes=n_bytes, layers=selected_count(select),
            context_len=prefix_len, wire_dtype=wire_dtype))


class InMemoryTransport(Transport):
    """In-process hand-over of the sender's device tensors (packed mode
    gathers the M selected layers). Bytes are the analytic payload size at
    the KV's own dtype."""

    def _send(self, cfg, kvcfg, kv, select, states=None,
              state_select=None) -> SharedKV:
        build = pack_shared if self.packed else build_shared
        shared = build(kvcfg, kv, select, states, state_select)
        self._record_kv(payload_bytes(kv, select, states, state_select),
                        select, shared.prefix_len, wire_dtype="model")
        return shared

    def _send_mapped(self, cfg, kvcfg, kv, assignment, states=None,
                     state_select=None) -> SharedKV:
        if kv is None or self.packed:
            shared = pack_mapped(kvcfg, kv, assignment, states, state_select)
        else:
            shared = scatter_mapped(kvcfg, gather_mapped(kv, assignment),
                                    assignment, int(kv["k"].shape[2]),
                                    states, state_select)
        self.log.append(TransferRecord(
            kind="kv", n_bytes=assignment_bytes(kv, assignment)
            + payload_bytes(None, None, states, state_select),
            layers=assignment.num_pairs, context_len=shared.prefix_len,
            wire_dtype="model"))
        return shared


class SerializedTransport(Transport):
    """Materializes the wire payload on the host and counts its bytes.

    The selected layers are gathered, encoded at ``wire_dtype`` ("float16"
    default, "bfloat16", "float32", "int8", "int4", a ``WirePlan`` or its
    "plan:..." spec), measured and decoded back at the compute dtype on the
    KV's device. Dense mode scatters the decoded payload into a zero-padded
    (L, ...) stack."""

    def __init__(self, wire_dtype="float16", packed: bool = True,
                 sync: bool = True, store=None) -> None:
        super().__init__(packed=packed, sync=sync, store=store)
        self.wire_dtype = resolve_wire_dtype(wire_dtype)

    def _roundtrip(self, kv, payload, states, state_select):
        """(decoded KV payload or None, decoded states, counted bytes) of a
        gathered payload (None without KV)."""
        rx, n_bytes = None, 0
        if kv is not None:
            rx, n_bytes = roundtrip_kv(payload, self.wire_dtype,
                                       kv["k"].dtype, kv["k"].device)
        rx_states, state_bytes = roundtrip_states(states, state_select,
                                                  self.wire_dtype)
        return rx, rx_states, n_bytes + state_bytes

    def _send(self, cfg, kvcfg, kv, select, states=None,
              state_select=None) -> SharedKV:
        layers = selected_layer_ids(select)
        rx, rx_states, n_bytes = self._roundtrip(
            kv, None if kv is None else gather_selected(kv, select), states,
            state_select)
        if kv is None:
            shared = build_shared(kvcfg, None, select, rx_states,
                                  state_select)
        elif self.packed:
            shared = build_packed(kvcfg, rx, layers, int(kv["k"].shape[2]),
                                  select=select, states=rx_states,
                                  state_select=state_select)
        else:
            dense = {}
            for part in ("k", "v"):
                dense[part] = torch.zeros_like(kv[part])
                for m, l in enumerate(layers):
                    dense[part][l] = rx[part][m]
            shared = build_shared(kvcfg, dense, select, rx_states,
                                  state_select)
        self._record_kv(n_bytes, select, shared.prefix_len,
                        wire_dtype=self._wire_spec())
        return shared

    def _send_mapped(self, cfg, kvcfg, kv, assignment, states=None,
                     state_select=None) -> SharedKV:
        rx, rx_states, n_bytes = self._roundtrip(
            kv, None if kv is None else gather_mapped(kv, assignment),
            states, state_select)
        if kv is None:
            shared = pack_mapped(kvcfg, None, assignment, rx_states,
                                 state_select)
        else:
            build = build_mapped if self.packed else scatter_mapped
            shared = build(kvcfg, rx, assignment, int(kv["k"].shape[2]),
                           rx_states, state_select)
        prefix_len = shared.prefix_len
        self.log.append(TransferRecord(
            kind="kv", n_bytes=n_bytes, layers=assignment.num_pairs,
            context_len=prefix_len, wire_dtype=self._wire_spec()))
        return shared
