"""RemoteTransport: KV shipping across processes over a framed wire codec.

The gathered payload (the same gather and codec ``SerializedTransport``
uses, ``repro_torch.comm.transport.encode_wire`` / ``decode_wire``) is
packed into a length-prefixed, versioned, checksummed frame and shipped
through a byte channel:

  LoopbackChannel — an in-process byte buffer: the frame is really encoded,
                    framed and decoded without a second process (the
                    serving scheduler's remote runs use it).
  SocketChannel   — a connected TCP stream.
  FileChannel     — shared-filesystem staging: every write lands one
                    numbered chunk file (atomic rename), the reader tails
                    them in order.

Frame layout (integers big-endian)::

  offset  size  field
  0       4     magic  b"KVCM"
  4       2     protocol version (1)
  6       4     header length H
  10      8     payload length P
  18      4     CRC-32 over header + payload
  22      H     header: UTF-8 JSON {kind, meta, arrays:[{name,dtype,shape}]}
  22+H    P     payload: the arrays' raw bytes, concatenated in header order

The frames are the reference's byte for byte: the same JSON (key order,
``null``s, default separators), the same array names, dtype names and
shapes, the same chunk plan of the streamed ``kv_stream_*`` frames, so the
CRCs agree and a JAX peer and this one read each other's frames. Arrays
are torch tensors on the host; a bfloat16 array crosses as its raw bytes
(no ``ml_dtypes``). Decoding raises a typed ``RemoteProtocolError``
subclass for every malformed input, never a partial result.

The receiver-side view is the packed receiver-keyed ``SharedKV`` (with a
``LayerAssignment``'s slots and ``src_layers``), decoded onto the
receiver's device. ``RemoteTransport`` retries a failed exchange under a
``RetryPolicy`` and short-circuits under a ``CircuitBreaker``
(``repro_torch.comm.resilience``). Not ported yet: SSM state leaves on the
wire (ROADMAP queue 1, item 4).
"""
from __future__ import annotations

import abc
import json
import os
import socket
import struct
import time
import zlib
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.comm.transport import (_SCALED_WIRES, _WIRE_BITS,
                                        Transport, _encode_uniform,
                                        _mapped_or_selected, _wire_groups,
                                        as_wire_plan, decode_wire,
                                        encode_wire, np_decode_wire,
                                        resolve_wire_dtype, wire_array_count,
                                        wire_has_scales, wire_spec)
from repro_torch.core.channel import TransferRecord
from repro_torch.core.layermap import LayerAssignment
from repro_torch.core.protocol import (gather_mapped, gather_selected,
                                       selected_layer_ids)
from repro_torch.core.types import KVCommConfig, SharedKV

PROTOCOL_VERSION = 1
MAGIC = b"KVCM"
_PREFIX = struct.Struct(">4sHIQI")        # magic, version, hdr len, body len, crc
MAX_HEADER_BYTES = 1 << 26                # 64 MiB of JSON is never legitimate
MAX_BODY_BYTES = 1 << 32                  # reject a corrupt length up front
_STATES_NOT_PORTED = ("SSM state leaves on the wire are not ported yet "
                      "(ROADMAP queue 1, item 4)")


# ---------------------------------------------------------------------------
# typed protocol errors
# ---------------------------------------------------------------------------
class RemoteProtocolError(RuntimeError):
    """Base for every failure of the remote framing/decoding protocol."""


class ChannelClosedError(RemoteProtocolError):
    """The channel ended cleanly at a frame boundary (peer hung up)."""


class ChannelTimeoutError(ChannelClosedError):
    """The channel produced nothing within its deadline (a stalled peer may
    still be alive); a ``ChannelClosedError`` so clean-close handling
    covers it."""


class FrameTruncatedError(RemoteProtocolError):
    """The channel ended mid-frame: a disconnect or a cut-short stream."""


class HeaderCorruptError(RemoteProtocolError):
    """Bad magic, implausible lengths, or an unparsable header document."""


class VersionSkewError(RemoteProtocolError):
    """The peer speaks a different protocol version."""


class FrameCorruptError(RemoteProtocolError):
    """Checksum mismatch: the frame's bytes were altered in flight."""


class PayloadMismatchError(RemoteProtocolError):
    """The header's dtype/shape claims disagree with the payload (or with
    each other): the frame cannot describe a coherent transfer."""


# ---------------------------------------------------------------------------
# channels
# ---------------------------------------------------------------------------
class RemoteChannel(abc.ABC):
    """A byte-stream channel. ``read`` returns up to ``n`` bytes and b""
    once the stream is exhausted (the framing turns b"" at a frame boundary
    into ``ChannelClosedError`` and mid-frame into
    ``FrameTruncatedError``)."""

    @abc.abstractmethod
    def write(self, data: bytes) -> None: ...

    @abc.abstractmethod
    def read(self, n: int) -> bytes: ...

    def close(self) -> None:
        pass

    # whole-frame deadline hooks: the framing calls ``begin_frame`` once a
    # frame's first bytes arrived and ``end_frame`` when it is read (or
    # failed); a channel with a wall-clock budget arms a deadline here
    def begin_frame(self) -> None:
        pass

    def end_frame(self) -> None:
        pass


class LoopbackChannel(RemoteChannel):
    """In-process byte buffer: writes append, reads consume from the front.
    A frame still crosses the whole encode -> bytes -> decode path."""

    def __init__(self) -> None:
        self._buf = bytearray()
        self._closed = False

    def write(self, data: bytes) -> None:
        if self._closed:
            raise ChannelClosedError("write on a closed LoopbackChannel")
        self._buf.extend(data)

    def read(self, n: int) -> bytes:
        chunk = bytes(self._buf[:n])
        del self._buf[:len(chunk)]
        return chunk

    def close(self) -> None:
        self._closed = True

    def __len__(self) -> int:
        return len(self._buf)


class SocketChannel(RemoteChannel):
    """A connected TCP stream: wrap a connected socket, or dial with
    ``connect`` (which retries until the listener is up)."""

    def __init__(self, sock: socket.socket,
                 frame_timeout_s: Optional[float] = None) -> None:
        self.sock = sock
        self.io_timeout_s = sock.gettimeout()
        # whole-frame budget from a frame's first byte (default: the io
        # timeout; None on a blocking socket keeps reads unbounded), so a
        # peer trickling a byte per io window cannot hold a read open
        self.frame_timeout_s = (frame_timeout_s if frame_timeout_s
                                is not None else self.io_timeout_s)
        self._deadline: Optional[float] = None

    @classmethod
    def connect(cls, host: str, port: int, timeout_s: float = 30.0,
                retry_s: float = 0.1,
                io_timeout_s: Optional[float] = None) -> "SocketChannel":
        """Dial with a real deadline: each attempt's timeout is capped at
        the remaining budget. ``io_timeout_s`` arms a per-read/write
        timeout on the connected socket."""
        deadline = time.monotonic() + timeout_s
        while True:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                raise ChannelTimeoutError(
                    f"could not connect to {host}:{port} "
                    f"within {timeout_s}s")
            try:
                sock = socket.create_connection(
                    (host, port), timeout=max(remaining, 1e-3))
                sock.settimeout(io_timeout_s)
                return cls(sock)
            except OSError as e:
                if time.monotonic() >= deadline:
                    raise ChannelClosedError(
                        f"could not connect to {host}:{port}: {e}") from e
                time.sleep(min(retry_s,
                               max(deadline - time.monotonic(), 0.0)))

    def write(self, data: bytes) -> None:
        try:
            self.sock.sendall(data)
        except socket.timeout as e:
            raise ChannelTimeoutError(f"socket send timed out: {e}") from e
        except OSError as e:
            raise ChannelClosedError(f"socket send failed: {e}") from e

    def begin_frame(self) -> None:
        if self.frame_timeout_s is not None:
            self._deadline = time.monotonic() + self.frame_timeout_s

    def end_frame(self) -> None:
        self._deadline = None
        try:
            self.sock.settimeout(self.io_timeout_s)
        except OSError:
            pass

    def read(self, n: int) -> bytes:
        if self._deadline is not None:
            remaining = self._deadline - time.monotonic()
            if remaining <= 0:
                raise ChannelTimeoutError(
                    f"frame not complete within the {self.frame_timeout_s}s"
                    " whole-frame deadline (peer trickling or stalled)")
            # this recv waits at most the frame's remaining budget
            try:
                self.sock.settimeout(
                    remaining if self.io_timeout_s is None
                    else min(self.io_timeout_s, remaining))
            except OSError as e:
                raise ChannelClosedError(
                    f"socket settimeout failed: {e}") from e
        try:
            return self.sock.recv(min(n, 1 << 20))
        except socket.timeout as e:
            raise ChannelTimeoutError(f"socket recv timed out: {e}") from e
        except OSError as e:
            raise ChannelClosedError(f"socket recv failed: {e}") from e

    def close(self) -> None:
        try:
            self.sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        self.sock.close()


class FileChannel(RemoteChannel):
    """Shared-filesystem staging: every ``write`` lands one numbered chunk
    file (written under a temporary name, then renamed), and ``read`` tails
    the chunks in order, polling up to ``timeout_s`` for the next one (with
    backoff from ``poll_s`` to ``max_poll_s``); consumed chunks are
    unlinked.

    Chunk names carry a per-connection nonce: the writer mints one on its
    first write, clears the chunks a dead pair left under this channel
    name and publishes the nonce in a ``<name>.nonce`` marker; the reader
    adopts the marker's nonce until its first chunk lands, so a restarted
    writer's sequence numbers never replay a dead pair's chunks. A
    writer's ``close`` publishes an ``.eof`` marker with its final
    sequence number, telling a clean close (b"") from a stall
    (``ChannelTimeoutError``)."""

    def __init__(self, directory: str, name: str = "kv",
                 poll_s: float = 0.01, timeout_s: float = 10.0,
                 consume: bool = True, max_poll_s: float = 0.25) -> None:
        self.directory = directory
        self.name = name
        self.poll_s = poll_s
        self.max_poll_s = max(max_poll_s, poll_s)
        self.timeout_s = timeout_s
        self.consume = consume
        os.makedirs(directory, exist_ok=True)
        self._wseq = 0
        self._rseq = 0
        self._rbuf = b""
        self._roff = 0
        self._nonce: Optional[str] = None
        self._published = False        # this side minted the nonce

    def _marker(self) -> str:
        return os.path.join(self.directory, f"{self.name}.nonce")

    def _eof_marker(self) -> str:
        return os.path.join(self.directory,
                            f"{self.name}.{self._nonce}.eof")

    def _writer_closed(self) -> bool:
        """The writer published its EOF marker and every chunk it wrote was
        consumed."""
        if self._nonce is None:
            return False
        try:
            with open(self._eof_marker(), "r") as f:
                final_seq = int(f.read().strip() or 0)
        except (OSError, ValueError):
            return False
        return self._rseq >= final_seq

    def _path(self, seq: int) -> str:
        return os.path.join(
            self.directory, f"{self.name}.{self._nonce}.{seq:08d}.chunk")

    def _publish_nonce(self) -> None:
        self._nonce = os.urandom(6).hex()
        self._published = True
        for fn in os.listdir(self.directory):
            if fn.startswith(self.name + ".") \
                    and fn.endswith((".chunk", ".eof")):
                try:
                    os.unlink(os.path.join(self.directory, fn))
                except OSError:
                    pass
        tmp = self._marker() + "." + self._nonce
        with open(tmp, "w") as f:
            f.write(self._nonce)
        os.replace(tmp, self._marker())

    def _adopt_nonce(self) -> None:
        """Reader side, before the first chunk: take the marker's nonce.
        After that the stream identity is locked (a writer restart then
        surfaces as a timeout, never a silent splice)."""
        try:
            with open(self._marker(), "r") as f:
                nonce = f.read().strip()
        except OSError:
            return
        if nonce:
            self._nonce = nonce

    def write(self, data: bytes) -> None:
        if not self._published:
            self._publish_nonce()
        tmp = self._path(self._wseq) + ".tmp"
        with open(tmp, "wb") as f:
            f.write(data)
        os.replace(tmp, self._path(self._wseq))
        self._wseq += 1

    def read(self, n: int) -> bytes:
        if self._roff >= len(self._rbuf):
            deadline = time.monotonic() + self.timeout_s
            pause = self.poll_s
            while True:
                if not self._published and self._rseq == 0:
                    self._adopt_nonce()
                path = (self._path(self._rseq) if self._nonce is not None
                        else None)
                if path is not None and os.path.exists(path):
                    break
                if self._writer_closed():
                    return b""
                if time.monotonic() >= deadline:
                    raise ChannelTimeoutError(
                        f"no chunk {self._rseq} under {self.name!r} "
                        f"within {self.timeout_s}s (writer stalled or "
                        "gone without closing)")
                time.sleep(min(pause, max(
                    deadline - time.monotonic(), 0.0)))
                pause = min(pause * 2.0, self.max_poll_s)
            with open(path, "rb") as f:
                self._rbuf = f.read()
            self._roff = 0
            self._rseq += 1
            if self.consume:
                try:
                    os.unlink(path)
                except OSError:
                    pass
        chunk = self._rbuf[self._roff:self._roff + n]
        self._roff += len(chunk)
        return chunk

    def close(self) -> None:
        """Writer side: publish the EOF marker (a reader's close is a
        no-op)."""
        if not self._published:
            return
        tmp = self._eof_marker() + ".tmp"
        try:
            with open(tmp, "w") as f:
                f.write(str(self._wseq))
            os.replace(tmp, self._eof_marker())
        except OSError:
            pass


# ---------------------------------------------------------------------------
# the framed codec
# ---------------------------------------------------------------------------
# array dtypes a frame may name (numpy's names, which the reference writes)
_FRAME_DTYPES = {name: getattr(torch, name) for name in (
    "float64", "float32", "float16", "bfloat16", "int64", "int32", "int16",
    "int8", "uint8", "bool")}


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).replace("torch.", "")


def _frame_dtype(name: str) -> torch.dtype:
    try:
        return _FRAME_DTYPES[name]
    except (KeyError, TypeError):
        raise PayloadMismatchError(
            f"unknown array dtype {name!r} in frame header") from None


def _host_array(arr) -> Tuple[str, list, bytes]:
    """(dtype name, shape, raw bytes) of a numpy array or a tensor."""
    if isinstance(arr, torch.Tensor):
        t = arr.detach().cpu().contiguous()
        raw = t.reshape(-1).view(torch.uint8).numpy().tobytes() \
            if t.numel() else b""
        return _dtype_name(t.dtype), list(t.shape), raw
    a = np.ascontiguousarray(arr)
    return a.dtype.name, list(a.shape), a.tobytes()


def encode_frame(kind: str, meta: Dict[str, Any], arrays: Dict[str, Any]
                 ) -> bytes:
    """Pack one message (a JSON-able ``meta`` plus named arrays, numpy or
    torch) into the length-prefixed, CRC-protected frame."""
    specs, chunks = [], []
    for name, arr in arrays.items():
        dname, shape, raw = _host_array(arr)
        specs.append({"name": name, "dtype": dname, "shape": shape})
        chunks.append(raw)
    body = b"".join(chunks)
    header = json.dumps({"kind": kind, "meta": meta,
                         "arrays": specs}).encode("utf-8")
    crc = zlib.crc32(body, zlib.crc32(header))
    return _PREFIX.pack(MAGIC, PROTOCOL_VERSION, len(header), len(body),
                        crc) + header + body


def _read_exactly(channel: RemoteChannel, n: int, what: str,
                  got: bytes = b"") -> bytes:
    buf = bytearray(got)
    while len(buf) < n:
        chunk = channel.read(n - len(buf))
        if not chunk:
            raise FrameTruncatedError(
                f"channel ended after {len(buf)}/{n} bytes of {what}")
        buf.extend(chunk)
    return bytes(buf)


def read_frame(channel: RemoteChannel
               ) -> Tuple[str, Dict[str, Any], Dict[str, torch.Tensor]]:
    """Read and validate ONE frame off the channel: ``(kind, meta,
    arrays)``, the arrays host tensors. Raises ``ChannelClosedError`` if
    the stream ends cleanly before the first byte, and a specific
    ``RemoteProtocolError`` for every way a frame can be wrong."""
    first = channel.read(_PREFIX.size)
    if not first:
        raise ChannelClosedError("channel closed at frame boundary")
    # the frame has started: arm the channel's whole-frame deadline;
    # waiting between frames stays unbounded
    channel.begin_frame()
    try:
        prefix = _read_exactly(channel, _PREFIX.size, "frame prefix",
                               got=first)
        magic, version, hlen, blen, crc = _PREFIX.unpack(prefix)
        if magic != MAGIC:
            raise HeaderCorruptError(f"bad frame magic {magic!r}")
        if version != PROTOCOL_VERSION:
            raise VersionSkewError(
                f"peer speaks protocol v{version}, this side "
                f"v{PROTOCOL_VERSION}")
        if hlen > MAX_HEADER_BYTES or blen > MAX_BODY_BYTES:
            raise HeaderCorruptError(
                f"implausible frame lengths (header {hlen}, payload {blen})")
        header = _read_exactly(channel, hlen, "header")
        body = _read_exactly(channel, blen, "payload")
    finally:
        channel.end_frame()
    if zlib.crc32(body, zlib.crc32(header)) != crc:
        raise FrameCorruptError("frame checksum mismatch")
    try:
        doc = json.loads(header.decode("utf-8"))
        kind, meta, specs = doc["kind"], doc["meta"], doc["arrays"]
        if not (isinstance(kind, str) and isinstance(specs, list)):
            raise TypeError("kind must be a string, arrays a list")
    except (UnicodeDecodeError, ValueError, KeyError, TypeError) as e:
        raise HeaderCorruptError(f"unparsable frame header: {e}") from None
    arrays: Dict[str, torch.Tensor] = {}
    off = 0
    try:
        for spec in specs:
            dt = _frame_dtype(spec["dtype"])
            shape = tuple(int(d) for d in spec["shape"])
            if any(d < 0 for d in shape):
                raise PayloadMismatchError(f"negative dim in shape {shape}")
            count = int(np.prod(shape, dtype=np.int64)) if shape else 1
            nbytes = count * dt.itemsize
            if off + nbytes > len(body):
                raise PayloadMismatchError(
                    f"array {spec['name']!r} claims {nbytes} bytes at "
                    f"offset {off} but the payload holds {len(body)}")
            raw = np.frombuffer(body, np.uint8, nbytes, off).copy()
            arrays[spec["name"]] = torch.from_numpy(raw).view(dt) \
                .reshape(shape)
            off += nbytes
    except (KeyError, TypeError, ValueError, OverflowError,
            RuntimeError) as e:
        raise PayloadMismatchError(
            f"malformed array spec in frame header: {e}") from None
    if off != len(body):
        raise PayloadMismatchError(
            f"payload holds {len(body)} bytes but the header accounts "
            f"for {off}")
    return kind, meta, arrays


def decode_frame(buf: bytes
                 ) -> Tuple[str, Dict[str, Any], Dict[str, torch.Tensor]]:
    """Decode one frame from a byte string; trailing bytes are an error."""
    ch = LoopbackChannel()
    ch.write(buf)
    out = read_frame(ch)
    if len(ch):
        raise PayloadMismatchError(
            f"{len(ch)} trailing bytes after the frame")
    return out


# ---------------------------------------------------------------------------
# the health payload (liveness and routing signals)
# ---------------------------------------------------------------------------
# Version 1 carried {"answered", "prefix_installed", "pool"}; version 2 adds
# the pool's resident page IDs, the queue depth and slot occupancy. It
# rides an ordinary "health_ack" frame, so the frame protocol version does
# not move; ``parse_health_meta`` fills what an older peer omitted.
HEALTH_META_VERSION = 2

HEALTH_DEFAULTS: Dict[str, Any] = {
    "health_version": 1,           # a payload without the field IS v1
    "answered": 0,
    "prefix_installed": False,
    "pool": None,                  # dict of StoreStats fields, or None
    "page_ids": [],                # resident page ids (affinity signal)
    "queue_depth": 0,
    "slots": {"capacity": 0, "occupied": 0},
}


def build_health_meta(*, answered: int, prefix_installed: bool,
                      pool: Optional[Dict[str, Any]] = None,
                      page_ids: Optional[list] = None,
                      queue_depth: int = 0,
                      slots_capacity: int = 0,
                      slots_occupied: int = 0) -> Dict[str, Any]:
    """The v2 health_ack meta a server answers a ``health`` frame with."""
    return {
        "health_version": HEALTH_META_VERSION,
        "answered": int(answered),
        "prefix_installed": bool(prefix_installed),
        "pool": pool,
        "page_ids": list(page_ids) if page_ids is not None else [],
        "queue_depth": int(queue_depth),
        "slots": {"capacity": int(slots_capacity),
                  "occupied": int(slots_occupied)},
    }


def parse_health_meta(meta: Dict[str, Any]) -> Dict[str, Any]:
    """A health_ack meta of any version in the v2 shape: keys a peer did
    not send take ``HEALTH_DEFAULTS``, malformed nested values degrade to
    them rather than raise."""
    if not isinstance(meta, dict):
        raise PayloadMismatchError(
            f"health_ack meta must be a dict, got {type(meta).__name__}")
    out = dict(HEALTH_DEFAULTS)
    out["slots"] = dict(HEALTH_DEFAULTS["slots"])
    for key in ("health_version", "answered", "queue_depth"):
        try:
            out[key] = int(meta.get(key, out[key]))
        except (TypeError, ValueError):
            pass
    out["prefix_installed"] = bool(meta.get("prefix_installed", False))
    pool = meta.get("pool")
    out["pool"] = pool if isinstance(pool, dict) else None
    page_ids = meta.get("page_ids")
    if isinstance(page_ids, (list, tuple)):
        out["page_ids"] = [str(p) for p in page_ids]
    slots = meta.get("slots")
    if isinstance(slots, dict):
        for key in ("capacity", "occupied"):
            try:
                out["slots"][key] = int(slots.get(key, 0))
            except (TypeError, ValueError):
                pass
    return out


# ---------------------------------------------------------------------------
# SharedKV transfers: the sender and receiver halves
# ---------------------------------------------------------------------------
def _put_wire(arrays: Dict[str, Any], name: str, x, wire_dtype) -> int:
    """Encode ``x`` into the frame's arrays: ``name`` / ``name@scale`` for
    a uniform wire, ``name@p0``, ``name@p1``, ... (the group-ordered tuple)
    for a ``WirePlan``."""
    wire, n = encode_wire(x, wire_dtype)
    if as_wire_plan(wire_dtype) is not None:
        for i, arr in enumerate(wire):
            arrays[f"{name}@p{i}"] = arr
        return n
    arrays[name] = wire[0]
    if len(wire) > 1:
        arrays[name + "@scale"] = wire[1]
    return n


def _take_wire(arrays: Dict[str, torch.Tensor], name: str, wire_dtype,
               dtype: torch.dtype, device) -> torch.Tensor:
    try:
        plan = as_wire_plan(wire_dtype)
        if plan is not None:
            wire = tuple(arrays[f"{name}@p{i}"]
                         for i in range(wire_array_count(plan)))
        elif wire_has_scales(wire_dtype):
            wire = (arrays[name], arrays[name + "@scale"])
        else:
            wire = (arrays[name],)
    except KeyError as e:
        raise PayloadMismatchError(f"frame lacks array {e.args[0]!r}") \
            from None
    try:
        return decode_wire(wire, wire_dtype, dtype, device)
    except (RuntimeError, ValueError, IndexError) as e:
        raise PayloadMismatchError(
            f"wire arrays of {name!r} do not decode: {e}") from None


def _transfer_layout(select, assignment: Optional[LayerAssignment]):
    """(layer count, receiver mask, receiver layers, sender provenance) of
    a transfer, as the frame header carries them."""
    if assignment is not None:
        return (assignment.num_pairs,
                [bool(b) for b in assignment.dst_mask()],
                list(assignment.dst), list(assignment.src))
    if select is None:
        return 0, None, None, None
    layers = list(selected_layer_ids(select))
    return len(layers), [bool(b) for b in select.tolist()], layers, None


def _gather(kv, select, assignment):
    if assignment is not None:
        return gather_mapped(kv, assignment)
    if select is None:
        raise ValueError("a remote KV transfer needs a selection mask or a "
                         "LayerAssignment")
    return gather_selected(kv, select)


def _kv_meta(kvcfg: KVCommConfig, prefix_len: int, packed: bool, layers,
             src_layers, sel_mask, dtype: torch.dtype) -> Dict[str, Any]:
    return {"prefix_len": prefix_len, "pos_mode": kvcfg.pos_mode,
            "packed": packed, "layers": layers, "src_layers": src_layers,
            "select": sel_mask, "compute_dtype": _dtype_name(dtype)}


def encode_kv_transfer(kvcfg: KVCommConfig, kv, select=None, states=None,
                       state_select=None,
                       assignment: Optional[LayerAssignment] = None,
                       wire_dtype="float16",
                       packed: bool = True) -> Tuple[bytes, int, int, int]:
    """The sender half: gather the selected (or assignment-mapped) layers,
    encode them and frame the result. Returns ``(frame, payload wire
    bytes, layer count, prefix_len)``; the payload bytes are what
    ``SerializedTransport`` counts for the same transfer."""
    if states is not None:
        raise NotImplementedError(_STATES_NOT_PORTED)
    wire_dtype = resolve_wire_dtype(wire_dtype)
    count, sel_mask, layers, src_layers = _transfer_layout(select,
                                                           assignment)
    arrays: Dict[str, Any] = {}
    n_bytes = prefix_len = 0
    kv_meta = None
    if kv is not None:
        payload = _gather(kv, select, assignment)
        prefix_len = int(kv["k"].shape[2])
        for part in ("k", "v"):
            n_bytes += _put_wire(arrays, part, payload[part], wire_dtype)
        kv_meta = _kv_meta(kvcfg, prefix_len, packed, layers, src_layers,
                           sel_mask, kv["k"].dtype)
    meta = {"wire_dtype": wire_spec(wire_dtype), "kv": kv_meta,
            "states": None, "pos_mode": kvcfg.pos_mode,
            "sel_mask": sel_mask if kv is None else None}
    return encode_frame("shared_kv", meta, arrays), n_bytes, count, \
        prefix_len


def _view_from_wire(kv_meta, payload, pos_mode, sel_mask) -> SharedKV:
    """The receiver-side view of a transfer (a KV-less one keeps only its
    mask)."""
    if kv_meta is None:
        return SharedKV(kv=None, select=None if sel_mask is None
                        else torch.tensor(sel_mask, dtype=torch.bool),
                        prefix_len=0, pos_mode=pos_mode)
    try:
        return SharedKV.from_wire(kv_meta, payload)
    except (KeyError, TypeError, ValueError, RuntimeError) as e:
        raise PayloadMismatchError(f"cannot rebuild SharedKV: {e}") \
            from None


def decode_kv_transfer(meta: Dict[str, Any],
                       arrays: Dict[str, torch.Tensor], device=None
                       ) -> Tuple[SharedKV, int]:
    """The receiver half: validate a decoded ``shared_kv`` frame and rebuild
    the packed receiver-keyed ``SharedKV`` on ``device`` (the card unless
    the caller asks for the CPU), densified when the sender asked for the
    dense form. Returns (view, wire bytes)."""
    dev = resolve_device(device)
    try:
        wire_dtype, kv_meta = meta["wire_dtype"], meta["kv"]
        state_meta = meta["states"]
    except (KeyError, TypeError) as e:
        raise PayloadMismatchError(f"shared_kv frame meta lacks {e}") \
            from None
    if state_meta is not None:
        raise NotImplementedError(_STATES_NOT_PORTED)
    try:
        wire_dtype = resolve_wire_dtype(wire_dtype)
    except ValueError:
        raise PayloadMismatchError(f"unknown wire dtype {wire_dtype!r}") \
            from None
    n_bytes = int(sum(a.numel() * a.element_size() for a in arrays.values()))
    payload = None
    if kv_meta is not None:
        try:
            dtype = _frame_dtype(kv_meta.get("compute_dtype", "float32"))
            prefix_len = int(kv_meta["prefix_len"])
            layers = kv_meta.get("layers")
        except (AttributeError, KeyError, TypeError, ValueError) as e:
            raise PayloadMismatchError(f"kv meta invalid: {e}") from None
        payload = {part: _take_wire(arrays, part, wire_dtype, dtype, dev)
                   for part in ("k", "v")}
        k = payload["k"]
        if k.shape != payload["v"].shape:
            raise PayloadMismatchError(
                f"k/v shapes disagree: {tuple(k.shape)} "
                f"vs {tuple(payload['v'].shape)}")
        if k.dim() != 5:
            raise PayloadMismatchError(
                f"KV payload must be (M, B, Sc, Hkv, Dh); got rank {k.dim()}")
        if layers is not None and len(layers) != k.shape[0]:
            raise PayloadMismatchError(
                f"layer map names {len(layers)} layers but the payload "
                f"stacks {k.shape[0]}")
        if int(k.shape[2]) != prefix_len:
            raise PayloadMismatchError(
                f"header prefix_len {prefix_len} != payload Sc "
                f"{k.shape[2]}")
    return _view_from_wire(kv_meta, payload, meta.get("pos_mode", "shift"),
                           meta.get("sel_mask")), n_bytes


# ---------------------------------------------------------------------------
# streamed transfers: kv_stream_begin / kv_stream_chunk / kv_stream_end
# ---------------------------------------------------------------------------
# The monolithic frame serializes the whole stack before the first byte
# moves. The stream splits the same payload into per-slot, sequence-sliced
# chunks of about DEFAULT_CHUNK_BYTES (the reference's chunk plan, so the
# frames are its frames), each with its slot's per-layer scale, so the
# rebuilt view is bit-identical to the monolithic frame's. The receiver
# installs nothing until the end frame arrives with every slot covered,
# so a replayed stream (fresh sid) is idempotent.
DEFAULT_CHUNK_BYTES = 1 << 20


class KVStreamSender:
    """Sender half of a chunked transfer: ``frames()`` lazily yields
    ``(frame bytes, payload bytes)``, one bounded chunk at a time. The
    payload is encoded once per dtype group on its own device; the chunks
    are slices of those host arrays."""

    def __init__(self, kvcfg: KVCommConfig, kv, select=None, states=None,
                 state_select=None,
                 assignment: Optional[LayerAssignment] = None,
                 wire_dtype="float16", packed: bool = True,
                 chunk_bytes: int = DEFAULT_CHUNK_BYTES,
                 sid: int = 0) -> None:
        if states is not None:
            raise NotImplementedError(_STATES_NOT_PORTED)
        self.wire_dtype = resolve_wire_dtype(wire_dtype)
        self.chunk_bytes = max(int(chunk_bytes), 1)
        self.sid = int(sid)
        self.kvcfg = kvcfg
        self.layer_count, self._sel_mask, layers, src_layers = \
            _transfer_layout(select, assignment)
        self.prefix_len = 0
        self._payload = None
        self._kv_meta = None
        self._kv_shape = None
        self._groups: list = []
        self._chunks: list = []
        if kv is not None:
            self._payload = _gather(kv, select, assignment)
            self.prefix_len = int(kv["k"].shape[2])
            self._kv_shape = [int(d) for d in self._payload["k"].shape]
            m_slots, b, sc, h, d = self._kv_shape
            self._groups = _wire_groups(self.wire_dtype, m_slots)
            slot_dtypes = [""] * m_slots
            for dt, slots in self._groups:
                for m in slots:
                    slot_dtypes[m] = dt
            self._kv_meta = _kv_meta(kvcfg, self.prefix_len, packed, layers,
                                     src_layers, self._sel_mask,
                                     kv["k"].dtype)
            # chunk plan: slot-major, each slot sliced along the sequence
            # so one chunk's k + v wire stays within ~chunk_bytes
            for m, dt in enumerate(slot_dtypes):
                bytes_per_pos = max((2 * b * h * d * _WIRE_BITS[dt]) // 8, 1)
                step = max(self.chunk_bytes // bytes_per_pos, 1)
                for start in range(0, sc, step):
                    self._chunks.append((m, start, min(step, sc - start)))
        self.n_frames = 2 + len(self._chunks)

    def _encode_slots(self) -> Dict[str, Dict[int, tuple]]:
        """The wire arrays per slot, (1, ...) views of one encode per dtype
        group (per-layer scales live on the leading axis, so a group
        encode is bit-equal to slot-by-slot encodes)."""
        slot_wire: Dict[str, Dict[int, tuple]] = {"k": {}, "v": {}}
        for dt, slots in self._groups:
            for part in ("k", "v"):
                stack = self._payload[part]
                sub = stack if len(slots) == stack.shape[0] \
                    else torch.stack([stack[m] for m in slots])
                wire = tuple(a.cpu() for a in _encode_uniform(sub, dt))
                for j, m in enumerate(slots):
                    slot_wire[part][m] = tuple(a[j:j + 1] for a in wire)
        return slot_wire

    def frames(self):
        meta = {"sid": self.sid, "wire_dtype": wire_spec(self.wire_dtype),
                "kv": self._kv_meta, "kv_shape": self._kv_shape,
                "pos_mode": self.kvcfg.pos_mode,
                "sel_mask": self._sel_mask if self._kv_meta is None
                else None,
                "chunks": len(self._chunks)}
        yield encode_frame("kv_stream_begin", meta, {}), 0
        slot_wire = self._encode_slots()
        seq = 0
        for (m, start, length) in self._chunks:
            arrays: Dict[str, Any] = {}
            nb = 0
            for part in ("k", "v"):
                wire = slot_wire[part][m]
                piece = wire[0][:, :, start:start + length]
                arrays[part] = piece
                nb += piece.numel() * piece.element_size()
                if len(wire) > 1:
                    # the scale rides every chunk (each decodes alone) but
                    # counts once per slot, as in the monolithic frame
                    arrays[part + "@scale"] = wire[1]
                    if start == 0:
                        nb += wire[1].numel() * wire[1].element_size()
            meta = {"sid": self.sid, "seq": seq, "slot": m,
                    "start": start, "length": length}
            yield encode_frame("kv_stream_chunk", meta, arrays), nb
            seq += 1
        meta = {"sid": self.sid, "seq": seq, "chunks": len(self._chunks),
                "states": None}
        yield encode_frame("kv_stream_end", meta, {}), 0


class KVStreamAssembler:
    """Receiver half: feed it stream frames in order; returns ``(SharedKV,
    payload bytes)`` on the end frame and None before. Each chunk is
    decoded on the host into one buffer (pinned for the card), uploaded
    once at the end: bit-equal to decoding on the card. A fresh
    ``kv_stream_begin`` replaces a stream in progress; every inconsistency
    raises ``PayloadMismatchError`` and aborts the stream."""

    def __init__(self, device=None) -> None:
        self.device = resolve_device(device)
        self._s: Optional[Dict[str, Any]] = None

    @property
    def active(self) -> bool:
        return self._s is not None

    def abort(self) -> None:
        self._s = None

    def feed(self, kind: str, meta: Dict[str, Any],
             arrays: Dict[str, torch.Tensor]
             ) -> Optional[Tuple[SharedKV, int]]:
        # a broken frame sequence cannot resume (frames arrive in order on
        # a serial channel): any violation drops the stream in progress
        try:
            if kind == "kv_stream_begin":
                return self._begin(meta)
            st = self._s
            if st is None:
                raise PayloadMismatchError(
                    f"{kind!r} frame without an active stream begin")
            if meta.get("sid") != st["sid"]:
                raise PayloadMismatchError(
                    f"stream sid mismatch: frame {meta.get('sid')!r} vs "
                    f"active {st['sid']!r}")
            if kind == "kv_stream_chunk":
                return self._chunk(meta, arrays)
            if kind == "kv_stream_end":
                return self._end(meta, arrays)
            raise PayloadMismatchError(
                f"unexpected frame kind {kind!r} mid-stream")
        except RemoteProtocolError:
            self._s = None
            raise

    def _begin(self, meta: Dict[str, Any]) -> None:
        try:
            sid = int(meta["sid"])
            wire_dtype = resolve_wire_dtype(meta["wire_dtype"])
            kv_meta = meta["kv"]
            chunks = int(meta["chunks"])
        except (KeyError, TypeError, ValueError) as e:
            raise PayloadMismatchError(
                f"kv_stream_begin meta invalid: {e}") from None
        bufs = shape = None
        slot_dtypes: list = []
        if kv_meta is not None:
            shape = meta.get("kv_shape")
            try:
                ok = (isinstance(shape, (list, tuple)) and len(shape) == 5
                      and all(int(d) >= 0 for d in shape))
            except (TypeError, ValueError):
                ok = False
            if not ok:
                raise PayloadMismatchError(
                    f"kv_stream_begin kv_shape invalid: {shape!r}")
            shape = tuple(int(d) for d in shape)
            if shape[2] != kv_meta.get("prefix_len", -1):
                raise PayloadMismatchError(
                    f"kv_shape Sc {shape[2]} != header prefix_len "
                    f"{kv_meta.get('prefix_len')!r}")
            layers = kv_meta.get("layers")
            if layers is not None and len(layers) != shape[0]:
                raise PayloadMismatchError(
                    f"layer map names {len(layers)} layers but the "
                    f"stream ships {shape[0]}")
            plan = as_wire_plan(wire_dtype)
            if plan is not None and len(plan) != shape[0]:
                raise PayloadMismatchError(
                    f"wire plan covers {len(plan)} slots but the stream "
                    f"ships {shape[0]}")
            dtype = _frame_dtype(kv_meta.get("compute_dtype", "float32"))
            pin = self.device.type == "cuda"
            bufs = {part: torch.zeros(shape, dtype=dtype, pin_memory=pin)
                    for part in ("k", "v")}
            slot_dtypes = (list(plan.dtypes) if plan is not None
                           else [wire_dtype] * shape[0])
        elif chunks:
            raise PayloadMismatchError(
                f"stream claims {chunks} chunks but carries no KV")
        self._s = {"sid": sid, "wire_dtype": wire_dtype,
                   "kv_meta": kv_meta, "begin": meta, "chunks": chunks,
                   "seq": 0, "bufs": bufs, "shape": shape,
                   "slot_dtypes": slot_dtypes,
                   "next": [0] * (shape[0] if shape else 0),
                   "n_bytes": 0}
        return None

    def _chunk(self, meta: Dict[str, Any],
               arrays: Dict[str, torch.Tensor]) -> None:
        st = self._s
        try:
            seq = int(meta["seq"])
            slot = int(meta["slot"])
            start = int(meta["start"])
            length = int(meta["length"])
        except (KeyError, TypeError, ValueError) as e:
            raise PayloadMismatchError(
                f"kv_stream_chunk meta invalid: {e}") from None
        if st["bufs"] is None:
            raise PayloadMismatchError("chunk for a KV-less stream")
        if seq != st["seq"]:
            raise PayloadMismatchError(
                f"stream chunk out of order: seq {seq}, "
                f"expected {st['seq']}")
        m_slots, b, sc, h, d = st["shape"]
        if not 0 <= slot < m_slots:
            raise PayloadMismatchError(
                f"chunk slot {slot} outside [0, {m_slots})")
        if start != st["next"][slot]:
            raise PayloadMismatchError(
                f"non-contiguous chunk for slot {slot}: start {start}, "
                f"expected {st['next'][slot]}")
        if length <= 0 or start + length > sc:
            raise PayloadMismatchError(
                f"chunk range [{start}, {start + length}) outside the "
                f"{sc}-position prefix")
        dt = st["slot_dtypes"][slot]
        scaled = dt in _SCALED_WIRES
        for part in ("k", "v"):
            try:
                wire = ((arrays[part], arrays[part + "@scale"]) if scaled
                        else (arrays[part],))
            except KeyError as e:
                raise PayloadMismatchError(
                    f"stream chunk lacks array {e.args[0]!r}") from None
            try:
                dec = np_decode_wire(wire, dt, st["bufs"][part].dtype)
            except (RuntimeError, ValueError, IndexError) as e:
                raise PayloadMismatchError(
                    f"stream chunk does not decode: {e}") from None
            if tuple(dec.shape) != (1, b, length, h, d):
                raise PayloadMismatchError(
                    f"chunk decodes to {tuple(dec.shape)}, expected "
                    f"{(1, b, length, h, d)}")
            st["bufs"][part][slot, :, start:start + length] = dec[0]
            st["n_bytes"] += arrays[part].numel() \
                * arrays[part].element_size()
            if scaled and start == 0:
                s = arrays[part + "@scale"]
                st["n_bytes"] += s.numel() * s.element_size()
        st["seq"] += 1
        st["next"][slot] = start + length
        return None

    def _end(self, meta: Dict[str, Any], arrays: Dict[str, torch.Tensor]
             ) -> Tuple[SharedKV, int]:
        st = self._s
        if meta.get("states") is not None:
            raise NotImplementedError(_STATES_NOT_PORTED)
        if st["seq"] != st["chunks"] \
                or meta.get("chunks", -1) != st["chunks"]:
            raise PayloadMismatchError(
                f"stream ended after {st['seq']}/{st['chunks']} chunks")
        payload = None
        if st["bufs"] is not None:
            _, _, sc, _, _ = st["shape"]
            for m, covered in enumerate(st["next"]):
                if covered != sc:
                    raise PayloadMismatchError(
                        f"stream slot {m} covered {covered}/{sc} "
                        "positions at end")
            payload = {part: buf.to(self.device, non_blocking=True)
                       for part, buf in st["bufs"].items()}
        n_bytes = st["n_bytes"] + int(sum(a.numel() * a.element_size()
                                          for a in arrays.values()))
        begin = st["begin"]
        shared = _view_from_wire(st["kv_meta"], payload,
                                 begin.get("pos_mode", "shift"),
                                 begin.get("sel_mask"))
        self._s = None
        return shared, n_bytes


def send_shared(channel: RemoteChannel, kvcfg: KVCommConfig, kv, select=None,
                *, states=None, state_select=None,
                assignment: Optional[LayerAssignment] = None,
                wire_dtype="float16", packed: bool = True,
                chunk_bytes: Optional[int] = None, sid: int = 0) -> int:
    """Sender-process entry: frame one KV transfer onto the channel, as one
    ``shared_kv`` frame (``chunk_bytes=None``) or as begin/chunk/end frames
    of about ``chunk_bytes``. Returns the payload wire bytes."""
    if chunk_bytes is None:
        frame, n_bytes, _, _ = encode_kv_transfer(
            kvcfg, kv, select, states, state_select, assignment,
            wire_dtype, packed)
        channel.write(frame)
        return n_bytes
    sender = KVStreamSender(kvcfg, kv, select, states, state_select,
                            assignment, wire_dtype, packed,
                            chunk_bytes=chunk_bytes, sid=sid)
    n_bytes = 0
    for frame, nb in sender.frames():
        channel.write(frame)
        n_bytes += nb
    return n_bytes


def recv_shared(channel: RemoteChannel, device=None
                ) -> Tuple[SharedKV, int]:
    """Receiver-process entry: read one KV transfer (a ``shared_kv`` frame
    or a complete ``kv_stream_*`` sequence) and rebuild the receiver-side
    view on ``device`` (the card unless the caller asks for the CPU).
    Returns (SharedKV, payload wire bytes)."""
    kind, meta, arrays = read_frame(channel)
    if kind == "shared_kv":
        return decode_kv_transfer(meta, arrays, device=device)
    if kind == "kv_stream_begin":
        asm = KVStreamAssembler(device=device)
        out = asm.feed(kind, meta, arrays)
        while out is None:
            out = asm.feed(*read_frame(channel))
        return out
    raise PayloadMismatchError(
        f"expected a shared_kv or kv_stream_begin frame, got {kind!r}")


# ---------------------------------------------------------------------------
# the Transport
# ---------------------------------------------------------------------------
class RemoteTransport(Transport):
    """Ships the gathered payload through the framed codec and a byte
    channel and hands back the decoded receiver-side view, on the device
    the sender's KV lives on.

    Over the default ``LoopbackChannel`` the round trip (gather, encode,
    frame, channel, parse, decode) runs in one process, with the frames of
    the two-process split (``send_shared`` / ``recv_shared``). Unpaged
    transfers stream in ~``chunk_bytes`` pieces by default; ``None`` sends
    one monolithic ``shared_kv`` frame. With a ``PageStore`` the transfer
    is the three-frame page_query / page_need / page_data exchange
    (``repro_torch.store.wire``), one object playing both roles.

    The record carries ``serialize_s`` (gather, encode, framing),
    ``channel_s`` (write and read back), ``deserialize_s`` (parse and
    rebuild), ``frame_bytes`` (whole frames) beside the payload-only
    ``n_bytes``, and ``attempts``.

    Fault tolerance (``repro_torch.comm.resilience``): a ``policy``
    (``RetryPolicy``) re-runs a failed exchange over a healed channel:
    ``channel_factory`` reconnects, a channel with ``reset()``
    (``FaultyChannel``) is reset in place. A retried stream starts under a
    fresh sid into a fresh assembler, and a retried paged exchange re-asks
    ``page_query`` under a fresh xid, so it ships only the pages the pool
    never got. A ``breaker`` (``CircuitBreaker``) raises
    ``CircuitOpenError`` without writing a frame while its peer is
    quarantined."""

    def __init__(self, wire_dtype="float16",
                 channel: Optional[RemoteChannel] = None,
                 packed: bool = True, sync: bool = True,
                 store=None, policy=None, channel_factory=None,
                 breaker=None,
                 chunk_bytes: Optional[int] = DEFAULT_CHUNK_BYTES) -> None:
        super().__init__(packed=packed, sync=sync, store=store)
        self.wire_dtype = resolve_wire_dtype(wire_dtype)
        self.chunk_bytes = chunk_bytes
        self.policy = policy                    # resilience.RetryPolicy
        self.channel_factory = channel_factory  # () -> RemoteChannel
        self.breaker = breaker                  # resilience.CircuitBreaker
        if channel is None:
            channel = (channel_factory() if channel_factory is not None
                       else LoopbackChannel())
        self.channel = channel
        self._paged_rx = None          # PagedReceiver over self.store
        self._xid = 0                  # paged exchange counter
        self._sid = 0                  # stream id counter (fresh per try)

    # -- retry plumbing ----------------------------------------------------
    def _reset_channel(self) -> None:
        """Heal the channel between attempts: forget the paged receiver's
        pending exchange, then reconnect through the factory or reset the
        channel in place."""
        if self._paged_rx is not None:
            self._paged_rx.abort()
        if self.channel_factory is not None:
            try:
                self.channel.close()
            except (RemoteProtocolError, OSError):
                pass
            self.channel = self.channel_factory()
        elif hasattr(self.channel, "reset"):
            self.channel.reset()

    def _attempt(self, fn, describe: str):
        """Run one exchange under the breaker and the retry policy; ``fn``
        appends its own record on success, whose ``attempts`` is stamped
        here."""
        from repro_torch.comm.resilience import CircuitOpenError
        if self.breaker is not None and not self.breaker.allow():
            raise CircuitOpenError(
                f"{describe}: peer circuit is open (quarantined after "
                f"{self.breaker.failures} consecutive failures)")
        used = [1]

        def wrapped(attempt: int):
            used[0] = attempt + 1
            if attempt:
                self._reset_channel()
            return fn()

        try:
            out = wrapped(0) if self.policy is None \
                else self.policy.run(wrapped, describe=describe)
        except (RemoteProtocolError, OSError):
            if self.breaker is not None:
                self.breaker.record_failure()
            raise
        if self.breaker is not None:
            self.breaker.record_success()
        self.log[-1].attempts = used[0]
        return out

    def _ship(self, kvcfg: KVCommConfig, kv, select,
              assignment: Optional[LayerAssignment]) -> SharedKV:
        return self._attempt(
            lambda: self._ship_once(kvcfg, kv, select, assignment),
            describe="remote shared_kv exchange")

    def _ship_once(self, kvcfg: KVCommConfig, kv, select,
                   assignment: Optional[LayerAssignment]) -> SharedKV:
        if self.chunk_bytes is not None:
            return self._ship_streamed(kvcfg, kv, select, assignment)
        dev = kv["k"].device
        t0 = time.perf_counter()
        frame, _, layer_count, prefix_len = encode_kv_transfer(
            kvcfg, kv, select, assignment=assignment,
            wire_dtype=self.wire_dtype, packed=self.packed)
        t1 = time.perf_counter()
        self.channel.write(frame)
        kind, meta, arrays = read_frame(self.channel)
        t2 = time.perf_counter()
        if kind != "shared_kv":
            raise PayloadMismatchError(
                f"expected a shared_kv frame, got {kind!r}")
        shared, n_decoded = decode_kv_transfer(meta, arrays, device=dev)
        t3 = time.perf_counter()
        self.log.append(TransferRecord(
            kind="kv", n_bytes=n_decoded, layers=layer_count,
            context_len=prefix_len, wire_dtype=wire_spec(self.wire_dtype),
            serialize_s=t1 - t0, channel_s=t2 - t1, deserialize_s=t3 - t2,
            frame_bytes=len(frame)))
        return shared

    def _ship_streamed(self, kvcfg: KVCommConfig, kv, select,
                       assignment: Optional[LayerAssignment]) -> SharedKV:
        """Each stream frame is encoded (serialize_s), written and read
        back (channel_s) and fed to the assembler (deserialize_s) before
        the next is encoded."""
        sid, self._sid = self._sid, self._sid + 1
        sender = KVStreamSender(kvcfg, kv, select, assignment=assignment,
                                wire_dtype=self.wire_dtype,
                                packed=self.packed,
                                chunk_bytes=self.chunk_bytes, sid=sid)
        asm = KVStreamAssembler(device=kv["k"].device)
        frames = sender.frames()
        ser_s = chan_s = deser_s = 0.0
        frame_bytes = 0
        out = None
        while out is None:
            t0 = time.perf_counter()
            try:
                frame, _ = next(frames)
            except StopIteration:
                raise PayloadMismatchError(
                    "KV stream exhausted before the end frame resolved") \
                    from None
            t1 = time.perf_counter()
            frame_bytes += len(frame)
            self.channel.write(frame)
            kind, meta, arrays = read_frame(self.channel)
            t2 = time.perf_counter()
            out = asm.feed(kind, meta, arrays)
            t3 = time.perf_counter()
            ser_s += t1 - t0
            chan_s += t2 - t1
            deser_s += t3 - t2
        shared, n_bytes = out
        self.log.append(TransferRecord(
            kind="kv", n_bytes=n_bytes, layers=sender.layer_count,
            context_len=sender.prefix_len,
            wire_dtype=wire_spec(self.wire_dtype),
            serialize_s=ser_s, channel_s=chan_s, deserialize_s=deser_s,
            frame_bytes=frame_bytes))
        return shared

    def _send(self, cfg, kvcfg, kv, select) -> SharedKV:
        return self._ship(kvcfg, kv, select, None)

    def _send_mapped(self, cfg, kvcfg, kv, assignment) -> SharedKV:
        return self._ship(kvcfg, kv, None, assignment)

    # -- the paged (content-addressed) wire --------------------------------
    def _send_paged(self, kvcfg: KVCommConfig, kv, select,
                    assignment: Optional[LayerAssignment] = None
                    ) -> SharedKV:
        """The dedup-aware three-frame exchange: ``page_query`` carries the
        block table (and the scales), ``page_need`` answers with the pool's
        missing IDs, ``page_data`` ships only those pages. The ingest is
        eager: the exchange reads the pages' host bytes. A retry re-asks
        ``page_query`` under a fresh xid: pages pooled before the failure
        answer as hits."""
        return self._attempt(
            lambda: self._send_paged_once(kvcfg, kv, select, assignment),
            describe="paged page_query/need/data exchange")

    def _send_paged_once(self, kvcfg: KVCommConfig, kv, select,
                         assignment: Optional[LayerAssignment] = None
                         ) -> SharedKV:
        # deferred: the store package imports this module's codec
        from repro_torch.store.paging import split_payload
        from repro_torch.store.wire import (PagedReceiver, decode_page_need,
                                            encode_page_data,
                                            encode_page_query)
        dev = kv["k"].device
        if self._paged_rx is None or self._paged_rx.store is not self.store:
            self._paged_rx = PagedReceiver(self.store, device=dev)
        payload, layers, src_layers, sel_mask, count = _mapped_or_selected(
            kv, select, assignment)
        xid, self._xid = self._xid, self._xid + 1
        t0 = time.perf_counter()
        table, pages = split_payload(
            payload, layers=layers, select=sel_mask,
            page_len=self.store.page_len, wire_dtype=self.wire_dtype,
            pos_mode=kvcfg.pos_mode, src_layers=src_layers)
        by_id = {p.page_id: p for p in pages}
        qframe = encode_page_query(xid, table)
        t1 = time.perf_counter()
        self.channel.write(qframe)
        kind, meta, arrays = read_frame(self.channel)
        t2 = time.perf_counter()
        if kind != "page_query":
            raise PayloadMismatchError(
                f"expected a page_query frame, got {kind!r}")
        need_frame = self._paged_rx.handle_query(meta, arrays)
        self.channel.write(need_frame)
        kind, meta, _ = read_frame(self.channel)
        if kind != "page_need":
            raise PayloadMismatchError(
                f"expected a page_need frame, got {kind!r}")
        _, need = decode_page_need(meta)
        t3 = time.perf_counter()
        dframe, _ = encode_page_data(xid, [by_id[pid] for pid in need],
                                     wire_dtype=self.wire_dtype)
        t4 = time.perf_counter()
        self.channel.write(dframe)
        kind, meta, arrays = read_frame(self.channel)
        t5 = time.perf_counter()
        if kind != "page_data":
            raise PayloadMismatchError(
                f"expected a page_data frame, got {kind!r}")
        shared, table_rx, novel_bytes, state_bytes = \
            self._paged_rx.handle_data(meta, arrays)
        # handle_data left table_rx pinned: release it if anything fails
        # before the swap
        try:
            if not self.packed:
                shared = shared.to_dense()
            self._swap_table(table_rx)
        except BaseException:
            self.store.release(table_rx)
            raise
        t6 = time.perf_counter()
        self.log.append(TransferRecord(
            kind="kv",
            n_bytes=novel_bytes + table_rx.scale_nbytes + state_bytes,
            layers=count, context_len=table.prefix_len,
            wire_dtype=wire_spec(self.wire_dtype),
            serialize_s=(t1 - t0) + (t4 - t3),
            channel_s=(t2 - t1) + (t5 - t4),
            deserialize_s=(t3 - t2) + (t6 - t5),
            frame_bytes=len(qframe) + len(need_frame) + len(dframe),
            pages_total=table.num_pages, pages_sent=len(need),
            pages_hit=table.num_pages - len(need)))
        return shared
