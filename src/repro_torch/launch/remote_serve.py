"""Two-process KV serving (port): a sender-side client ships selected KV to
a receiver-side server over the framed remote codec
(``repro_torch.comm.remote``), byte for byte the reference's frames, so a
port peer and a reference peer talk to each other.

  server — owns the receiver model. ``shared_kv`` frames and
           ``kv_stream_*`` sequences install the sender's prefix,
           ``page_query`` / ``page_data`` install it through the
           server's ``PageStore``, ``query`` frames are answered with a
           ``tokens`` frame (``Agent.generate``, the masked-dense path),
           ``health`` with a v2 ``health_ack``, ``shutdown`` ends the
           connection.
  client — owns the sender model: exports KV for a context batch, ships
           the selected layers (``send_shared`` or the paged exchange),
           then asks queries.

CLI (weights are random from ``--seed``; ``--config tiny`` is the 8-layer
float32 pair, ``full`` llama3.2-3b-pair at its published widths)::

  # the receiver process (prints "PORT <p>" once listening)
  PYTHONPATH=src python -m repro_torch.launch.remote_serve server --port 0
  # the sender process
  PYTHONPATH=src python -m repro_torch.launch.remote_serve client --port <p>

Both run on the card unless ``--device cpu`` is given.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import socket
import sys
import threading
from typing import Callable, Dict, List, Optional, Set, Tuple

import numpy as np
import torch

from repro_torch.comm.agent import Agent
from repro_torch.comm.remote import (ChannelClosedError, KVStreamAssembler,
                                     RemoteChannel, RemoteProtocolError,
                                     SocketChannel, build_health_meta,
                                     decode_kv_transfer, encode_frame,
                                     read_frame, send_shared)
from repro_torch.core.types import KVCommConfig, SharedKV

# the resident page IDs a health_ack ships at most (the affinity signal)
HEALTH_PAGE_IDS_LIMIT = 4096


# ---------------------------------------------------------------------------
# server half (receiver side)
# ---------------------------------------------------------------------------
def serve_channel(agent: Agent, channel: RemoteChannel, store=None, *,
                  lock=None,
                  health_extra: Optional[Callable[[], Dict]] = None) -> int:
    """The receiver's protocol loop over any channel. A clean peer close
    ends it; a mid-frame disconnect or a corrupt frame raises the typed
    ``RemoteProtocolError`` (nothing is answered from a half-decoded
    prefix). Returns the number of query frames answered.

    Everything decodes onto ``agent.device`` (never a thread's current
    device). A streamed install replaces the prefix only when its end
    frame lands complete, so a client dying mid-stream, or retrying under
    a fresh sid, leaves the installed prefix as it was. With a ``store``
    the installed prefix's block table stays pinned until the next paged
    install, and is released however the loop ends.

    ``lock`` (a context manager) serializes frame handling, not frame
    reads, so a stalled client blocks only its own connection;
    ``health_extra`` supplies the server-level routing signals (queue
    depth, slot occupancy) of the health_ack."""
    dev = agent.device
    paged_rx = pinned = None
    if store is not None:
        from repro_torch.store.wire import PagedReceiver
        paged_rx = PagedReceiver(store, device=dev)
    guard = lock if lock is not None else contextlib.nullcontext()
    assembler = KVStreamAssembler(device=dev)
    shared: Optional[SharedKV] = None
    answered = 0
    try:
        while True:
            try:
                kind, meta, arrays = read_frame(channel)
            except ChannelClosedError:
                break              # the peer hung up between frames
            if kind == "shutdown":
                break
            with guard:
                if kind == "shared_kv":
                    shared, _ = decode_kv_transfer(meta, arrays, device=dev)
                elif kind in ("kv_stream_begin", "kv_stream_chunk",
                              "kv_stream_end"):
                    done = assembler.feed(kind, meta, arrays)
                    if done is not None:
                        shared, _ = done
                elif kind == "page_query" and paged_rx is not None:
                    channel.write(paged_rx.handle_query(meta, arrays))
                elif kind == "page_data" and paged_rx is not None:
                    shared, table, _, _ = paged_rx.handle_data(meta, arrays)
                    if pinned is not None:
                        store.release(pinned)
                    pinned = table
                elif kind == "health":
                    # answered with or without a prefix, so a client (or a
                    # breaker) tells a live idle server from a dead one
                    pool = page_ids = None
                    if store is not None:
                        pool = dataclasses.asdict(store.stats())
                        page_ids = store.resident_ids(
                            limit=HEALTH_PAGE_IDS_LIMIT)
                    extra = health_extra() if health_extra is not None \
                        else {}
                    channel.write(encode_frame(
                        "health_ack",
                        build_health_meta(
                            answered=answered,
                            prefix_installed=shared is not None,
                            pool=pool, page_ids=page_ids, **extra), {}))
                elif kind == "query":
                    if shared is None:
                        # an answer from no prefix would be confidently
                        # wrong: refuse loudly
                        raise RemoteProtocolError(
                            "query frame before any shared_kv frame")
                    tokens = arrays["tokens"].numpy().astype(np.int32)
                    max_new = int(meta.get("max_new", 1))
                    toks, _ = agent.generate(tokens, shared,
                                             max_new=max_new)
                    channel.write(encode_frame(
                        "tokens", {},
                        {"tokens": toks.to(torch.int32).cpu()}))
                    answered += 1
                else:
                    raise RemoteProtocolError(
                        f"unexpected frame kind {kind!r}")
    finally:
        # a dead connection must not leak its pinned table into the pool
        if pinned is not None:
            with guard:
                store.release(pinned)
    return answered


class _CountingLock:
    """An RLock that counts its demand (holders + waiters): the health
    probe reports it as queue depth."""

    def __init__(self) -> None:
        self._lock = threading.RLock()
        self._guard = threading.Lock()
        self._demand = 0

    @property
    def demand(self) -> int:
        with self._guard:
            return self._demand

    def __enter__(self) -> "_CountingLock":
        with self._guard:
            self._demand += 1
        self._lock.acquire()
        return self

    def __exit__(self, *exc) -> None:
        self._lock.release()
        with self._guard:
            self._demand -= 1


class KVServer:
    """Serves one receiver agent over the frame protocol. The listener is
    bound at construction (``port`` is known before a client dials).
    ``serve_once`` serves one connection to its end; ``serve`` and
    ``start`` run a concurrent accept loop, one handler thread per
    connection, frame handling serialized under one lock and frame reads
    per thread. ``start`` / ``stop`` are a replica's lifecycle: ``stop``
    severs every connection (their handlers release their pins on the way
    out) and a fresh ``KVServer`` may bind the same port again."""

    def __init__(self, agent: Agent, host: str = "127.0.0.1",
                 port: int = 0, store=None, max_conns: int = 8) -> None:
        self.agent = agent
        self.store = store   # the PageStore the paged wire dedups against
        self.max_conns = max_conns
        self._listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._listener.bind((host, port))
        self._listener.listen(max_conns)
        self.host, self.port = self._listener.getsockname()[:2]
        self._lock = _CountingLock()        # serializes frame handling
        self._guard = threading.Lock()      # guards the bookkeeping below
        self._conns: Set[socket.socket] = set()
        self._threads: List[threading.Thread] = []
        self._accept_thread: Optional[threading.Thread] = None
        self._stopping = False
        self.answered_total = 0             # query frames, all connections

    def _health_extra(self) -> Dict:
        """Queue depth (handlers wanting the lock, the prober excluded)
        and slot occupancy (live connections of ``max_conns``)."""
        with self._guard:
            occupied = len(self._conns)
        return {"queue_depth": max(0, self._lock.demand - 1),
                "slots_capacity": self.max_conns,
                "slots_occupied": occupied}

    def _handle(self, sock: socket.socket) -> int:
        try:
            n = serve_channel(self.agent, SocketChannel(sock),
                              store=self.store, lock=self._lock,
                              health_extra=self._health_extra)
            with self._guard:
                self.answered_total += n
            return n
        except RemoteProtocolError as e:
            # one client dying mid-frame does not take the server down
            if not self._stopping:
                print(f"[server] connection died: "
                      f"{type(e).__name__}: {e}",
                      file=sys.stderr, flush=True)
            return 0
        finally:
            with self._guard:
                self._conns.discard(sock)
            try:
                sock.close()
            except OSError:
                pass

    def _spawn(self, sock: socket.socket) -> threading.Thread:
        with self._guard:
            self._conns.add(sock)
        th = threading.Thread(target=self._handle, args=(sock,),
                              daemon=True)
        th.start()
        return th

    def serve_once(self, timeout_s: float = 120.0) -> int:
        """Accept one client and serve it to shutdown or disconnect.
        Returns the number of query frames answered."""
        self._listener.settimeout(timeout_s)
        sock, _ = self._listener.accept()
        try:
            return serve_channel(self.agent, SocketChannel(sock),
                                 store=self.store)
        finally:
            sock.close()
            self._listener.close()

    def serve(self, conns: int, timeout_s: float = 120.0) -> int:
        """Accept ``conns`` clients, each on its own thread, over one
        shared pool; a protocol error ends only its own connection.
        Returns the query frames answered once all have ended."""
        self._listener.settimeout(timeout_s)
        threads = []
        try:
            for _ in range(conns):
                sock, _ = self._listener.accept()
                threads.append(self._spawn(sock))
        finally:
            for th in threads:
                th.join()
            self._listener.close()
        return self.answered_total

    def start(self, poll_s: float = 0.05) -> None:
        """Run the accept loop in a background thread until ``stop``."""
        if self._accept_thread is not None:
            raise RuntimeError("server already started")
        self._stopping = False
        self._listener.settimeout(poll_s)

        def loop() -> None:
            while not self._stopping:
                try:
                    sock, _ = self._listener.accept()
                except socket.timeout:
                    continue
                except OSError:
                    break          # the listener closed under us: stop()
                self._threads.append(self._spawn(sock))

        self._accept_thread = threading.Thread(target=loop, daemon=True)
        self._accept_thread.start()

    def stop(self, timeout_s: float = 5.0) -> None:
        """Stop accepting, sever every live connection and join the
        handlers. Idempotent."""
        self._stopping = True
        try:
            self._listener.close()
        except OSError:
            pass
        with self._guard:
            conns = list(self._conns)
        for sock in conns:
            try:
                sock.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                sock.close()
            except OSError:
                pass
        if self._accept_thread is not None:
            self._accept_thread.join(timeout=timeout_s)
            self._accept_thread = None
        for th in self._threads:
            th.join(timeout=timeout_s)
        self._threads.clear()


# ---------------------------------------------------------------------------
# client half (sender side)
# ---------------------------------------------------------------------------
def export_pages(sender: Agent, context: np.ndarray, kvcfg: KVCommConfig,
                 select, *, page_len: int = 16, wire_dtype="float16"):
    """The sender's KV over ``context``, its ``select``-ed layers split into
    content-addressed pages, with no wire exchange: ``(table, pages)``.
    The router splits once to score replicas by page overlap;
    ``KVClient.share_pages`` ships the result."""
    from repro_torch.core.protocol import gather_selected, selected_layer_ids
    from repro_torch.store.paging import split_payload
    kv, _ = sender.export_kv(context)
    return split_payload(
        gather_selected(kv, select), layers=selected_layer_ids(select),
        select=select, page_len=page_len, wire_dtype=wire_dtype,
        pos_mode=kvcfg.pos_mode)


class KVClient:
    """The sender's handle on a remote receiver. With a ``policy``
    (``RetryPolicy``) every operation retries under it; with a
    ``channel_factory`` (``connect`` sets one) a retry reconnects first,
    and ``generate`` replays the last successful share before retrying.
    A replayed paged share re-runs the dedup handshake, so a reconnect to
    the same server ships only what its pool lacks."""

    def __init__(self, channel: RemoteChannel, *,
                 channel_factory=None, policy=None) -> None:
        self.channel = channel
        self.channel_factory = channel_factory
        self.policy = policy
        self.sent_bytes = 0
        self._xid = 0
        self._sid = 0          # stream id: fresh per streamed share try
        self._reshare = None   # replays the last successful share

    @classmethod
    def connect(cls, host: str, port: int, timeout_s: float = 30.0, *,
                policy=None, io_timeout_s: Optional[float] = None
                ) -> "KVClient":
        def factory():
            return SocketChannel.connect(host, port, timeout_s=timeout_s,
                                         io_timeout_s=io_timeout_s)
        return cls(factory(), channel_factory=factory, policy=policy)

    # -- retry plumbing -----------------------------------------------------
    def _reconnect(self, replay: bool) -> None:
        try:
            self.channel.close()
        except (RemoteProtocolError, OSError):
            pass
        self.channel = self.channel_factory()
        if replay and self._reshare is not None:
            # a fresh connection (maybe a restarted server) holds no
            # prefix: reinstall it before replaying the failed op
            self._reshare()

    def _with_retry(self, fn, describe: str, replay: bool):
        if self.policy is None:
            return fn()

        def wrapped(attempt: int):
            if attempt > 0 and self.channel_factory is not None:
                self._reconnect(replay)
            return fn()

        return self.policy.run(wrapped, describe=describe)

    # -- operations ---------------------------------------------------------
    def share(self, sender: Agent, context: np.ndarray,
              kvcfg: KVCommConfig, select, *, wire_dtype="float16",
              packed: bool = True,
              chunk_bytes: Optional[int] = None) -> int:
        """Export the sender's KV over ``context`` and ship the selected
        layers, as one frame or (``chunk_bytes``) as a stream; a retried
        stream restarts under a fresh sid. Returns (and accumulates) the
        payload wire bytes."""
        def once():
            kv, _ = sender.export_kv(context)
            sid, self._sid = self._sid, self._sid + 1
            n = send_shared(self.channel, kvcfg, kv, select,
                            wire_dtype=wire_dtype, packed=packed,
                            chunk_bytes=chunk_bytes, sid=sid)
            self.sent_bytes += n
            return n
        n = self._with_retry(once, "remote share", replay=False)
        self._reshare = once
        return n

    def share_paged(self, sender: Agent, context: np.ndarray,
                    kvcfg: KVCommConfig, select, *, page_len: int = 16,
                    wire_dtype="float16") -> Tuple[int, int, int]:
        """The dedup-aware share: split into pages, ask the server's pool
        what it lacks (``page_query`` -> ``page_need``), ship only that
        (``page_data``). Returns ``(payload bytes, pages_total,
        pages_sent)``."""
        def once():
            table, pages = export_pages(sender, context, kvcfg, select,
                                        page_len=page_len,
                                        wire_dtype=wire_dtype)
            return self._share_pages_once(table, pages, wire_dtype)
        out = self._with_retry(once, "paged remote share", replay=False)
        self._reshare = once
        return out

    def share_pages(self, table, pages, *, wire_dtype="float16"
                    ) -> Tuple[int, int, int]:
        """Ship an already-split page set (``export_pages``) through the
        dedup handshake: the fabric's entry point. Retries and replays as
        ``share_paged``."""
        def once():
            return self._share_pages_once(table, pages, wire_dtype)
        out = self._with_retry(once, "paged remote share", replay=False)
        self._reshare = once
        return out

    def _share_pages_once(self, table, pages, wire_dtype
                          ) -> Tuple[int, int, int]:
        from repro_torch.store.wire import (decode_page_need,
                                            encode_page_data,
                                            encode_page_query)
        xid, self._xid = self._xid, self._xid + 1
        self.channel.write(encode_page_query(xid, table))
        kind, meta, _ = read_frame(self.channel)
        if kind != "page_need":
            raise RemoteProtocolError(f"expected a page_need frame, "
                                      f"got {kind!r}")
        _, need = decode_page_need(meta)
        by_id = {p.page_id: p for p in pages}
        frame, n = encode_page_data(xid, [by_id[pid] for pid in need],
                                    wire_dtype=wire_dtype)
        self.channel.write(frame)
        n += table.scale_nbytes
        self.sent_bytes += n
        return n, table.num_pages, len(need)

    def generate(self, query: np.ndarray, max_new: int = 1) -> np.ndarray:
        """The remote receiver's (B, max_new) greedy tokens for ``query``
        (B, Sq) against the last shared prefix."""
        def once():
            self.channel.write(encode_frame(
                "query", {"max_new": int(max_new)},
                {"tokens": np.asarray(query, np.int32)}))
            kind, _, arrays = read_frame(self.channel)
            if kind != "tokens":
                raise RemoteProtocolError(f"expected a tokens frame, "
                                          f"got {kind!r}")
            return arrays["tokens"].numpy().astype(np.int32)
        return self._with_retry(once, "remote generate", replay=True)

    def probe(self) -> dict:
        """One ``health`` round trip: the server's health_ack meta. Raises
        the typed errors when the peer is gone."""
        def once():
            self.channel.write(encode_frame("health", {}, {}))
            kind, meta, _ = read_frame(self.channel)
            if kind != "health_ack":
                raise RemoteProtocolError(f"expected a health_ack frame, "
                                          f"got {kind!r}")
            return meta
        return self._with_retry(once, "health probe", replay=False)

    def close(self) -> None:
        try:
            self.channel.write(encode_frame("shutdown", {}, {}))
        except (RemoteProtocolError, OSError):
            pass
        self.channel.close()


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------
PROBE_QUERY = np.arange(4, 12, dtype=np.int32)[None, :]


def probe_logits(agent: Agent) -> List[float]:
    """The receiver's float32 last-position logits on ``PROBE_QUERY`` with
    no prefix: the first 16 values and the L2 norm. Two processes built
    from one seed on one card print the same list."""
    logits = agent.prefill(PROBE_QUERY).logits[0, -1].float()
    return [float(x) for x in logits[:16].cpu()] + \
        [float(torch.linalg.vector_norm(logits).cpu())]


def _load_agents(args) -> Tuple[Agent, Agent, object]:
    from repro_torch import resolve_device
    from repro_torch.launch import pairs
    device = resolve_device(args.device)
    cfg = (pairs.full_width_config() if args.config == "full"
           else pairs.pair_config())
    tok = pairs.pair_tokenizer()
    sender, receiver = pairs.random_pair(cfg, args.seed, device=device)
    return (Agent("sender", cfg, sender, tok),
            Agent("receiver", cfg, receiver, tok), tok)


def run_server(args) -> None:
    _, receiver, _ = _load_agents(args)
    store = None
    if args.pool_mb > 0:
        from repro_torch.store import PageStore
        store = PageStore(page_len=args.page_len,
                          capacity_bytes=args.pool_mb * (1 << 20))
    server = KVServer(receiver, host=args.host, port=args.port,
                      store=store)
    print(f"PROBE {json.dumps(probe_logits(receiver))}", flush=True)
    # a parent process reads this line to learn the port before dialing
    print(f"PORT {server.port}", flush=True)
    if args.serve_conns > 1:
        answered = server.serve(args.serve_conns, timeout_s=args.timeout)
    else:
        answered = server.serve_once(timeout_s=args.timeout)
    print(f"[server] answered {answered} query frames", flush=True)
    if store is not None:
        st = store.stats()
        print(f"[server] pool: {st.pages} pages, {st.used_bytes} bytes, "
              f"hit_rate {st.hit_rate:.3f}, {st.evictions} evictions",
              flush=True)


def run_client(args) -> None:
    from repro_torch.core.protocol import make_selection
    from repro_torch.data.synthetic import SyntheticTask, TaskConfig
    sender, _, tok = _load_agents(args)
    task = SyntheticTask(tok, TaskConfig("retrieval", num_facts=6, seed=42))
    batch = task.batch(args.requests)
    kvcfg = KVCommConfig(ratio=args.ratio, selector="prior_only")
    select = make_selection(sender.cfg, kvcfg)
    policy = None
    if args.retries > 1:
        from repro_torch.comm.resilience import RetryPolicy
        policy = RetryPolicy(max_attempts=args.retries)
    client = KVClient.connect(args.host, args.port, policy=policy,
                              io_timeout_s=args.io_timeout)
    try:
        if args.paged:
            n, total, sent = client.share_paged(
                sender, batch["context"], kvcfg, select,
                page_len=args.page_len, wire_dtype=args.wire_dtype)
            print(f"[client] paged: {sent}/{total} pages shipped "
                  f"({total - sent} pool hits)")
        else:
            n = client.share(sender, batch["context"], kvcfg, select,
                             wire_dtype=args.wire_dtype,
                             chunk_bytes=(args.chunk_kb * 1024
                                          if args.chunk_kb > 0 else None))
        toks = client.generate(batch["query"], max_new=1)
    finally:
        client.close()
    acc = float(np.mean(toks[:, 0] == batch["answer"]))
    print(f"[client] shipped {n} payload bytes, accuracy {acc:.3f}")


def _model_flags(p) -> None:
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    p.add_argument("--config", default="tiny", choices=["tiny", "full"],
                   help="the tiny 8-layer float32 pair or llama3.2-3b-pair "
                        "at full width")
    p.add_argument("--seed", type=int, default=0,
                   help="the random weights' seed (sender and receiver "
                        "share one parameter set)")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    sub = ap.add_subparsers(dest="role", required=True)
    s = sub.add_parser("server", help="receiver-side KV server")
    s.add_argument("--host", default="127.0.0.1")
    s.add_argument("--port", type=int, default=0,
                   help="0 picks a free port (printed as 'PORT <p>')")
    s.add_argument("--timeout", type=float, default=120.0)
    s.add_argument("--pool-mb", type=int, default=0,
                   help=">0 attaches a content-addressed page pool of this "
                        "capacity: the server answers the paged wire and "
                        "dedups repeated prefixes against it")
    s.add_argument("--page-len", type=int, default=16)
    s.add_argument("--serve-conns", type=int, default=1,
                   help="accept this many client connections; the page "
                        "pool persists across them")
    _model_flags(s)
    c = sub.add_parser("client", help="sender-side KV client")
    c.add_argument("--host", default="127.0.0.1")
    c.add_argument("--port", type=int, required=True)
    c.add_argument("--requests", type=int, default=8)
    c.add_argument("--ratio", type=float, default=0.5)
    c.add_argument("--wire-dtype", default="float16",
                   help="float16 | bfloat16 | float32 | int8 | int4, or "
                        "a per-layer 'plan:<dtype,dtype,...>' spec with one "
                        "entry per selected layer")
    c.add_argument("--chunk-kb", type=int, default=0,
                   help=">0 streams the (unpaged) share in frames of "
                        "roughly this many KiB instead of one frame")
    c.add_argument("--paged", action="store_true",
                   help="ship through the dedup-aware paged wire (the "
                        "server must run with --pool-mb > 0)")
    c.add_argument("--page-len", type=int, default=16)
    c.add_argument("--retries", type=int, default=1,
                   help=">1 retries failed operations under a RetryPolicy "
                        "with that many attempts, reconnecting (and "
                        "replaying the share before a generate) between "
                        "tries")
    c.add_argument("--io-timeout", type=float, default=None,
                   help="per-read/write socket timeout in seconds")
    _model_flags(c)
    args = ap.parse_args(argv)
    if args.role == "server":
        run_server(args)
    else:
        run_client(args)


if __name__ == "__main__":
    main()
