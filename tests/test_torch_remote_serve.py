"""The port's two-process KV server and client (``repro_torch.launch.
remote_serve``) on bridged float32 ``tiny_params``: the protocol loop over
a loopback, ``KVServer`` / ``KVClient`` over 127.0.0.1 sockets (streamed,
monolithic and paged shares, health, retry with replay after a killed
connection, a poisoned connection, no pin outliving its connection), and,
across packages, a reference ``KVClient`` against a port ``KVServer`` and
the other way round, with answers equal to the same-package run and the
port's health_ack meta equal to the reference server's. ``export_pages``
gives the reference's page IDs and ``BlockTable.meta()``. Every socket
wait has a deadline of its own."""
import socket
import threading

import numpy as np
import pytest
import torch

import repro.launch.remote_serve as jrs
from _torch_bridge import port_cfg, port_params
from repro.comm import Agent as JAgent
from repro.core import make_selection as jmake_selection
from repro.core.types import KVCommConfig as JKVCommConfig
from repro.store import PageStore as JPageStore
from repro_torch.comm import Agent
from repro_torch.comm.remote import (LoopbackChannel, RemoteProtocolError,
                                     SocketChannel, encode_frame,
                                     read_frame, send_shared)
from repro_torch.comm.resilience import RetryPolicy
from repro_torch.core import protocol
from repro_torch.core.types import KVCommConfig
from repro_torch.launch.remote_serve import (KVClient, KVServer,
                                             export_pages, serve_channel)
from repro_torch.store import PageStore

KVCFG = KVCommConfig(ratio=0.5, selector="prior_only")
JKVCFG = JKVCommConfig(ratio=0.5, selector="prior_only")
DEADLINE = 20.0            # every accept and every socket read


@pytest.fixture(scope="module")
def pair(tiny_cfg, tiny_params):
    return port_cfg(tiny_cfg), port_params(tiny_params)


@pytest.fixture(scope="module")
def agents(pair, tok):
    cfg, params = pair
    return Agent("s", cfg, params, tok), Agent("r", cfg, params, tok)


@pytest.fixture(scope="module")
def jagents(tiny_cfg, tiny_params, tok):
    return (JAgent("s", tiny_cfg, tiny_params, tok),
            JAgent("r", tiny_cfg, tiny_params, tok))


def _inputs(cfg, seed=1, B=2, Sc=7, Sq=4):
    rng = np.random.default_rng(seed)
    return (rng.integers(4, cfg.vocab_size, (B, Sc)).astype(np.int32),
            rng.integers(4, cfg.vocab_size, (B, Sq)).astype(np.int32))


def _select(cfg):
    return protocol.make_selection(cfg, KVCFG)


def _local(agents, ctx, qry, max_new):
    """The answer of an in-process receiver on the unpaged packed view."""
    sender, receiver = agents
    kv, _, _ = sender.export_kv(ctx)
    shared = protocol.pack_shared(KVCFG, kv, _select(sender.cfg))
    toks, _ = receiver.generate(qry, shared, max_new=max_new)
    return toks.numpy().astype(np.int32)


def _serve_in_thread(server, conns):
    out = {}
    th = threading.Thread(target=lambda: out.update(
        n=server.serve(conns=conns, timeout_s=DEADLINE)), daemon=True)
    th.start()
    return th, out


def _connect(server, **kw):
    return KVClient.connect(server.host, server.port, timeout_s=DEADLINE,
                            io_timeout_s=DEADLINE, **kw)


# ---------------------------------------------------------------------------
# the protocol loop over a loopback
# ---------------------------------------------------------------------------
class TestServeChannel:
    @pytest.mark.parametrize("chunk_bytes", [None, 300])
    def test_answers_queries_like_a_local_receiver(self, agents, chunk_bytes):
        sender, receiver = agents
        ctx, qry = _inputs(sender.cfg)
        kv, _, _ = sender.export_kv(ctx)
        ch = LoopbackChannel()
        send_shared(ch, KVCFG, kv, _select(sender.cfg), wire_dtype="float32",
                    chunk_bytes=chunk_bytes)
        ch.write(encode_frame("query", {"max_new": 3}, {"tokens": qry}))
        ch.write(encode_frame("shutdown", {}, {}))
        assert serve_channel(receiver, ch) == 1
        kind, _, arrays = read_frame(ch)
        assert kind == "tokens" and arrays["tokens"].dtype == torch.int32
        np.testing.assert_array_equal(arrays["tokens"].numpy(),
                                      _local(agents, ctx, qry, 3))

    def test_query_before_share_is_refused(self, agents):
        ch = LoopbackChannel()
        ch.write(encode_frame("query", {"max_new": 1},
                              {"tokens": np.zeros((1, 3), np.int32)}))
        with pytest.raises(RemoteProtocolError):
            serve_channel(agents[1], ch)

    def test_replayed_stream_installs_only_the_complete_one(self, agents):
        """A partial stream (the client died), then the whole stream under
        a fresh sid: the answer is the clean one."""
        from repro_torch.comm.remote import KVStreamSender
        sender, receiver = agents
        ctx, qry = _inputs(sender.cfg, seed=3)
        kv, _, _ = sender.export_kv(ctx)
        select = _select(sender.cfg)
        ch = LoopbackChannel()
        partial = KVStreamSender(KVCFG, kv, select, wire_dtype="float32",
                                 chunk_bytes=300, sid=0)
        for frame, _ in list(partial.frames())[:3]:
            ch.write(frame)
        send_shared(ch, KVCFG, kv, select, wire_dtype="float32",
                    chunk_bytes=300, sid=1)
        ch.write(encode_frame("query", {"max_new": 2}, {"tokens": qry}))
        ch.write(encode_frame("shutdown", {}, {}))
        assert serve_channel(receiver, ch) == 1
        _, _, arrays = read_frame(ch)
        np.testing.assert_array_equal(arrays["tokens"].numpy(),
                                      _local(agents, ctx, qry, 2))

    def test_error_path_releases_the_pinned_table(self, agents):
        """A paged install then a corrupt frame: the loop raises and the
        pool ends with nothing pinned."""
        sender, receiver = agents
        ctx, _ = _inputs(sender.cfg)
        store = PageStore(page_len=4)
        a, b = socket.socketpair()
        a.settimeout(DEADLINE)
        b.settimeout(DEADLINE)
        err = {}

        def run():
            try:
                serve_channel(receiver, SocketChannel(b), store=store)
            except RemoteProtocolError as e:
                err["e"] = e

        th = threading.Thread(target=run, daemon=True)
        th.start()
        client = KVClient(SocketChannel(a))
        client.share_paged(sender, ctx, KVCFG, _select(sender.cfg),
                           page_len=4, wire_dtype="float32")
        assert client.probe()["prefix_installed"] is True
        a.sendall(b"KVCM" + b"\x00" * 40)     # a frame that cannot parse
        a.close()
        th.join(DEADLINE)
        assert not th.is_alive() and "e" in err
        assert store.stats().pinned_bytes == 0


# ---------------------------------------------------------------------------
# KVServer / KVClient over sockets
# ---------------------------------------------------------------------------
class TestServerClient:
    def test_streamed_monolithic_and_paged_shares(self, agents):
        sender, receiver = agents
        ctx, qry = _inputs(sender.cfg)
        select = _select(sender.cfg)
        want = _local(agents, ctx, qry, 2)
        store = PageStore(page_len=4)
        server = KVServer(receiver, store=store)
        th, served = _serve_in_thread(server, conns=1)
        client = _connect(server)
        try:
            outs = []
            for chunk in (None, 300):
                client.share(sender, ctx, KVCFG, select,
                             wire_dtype="float32", chunk_bytes=chunk)
                outs.append(client.generate(qry, max_new=2))
            n1, total1, sent1 = client.share_paged(
                sender, ctx, KVCFG, select, page_len=4, wire_dtype="float32")
            outs.append(client.generate(qry, max_new=2))
            n2, total2, sent2 = client.share_paged(
                sender, ctx, KVCFG, select, page_len=4, wire_dtype="float32")
            outs.append(client.generate(qry, max_new=2))
        finally:
            client.close()
            th.join(DEADLINE)
        for o in outs:
            np.testing.assert_array_equal(o, want)
        assert served["n"] == 4
        assert sent1 == total1 > 0 and n1 > 0
        assert sent2 == 0 and n2 == 0
        assert store.stats().pinned_bytes == 0

    def test_health_probe_before_and_after_a_share(self, agents):
        sender, receiver = agents
        ctx, _ = _inputs(sender.cfg)
        server = KVServer(receiver, store=PageStore(page_len=4), max_conns=4)
        server.start()
        client = _connect(server)
        try:
            m0 = client.probe()
            assert m0["prefix_installed"] is False
            assert m0["pool"]["pages"] == 0 and m0["health_version"] == 2
            assert m0["slots"] == {"capacity": 4, "occupied": 1}
            client.share_paged(sender, ctx, KVCFG, _select(sender.cfg),
                               page_len=4, wire_dtype="float32")
            m1 = client.probe()
            assert m1["prefix_installed"] is True
            assert m1["pool"]["pages"] == len(m1["page_ids"]) > 0
            assert m1["answered"] == 0 and m1["queue_depth"] == 0
        finally:
            client.close()
            server.stop()

    def test_reconnect_replays_the_share_dedup_bounded(self, agents):
        """The client's socket dies after a paged share; the next generate
        reconnects, replays the share against the same pool (zero pages)
        and answers identically."""
        sender, receiver = agents
        ctx, qry = _inputs(sender.cfg)
        store = PageStore(page_len=4)
        server = KVServer(receiver, store=store)
        th, served = _serve_in_thread(server, conns=2)
        client = _connect(server, policy=RetryPolicy(
            max_attempts=3, backoff_s=0.01, jitter=0.0))
        try:
            _, total, sent = client.share_paged(
                sender, ctx, KVCFG, _select(sender.cfg), page_len=4,
                wire_dtype="float32")
            toks1 = client.generate(qry, max_new=2)
            before = client.sent_bytes
            client.channel.close()          # the connection dies under us
            toks2 = client.generate(qry, max_new=2)
        finally:
            client.close()
            th.join(DEADLINE)
        np.testing.assert_array_equal(toks1, toks2)
        np.testing.assert_array_equal(toks1, _local(agents, ctx, qry, 2))
        assert sent == total > 0 and client.sent_bytes == before
        assert served["n"] == 2 and store.stats().pinned_bytes == 0

    def test_server_outlives_a_connection_killed_mid_frame(self, agents):
        sender, receiver = agents
        ctx, qry = _inputs(sender.cfg, seed=2, Sc=6, Sq=3)
        server = KVServer(receiver)
        th, served = _serve_in_thread(server, conns=2)
        poison = socket.create_connection((server.host, server.port),
                                          timeout=DEADLINE)
        poison.sendall(b"KVCM" + b"\x00" * 7)   # half a prefix, then death
        poison.close()
        client = _connect(server)
        try:
            client.share(sender, ctx, KVCFG, _select(sender.cfg),
                         wire_dtype="float32", chunk_bytes=256)
            toks = client.generate(qry, max_new=2)
        finally:
            client.close()
            th.join(DEADLINE)
        assert served["n"] == 1
        np.testing.assert_array_equal(toks, _local(agents, ctx, qry, 2))

    def test_stop_releases_every_pin(self, agents):
        """Two live connections each holding a pinned table: ``stop``
        severs them and no pin survives; a fresh server binds the port."""
        sender, receiver = agents
        store = PageStore(page_len=4)
        server = KVServer(receiver, store=store)
        server.start()
        clients = [_connect(server) for _ in range(2)]
        for i, c in enumerate(clients):
            ctx, _ = _inputs(sender.cfg, seed=5 + i)
            c.share_paged(sender, ctx, KVCFG, _select(sender.cfg),
                          page_len=4, wire_dtype="float32")
            assert c.probe()["prefix_installed"]
        assert store.stats().pinned_bytes > 0
        server.stop()
        assert store.stats().pinned_bytes == 0
        for c in clients:
            c.channel.close()
        again = KVServer(receiver, port=server.port)
        again.start()
        c = _connect(again)
        try:
            assert c.probe()["prefix_installed"] is False
        finally:
            c.close()
            again.stop()

    def test_slow_client_does_not_block_another(self, agents):
        sender, receiver = agents
        ctx, qry = _inputs(sender.cfg)
        select = _select(sender.cfg)
        server = KVServer(receiver, store=PageStore(page_len=4))
        th, served = _serve_in_thread(server, conns=2)
        slow = _connect(server)
        fast = _connect(server)
        try:
            fast.share_paged(sender, ctx, KVCFG, select, page_len=4,
                             wire_dtype="float32")
            toks_fast = fast.generate(qry, max_new=2)
            _, total, sent = slow.share_paged(sender, ctx, KVCFG, select,
                                              page_len=4,
                                              wire_dtype="float32")
            toks_slow = slow.generate(qry, max_new=2)
        finally:
            fast.close()
            slow.close()
            th.join(DEADLINE)
        assert sent == 0 and total > 0 and served["n"] == 2
        np.testing.assert_array_equal(toks_fast, toks_slow)


# ---------------------------------------------------------------------------
# across packages
# ---------------------------------------------------------------------------
def _run_client(kind, server, agent, ctx, qry, select, paged):
    mod = jrs if kind == "ref" else None
    client = (mod.KVClient if mod else KVClient).connect(
        server.host, server.port, timeout_s=DEADLINE,
        io_timeout_s=DEADLINE)
    try:
        out = []
        if paged:
            for _ in range(2):
                _, total, sent = client.share_paged(
                    agent, ctx, JKVCFG if mod else KVCFG, select,
                    page_len=4, wire_dtype="float32")
                out.append((total, sent,
                            np.asarray(client.generate(qry, max_new=3))))
        else:
            client.share(agent, ctx, JKVCFG if mod else KVCFG, select,
                         wire_dtype="float32", chunk_bytes=300)
            out.append(np.asarray(client.generate(qry, max_new=3)))
        meta = client.probe()
    finally:
        client.close()
    return out, meta


@pytest.mark.parametrize("paged", [False, True], ids=["streamed", "paged"])
@pytest.mark.parametrize("client_side", ["ref", "port"])
def test_cross_package_client_and_server(agents, jagents, tiny_cfg,
                                         client_side, paged):
    """A reference client against a port server and a port client against
    a reference server answer as the same-package pair does; the port
    server's health_ack meta equals the reference server's."""
    ctx, qry = _inputs(agents[0].cfg)
    jselect = jmake_selection(tiny_cfg, JKVCFG)
    tselect = _select(agents[0].cfg)
    results = {}
    for server_side in ("ref", "port"):
        if server_side == "ref":
            srv = jrs.KVServer(jagents[1], store=JPageStore(page_len=4))
        else:
            srv = KVServer(agents[1], store=PageStore(page_len=4))
        srv.start()
        try:
            agent = jagents[0] if client_side == "ref" else agents[0]
            select = jselect if client_side == "ref" else tselect
            results[server_side] = _run_client(client_side, srv, agent, ctx,
                                               qry, select, paged)
        finally:
            srv.stop()
    (got, gmeta), (want, wmeta) = results["port"], results["ref"]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        if paged:
            assert g[:2] == w[:2]
            g, w = g[2], w[2]
        np.testing.assert_array_equal(g, w)
    assert gmeta == wmeta
    assert np.array_equal(np.asarray(want[0][2] if paged else want[0]),
                          _local(agents, ctx, qry, 3))


class _FixedKV(Agent):
    """A sender whose export is the reference sender's KV (page IDs hash
    the wire bytes, so the comparison needs the same KV bits)."""

    def export_kv(self, context, *, add_bos=True):
        kv, _, sc = self.ref.export_kv(context)
        return ({p: torch.from_numpy(np.asarray(kv[p])) for p in kv}, None,
                sc)


def test_export_pages_matches_reference(agents, jagents, tiny_cfg):
    ctx, _ = _inputs(agents[0].cfg, seed=4, Sc=13)
    sender = _FixedKV(*(getattr(agents[0], f) for f in
                        ("name", "cfg", "params", "tok")))
    sender.ref = jagents[0]
    for wire in ("float32", "float16", "int8"):
        table, pages, states, state_select = export_pages(
            sender, ctx, KVCFG, _select(agents[0].cfg), page_len=4,
            wire_dtype=wire)
        assert states is None and state_select is None
        jtable, jpages, _, _ = jrs.export_pages(
            jagents[0], ctx, JKVCFG, jmake_selection(tiny_cfg, JKVCFG),
            page_len=4, wire_dtype=wire)
        assert table.meta() == jtable.meta()
        assert [p.page_id for p in pages] == [p.page_id for p in jpages]
        assert table.all_ids() == jtable.all_ids()


def test_cli_server_and_client_on_the_cpu(tmp_path):
    """The CLI pair on the tiny config: the server prints its probe and
    port, the client ships a paged share and both exit 0."""
    import os
    import subprocess
    import sys
    env = dict(os.environ, PYTHONPATH=os.path.join(
        os.path.dirname(__file__), "..", "src"))
    base = [sys.executable, "-m", "repro_torch.launch.remote_serve"]
    server = subprocess.Popen(
        base + ["server", "--device", "cpu", "--pool-mb", "8",
                "--page-len", "8", "--timeout", str(DEADLINE)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
    try:
        probe = server.stdout.readline()
        port_line = server.stdout.readline()
        assert probe.startswith("PROBE [") and port_line.startswith("PORT ")
        port = port_line.split()[1]
        client = subprocess.run(
            base + ["client", "--device", "cpu", "--port", port, "--paged",
                    "--page-len", "8", "--requests", "2", "--retries", "2",
                    "--io-timeout", str(DEADLINE)],
            capture_output=True, text=True, env=env, timeout=120)
        assert client.returncode == 0, client.stderr
        assert "pages shipped" in client.stdout
        out, err = server.communicate(timeout=60)
        assert server.returncode == 0, err
        assert "answered 1 query frames" in out
    finally:
        if server.poll() is None:
            server.kill()
            server.communicate()
