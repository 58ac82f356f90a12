"""The port's paged prefix store against the reference's, on the same numpy
payloads: page IDs and ``BlockTable.meta()`` equal at every wire tier (so a
table from either side loads in the other), rebuilds and the bucketed
``gather_prefix`` bit-equal to ``pad_prefix(materialize)``, the pool's
residency and stats equal op by op under random sequences, and the
store-attached transports' records and receiver views equal to the
reference's (and ``sync=False`` to ``sync=True``)."""
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.store as jstore
from _torch_bridge import port_cfg, t
from repro.comm.transport import InMemoryTransport as JInMemory
from repro.comm.transport import SerializedTransport as JSerialized
from repro.core.types import KVCommConfig as JKVCommConfig
from repro.store.paging import rebuild_decoded as jrebuild_decoded
from repro_torch.comm.transport import (InMemoryTransport,
                                        SerializedTransport, roundtrip_kv)
from repro_torch.core import protocol
from repro_torch.core.types import KVCommConfig
from repro_torch.store import (BlockTable, Page, PagePool, PagePoolError,
                               PageStore, PoolFullError, rebuild_payload,
                               split_payload)
from repro_torch.store.paging import rebuild_decoded

PLAN = "plan:float16,int4,int8"
TIERS = ["float32", "bfloat16", "float16", "int8", "int4", PLAN]
LAYERS, SELECT = (0, 2, 3), (True, False, True, True)


def _payload(dtype="bfloat16", seed=0, Sc=37):
    """(M 3, B 2, Sc, Hkv 2, Dh 16) k and v at ``dtype``, an all-zero k
    layer included, for both frameworks."""
    rng = np.random.default_rng(seed)
    x = {p: (rng.standard_normal((3, 2, Sc, 2, 16)) * 2).astype(np.float32)
         for p in ("k", "v")}
    x["k"][1] = 0.0
    return ({p: jnp.asarray(a).astype(dtype) for p, a in x.items()},
            {p: t(a).to(getattr(torch, dtype)) for p, a in x.items()})


def _split(payloads, wire, page_len):
    jp, tp = payloads
    kw = dict(layers=LAYERS, select=SELECT, page_len=page_len,
              wire_dtype=wire)
    return jstore.split_payload(jp, **kw), split_payload(tp, **kw)


def _bytes(a) -> bytes:
    if isinstance(a, torch.Tensor):
        return a.contiguous().view(torch.uint8).numpy().tobytes()
    return np.ascontiguousarray(a).view(np.uint8).tobytes()


@pytest.mark.parametrize("page_len", [4, 16])
@pytest.mark.parametrize("wire", TIERS)
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_page_ids_and_meta_match_reference(dtype, wire, page_len):
    """Same payload, same page IDs (Sc 37: a ragged tail at both page
    lengths), same page bytes, the same meta JSON, and each side's meta
    loads in the other."""
    (jt, jpages), (pt, ppages) = _split(_payload(dtype), wire, page_len)
    assert [p.page_id for p in ppages] == [p.page_id for p in jpages]
    for a, b in zip(ppages, jpages):
        assert (a.layer, a.start, a.length, a.nbytes) == \
            (b.layer, b.start, b.length, b.nbytes)
        assert _bytes(a.k) == _bytes(b.k) and _bytes(a.v) == _bytes(b.v)
    assert json.dumps(pt.meta()) == json.dumps(jt.meta())
    assert pt.scale_nbytes == jt.scale_nbytes
    assert (pt.scales is None) == (jt.scales is None)
    if pt.scales is not None:
        for p in ("k", "v"):
            assert _bytes(pt.scales[p]) == _bytes(jt.scales[p])
    assert BlockTable.from_meta(jt.meta()).meta() == pt.meta()
    assert jstore.BlockTable.from_meta(pt.meta()).meta() == jt.meta()
    assert pt.num_pages == 3 * -(-37 // page_len) == len(ppages)


@pytest.mark.parametrize("wire", TIERS)
def test_rebuild_and_gather_bit_equal(wire):
    """materialize, the stacked wire rebuild and the bucket-padded gather
    against the unpaged codec, pad_prefix and the reference's rebuild."""
    jp, tp = payloads = _payload("bfloat16", seed=1)
    (jt, jpages), (pt, ppages) = _split(payloads, wire, 8)
    store = PageStore(page_len=8)
    table, novel, _ = store.ingest(tp, layers=LAYERS, select=SELECT,
                                   wire_dtype=wire)
    assert table.meta() == pt.meta() and len(novel) == table.num_pages
    shared = store.materialize(table, device="cpu")
    ref = {p: torch.from_numpy(np.array(
        jrebuild_decoded(jt, {pg.page_id: pg for pg in jpages})[p]
        .astype(jnp.float32))) for p in ("k", "v")}
    unpaged, _ = roundtrip_kv(tp, wire, torch.bfloat16, "cpu")
    for p in ("k", "v"):
        assert torch.equal(shared.packed_kv[p], unpaged[p])
        assert torch.equal(shared.packed_kv[p].float(), ref[p])
    assert shared.layers == LAYERS and shared.prefix_len == 37
    gathered = store.gather_prefix(table, 48, device="cpu")
    padded = protocol.pad_prefix(shared, 48)
    jg = jrebuild_decoded(jt, {pg.page_id: pg for pg in jpages}, out_len=48)
    for p in ("k", "v"):
        assert torch.equal(gathered[p], padded.packed_kv[p])
        np.testing.assert_array_equal(gathered[p].float().numpy(),
                                      np.asarray(jg[p].astype(jnp.float32)))
    with pytest.raises(ValueError, match="bucket"):
        store.gather_prefix(table, 36, device="cpu")
    if wire != PLAN:
        wire_stack = rebuild_payload(pt, {pg.page_id: pg for pg in ppages})
        jw = jstore.rebuild_payload(jt, {pg.page_id: pg for pg in jpages})
        for p in ("k", "v"):
            assert _bytes(wire_stack[p]) == _bytes(jw[p])


def test_missing_page_raises_keyerror():
    _, (pt, ppages) = _split(_payload("float32"), "int8", 8)
    pages = {pg.page_id: pg for pg in ppages[1:]}
    with pytest.raises(KeyError, match=ppages[0].page_id):
        rebuild_payload(pt, pages)
    with pytest.raises(KeyError, match=ppages[0].page_id):
        rebuild_decoded(pt, pages, device="cpu")


# ---------------------------------------------------------------------------
# the pool, op by op against the reference's
# ---------------------------------------------------------------------------
def _pages(pid, nbytes):
    side = max(nbytes // 2, 1)
    z = np.zeros((1, side, 1, 1), np.int8)
    return (jstore.Page(pid, 0, 0, side, z, z),
            Page(pid, 0, 0, side, torch.from_numpy(z), torch.from_numpy(z)))


def _apply(pool, op, args, is_ref):
    try:
        if op == "put":
            pid, nbytes, prio, pin = args
            page = _pages(pid, nbytes)[0 if is_ref else 1]
            return pool.put(page, priority=prio, pin=pin)
        if op == "pin":
            return pool.pin(args)
        if op == "unpin":
            return pool.unpin(args)
        if op == "get":
            return pool.get(args).page_id
        return pool.missing(args)
    except Exception as e:          # the two pools must raise alike
        return type(e).__name__


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("policy", ["lru", "priority"])
def test_pool_matches_reference_op_by_op(policy, seed):
    """Seeded random put / pin / unpin / get / missing sequences over a
    small capacity: evictions, pinned pages surviving, PoolFullError and
    unbalanced unpins all land alike, and ids() and stats() agree after
    every op."""
    rng = np.random.default_rng(seed)
    ref = jstore.PagePool(capacity_bytes=192, policy=policy)
    port = PagePool(capacity_bytes=192, policy=policy)
    names = [f"p{i}" for i in range(10)]
    raised = set()
    for _ in range(160):
        op = rng.choice(["put", "put", "pin", "unpin", "get", "missing"])
        if op == "put":
            args = (str(rng.choice(names)), int(rng.choice([32, 64, 128])),
                    float(rng.integers(0, 3)), bool(rng.random() < 0.4))
        else:
            ids = [str(x) for x in rng.choice(names, rng.integers(1, 3))]
            args = ids[0] if op == "get" else ids
        got = _apply(port, op, args, False)
        want = _apply(ref, op, args, True)
        assert got == want, (op, args)
        if isinstance(got, str) and got.endswith("Error"):
            raised.add(got)
        assert port.ids() == ref.ids() and port.stats() == ref.stats()
        assert port.pins == ref.pins
    assert raised and ref.evictions > 0, "no error path or eviction hit"
    with pytest.raises(PoolFullError):
        PagePool(capacity_bytes=8).put(_pages("big", 64)[1])
    with pytest.raises(PagePoolError, match="unbalanced"):
        port.unpin(["never"])


# ---------------------------------------------------------------------------
# store-attached transports against the reference's
# ---------------------------------------------------------------------------
def _kv_stream(seed=2):
    """Three sends: a context, the same context again, and one that
    extends its first 8 positions (2 shared pages of 4 per layer)."""
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((4, 1, 10, 2, 16)).astype(np.float32)
    b = np.concatenate([a[:, :, :8], rng.standard_normal(
        (4, 1, 6, 2, 16)).astype(np.float32)], axis=2)
    return [a, a, b]


TRANSPORTS = {
    "mem": (lambda s, **kw: InMemoryTransport(store=s, **kw),
            lambda s, **kw: JInMemory(store=s, **kw)),
    "ser_float32": (lambda s, **kw: SerializedTransport("float32", store=s,
                                                        **kw),
                    lambda s, **kw: JSerialized("float32", store=s, **kw)),
    "ser_int8": (lambda s, **kw: SerializedTransport("int8", store=s, **kw),
                 lambda s, **kw: JSerialized("int8", store=s, **kw)),
    "ser_int4": (lambda s, **kw: SerializedTransport("int4", store=s, **kw),
                 lambda s, **kw: JSerialized("int4", store=s, **kw)),
    "ser_plan": (lambda s, **kw: SerializedTransport("plan:int8,float16",
                                                     store=s, **kw),
                 lambda s, **kw: JSerialized("plan:int8,float16", store=s,
                                             **kw)),
}
FIELDS = ("kind", "n_bytes", "layers", "context_len", "wire_dtype",
          "pages_total", "pages_sent", "pages_hit")


@pytest.mark.parametrize("packed", [True, False], ids=["packed", "dense"])
@pytest.mark.parametrize("name", sorted(TRANSPORTS))
def test_store_transports_match_reference(tiny_cfg, name, packed):
    cfg = port_cfg(tiny_cfg)
    ours, theirs = TRANSPORTS[name]
    kvcfg = KVCommConfig(ratio=0.5, selector="prior_only")
    jkvcfg = JKVCommConfig(ratio=0.5, selector="prior_only")
    select = protocol.make_selection(cfg, kvcfg)
    jselect = jnp.asarray(select.numpy())
    runs = {}
    for sync in (True, False):
        tr = ours(PageStore(page_len=4), packed=packed, sync=sync)
        views = [tr.send(cfg, kvcfg, {"k": t(x), "v": t(x) * 0.5}, select)
                 for x in _kv_stream()]
        table = tr.last_table              # settles the deferred ingests
        tr.flush_latency()
        assert table is not None and table.all_ids() == \
            [pid for ids in table.page_ids for pid in ids]
        runs[sync] = (tr, views)
    jtr = theirs(jstore.PageStore(page_len=4), packed=packed)
    jviews = [jtr.send(tiny_cfg, jkvcfg, {"k": jnp.asarray(x),
                                          "v": jnp.asarray(x) * 0.5},
                       jselect) for x in _kv_stream()]
    want = [tuple(getattr(r, f) for f in FIELDS) for r in jtr.log]
    assert want[1][6] == 0 and want[2][7] > 0      # a repeat, an overlap
    for sync, (tr, views) in runs.items():
        assert [tuple(getattr(r, f) for f in FIELDS) for r in tr.log] \
            == want, f"sync={sync}"
        assert tr.last_table.meta() == jtr.last_table.meta()
        for v, jv in zip(views, jviews):
            src, jsrc = ((v.packed_kv, jv.packed_kv) if packed
                         else (v.kv, jv.kv))
            assert v.layers == (jv.layers if packed else None)
            for p in ("k", "v"):
                np.testing.assert_array_equal(src[p].numpy(),
                                              np.asarray(jsrc[p]))
    # the pool holds one pin per table reference of the last send only
    tr = runs[True][0]
    assert tr.store.stats().pinned_bytes > 0
    tr.release_table()
    assert tr.store.stats().pinned_bytes == 0 and tr.last_table is None


def test_insert_pages_pins_the_table_and_rolls_back():
    """The receiver half of a paged exchange, port and reference side by
    side: shipped pages inserted, the resident remainder pinned; a table
    naming a page neither resident nor shipped raises and leaves no pin
    behind."""
    payloads = _payload("bfloat16", seed=3)
    (jt, jpages), (pt, ppages) = _split(payloads, "int8", 8)
    stores = (jstore.PageStore(page_len=8), PageStore(page_len=8))
    for store, table, pages in zip(stores, (jt, pt), (jpages, ppages)):
        half = len(pages) // 2
        # the first exchange ships every page; a repeat that ships half of
        # them again inserts nothing and pins the whole table
        assert store.insert_pages(table, pages) > 0
        store.release(table)
        assert store.insert_pages(table, pages[half:]) == 0
        store.pin(table)
        assert store.resident_ids(limit=3) == [p.page_id
                                               for p in pages[-3:]]
    assert stores[1].stats().__dict__ == stores[0].stats().__dict__
    assert stores[1].stats().pinned_bytes > 0
    fresh = PageStore(page_len=8)
    with pytest.raises(PagePoolError):
        fresh.insert_pages(pt, ppages[:2])
    assert fresh.stats().pinned_bytes == 0
