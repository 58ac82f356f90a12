"""The port's whisper-medium against the reference: the sinusoid positions,
cross-attention, the encoder-decoder model in train mode, cached prefill
and decode, the KVComm round over whisper's decoder self-attention (dense
and packed, in memory and int8-serialized), share-all against the skyline,
and the refusals (both schedulers, ragged rows). Reduced config at
float32, weights bridged through ``params_from_jax``. Also the kernels'
geometry rules (``ragged_decode.supports``, ``flash_decode.supports``,
``flash_attention.supports``) for every registered config, and K3's
head-group split for G > 8 in its plain decomposition.

Tolerances, stated: sinusoid 1e-6 absolute (positions up to 4,096: the
frequencies take XLA's exp bit for bit, and XLA's and torch's float32 sin
and cos may differ in the last bit); cross-attention 1e-5 and model logits 1e-4 of the reference's
largest |value| (sums in another order); selections, bytes and tokens
identical."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_bridge import as_reference, port_cfg, port_params, t
from repro import core as jcore
from repro.comm import transport as jtransport
from repro.configs.registry import get_config as jget_config
from repro.core.types import KVCommConfig as JKVCommConfig
from repro.models import attention as jattn
from repro.models import layers as jlayers
from repro.models import transformer as jtfm
from repro.serving.scheduler import Scheduler as JScheduler
from repro.comm import Agent as JAgent
from repro.comm import CommSession as JSession
from repro_torch.comm import Agent, CommSession
from repro_torch.comm import transport
from repro_torch.configs.registry import get_config, list_archs
from repro_torch.core import protocol
from repro_torch.core.types import KVCommConfig
from repro_torch.data.tokenizer import SymbolTokenizer
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import flash_decode as fd
from repro_torch.kernels import ragged_decode as rd
from repro_torch.models import attention as attn
from repro_torch.models import layers
from repro_torch.models import transformer as tfm
from repro_torch.serving.scheduler import Scheduler
from repro_torch.weights import params_from_jax, params_to_jax

TOL = 1e-4
NAME = "whisper-medium"
japply = jax.jit(jtfm.apply_model, static_argnums=(1,),
                 static_argnames=("mode", "logits_mode", "decode_backend"))


def _close(got, want, tol=TOL):
    want = np.asarray(want, np.float32)
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got, np.float32)
    assert got.shape == want.shape
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, (err, scale)


@pytest.fixture(scope="module")
def model():
    """(reference cfg, reference params, port cfg, port params)."""
    jcfg = dataclasses.replace(jget_config(NAME).reduced(), dtype="float32")
    jp = jtfm.init_params(jcfg, jax.random.PRNGKey(0))
    return jcfg, jp, port_cfg(jcfg), port_params(jp)


def _tokens(seed, shape, vocab):
    return np.random.default_rng(seed).integers(4, vocab, shape).astype(
        np.int32)


def _frames(cfg, B, seeded=False):
    """tests/test_archs.py::_extra's frames (ones), or seeded ones."""
    shape = (B, cfg.encoder_seq, cfg.d_model)
    fr = (np.random.default_rng(3).standard_normal(shape) if seeded
          else np.ones(shape)).astype(np.float32)
    return {"frames": jnp.asarray(fr)}, {"frames": t(fr)}


# ---------------------------------------------------------------------------
# the config and the modules
# ---------------------------------------------------------------------------
def test_config_and_plan_match_reference():
    ref, cfg = jget_config(NAME), get_config(NAME)
    assert as_reference(cfg, ref) == dataclasses.asdict(ref)
    assert as_reference(cfg.reduced(), ref.reduced()) \
        == dataclasses.asdict(ref.reduced())
    assert (cfg.reduced().encoder_layers, cfg.reduced().encoder_seq) == (2,
                                                                       16)
    for c, r in ((cfg, ref), (cfg.reduced(), ref.reduced())):
        assert [dataclasses.asdict(s) for s in c.layer_plan()] \
            == [dataclasses.asdict(s) for s in r.layer_plan()]
        assert [dataclasses.asdict(s) for s in tfm.encoder_specs(c)] \
            == [dataclasses.asdict(s) for s in r.encoder_plan()] \
            * c.encoder_layers
        assert tfm.mlp_type(c) == jtfm.mlp_type(r) == "gelu"


@pytest.mark.parametrize("d", [64, 1024])
def test_sinusoid_positions_match(d):
    pos = np.concatenate([np.arange(64), [447, 448, 1499, 4095]]).astype(
        np.int32)
    want = np.asarray(jlayers.sinusoid_positions(jnp.asarray(pos), d))
    got = layers.sinusoid_positions(t(pos), d)
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=0)


def test_cross_attention_and_cross_kv_match(model):
    jcfg, jp, cfg, p = model
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, cfg.d_model)).astype(np.float32)
    enc = rng.standard_normal((2, cfg.encoder_seq, cfg.d_model)).astype(
        np.float32)
    jx = jax.tree.map(lambda a: a[0], jp["blocks"][0]["xattn"])
    px = p["layers"][0]["xattn"]
    jk, jv = jattn.cross_kv(jx, jcfg, jnp.asarray(enc))
    k, v = attn.cross_kv(px, cfg, t(enc))
    _close(k, jk, 1e-5)
    _close(v, jv, 1e-5)
    want = jattn.cross_attention(jx, jcfg, jnp.asarray(x), jk, jv)
    _close(attn.cross_attention(px, cfg, t(x), k, v), want, 1e-5)


def test_port_init_shapes_match_reference():
    """The port's own init gives the reference's shapes and dtypes, the
    encoder and every layer's ``xattn`` included."""
    jcfg = jget_config(NAME).reduced()
    want = params_to_jax(port_params(jtfm.init_params(
        jcfg, jax.random.PRNGKey(0))), port_cfg(jcfg))
    got = params_to_jax(tfm.init_params(port_cfg(jcfg), 0, device="cpu"),
                        port_cfg(jcfg))
    shapes = lambda tree: jax.tree.map(  # noqa: E731
        lambda a: (a.shape, a.dtype.str), tree)
    assert shapes(got) == shapes(want)
    assert set(got["encoder"]) == {"blocks", "final_norm"}
    assert {"ln_x", "xattn"} <= set(got["blocks"][0])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_params_bridge_round_trip(dtype):
    """params_to_jax inverts params_from_jax bit for bit, the encoder and
    the cross-attention weights included, at float32 and bf16."""
    jcfg = dataclasses.replace(jget_config(NAME).reduced(), dtype=dtype)
    jp = jax.tree.map(np.asarray, jtfm.init_params(jcfg,
                                                   jax.random.PRNGKey(2)))
    p = params_from_jax(jp, device="cpu")
    assert len(p["encoder"]["layers"]) == jcfg.encoder_layers
    assert p["layers"][0]["xattn"]["wq"].dtype == getattr(torch, dtype)
    back = params_to_jax(p, port_cfg(jcfg))
    la, lb = jax.tree.leaves(jp), jax.tree.leaves(back)
    assert len(la) == len(lb)
    for a, b in zip(la, lb):
        assert a.shape == b.shape
        assert a.view(np.uint8).tobytes() == b.view(np.uint8).tobytes()


# ---------------------------------------------------------------------------
# the model (the counterpart of tests/test_archs.py::TestArchSmoke)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("seeded", [False, True])
def test_reduced_forward_prefill_and_decode(model, seeded):
    """Train mode, cached prefill and 4 decode steps (the plain backend
    and the kernel's, its plain version on the CPU): the decode reuses the
    cached cross KV."""
    jcfg, jp, cfg, p = model
    B, S = 2, 16
    toks = _tokens(0, (B, S), cfg.vocab_size)
    jx, x = _frames(cfg, B, seeded)
    want = japply(jp, jcfg, jnp.asarray(toks), mode="train", extra=jx)
    got = tfm.apply_model(p, cfg, t(toks).long(), mode="train", extra=x)
    _close(got.logits, want.logits)
    jo = japply(jp, jcfg, jnp.asarray(toks), mode="cached",
                cache=jtfm.init_cache(jcfg, B, S + 4), extra=jx)
    caches = {}
    for backend in ("reference", "kernel"):
        o = tfm.apply_model(p, cfg, t(toks).long(), mode="cached",
                            cache=tfm.init_cache(cfg, B, S + 4,
                                                 device="cpu"), extra=x)
        _close(o.logits, jo.logits)
        assert o.cache["layers"][0]["xk"].shape == (
            B, cfg.encoder_seq, cfg.num_kv_heads, cfg.resolved_head_dim)
        caches[backend] = o.cache
    jcache = jo.cache
    tok = np.argmax(np.asarray(jo.logits[:, -1:]), -1).astype(np.int32)
    for _ in range(4):
        jo = japply(jp, jcfg, jnp.asarray(tok), mode="cached", cache=jcache)
        for backend, cache in caches.items():
            o = tfm.apply_model(p, cfg, t(tok).long(), mode="cached",
                                cache=cache, decode_backend=backend)
            _close(o.logits, jo.logits)
            caches[backend] = o.cache
        jcache = jo.cache
        tok = np.argmax(np.asarray(jo.logits[:, -1:]), -1).astype(np.int32)


def test_frames_are_needed_where_the_encoder_is_read(model):
    _, _, cfg, p = model
    toks = t(_tokens(0, (1, 4), cfg.vocab_size)).long()
    with pytest.raises(ValueError, match="frames"):
        tfm.apply_model(p, cfg, toks, mode="train")
    with pytest.raises(ValueError, match="frames"):
        tfm.apply_model(p, cfg, toks, mode="cached",
                        cache=tfm.init_cache(cfg, 1, 8, device="cpu"))


# ---------------------------------------------------------------------------
# the KVComm round over the decoder's self-attention
# ---------------------------------------------------------------------------
def _round(jcfg, jp, cfg, p, transports, B=2, Sc=12, Sq=6):
    ctx = _tokens(1, (B, Sc), cfg.vocab_size)
    qry = _tokens(2, (B, Sq), cfg.vocab_size)
    jx, x = _frames(cfg, B, seeded=True)
    jkv, _ = jcore.sender_prefill(jp, jcfg, jnp.asarray(ctx), extra=jx)
    kv, _ = protocol.sender_prefill(p, cfg, t(ctx).long(), extra=x)
    return ctx, qry, jx, x, jkv, kv


def test_extract_kv_holds_self_attention_only(model):
    """The sender's KV is the decoder self-attention's (L, B, Sc, Hkv,
    Dh); the cross KV never crosses a wire."""
    jcfg, jp, cfg, p = model
    _, _, _, _, jkv, kv = _round(jcfg, jp, cfg, p, None)
    assert set(kv) == {"k", "v"}
    assert tuple(kv["k"].shape) == (cfg.attn_layer_count, 2, 12,
                                    cfg.num_kv_heads, cfg.resolved_head_dim)
    _close(kv["k"], jkv["k"])
    _close(kv["v"], jkv["v"])


@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("wire", ["memory", "int8"])
def test_kvcomm_round_matches_reference(model, packed, wire):
    """sender_prefill(frames) -> calibrate -> selection -> send ->
    receiver_prefill(frames) -> 3 decode steps: scores within TOL,
    selection and bytes identical, logits within TOL."""
    jcfg, jp, cfg, p = model
    ctx, qry, jx, x, jkv, kv = _round(jcfg, jp, cfg, p, None)
    jscores = jcore.calibrate(jp, jcfg, jnp.asarray(qry[:1]),
                              jax.tree.map(lambda a: a[:, :1], jkv),
                              extra={"frames": jx["frames"][:1]})
    scores = protocol.calibrate(p, cfg, t(qry[:1]).long(),
                                {k: v[:, :1] for k, v in kv.items()},
                                extra={"frames": x["frames"][:1]})
    _close(scores, jscores)
    kw = dict(ratio=0.5, alpha=0.7)
    jsel = jcore.make_selection(jcfg, JKVCommConfig(**kw), jscores)
    sel = protocol.make_selection(cfg, KVCommConfig(**kw),
                                  torch.from_numpy(np.asarray(jscores)))
    np.testing.assert_array_equal(sel.numpy(), np.asarray(jsel))
    if wire == "memory":
        jtr = jtransport.InMemoryTransport(packed=packed)
        tr = transport.InMemoryTransport(packed=packed)
    else:
        jtr = jtransport.SerializedTransport("int8", packed=packed)
        tr = transport.SerializedTransport("int8", packed=packed)
    jsh = jtr.send(jcfg, JKVCommConfig(**kw), jkv, jsel)
    sh = tr.send(cfg, KVCommConfig(**kw), kv, sel)
    assert sh.is_packed == jsh.is_packed == packed
    assert tr.total_bytes == jtr.total_bytes
    jo = jcore.receiver_prefill(jp, jcfg, jnp.asarray(qry), jsh, max_new=3,
                                extra=jx)
    o = protocol.receiver_prefill(p, cfg, t(qry).long(), sh, max_new=3,
                                  extra=x)
    _close(o.logits, jo.logits)
    jcache, cache = jo.cache, o.cache
    tok = np.argmax(np.asarray(jo.logits[:, -1:]), -1).astype(np.int32)
    for _ in range(3):
        jtok, jlg, jcache = jcore.decode_step(jp, jcfg, jnp.asarray(tok),
                                              jcache, jsh)
        ntok, lg, cache = protocol.decode_step(p, cfg, t(tok).long(), cache,
                                               sh, backend="kernel")
        _close(lg, jlg)
        tok = np.asarray(jtok).astype(np.int32)


def test_share_all_equals_skyline(model):
    """Every layer shared, the same frames on both sides: the receiver's
    last-position logits equal the train-mode forward over [C; Q] (the
    decoder positions continue from the prefix through the sinusoid)."""
    jcfg, jp, cfg, p = model
    ctx, qry, jx, x, jkv, kv = _round(jcfg, jp, cfg, p, None)
    L = cfg.attn_layer_count
    shared = protocol.build_shared(KVCommConfig(), kv,
                                   torch.ones(L, dtype=torch.bool))
    got = protocol.receiver_prefill(p, cfg, t(qry).long(), shared,
                                    max_new=0, extra=x).logits[:, -1]
    sky = tfm.apply_model(p, cfg, t(np.concatenate([ctx, qry], 1)).long(),
                          mode="train", extra=x).logits[:, -1]
    _close(got, sky.detach())
    want = japply(jp, jcfg, jnp.asarray(np.concatenate([ctx, qry], 1)),
                  mode="train", extra=jx).logits[:, -1]
    _close(got, want)


# ---------------------------------------------------------------------------
# refusals
# ---------------------------------------------------------------------------
def test_schedulers_refuse_whisper(model):
    """Both packages' schedulers refuse an audio model with
    cross-attention (the reference by assertion, the port by a
    ValueError naming the reason)."""
    jcfg, jp, cfg, p = model
    tok = SymbolTokenizer(16, 8)
    jcfg = dataclasses.replace(jcfg, vocab_size=max(jcfg.vocab_size,
                                                    tok.vocab_size))
    cfg = port_cfg(jcfg)
    jsess = JSession(JAgent("s", jcfg, jp, tok), JAgent("r", jcfg, jp, tok))
    sess = CommSession(Agent("s", cfg, p, tok), Agent("r", cfg, p, tok))
    with pytest.raises(AssertionError):
        JScheduler(jsess, JKVCommConfig(selector="prior_only"))
    with pytest.raises(ValueError, match="cross-attention|RoPE"):
        Scheduler(sess, KVCommConfig(selector="prior_only"))


def test_ragged_rows_raise(model):
    jcfg, jp, cfg, p = model
    B = 2
    kv = {k: torch.zeros((cfg.attn_layer_count, B, 4, cfg.num_kv_heads,
                          cfg.resolved_head_dim)) for k in ("k", "v")}
    shared = protocol.build_shared(KVCommConfig(), kv,
                                   torch.ones(cfg.attn_layer_count,
                                              dtype=torch.bool))
    _, x = _frames(cfg, B)
    toks = t(_tokens(0, (B, 3), cfg.vocab_size)).long()
    with pytest.raises(ValueError, match="RoPE"):
        protocol.receiver_prefill(p, cfg, toks, shared, max_new=2, extra=x,
                                  prefix_lens=torch.tensor([4, 3]))
    cache = tfm.init_cache(cfg, B, 8, device="cpu")
    cache["len"] = torch.tensor([3, 2])
    with pytest.raises(ValueError, match="RoPE"):
        tfm.apply_model(p, cfg, toks[:, :1], mode="cached", cache=cache)
    jkv = jax.tree.map(lambda a: jnp.asarray(a.numpy()), kv)
    jshared = jcore.build_shared(JKVCommConfig(), jkv,
                                 jnp.ones((cfg.attn_layer_count,), bool))
    jx, _ = _frames(cfg, B)
    with pytest.raises(AssertionError):
        jtfm.apply_model(jp, jcfg, jnp.asarray(toks.numpy()), mode="cached",
                         cache=jtfm.init_cache(jcfg, B, 5, shared=jshared),
                         shared=jshared, extra=jx,
                         prefix_lens=jnp.asarray([4, 3]))


# ---------------------------------------------------------------------------
# the kernels' geometry rules (F7, F8) and K3's head groups
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", sorted(set(list_archs()) - {"rwkv6-1.6b"}))
def test_decode_kernels_support_every_config(name):
    """K1 and K3 take the (G, D) of every registered attention config at
    its own dtype and at float32 (whisper's MHA at D 64, starcoder2's G 9
    included); K2 too (every D is a multiple of 16)."""
    cfg = get_config(name)
    G = cfg.num_heads // cfg.num_kv_heads
    for dt in (getattr(torch, cfg.dtype), torch.float32):
        for mod in (rd, fd, fa):
            assert mod.supports(G, cfg.resolved_head_dim, dt), (mod, G, dt)


def test_supports_bounds():
    for mod in (rd, fd, fa):
        assert mod.supports(16, 64, torch.float16)
        assert mod.supports(9, 128, torch.bfloat16)
        assert mod.supports(64, 256, torch.float32)
        assert not mod.supports(0, 128, torch.bfloat16)
        assert not mod.supports(4, 288, torch.bfloat16)
        assert not mod.supports(4, 128, torch.int8)
    assert not fa.supports(2, 24, torch.bfloat16)       # tensor-core k-step
    assert fa.supports(2, 24, torch.float32)
    assert fd.supports(2, 24, torch.bfloat16)           # staged rows


@pytest.mark.parametrize("G", [9, 16])
@pytest.mark.parametrize("window", [None, 37])
def test_flash_decode_split_takes_any_group(G, window):
    """K3's chunked decomposition (the kernel's arithmetic) at G 9 and 16
    against the plain versions, normalised and partials."""
    g = torch.Generator().manual_seed(G)
    B, S, Hkv, D = 3, 300, 2, 32
    q = torch.randn(B, G * Hkv, D, generator=g)
    k = torch.randn(B, S, Hkv, D, generator=g)
    v = torch.randn(B, S, Hkv, D, generator=g)
    kv_len = torch.tensor([0, 171, 300], dtype=torch.int32)
    want = fd.flash_decode_reference(q, k, v, kv_len, window=window)
    got = fd.decode_split_reference(q, k, v, kv_len, window=window, chunk=64)
    torch.testing.assert_close(got, want, atol=2e-5, rtol=2e-5)
    ro, rm, rl = fd.decode_partial_reference(q, k, v, kv_len, window=window)
    o, m, l = fd.decode_split_reference(q, k, v, kv_len, window=window,
                                        chunk=64, partials=True)
    live = rl > 0
    torch.testing.assert_close(m[live], rm[live], atol=2e-5, rtol=2e-5)
    scale = torch.exp(m - rm)[..., None]
    torch.testing.assert_close((o * scale)[live], ro[live], atol=2e-5,
                               rtol=2e-5)
