"""The port's decoder-only attention models against the reference: the
seven configs of the registry beyond the pair (gemma3-4b's local/global
windows, olmoe-1b-7b's and mixtral-8x22b's MoE, mixtral's sliding window
and ring cache, starcoder2-7b's gelu MLP, pixtral-12b's stub patches,
internlm2-20b, qwen1.5-110b's QKV bias), their reduced variants at
float32 with weights bridged through ``params_from_jax``; the windowed
and chunked attention cores; the weight bridge of MoE runs; the KVComm
round and both schedulers on reduced gemma3 (windows under a prefix) and
olmoe (MoE in the ragged step); K1's geometry rule for every config.

Tolerance, stated: logits within TOL of the reference's largest |logit|
(XLA and torch sum in other orders; float32). Tokens and selections are
identical; predictions identical wherever the reference's top-2 margin is
at least MARGIN."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_bridge import as_reference, port_cfg, port_params, t
from repro.comm import Agent as JAgent
from repro.comm import CommSession as JSession
from repro.configs.registry import get_config as jget_config
from repro.core import protocol as jprotocol
from repro.core.types import KVCommConfig as JKVCommConfig
from repro.data.synthetic import SyntheticTask, TaskConfig
from repro.models import layers as jlayers
from repro.models import transformer as jtfm
from repro.serving.scheduler import Request as JRequest
from repro.serving.scheduler import Scheduler as JScheduler
from repro.serving.scheduler import SchedulerConfig as JSchedulerConfig
from repro_torch.comm import Agent, CommSession
from repro_torch.configs.registry import (get_config, list_archs,
                                          reference_archs)
from repro_torch.core import protocol
from repro_torch.core.types import KVCommConfig
from repro_torch.kernels import ragged_decode as rd
from repro_torch.models import layers
from repro_torch.models import transformer as tfm
from repro_torch.serving.scheduler import (Scheduler, SchedulerConfig,
                                           make_requests)
from repro_torch.weights import params_from_jax

TOL = 1e-4
MARGIN = 1e-3
ARCHS = ["gemma3-4b", "olmoe-1b-7b", "starcoder2-7b", "pixtral-12b",
         "internlm2-20b", "mixtral-8x22b", "qwen1.5-110b"]
KEY = jax.random.PRNGKey(0)
# the reference's forward, compiled once per shape (eager, its layer scans
# would trace again on every call)
japply = jax.jit(jtfm.apply_model, static_argnums=(1,),
                 static_argnames=("mode", "logits_mode"))


def _close(got, want, tol=TOL):
    want = np.asarray(want, np.float32)
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got, np.float32)
    assert got.shape == want.shape
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, (err, scale)


def _jcfg(name, **kw):
    return dataclasses.replace(jget_config(name).reduced(),
                               **{"dtype": "float32", **kw})


def _pair(jcfg, key=KEY):
    jp = jtfm.init_params(jcfg, key)
    return jp, port_cfg(jcfg), port_params(jp)


def _tokens(seed, shape, vocab):
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(
        np.int32)


def _patches(cfg, B, seed=1):
    """Seeded stub patch embeddings for a VLM (None otherwise)."""
    if not cfg.num_patches:
        return None, None
    pe = np.random.default_rng(seed).standard_normal(
        (B, cfg.num_patches, cfg.d_model)).astype(np.float32)
    return {"patches": jnp.asarray(pe)}, {"patches": t(pe)}


# ---------------------------------------------------------------------------
# the configs
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", ARCHS)
def test_config_and_plan_match_reference(name):
    ref, cfg = jget_config(name), get_config(name)
    assert as_reference(cfg, ref) == dataclasses.asdict(ref)
    assert as_reference(cfg.reduced(), ref.reduced()) \
        == dataclasses.asdict(ref.reduced())
    for c, r in ((cfg, ref), (cfg.reduced(), ref.reduced())):
        assert [dataclasses.asdict(s) for s in c.layer_plan()] \
            == [dataclasses.asdict(s) for s in r.layer_plan()]
        assert c.attn_layer_count == r.attn_layer_count
        assert tfm.mlp_type(c) == jtfm.mlp_type(r)


def test_registry_holds_every_decoder_and_names_whisper():
    """Every config of the reference is registered, whisper-medium
    included (it was refused before its encoder and cross-attention were
    ported, and the model refused it); an unknown name raises KeyError
    listing the known ones."""
    assert set(ARCHS) < set(list_archs())
    assert len(list_archs()) == 12
    assert set(list_archs()) - set(reference_archs()) == {"mellum2-12b"}
    assert as_reference(get_config("whisper-medium"),
                        jget_config("whisper-medium")) == \
        dataclasses.asdict(jget_config("whisper-medium"))
    with pytest.raises(KeyError, match="whisper-medium"):
        get_config("gpt-7")
    cfg = get_config("whisper-medium").reduced()
    p = tfm.init_params(cfg, 0, device="cpu")
    assert len(p["encoder"]["layers"]) == cfg.encoder_layers
    assert "xk" in tfm.init_cache(cfg, 1, 4, device="cpu")["layers"][0]


# ---------------------------------------------------------------------------
# the models: train, cached prefill, decode (the counterparts of
# tests/test_archs.py::TestArchSmoke::test_reduced_forward_and_decode)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", ARCHS)
def test_reduced_forward_prefill_and_decode(name):
    jcfg = _jcfg(name)
    jp, cfg, p = _pair(jcfg)
    B, S = 2, 16
    toks = _tokens(0, (B, S), cfg.vocab_size)
    jx, x = _patches(cfg, B)
    want = japply(jp, jcfg, jnp.asarray(toks), mode="train",
                            extra=jx)
    got = tfm.apply_model(p, cfg, t(toks).long(), mode="train", extra=x)
    _close(got.logits, want.logits)
    assert abs(float(got.aux_loss) - float(want.aux_loss)) <= 1e-6
    jo = japply(jp, jcfg, jnp.asarray(toks), mode="cached",
                          cache=jtfm.init_cache(jcfg, B, S + 4), extra=jx)
    o = tfm.apply_model(p, cfg, t(toks).long(), mode="cached",
                        cache=tfm.init_cache(cfg, B, S + 4, device="cpu"),
                        extra=x)
    _close(o.logits, jo.logits)
    _close(o.logits, got.logits)          # the cache is right
    for _ in range(4):
        nxt = np.asarray(jnp.argmax(jo.logits[:, -1:], -1), np.int32)
        jo = japply(jp, jcfg, jnp.asarray(nxt), mode="cached",
                              cache=jo.cache, logits_mode="last")
        o = tfm.apply_model(p, cfg, t(nxt).long(), mode="cached",
                            cache=o.cache, logits_mode="last")
        _close(o.logits, jo.logits)
    assert o.cache["len"] == int(jo.cache["len"]) == S + 4


def test_decode_matches_prefill_dense():
    """gemma3 (local window 8, one global layer): prefill 12 tokens, then
    4 one at a time, against the one-shot logits, in the port and the
    reference alike."""
    jcfg = _jcfg("gemma3-4b")
    jp, cfg, p = _pair(jcfg)
    B, S = 1, 12
    toks = _tokens(3, (B, S + 4), cfg.vocab_size)
    jfull = japply(jp, jcfg, jnp.asarray(toks), mode="train")
    full = tfm.apply_model(p, cfg, t(toks).long(), mode="train")
    _close(full.logits, jfull.logits)
    cache = tfm.apply_model(p, cfg, t(toks[:, :S]).long(), mode="cached",
                            cache=tfm.init_cache(cfg, B, S + 8,
                                                 device="cpu")).cache
    for i in range(4):
        o = tfm.apply_model(p, cfg, t(toks[:, S + i:S + i + 1]).long(),
                            mode="cached", cache=cache)
        cache = o.cache
        _close(o.logits[:, -1], jfull.logits[:, S + i])


def test_ring_cache_decode():
    """mixtral (window 8): the ring buffer against the full cache over 9
    decode steps past a 20-token prefill, in the port and against the
    reference's ring; the buffer is the window."""
    jcfg0 = _jcfg("mixtral-8x22b")
    assert jcfg0.sliding_window == 8
    jp, cfg0, p = _pair(jcfg0)
    B, S, steps = 1, 20, 9
    toks = _tokens(4, (B, S + steps), cfg0.vocab_size)

    def run_port(cfg):
        o = tfm.apply_model(p, cfg, t(toks[:, :S]).long(), mode="cached",
                            cache=tfm.init_cache(cfg, B, S + steps,
                                                 device="cpu"))
        logits, cache = [o.logits[:, -1]], o.cache
        for i in range(steps):
            o = tfm.apply_model(p, cfg, t(toks[:, S + i:S + i + 1]).long(),
                                mode="cached", cache=cache)
            cache = o.cache
            logits.append(o.logits[:, -1])
        return torch.stack(logits)

    def run_ref(cfg):
        o = japply(jp, cfg, jnp.asarray(toks[:, :S]),
                             mode="cached",
                             cache=jtfm.init_cache(cfg, B, S + steps))
        logits, cache = [o.logits[:, -1]], o.cache
        for i in range(steps):
            o = japply(jp, cfg, jnp.asarray(toks[:, S + i:S + i
                                                           + 1]),
                                 mode="cached", cache=cache)
            cache = o.cache
            logits.append(o.logits[:, -1])
        return jnp.stack(logits)

    ring_cfg = dataclasses.replace(cfg0, ring_cache=True)
    ring = run_port(ring_cfg)
    _close(ring, run_port(cfg0))
    _close(ring, run_ref(dataclasses.replace(jcfg0, ring_cache=True)))
    cache = tfm.init_cache(ring_cfg, B, 26, device="cpu")
    assert cache["layers"][0]["k"].shape[1] == 8
    assert all(e["ring"] for e in cache["layers"])


def test_extract_kv_refuses_a_ring_buffer():
    """A ring holds the last window positions in slot order: sharing it as
    a prefix raises; a context within the window has no ring and
    shares."""
    cfg = dataclasses.replace(port_cfg(_jcfg("mixtral-8x22b")),
                              ring_cache=True)
    p = tfm.init_params(cfg, 0, device="cpu")
    long_ctx = torch.from_numpy(_tokens(5, (1, 12), cfg.vocab_size)).long()
    with pytest.raises(ValueError, match="ring buffer"):
        protocol.sender_prefill(p, cfg, long_ctx)
    kv, _ = protocol.sender_prefill(p, cfg, long_ctx[:, :8])
    assert kv["k"].shape[2] == 8


@pytest.mark.parametrize("name", ["gemma3-4b", "olmoe-1b-7b"])
def test_chunked_core_model_matches(name):
    """attn_impl="chunked" (query blocks of 8 over 16 positions): train and
    cached prefill against the reference's chunked model and the port's
    plain one, and the Eq. (1) masses of a shared prefill."""
    jcfg = _jcfg(name, attn_impl="chunked", attn_block_q=8)
    jp, cfg, p = _pair(jcfg)
    plain = dataclasses.replace(cfg, attn_impl="xla")
    toks = _tokens(6, (2, 16), cfg.vocab_size)
    want = japply(jp, jcfg, jnp.asarray(toks), mode="train")
    got = tfm.apply_model(p, cfg, t(toks).long(), mode="train")
    _close(got.logits, want.logits)
    _close(got.logits, tfm.apply_model(p, plain, t(toks).long(),
                                       mode="train").logits)
    ctx = _tokens(7, (2, 9), cfg.vocab_size)
    jkv, _ = jprotocol.sender_prefill(jp, jcfg, jnp.asarray(ctx))
    kv, _ = protocol.sender_prefill(p, cfg, t(ctx).long())
    _close(kv["k"], jkv["k"])
    jout = jprotocol._receiver_prefill_jit(
        jp, jcfg, jnp.asarray(toks), jprotocol.build_shared(
            JKVCommConfig(), jkv, jnp.ones((jcfg.attn_layer_count,), bool)),
        0, None, collect_mass=True)
    out = protocol.receiver_prefill(
        p, cfg, t(toks).long(), protocol.build_shared(
            KVCommConfig(), kv, torch.ones(cfg.attn_layer_count,
                                           dtype=torch.bool)),
        max_new=0, collect_mass=True)
    _close(out.logits, jout.logits)
    np.testing.assert_allclose(out.masses.numpy(), np.asarray(jout.masses),
                               atol=1e-5, rtol=1e-4)


# ---------------------------------------------------------------------------
# the attention cores and the gelu MLP
# ---------------------------------------------------------------------------
def _qkv(seed, B, Sq, Skv, Hq, Hkv, D):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32)
            for s in ((B, Sq, Hq, D), (B, Skv, Hkv, D), (B, Skv, Hkv, D))]


@pytest.mark.parametrize("window", [None, 1, 5, 64])
@pytest.mark.parametrize("ragged", [False, True])
def test_attention_core_window_matches(window, ragged):
    """A window over a prefix and self region, per-row positions when
    ragged, kv_valid and the Eq. (1) mass."""
    B, Sq, Skv, Hq, Hkv, D = 2, 6, 20, 4, 2, 8
    q, k, v = _qkv(1, B, Sq, Skv, Hq, Hkv, D)
    if ragged:
        q_pos = np.stack([np.arange(9, 15), np.arange(12, 18)])
        kv_pos = np.stack([np.arange(Skv), np.arange(Skv) + 1])
    else:
        q_pos, kv_pos = np.arange(14, 20), np.arange(Skv)
    valid = np.ones((Skv,), bool)
    valid[3] = False
    mass = np.arange(Skv) < 8
    kw = dict(causal=True, window=window)
    want, wm = jlayers.attention_core(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        q_pos=jnp.asarray(q_pos), kv_pos=jnp.asarray(kv_pos),
        kv_valid=jnp.asarray(valid), mass_mask=jnp.asarray(mass), **kw)
    got, gm = layers.attention_core(
        t(q), t(k), t(v), q_pos=t(q_pos), kv_pos=t(kv_pos),
        kv_valid=t(valid), mass_mask=t(mass), **kw)
    _close(got, want)
    np.testing.assert_allclose(gm.numpy(), np.asarray(wm), atol=1e-6,
                               rtol=1e-5)


@pytest.mark.parametrize("Sq,blk_q,window", [(16, 4, None), (16, 4, 3),
                                             (12, 8, None), (8, 8, 2)])
def test_attention_core_chunked_matches(Sq, blk_q, window):
    """Query blocks (Sq a multiple of blk_q larger than it) or the plain
    core's fallback; the mass is the mean over blocks."""
    B, Skv, Hq, Hkv, D = 2, Sq + 6, 4, 2, 8
    q, k, v = _qkv(2, B, Sq, Skv, Hq, Hkv, D)
    q_pos, kv_pos = np.arange(6, 6 + Sq), np.arange(Skv)
    mass = np.arange(Skv) < 6
    kw = dict(causal=True, window=window, blk_q=blk_q)
    want, wm = jlayers.attention_core_chunked(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        q_pos=jnp.asarray(q_pos), kv_pos=jnp.asarray(kv_pos),
        mass_mask=jnp.asarray(mass), **kw)
    got, gm = layers.attention_core_chunked(
        t(q), t(k), t(v), q_pos=t(q_pos), kv_pos=t(kv_pos),
        mass_mask=t(mass), **kw)
    _close(got, want)
    np.testing.assert_allclose(gm.numpy(), np.asarray(wm), atol=1e-6,
                               rtol=1e-5)
    plain, pm = layers.attention_core(
        t(q), t(k), t(v), q_pos=t(q_pos), kv_pos=t(kv_pos),
        mass_mask=t(mass), causal=True, window=window)
    _close(got, plain.numpy())
    np.testing.assert_allclose(gm.numpy(), pm.numpy(), atol=1e-6,
                               rtol=1e-5)


def test_gelu_mlp_matches():
    """starcoder-style gelu MLP (w_up, w_down only; the tanh form that
    ``jax.nn.gelu`` defaults to)."""
    jp = jlayers.init_mlp(KEY, 32, 64, jnp.float32, "gelu")
    assert set(jp) == {"w_up", "w_down"}
    p = {k: t(v) for k, v in jp.items()}
    x = np.random.default_rng(3).standard_normal((2, 5, 32)).astype(
        np.float32) * 3
    _close(layers.apply_mlp(p, t(x), "gelu"),
           jlayers.apply_mlp(jp, jnp.asarray(x), "gelu"))
    # the exact (erf) gelu is another function: the approximation matters
    exact = torch.nn.functional.gelu(t(x) @ p["w_up"]) @ p["w_down"]
    assert float((exact - layers.apply_mlp(p, t(x), "gelu")).abs().max()) \
        > 1e-4


# ---------------------------------------------------------------------------
# the weight bridge
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_params_bridge_moe_runs_bias_and_router(dtype):
    """olmoe's MoE runs, nested and flat, at float32 and bf16, with and
    without ``dtype=``: the router stays float32; qwen1.5's q/k/v biases
    and starcoder2's gelu matrices cross key by key."""
    from repro.training.checkpoint import _flatten
    jcfg = _jcfg("olmoe-1b-7b", dtype=dtype)
    jp = jtfm.init_params(jcfg, KEY)
    nested = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    flat = params_from_jax(_flatten(jp), device="cpu")
    cast = params_from_jax(_flatten(jp), device="cpu", dtype=torch.float16)
    for p in (nested, flat, cast):
        assert len(p["layers"]) == 2
        moe = p["layers"][1]["moe"]
        assert set(moe) == {"router", "w_gate", "w_up", "w_down"}
        assert moe["router"].dtype == torch.float32
        assert moe["w_gate"].shape == (4, 128, 256)
        assert moe["w_down"].shape == (4, 256, 128)
    assert cast["layers"][0]["moe"]["w_up"].dtype == torch.float16
    assert nested["layers"][0]["moe"]["w_up"].dtype == getattr(torch, dtype)
    for a, b in zip(nested["layers"], flat["layers"]):
        for k in a["moe"]:
            assert torch.equal(a["moe"][k], b["moe"][k])
    np.testing.assert_array_equal(
        nested["layers"][1]["moe"]["router"].numpy(),
        np.asarray(jp["blocks"][0]["moe"]["router"][1]))
    # qwen1.5: the biases cross (made nonzero here so a dropped one shows)
    jq = jtfm.init_params(_jcfg("qwen1.5-110b"), KEY)
    jq["blocks"][0]["attn"]["bk"] = jnp.full_like(
        jq["blocks"][0]["attn"]["bk"], 0.5)
    q = params_from_jax(_flatten(jq), device="cpu")
    assert {"bq", "bk", "bv"} <= set(q["layers"][1]["attn"])
    assert float(q["layers"][1]["attn"]["bk"][0]) == 0.5
    js = jtfm.init_params(_jcfg("starcoder2-7b"), KEY)
    s = params_from_jax(_flatten(js), device="cpu")
    assert set(s["layers"][0]["mlp"]) == {"w_up", "w_down"}


def test_port_init_shapes_match_reference():
    """The port's own init gives the reference's parameter shapes and
    dtypes (the router float32 in a bf16 model)."""
    for name in ("olmoe-1b-7b", "starcoder2-7b", "qwen1.5-110b"):
        jcfg = dataclasses.replace(jget_config(name).reduced())
        cfg = port_cfg(jcfg)
        want = port_params(jtfm.init_params(jcfg, KEY))
        got = tfm.init_params(cfg, 0, device="cpu")
        for a, b in zip(jax.tree.leaves(jax.tree.map(
                lambda x: (tuple(x.shape), x.dtype), got,
                is_leaf=torch.is_tensor)), jax.tree.leaves(jax.tree.map(
                lambda x: (tuple(x.shape), x.dtype), want,
                is_leaf=torch.is_tensor))):
            assert a == b


# ---------------------------------------------------------------------------
# the KVComm round and the schedulers
# ---------------------------------------------------------------------------
def _session_pair(name, tok):
    jcfg = _jcfg(name, vocab_size=tok.vocab_size)
    js = jtfm.init_params(jcfg, jax.random.PRNGKey(0))
    jr = jtfm.init_params(jcfg, jax.random.PRNGKey(1))
    cfg = port_cfg(jcfg)
    return (JSession(JAgent("s", jcfg, js, tok), JAgent("r", jcfg, jr, tok)),
            CommSession(Agent("s", cfg, port_params(js), tok),
                        Agent("r", cfg, port_params(jr), tok)))


@pytest.mark.parametrize("name", ["gemma3-4b", "olmoe-1b-7b"])
def test_kvcomm_run_matches_reference(tok, name):
    """``run("kvcomm")`` on the reference's Eq. (1) scores: bytes, FLOPs,
    M and the selection identical; predictions under the margin rule, the
    rest within TOL."""
    jsess, sess = _session_pair(name, tok)
    batch = SyntheticTask(tok, TaskConfig("retrieval", num_facts=8,
                                          seed=5)).batch(3)
    assert batch["context"].shape[1] > 8        # windows bite
    scores = np.array(jsess.calibrate(batch["context"][:1],
                                      batch["query"][:1]))
    _close(sess.calibrate(batch["context"][:1], batch["query"][:1]), scores)
    logits = {}
    for key, agent in (("ref", jsess.receiver), ("port", sess.receiver)):
        predict = agent.predict_last

        def recorded(lg, key=key, predict=predict):
            logits[key] = np.asarray(lg, np.float32)[:, -1]
            return predict(lg)
        agent.predict_last = recorded
    kw = dict(ratio=0.5, alpha=0.7)
    want = jsess.run("kvcomm", batch, kvcfg=JKVCommConfig(**kw),
                     scores=jnp.asarray(scores))
    got = sess.run("kvcomm", batch, kvcfg=KVCommConfig(**kw),
                   scores=torch.from_numpy(scores))
    assert (got.wire_bytes, got.flops) == (want.wire_bytes, want.flops)
    assert got.extras["M"] == want.extras["M"]
    np.testing.assert_array_equal(got.extras["select"],
                                  np.asarray(want.extras["select"]))
    _close(logits["port"], logits["ref"])
    top2 = np.sort(logits["ref"], axis=-1)[:, -2:]
    clear = top2[:, 1] - top2[:, 0] >= MARGIN
    np.testing.assert_array_equal(got.preds[clear],
                                  np.asarray(want.preds)[clear])


@pytest.mark.parametrize("name", ["gemma3-4b", "olmoe-1b-7b"])
def test_schedulers_match_reference(tok, name):
    """The port's Scheduler on the kernel backend (its plain version on the
    CPU) against the reference's Scheduler, token for token: ragged
    contexts longer than gemma3's local window under a prefix, olmoe's
    MoE in the ragged step."""
    jsess, sess = _session_pair(name, tok)
    batches = [SyntheticTask(tok, TaskConfig("retrieval", num_facts=nf,
                                             seed=11 + nf)).batch(2)
               for nf in (4, 8)]
    reqs = make_requests(batches, pad=tok.PAD)
    for i, r in enumerate(reqs):
        r.max_new = (4, 2, 3)[i % 3]
    kv = dict(ratio=0.5, selector="prior_only")
    sched = dict(capacity=3, prefix_bucket=8, query_bucket=4)
    want, _ = JScheduler(jsess, JKVCommConfig(**kv),
                         config=JSchedulerConfig(**sched)).run(
        [JRequest(rid=r.rid, context=r.context, query=r.query,
                  max_new=r.max_new) for r in reqs])
    got, _ = Scheduler(sess, KVCommConfig(**kv), config=SchedulerConfig(
        decode_backend="kernel", **sched)).run(reqs)
    assert [c.rid for c in got] == [c.rid for c in want]
    for a, b in zip(want, got):
        np.testing.assert_array_equal(b.tokens, a.tokens)


# ---------------------------------------------------------------------------
# K1's geometry rule
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", sorted(set(list_archs()) - {"rwkv6-1.6b"}))
def test_ragged_decode_supports_every_config(name):
    """K1 takes the (G, D) of every registered attention config, at its
    own dtype and at float32: G 9 (starcoder2) and D 160 (pixtral)
    included."""
    cfg = get_config(name)
    G = cfg.num_heads // cfg.num_kv_heads
    for dt in (getattr(torch, cfg.dtype), torch.float32):
        assert rd.supports(G, cfg.resolved_head_dim, dt), (G, dt)


def test_ragged_decode_supports_bounds():
    assert rd.supports(16, 64, torch.float16)
    assert rd.supports(64, 128, torch.bfloat16)
    assert not rd.supports(0, 128, torch.bfloat16)
    assert not rd.supports(4, 288, torch.bfloat16)
    assert not rd.supports(4, 128, torch.int8)
