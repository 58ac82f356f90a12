"""The port's SSM layers and state-sharing models against the reference,
on the reduced rwkv6-1.6b (attention-free) and zamba2-2.7b (Mamba2 plus
shared attention) configs at float32, with weights bridged through
``params_from_jax``.

Tolerance, stated: module and model outputs within TOL of the largest
|value| of the reference's output (XLA's exp, tanh and silu differ from
torch's in the last float32 bit, and the scans sum in another order).
Predictions of the random-weight tiny pair are identical wherever the
reference's top-2 margin is at least MARGIN; below it the logits are held
to TOL."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_bridge import as_reference, port_cfg, port_params, t
from repro import core as jcore
from repro.comm import Agent as JAgent
from repro.comm import CommSession as JSession
from repro.configs.registry import get_config as jget_config
from repro.core.types import KVCommConfig as JKVCommConfig
from repro.core.types import SharedKV as JSharedKV
from repro.data.synthetic import SyntheticTask, TaskConfig
from repro.models import ssm as jssm
from repro.models import transformer as jtfm
from repro.serving.scheduler import Scheduler as JScheduler
from repro_torch.comm import Agent, CommSession
from repro_torch.configs.registry import get_config
from repro_torch.core import protocol
from repro_torch.core.types import KVCommConfig, SharedKV
from repro_torch.models import ssm
from repro_torch.models import transformer as tfm
from repro_torch.serving.scheduler import Scheduler
from repro_torch.weights import params_from_jax

TOL = 1e-4
MARGIN = 1e-3
ARCHS = ["rwkv6-1.6b", "zamba2-2.7b"]


def _close(got, want, tol=TOL):
    want = np.asarray(want, np.float32)
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got, np.float32)
    assert got.shape == want.shape
    scale = max(float(np.abs(want).max()), 1e-30)
    assert float(np.abs(got - want).max()) <= tol * scale


def _jcfg(name, **kw):
    return dataclasses.replace(jget_config(name).reduced(),
                               **{"dtype": "float32", **kw})


@pytest.fixture(scope="module")
def models():
    """arch -> (reference cfg, reference params, port cfg, port params)."""
    out = {}
    for name in ARCHS:
        jcfg = _jcfg(name)
        jp = jtfm.init_params(jcfg, jax.random.PRNGKey(0))
        out[name] = (jcfg, jp, port_cfg(jcfg), port_params(jp))
    return out


def _tokens(seed, shape, vocab):
    return np.random.default_rng(seed).integers(4, vocab, shape).astype(
        np.int32)


def _state(rng, shapes):
    return {k: (0.3 * rng.standard_normal(s)).astype(np.float32)
            for k, s in shapes.items()}


# ---------------------------------------------------------------------------
# the configs and the parameter bridge
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", ARCHS)
def test_configs_and_reduced_match_reference(name):
    ref = jget_config(name)
    assert as_reference(get_config(name), ref) == dataclasses.asdict(ref)
    assert as_reference(get_config(name).reduced(), ref.reduced()) \
        == dataclasses.asdict(ref.reduced())
    cfg = get_config(name)
    assert cfg.attn_layer_count == ref.attn_layer_count
    assert cfg.supports_kv_sharing == ref.supports_kv_sharing
    assert protocol._n_ssm(cfg) == jcore.protocol._n_ssm(ref)


@pytest.mark.parametrize("dtype", ["float32", "float16", "bfloat16"])
def test_params_bridge_nested_flat_and_shared(dtype):
    """Nested trees and flat checkpoint keys bridge to the same tensors at
    every dtype; every shared-attention invocation is the one top-level
    dict; a flat hybrid checkpoint needs the cfg."""
    from repro.training.checkpoint import _flatten
    jcfg = _jcfg("zamba2-2.7b", dtype=dtype)
    jp = jtfm.init_params(jcfg, jax.random.PRNGKey(0))
    cfg = port_cfg(jcfg)
    nested = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    flat = params_from_jax(_flatten(jp), cfg=cfg, device="cpu")
    kinds = [s.kind for s in cfg.layer_plan() for _ in range(s.count)]
    # mamba, shared_attn, mamba, shared_attn: the last run is shared
    assert len(nested["layers"]) == len(kinds) == 4
    for p in (nested, flat):
        for kind, layer in zip(kinds, p["layers"]):
            assert (layer is p["shared_attn"]) == (kind == "shared_attn")
        assert p["embed"].dtype == getattr(torch, dtype)
        assert p["layers"][0]["mamba"]["A_log"].dtype == torch.float32
    for a, b in zip(jax.tree.leaves(jax.tree.map(
            lambda x: x.float(), nested, is_leaf=torch.is_tensor)),
            jax.tree.leaves(jax.tree.map(lambda x: x.float(), flat,
                                         is_leaf=torch.is_tensor))):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="needs cfg"):
        params_from_jax(_flatten(jp), device="cpu")
    # RWKV6 is untied: its lm_head crosses
    jr = _jcfg("rwkv6-1.6b", dtype=dtype)
    rp = params_from_jax(_flatten(jtfm.init_params(jr,
                                                   jax.random.PRNGKey(1))),
                         device="cpu")
    assert "lm_head" in rp and len(rp["layers"]) == 2
    assert set(rp["layers"][0]) == {"ln1", "ln2", "rwkv"}


def test_port_init_shares_one_attention_block():
    cfg = dataclasses.replace(get_config("zamba2-2.7b").reduced(),
                              num_layers=4, hybrid_attn_every=2,
                              dtype="float32")
    p = tfm.init_params(cfg, 0, device="cpu")
    shared = [layer for layer in p["layers"] if "attn" in layer]
    assert len(shared) == cfg.attn_layer_count == 2
    assert all(layer is p["shared_attn"] for layer in shared)
    # an audio arch_type makes the plan one plain attention run (no
    # encoder here, so no cross-attention) with gelu MLPs: the port now
    # builds it, as the reference does, with no shared block
    audio = tfm.init_params(dataclasses.replace(cfg, arch_type="audio"), 0,
                            device="cpu")
    assert "shared_attn" not in audio and "encoder" not in audio
    assert len(audio["layers"]) == cfg.num_layers
    assert all(set(layer["mlp"]) == {"w_up", "w_down"}
               for layer in audio["layers"])


# ---------------------------------------------------------------------------
# the SSM modules
# ---------------------------------------------------------------------------
def test_rwkv_time_and_channel_mix_match(models):
    jcfg, jp, cfg, p = models["rwkv6-1.6b"]
    jlayer = jax.tree.map(lambda a: a[0], jp["blocks"][0]["rwkv"])
    layer = p["layers"][0]["rwkv"]
    rng = np.random.default_rng(0)
    B, S, D = 2, 7, cfg.d_model
    H, hd = ssm.rwkv_dims(cfg)
    x = rng.standard_normal((B, S, D)).astype(np.float32)
    st = _state(rng, {"tm_x": (B, D), "cm_x": (B, D),
                      "wkv": (B, H, hd, hd)})
    jst = {k: jnp.asarray(v) for k, v in st.items()}
    tst = {k: t(v) for k, v in st.items()}
    want = jssm.rwkv_time_mix(jlayer, jcfg, jnp.asarray(x), jst)
    got = ssm.rwkv_time_mix(layer, cfg, t(x), tst)
    for g, w in zip(got, want):
        _close(g, w)
    want = jssm.rwkv_channel_mix(jlayer, jcfg, jnp.asarray(x), jst)
    got = ssm.rwkv_channel_mix(layer, cfg, t(x), tst)
    for g, w in zip(got, want):
        _close(g, w)


@pytest.mark.parametrize("S", [1, 6])
def test_apply_mamba_matches(models, S):
    jcfg, jp, cfg, p = models["zamba2-2.7b"]
    jlayer = jax.tree.map(lambda a: a[0], jp["blocks"][0]["mamba"])
    layer = p["layers"][0]["mamba"]
    d_inner, nh, hd, ds, conv_dim = ssm.mamba_dims(cfg)
    assert (d_inner, nh, hd, ds, conv_dim) == jssm.mamba_dims(jcfg)
    rng = np.random.default_rng(S)
    x = rng.standard_normal((2, S, cfg.d_model)).astype(np.float32)
    st = _state(rng, {"conv": (2, cfg.ssm_conv - 1, conv_dim),
                      "ssm": (2, nh, hd, ds)})
    out, new = jssm.apply_mamba(jlayer, jcfg, jnp.asarray(x),
                                {k: jnp.asarray(v) for k, v in st.items()},
                                mode="cached")
    gout, gnew = ssm.apply_mamba(layer, cfg, t(x),
                                 {k: t(v) for k, v in st.items()})
    _close(gout, out)
    assert list(gnew) == list(new)
    for k in new:
        assert gnew[k].dtype == torch.float32
        _close(gnew[k], new[k])


def test_softplus_is_logaddexp():
    x = torch.tensor([-30.0, -1.0, 0.0, 1.0, 19.0, 25.0, 80.0])
    np.testing.assert_allclose(ssm._softplus(x).numpy(),
                               np.asarray(jax.nn.softplus(jnp.asarray(
                                   x.numpy()))), rtol=1e-6, atol=0)


# ---------------------------------------------------------------------------
# the models
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", ARCHS)
def test_apply_model_train_matches(models, name):
    jcfg, jp, cfg, p = models[name]
    toks = _tokens(1, (2, 9), cfg.vocab_size)
    want = jtfm.apply_model(jp, jcfg, jnp.asarray(toks), mode="train")
    got = tfm.apply_model(p, cfg, t(toks).long(), mode="train")
    _close(got.logits, want.logits)


@pytest.mark.parametrize("name", ARCHS)
def test_apply_model_cached_prefill_and_decode_match(models, name):
    """A prefill then a decode step in cached mode: logits, the carried
    states and (Zamba2) the shared-attention KV."""
    jcfg, jp, cfg, p = models[name]
    toks = _tokens(2, (2, 6), cfg.vocab_size)
    jcache = jtfm.init_cache(jcfg, 2, 8)
    cache = tfm.init_cache(cfg, 2, 8, device="cpu")
    for sl in (slice(0, 5), slice(5, 6)):
        jo = jtfm.apply_model(jp, jcfg, jnp.asarray(toks[:, sl]),
                              mode="cached", cache=jcache)
        o = tfm.apply_model(p, cfg, t(toks[:, sl]).long(), mode="cached",
                            cache=cache)
        jcache, cache = jo.cache, o.cache
        _close(o.logits, jo.logits)
    jst = jcore.protocol.extract_states(jcfg, jcache)
    st = protocol.extract_states(cfg, cache)
    assert list(st) == list(jst)
    for k in st:
        _close(st[k], jst[k])
    jkv = jcore.protocol.extract_kv(jcfg, jcache)
    kv = protocol.extract_kv(cfg, cache)
    assert (kv is None) == (jkv is None) == (name == "rwkv6-1.6b")
    if kv is not None:
        _close(kv["k"], jkv["k"])


def test_rwkv_state_protocol_matches_reference(models):
    """The mirror of TestStateSharing::test_rwkv_state_protocol: every
    state shared equals the skyline over [C; Q], none shared differs, and
    the port's logits equal the reference's."""
    jcfg, jp, cfg, p = models["rwkv6-1.6b"]
    B, Sc, Sq = 1, 8, 4
    ctx = _tokens(3, (B, Sc), cfg.vocab_size)
    qry = _tokens(4, (B, Sq), cfg.vocab_size)
    kv, states = protocol.sender_prefill(p, cfg, t(ctx).long())
    jkv, jstates = jcore.sender_prefill(jp, jcfg, jnp.asarray(ctx))
    assert kv is None and jkv is None
    n = protocol._n_ssm(cfg)
    out = {}
    for share in (True, False):
        shared = SharedKV(states=states, state_select=torch.full(
            (n,), share), prefix_len=0)
        out[share] = protocol.receiver_prefill(p, cfg, t(qry).long(),
                                               shared, max_new=0).logits
        jshared = JSharedKV(states=jstates, state_select=jnp.full(
            (n,), share), prefix_len=0)
        _close(out[share], jcore.receiver_prefill(
            jp, jcfg, jnp.asarray(qry), jshared, max_new=0).logits)
    sky = tfm.apply_model(p, cfg, t(np.concatenate([ctx, qry], 1)).long())
    np.testing.assert_allclose(out[True].numpy(),
                               sky.logits[:, Sc:].numpy(), atol=2e-3,
                               rtol=2e-3)
    assert not np.allclose(out[True].numpy(), out[False].numpy())


def test_zamba_dense_and_packed_agree_with_reference(models, tok):
    """The mirror of test_packed.py::test_ssm_and_cross_attn_configs
    [zamba2-2.7b]: dense and packed views give equal logits and tokens,
    and each view's logits equal the reference's."""
    jcfg = _jcfg("zamba2-2.7b", vocab_size=tok.vocab_size)
    jp = jtfm.init_params(jcfg, jax.random.PRNGKey(0))
    cfg, p = port_cfg(jcfg), port_params(jp)
    L = cfg.attn_layer_count
    sel = np.zeros((L,), bool)
    sel[::2] = True
    ctx = _tokens(5, (2, 8), cfg.vocab_size)
    qry = _tokens(6, (2, 4), cfg.vocab_size)
    kv, states = protocol.sender_prefill(p, cfg, t(ctx).long())
    jkv, jstates = jcore.sender_prefill(jp, jcfg, jnp.asarray(ctx))
    ss = torch.ones((protocol._n_ssm(cfg),), dtype=torch.bool)
    kvcfg, jkvcfg = KVCommConfig(), JKVCommConfig()
    views = [protocol.build_shared(kvcfg, kv, t(sel), states, ss),
             protocol.pack_shared(kvcfg, kv, t(sel), states, ss)]
    jviews = [jcore.build_shared(jkvcfg, jkv, jnp.asarray(sel), jstates,
                                 jnp.asarray(ss.numpy())),
              jcore.pack_shared(jkvcfg, jkv, jnp.asarray(sel), jstates,
                                jnp.asarray(ss.numpy()))]
    logits, toks = [], []
    for v, jv in zip(views, jviews):
        a = protocol.receiver_prefill(p, cfg, t(qry).long(), v, max_new=2)
        ja = jcore.receiver_prefill(jp, jcfg, jnp.asarray(qry), jv,
                                    max_new=2)
        _close(a.logits, ja.logits)
        logits.append(a.logits)
        tk, _ = protocol.generate(p, cfg, t(qry).long(), v, max_new=3)
        toks.append(tk)
    np.testing.assert_allclose(logits[0].numpy(), logits[1].numpy(),
                               atol=3e-5, rtol=1e-5)
    assert torch.equal(toks[0], toks[1])


def test_zamba_all_shared_equals_skyline(models):
    """Every layer's KV and every state shared: the receiver's logits over
    Q equal the skyline run of [C; Q]."""
    jcfg, jp, cfg, p = models["zamba2-2.7b"]
    ctx = _tokens(7, (2, 8), cfg.vocab_size)
    qry = _tokens(8, (2, 4), cfg.vocab_size)
    kv, states = protocol.sender_prefill(p, cfg, t(ctx).long())
    L, n = cfg.attn_layer_count, protocol._n_ssm(cfg)
    shared = protocol.pack_shared(
        KVCommConfig(), kv, torch.ones((L,), dtype=torch.bool), states,
        torch.ones((n,), dtype=torch.bool))
    out = protocol.receiver_prefill(p, cfg, t(qry).long(), shared,
                                    max_new=0)
    sky = tfm.apply_model(p, cfg, t(np.concatenate([ctx, qry], 1)).long())
    _close(out.logits, sky.logits[:, 8:], tol=1e-4)


def test_zamba_kvcomm_run_matches_reference(tok):
    """``run("kvcomm")`` on a tiny Zamba2 pair (sender PRNGKey 0, receiver
    PRNGKey 1) on the reference's Eq. (1) scores: bytes, FLOPs, M and the
    selection identical; predictions under the margin rule."""
    jcfg = _jcfg("zamba2-2.7b", vocab_size=tok.vocab_size)
    js = jtfm.init_params(jcfg, jax.random.PRNGKey(0))
    jr = jtfm.init_params(jcfg, jax.random.PRNGKey(1))
    cfg = port_cfg(jcfg)
    jsess = JSession(JAgent("s", jcfg, js, tok), JAgent("r", jcfg, jr, tok))
    sess = CommSession(Agent("s", cfg, port_params(js), tok),
                       Agent("r", cfg, port_params(jr), tok))
    batch = SyntheticTask(tok, TaskConfig("retrieval", num_facts=3,
                                          seed=5)).batch(3)
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
    top2 = np.sort(logits["ref"], axis=-1)[:, -2:]
    clear = top2[:, 1] - top2[:, 0] >= MARGIN
    np.testing.assert_array_equal(got.preds[clear],
                                  np.asarray(want.preds)[clear])
    np.testing.assert_allclose(logits["port"][~clear], logits["ref"][~clear],
                               atol=TOL, rtol=TOL)


@pytest.mark.parametrize("name", ARCHS)
def test_both_schedulers_refuse_ssm_models(models, tok, name):
    jcfg, jp, cfg, p = models[name]
    jsess = JSession(JAgent("s", jcfg, jp, tok), JAgent("r", jcfg, jp, tok))
    sess = CommSession(Agent("s", cfg, p, tok), Agent("r", cfg, p, tok))
    kw = dict(ratio=0.5, selector="prior_only")
    with pytest.raises(AssertionError, match="attention-only"):
        JScheduler(jsess, JKVCommConfig(**kw))
    with pytest.raises(ValueError, match="attention-only"):
        Scheduler(sess, KVCommConfig(**kw))
