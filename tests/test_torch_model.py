"""The port's model against the reference on the same weights (tiny_params
bridged with params_from_jax) and the same numpy inputs, float32 on the
CPU. Tolerances: 1e-4 abs/rel on logits (float32 through a 4-layer model,
summed in another order), 2e-5 on single primitives."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_bridge import port_cfg, port_params, t
from repro import core as jcore
from repro.core.types import KVCommConfig as JKVCommConfig
from repro.models import attention as jattn
from repro.models import layers as jlayers
from repro.models import transformer as jtfm
from repro_torch.core import protocol
from repro_torch.core.types import KVCommConfig
from repro_torch.models import attention as tattn
from repro_torch.models import layers as tlayers
from repro_torch.models import transformer as ttfm

LOGIT_TOL = dict(atol=1e-4, rtol=1e-4)
PRIM_TOL = dict(atol=2e-5, rtol=2e-5)


@pytest.fixture(scope="module")
def pair(tiny_cfg, tiny_params):
    return port_cfg(tiny_cfg), port_params(tiny_params)


def _tokens(seed, shape, vocab):
    return np.random.default_rng(seed).integers(4, vocab, shape) \
        .astype(np.int32)


def test_primitives_match():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 3, 16)).astype(np.float32)
    w = rng.standard_normal((16,)).astype(np.float32)
    pos = rng.integers(0, 50, (2, 5)).astype(np.int32)
    np.testing.assert_allclose(
        tlayers.rms_norm(t(x), t(w)).numpy(),
        np.asarray(jlayers.rms_norm(x, w)), **PRIM_TOL)
    np.testing.assert_allclose(
        tlayers.rope(t(x), t(pos), 500000.0).numpy(),
        np.asarray(jlayers.rope(x, pos, 500000.0)), **PRIM_TOL)
    q = rng.standard_normal((2, 5, 4, 16)).astype(np.float32)
    kv = rng.standard_normal((2, 9, 2, 16)).astype(np.float32)
    valid = rng.random((2, 9)) > 0.3
    valid[:, 0] = True
    kw = dict(q_pos=np.arange(4, 9), kv_pos=np.arange(9), causal=True)
    mm = np.arange(9) < 4
    o, m = tlayers.attention_core(
        t(q), t(kv), t(kv), q_pos=t(kw["q_pos"]), kv_pos=t(kw["kv_pos"]),
        kv_valid=t(valid), mass_mask=t(mm))
    jo, jm = jlayers.attention_core(q, kv, kv, kv_valid=valid,
                                    mass_mask=mm, **kw)
    np.testing.assert_allclose(o.numpy(), np.asarray(jo), **PRIM_TOL)
    np.testing.assert_allclose(m.numpy(), np.asarray(jm), **PRIM_TOL)


@pytest.mark.parametrize("P,ctx_valid", [(8, True), (8, False), (0, None)])
def test_decode_attention_kernel_backend(tiny_cfg, tiny_params, pair, P,
                                         ctx_valid):
    """S == 1 ragged decode through backend="kernel" (its plain version on
    the CPU) against the reference's backend="pallas" (interpret mode)."""
    cfg, params = pair
    rng = np.random.default_rng(7)
    B, Smax, D = 3, P + 12, tiny_cfg.d_model
    x = rng.standard_normal((B, 1, D)).astype(np.float32)
    ck = rng.standard_normal((B, Smax, 2, 16)).astype(np.float32)
    cv = rng.standard_normal((B, Smax, 2, 16)).astype(np.float32)
    clen = np.array([P + 3, P + 6, P + 1], np.int32)
    plens = np.array([5, 8, 2], np.int32) if P else None
    shift = plens if P else np.zeros(B, np.int32)
    jp = jax.tree.map(lambda a: a[0], tiny_params["blocks"][0]["attn"])
    jout, (jk, jv), _ = jattn.self_attention(
        jp, tiny_cfg, jnp.asarray(x), mode="cached",
        pos_shift=jnp.asarray(shift), prefix_len=P,
        ctx_valid=None if ctx_valid is None else jnp.asarray(ctx_valid),
        cache_k=jnp.asarray(ck), cache_v=jnp.asarray(cv),
        cache_len=jnp.asarray(clen),
        prefix_lens=None if plens is None else jnp.asarray(plens),
        backend="pallas")
    tk, tv = t(ck), t(cv)
    out, _, _ = tattn.self_attention(
        params["layers"][0]["attn"], cfg, t(x), mode="cached",
        pos_shift=t(shift), prefix_len=P, ctx_valid=ctx_valid, cache_k=tk,
        cache_v=tv, cache_len=t(clen),
        prefix_lens=None if plens is None else t(plens), backend="kernel")
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), **PRIM_TOL)
    np.testing.assert_allclose(tk.numpy(), np.asarray(jk), **PRIM_TOL)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), **PRIM_TOL)


def test_train_logits(tiny_cfg, tiny_params, pair):
    cfg, params = pair
    toks = _tokens(1, (2, 7), tiny_cfg.vocab_size)
    jl = jtfm.apply_model(tiny_params, tiny_cfg, jnp.asarray(toks)).logits
    tl = ttfm.apply_model(params, cfg, t(toks).long()).logits
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGIT_TOL)


@pytest.mark.parametrize("packed", [True, False], ids=["packed", "dense"])
@pytest.mark.parametrize("ratio,selector,layer_from", [
    (0.3, "prior_only", 0), (0.5, "contiguous", 2), (0.25, "prior_only", 0)])
def test_cached_prefill_and_decode_logits(tiny_cfg, tiny_params, pair,
                                          packed, ratio, selector,
                                          layer_from):
    """Sender prefill -> shared view -> receiver prefill (natural and
    bucket-padded with prefix_lens) -> two decode steps on the kernel
    backend, logits against the reference at every stage."""
    cfg, params = pair
    kw = dict(ratio=ratio, selector=selector, layer_from=layer_from)
    jk, tk = JKVCommConfig(**kw), KVCommConfig(**kw)
    ctx = _tokens(2, (1, 9), tiny_cfg.vocab_size)
    qry = _tokens(3, (1, 5), tiny_cfg.vocab_size)
    jkv, _ = jcore.sender_prefill(tiny_params, tiny_cfg, jnp.asarray(ctx))
    tkv, _ = protocol.sender_prefill(params, cfg, t(ctx).long())
    np.testing.assert_allclose(tkv["k"].numpy(), np.asarray(jkv["k"]),
                               **LOGIT_TOL)
    jsel = jcore.make_selection(tiny_cfg, jk)
    tsel = protocol.make_selection(cfg, tk)
    np.testing.assert_array_equal(tsel.numpy(), np.asarray(jsel))
    jb = jcore.pack_shared if packed else jcore.build_shared
    tb = protocol.pack_shared if packed else protocol.build_shared
    jsh, tsh = jb(jk, jkv, jsel), tb(tk, tkv, tsel)
    jout = jcore.receiver_prefill(tiny_params, tiny_cfg, jnp.asarray(qry),
                                  jsh, max_new=3)
    tout = protocol.receiver_prefill(params, cfg, t(qry).long(), tsh,
                                     max_new=3)
    np.testing.assert_allclose(tout.logits.numpy(), np.asarray(jout.logits),
                               **LOGIT_TOL)
    # the scheduler's admission geometry: padded query + padded prefix
    qpad = np.concatenate([qry, np.zeros((1, 3), np.int32)], 1)
    plens = np.full((1,), 9, np.int32)
    jpad = jcore.receiver_prefill(
        tiny_params, tiny_cfg, jnp.asarray(qpad), jcore.pad_prefix(jsh, 16),
        max_new=2, prefix_lens=jnp.asarray(plens))
    tpad = protocol.receiver_prefill(
        params, cfg, t(qpad).long(), protocol.pad_prefix(tsh, 16),
        max_new=2, prefix_lens=t(plens))
    np.testing.assert_allclose(tpad.logits[:, :5].numpy(),
                               np.asarray(jpad.logits[:, :5]), **LOGIT_TOL)
    np.testing.assert_allclose(tpad.logits[:, :5].numpy(),
                               tout.logits.numpy(), **LOGIT_TOL)
    # decode: the reference's pallas step vs the port's kernel step
    jc, tc = jout.cache, tout.cache
    jtok = jnp.argmax(jout.logits[:, -1], -1)[:, None]
    ttok = torch.argmax(tout.logits[:, -1], -1)[:, None]
    for _ in range(2):
        jtok, jlog, jc = jcore.decode_step(tiny_params, tiny_cfg, jtok, jc,
                                           jsh, backend="pallas")
        ttok, tlog, tc = protocol.decode_step(params, cfg, ttok, tc, tsh,
                                              backend="kernel")
        np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog),
                                   **LOGIT_TOL)
        np.testing.assert_array_equal(ttok.numpy(), np.asarray(jtok))


def test_calibrate_scores(tiny_cfg, tiny_params, pair):
    """Eq. (1) masses through a prefill with every layer shared, min-max
    normalized: the scores the kvcomm selector ranks."""
    cfg, params = pair
    ctx = _tokens(4, (2, 11), tiny_cfg.vocab_size)
    qry = _tokens(5, (2, 4), tiny_cfg.vocab_size)
    jkv, _ = jcore.sender_prefill(tiny_params, tiny_cfg, jnp.asarray(ctx))
    js = jcore.calibrate(tiny_params, tiny_cfg, jnp.asarray(qry), jkv)
    ts = protocol.calibrate(params, cfg, t(qry).long(),
                            protocol.sender_prefill(params, cfg,
                                                    t(ctx).long())[0])
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), **LOGIT_TOL)


def test_cache_insert_row_two_segments(pair):
    """A row prefilled at a smaller prefix bucket lands as two segments:
    prefix at [0, src), self region moved to dst."""
    cfg, _ = pair
    L, Hkv, D = cfg.num_layers, cfg.num_kv_heads, cfg.resolved_head_dim
    mk = lambda B, S: {"len": 0, "layers": [                 # noqa: E731
        {"k": torch.randn(B, S, Hkv, D), "v": torch.randn(B, S, Hkv, D),
         "prefix": True, "ctx_valid": True} for _ in range(L)]}
    table, row = mk(3, 16 + 6), mk(1, 8 + 6)
    ttfm.cache_insert_row(table, row, 1, src_prefix=8, dst_prefix=16,
                          row_max_len=6)
    for te, re in zip(table["layers"], row["layers"]):
        assert torch.equal(te["k"][1, :8], re["k"][0, :8])
        assert torch.equal(te["k"][1, 16:], re["k"][0, 8:])


def test_params_bridge_accepts_flat_checkpoint_keys(tiny_params, pair):
    """The flat 'blocks/0/attn/wq' keys of the reference's checkpoint
    files bridge to the same per-layer parameters as the nested tree."""
    from repro.training.checkpoint import _flatten
    from repro_torch.weights import params_from_jax
    _, nested = pair
    flat = params_from_jax(_flatten(tiny_params), device="cpu")
    assert flat.keys() == nested.keys()
    assert len(flat["layers"]) == len(nested["layers"]) == 4
    for a, b in zip(flat["layers"], nested["layers"]):
        for grp in ("attn", "mlp"):
            for k in a[grp]:
                assert torch.equal(a[grp][k], b[grp][k])
    assert torch.equal(flat["lm_head"], nested["lm_head"])


def test_params_bridge_defaults_to_the_card(tiny_params, monkeypatch):
    """Like every other entry point, params_from_jax runs on the card
    unless told otherwise: without a card and without device="cpu" it
    raises instead of quietly building CPU tensors."""
    from repro.training.checkpoint import _flatten
    from repro_torch.weights import params_from_jax
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        params_from_jax(_flatten(tiny_params))
    cpu = params_from_jax(_flatten(tiny_params), device="cpu")
    assert cpu["embed"].device.type == "cpu"


def test_init_distributions(pair):
    """init_params draws the reference's distributions (not its bits):
    dense weights N(0, 1/fan_in), embeddings N(0, 0.02^2), norms zero."""
    cfg, _ = pair
    p = ttfm.init_params(cfg, 3, device="cpu")
    wq = p["layers"][0]["attn"]["wq"]
    assert abs(float(wq.std()) * cfg.d_model ** 0.5 - 1.0) < 0.05
    assert abs(float(p["embed"].std()) / 0.02 - 1.0) < 0.1
    assert not p["layers"][0]["ln1"].any()
    again = ttfm.init_params(cfg, 3, device="cpu")
    assert torch.equal(again["embed"], p["embed"])
