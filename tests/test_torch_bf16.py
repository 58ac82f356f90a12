"""bfloat16 parity: the reference's tiny model at bf16, bridged with
params_from_jax, through the sender prefill and one receiver prefill in
both packages (2 x 33 context tokens, 2 x 33 query tokens, a packed view
of half the layers).

Tolerances, stated: layer 0's sender K/V are bit-identical (the norm,
rope, projections and the rounding to bf16 agree there); past layer 0
XLA-CPU's silu and torch's differ in the last bit for about a quarter of
float32 inputs, which bf16 rounding turns into whole ulps, so bit parity
is out of reach: the receiver's logits within 3e-2 of the largest |logit|
and their argmax agreeing at no fewer than 95% of positions."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_bridge import port_cfg, port_params
from repro import core as jcore
from repro.core.types import KVCommConfig as JKVCommConfig
from repro.models import transformer as jtfm
from repro_torch.core import protocol
from repro_torch.core.types import KVCommConfig

LOGIT_REL_TOL = 3e-2
MIN_ARGMAX_AGREEMENT = 0.95
KW = dict(ratio=0.5, selector="prior_only")


@pytest.fixture(scope="module")
def bf16_pair(tiny_cfg):
    cfg = dataclasses.replace(tiny_cfg, dtype="bfloat16")
    params = jtfm.init_params(cfg, jax.random.PRNGKey(0))
    return cfg, params, port_cfg(cfg), port_params(params)


@pytest.fixture(scope="module")
def tokens(tiny_cfg):
    rng = np.random.default_rng(0)
    return [rng.integers(4, tiny_cfg.vocab_size, (2, 33)).astype(np.int32)
            for _ in range(2)]


def test_bridged_bf16_params_stay_bf16_and_cached_path_runs(bf16_pair,
                                                            tokens):
    """params_from_jax keeps each array's dtype: bf16 weights stay bf16,
    so the cached path (bf16 cache from cfg.dtype) runs."""
    _, jparams, cfg, params = bf16_pair
    leaves = [params["embed"], params["final_norm"], params["lm_head"]] + [
        t for lp in params["layers"] for t in
        [lp["ln1"], lp["ln2"], *lp["attn"].values(), *lp["mlp"].values()]]
    assert {t.dtype for t in leaves} == {torch.bfloat16}
    np.testing.assert_array_equal(
        params["embed"].view(torch.int16).numpy(),
        np.asarray(jparams["embed"]).view(np.int16))
    kv, _ = protocol.sender_prefill(params, cfg,
                                    torch.from_numpy(tokens[0]).long())
    assert kv["k"].dtype == torch.bfloat16
    assert kv["k"].shape == (cfg.attn_layer_count, 2, 33,
                             cfg.num_kv_heads, cfg.resolved_head_dim)


def test_bf16_sender_and_receiver_match_reference(bf16_pair, tokens):
    jcfg, jparams, cfg, params = bf16_pair
    ctx, qry = tokens
    jkv, _ = jcore.sender_prefill(jparams, jcfg, jnp.asarray(ctx))
    kv, _ = protocol.sender_prefill(params, cfg,
                                    torch.from_numpy(ctx).long())
    for p in ("k", "v"):
        np.testing.assert_array_equal(
            kv[p][0].view(torch.int16).numpy(),
            np.asarray(jkv[p][0]).view(np.int16))
    jsel = jcore.make_selection(jcfg, JKVCommConfig(**KW))
    sel = protocol.make_selection(cfg, KVCommConfig(**KW))
    np.testing.assert_array_equal(sel.numpy(), np.asarray(jsel))
    jout = jcore.receiver_prefill(
        jparams, jcfg, jnp.asarray(qry),
        jcore.pack_shared(JKVCommConfig(**KW), jkv, jsel), max_new=1)
    out = protocol.receiver_prefill(
        params, cfg, torch.from_numpy(qry).long(),
        protocol.pack_shared(KVCommConfig(**KW), kv, sel), max_new=1)
    want = np.asarray(jout.logits, np.float32)
    got = out.logits.float().numpy()
    assert got.shape == want.shape == (2, 33, cfg.vocab_size)
    err = np.abs(got - want).max()
    assert err <= LOGIT_REL_TOL * np.abs(want).max(), err
    agree = (got.argmax(-1) == want.argmax(-1)).mean()
    assert agree >= MIN_ARGMAX_AGREEMENT, agree
