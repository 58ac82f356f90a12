"""The port's MoE against the reference's: top-k routing (gates, expert
indices, the load-balancing loss), ``dense_all``, capacity-based
``dropping`` with drops and with token groups, the drop count, and MoE
models through ``apply_model`` under both strategies, at float32 on
seeded inputs with the reference's parameters.

Tolerance, stated: outputs within TOL of the reference's largest |value|.
The router's float32 product may differ from XLA's in the last bit and
flip a near-tied expert, so expert indices must be identical wherever the
reference's gap between its k-th and (k+1)-th probability is at least
GAP, and outputs are compared on the tokens whose routes agree."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_bridge import port_cfg, port_params, t
from repro.configs.registry import get_config as jget_config
from repro.models import layers as jlayers
from repro.models import transformer as jtfm
from repro_torch.models import layers
from repro_torch.models import transformer as tfm

TOL = 1e-4
GAP = 1e-6
D, F, E = 32, 48, 8


@pytest.fixture(scope="module")
def moe():
    jp = jlayers.init_moe(jax.random.PRNGKey(3), D, F, E, jnp.float32)
    assert jp["router"].dtype == jnp.float32
    return jp, {k: t(v) for k, v in jp.items()}


def _x(seed, B=3, S=10, scale=1.0):
    return (scale * np.random.default_rng(seed).standard_normal(
        (B, S, D))).astype(np.float32)


def _close(got, want, rows=None):
    want = np.asarray(want, np.float32)
    got = got.detach().float().numpy()
    if rows is not None:
        got, want = got[rows], want[rows]
    scale = max(float(np.abs(want).max()), 1e-30)
    assert float(np.abs(got - want).max()) <= TOL * scale


def _clear_tokens(jp, x, k):
    """(B, S) tokens whose k-th and (k+1)-th reference probabilities are
    at least GAP apart (their routes cannot flip on a last-bit change)."""
    probs = np.asarray(jax.nn.softmax(jnp.asarray(x) @ jp["router"], -1))
    srt = -np.sort(-probs, axis=-1)
    return (srt[..., k - 1] - srt[..., k]) >= GAP


@pytest.mark.parametrize("k", [1, 2, 3])
def test_router_probs_match(moe, k):
    jp, p = moe
    x = _x(0)
    jg, ji, jaux = jlayers.router_probs(jp, jnp.asarray(x), k)
    g, i, aux = layers.router_probs(p, t(x), k)
    clear = _clear_tokens(jp, x, k)
    assert clear.mean() > 0.9
    np.testing.assert_array_equal(i.numpy()[clear], np.asarray(ji)[clear])
    _close(g, jg, clear)
    assert g.dtype == torch.float32 and i.shape == (3, 10, k)
    assert abs(float(aux) - float(jaux)) <= 1e-5 * abs(float(jaux))


def test_router_ties_go_to_the_lower_expert():
    """Duplicated router columns tie exactly: jax.lax.top_k puts the lower
    index first, and so must the port."""
    col = np.random.default_rng(1).standard_normal((D, 1)).astype(np.float32)
    router = np.concatenate([col, col * 0.5, col, col, col * 0.5], 1)
    jp = {"router": jnp.asarray(router)}
    x = np.abs(_x(2))               # x @ col has one sign per token
    jg, ji, _ = jlayers.router_probs(jp, jnp.asarray(x), 3)
    g, i, _ = layers.router_probs({"router": t(router)}, t(x), 3)
    np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
    _close(g, jg)


def test_dense_all_matches(moe):
    jp, p = moe
    x = _x(4)
    want, jaux = jlayers.apply_moe_dense_all(jp, jnp.asarray(x), 2)
    got, aux = layers.apply_moe_dense_all(p, t(x), 2)
    rows = _clear_tokens(jp, x, 2)
    _close(got, want, rows)
    assert abs(float(aux) - float(jaux)) <= 1e-5 * abs(float(jaux))


@pytest.mark.parametrize("cf,groups", [(1.25, 1), (0.5, 1), (1.25, 2),
                                       (0.75, 3), (1.25, 4)])
def test_dropping_matches(moe, cf, groups):
    """Capacity dispatch with drops (0.5 and 0.75 drop many), token groups
    (3 and 2 divide the 30 tokens; 4 does not, so one group); the drop
    count equals the assignments past each expert's capacity."""
    jp, p = moe
    x = _x(5, scale=2.0)
    rows = _clear_tokens(jp, x, 2)
    assert rows.all()   # a flipped route would move another token's slot
    want, jaux = jax.jit(jlayers.apply_moe_dropping, static_argnums=(2, 3),
                         static_argnames=("groups",))(
        jp, jnp.asarray(x), 2, cf, groups=groups)
    got, aux = layers.apply_moe_dropping(p, t(x), 2, cf, groups=groups)
    _close(got, want)
    assert abs(float(aux) - float(jaux)) <= 1e-5 * abs(float(jaux))
    cfg = dataclasses.replace(port_cfg(jget_config("olmoe-1b-7b")),
                              num_experts_per_tok=2, moe_capacity_factor=cf,
                              moe_groups=groups)
    G = groups if 30 % groups == 0 else 1
    n = 30 // G
    C = max(int(cf * n * 2 / E), 1)
    _, idx, _ = layers.router_probs(p, t(x), 2)
    idx = idx.reshape(G, n * 2)
    want_drop = sum(int(np.maximum(np.bincount(r, minlength=E) - C, 0)
                        .sum()) for r in idx.numpy())
    assert layers.moe_dropped(p, t(x), cfg) == want_drop
    assert want_drop > 0 or cf > 1     # the low factors drop


def test_dropping_at_full_capacity_equals_dense_all(moe):
    """At capacity_factor E / k nothing drops: dropping = dense_all."""
    jp, p = moe
    x = _x(6)
    cfg = dataclasses.replace(port_cfg(jget_config("olmoe-1b-7b")),
                              num_experts_per_tok=2,
                              moe_capacity_factor=E / 2)
    assert layers.moe_dropped(p, t(x), cfg) == 0
    dense, _ = layers.apply_moe_dense_all(p, t(x), 2)
    drop, _ = layers.apply_moe_dropping(p, t(x), 2, E / 2)
    _close(drop, dense.numpy())


@pytest.mark.parametrize("impl", ["dense_all", "dropping"])
def test_moe_models_match(impl):
    """Reduced olmoe and mixtral through apply_model under each strategy:
    logits and ``ModelOut.aux_loss`` (summed over the MoE layers) equal
    the reference's; a dense model's aux_loss is 0."""
    for name in ("olmoe-1b-7b", "mixtral-8x22b"):
        jcfg = dataclasses.replace(jget_config(name).reduced(),
                                   dtype="float32", moe_impl=impl)
        jp = jtfm.init_params(jcfg, jax.random.PRNGKey(0))
        cfg, p = port_cfg(jcfg), port_params(jp)
        toks = np.random.default_rng(2).integers(
            0, cfg.vocab_size, (2, 12)).astype(np.int32)
        want = jax.jit(jtfm.apply_model, static_argnums=(1,))(
            jp, jcfg, jnp.asarray(toks))
        got = tfm.apply_model(p, cfg, t(toks).long(), mode="train")
        _close(got.logits, want.logits)
        assert float(want.aux_loss) > 0
        assert abs(float(got.aux_loss) - float(want.aux_loss)) \
            <= 1e-5 * float(want.aux_loss)
    dense = port_cfg(dataclasses.replace(
        jget_config("qwen1.5-110b").reduced(), dtype="float32"))
    out = tfm.apply_model(tfm.init_params(dense, 0, device="cpu"), dense,
                          torch.zeros((1, 4), dtype=torch.long))
    assert out.aux_loss.dtype == torch.float32 and float(out.aux_loss) == 0
    assert out._fields == ("logits", "cache", "masses", "aux_loss",
                           "hiddens")
