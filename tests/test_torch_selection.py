"""The port's layer selection against the reference: tie order (the
symmetric Gaussian prior ties layers, and jax.lax.top_k puts the lower
index first where torch.topk does not) and the kvcomm selector on
calibrated scores. Selections must be identical, ties included."""
import jax.numpy as jnp
import numpy as np
import pytest

from _torch_bridge import port_cfg, port_params, t
from repro import core as jcore
from repro.core import selection as jsel
from repro.core.types import KVCommConfig as JKVCommConfig
from repro_torch.core import protocol
from repro_torch.core import selection as tsel
from repro_torch.core.types import KVCommConfig


@pytest.mark.parametrize("L,expected", [(4, [0, 1]),
                                        (12, [2, 3, 4, 5, 6, 7])])
def test_prior_tie_order_pinned(L, expected):
    kw = dict(ratio=0.5, selector="prior_only")
    got = tsel.select_layers(None, L, KVCommConfig(**kw))
    ref = jsel.select_layers(None, L, JKVCommConfig(**kw))
    assert np.nonzero(got.numpy())[0].tolist() == expected
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


@pytest.mark.parametrize("L", [4, 8, 12, 28])
@pytest.mark.parametrize("ratio", [0.1, 0.3, 0.5, 0.7, 1.0])
@pytest.mark.parametrize("selector", ["prior_only", "contiguous", "all"])
def test_static_selectors_match(L, ratio, selector):
    kw = dict(ratio=ratio, selector=selector, layer_from=L // 3)
    np.testing.assert_array_equal(
        tsel.select_layers(None, L, KVCommConfig(**kw)).numpy(),
        np.asarray(jsel.select_layers(None, L, JKVCommConfig(**kw))))


def test_topk_ties_and_edges():
    scores = np.array([0.5, 1.0, 0.5, 1.0, 0.2], np.float32)
    for m in range(-1, 7):
        np.testing.assert_array_equal(
            tsel.topk_mask(t(scores), m).numpy(),
            np.asarray(jsel.topk_mask(jnp.asarray(scores), m)))


def test_score_pipeline_matches():
    raw = np.random.default_rng(0).random((6, 3)).astype(np.float32)
    np.testing.assert_allclose(tsel.normalize_scores(t(raw)).numpy(),
                               np.asarray(jsel.normalize_scores(raw)),
                               atol=1e-6)
    np.testing.assert_allclose(tsel.gaussian_prior(7, None, 3.0).numpy(),
                               np.asarray(jsel.gaussian_prior(7, None, 3.0)),
                               atol=1e-7)


@pytest.mark.parametrize("alpha", [1.0, 0.7])
def test_kvcomm_selection_on_calibrated_scores(tiny_cfg, tiny_params, tok,
                                               alpha):
    """Calibrate both packages on the same sample and weights, then
    select: the kvcomm masks are identical."""
    from repro.data.synthetic import SyntheticTask, TaskConfig
    cfg, params = port_cfg(tiny_cfg), port_params(tiny_params)
    b = SyntheticTask(tok, TaskConfig("retrieval", num_facts=6,
                                      seed=42)).batch(1)
    ctx = np.concatenate([np.full((1, 1), tok.BOS, np.int32),
                          b["context"]], 1)
    jkv, _ = jcore.sender_prefill(tiny_params, tiny_cfg, jnp.asarray(ctx))
    js = jcore.calibrate(tiny_params, tiny_cfg, jnp.asarray(b["query"]), jkv)
    ts = protocol.calibrate(params, cfg, t(b["query"]).long(),
                            protocol.sender_prefill(params, cfg,
                                                    t(ctx).long())[0])
    for ratio in (0.3, 0.5, 0.75):
        kw = dict(ratio=ratio, alpha=alpha)
        np.testing.assert_array_equal(
            protocol.make_selection(cfg, KVCommConfig(**kw), ts).numpy(),
            np.asarray(jcore.make_selection(tiny_cfg, JKVCommConfig(**kw),
                                            js)))


@pytest.fixture
def partitionable_threefry():
    """jax.random's bits depend on this flag; the port reproduces its
    default, True. Pinned for the test and restored after."""
    import jax
    old = jax.config.jax_threefry_partitionable
    jax.config.update("jax_threefry_partitionable", True)
    yield
    jax.config.update("jax_threefry_partitionable", old)


@pytest.mark.parametrize("L", [4, 12, 28, 36])
def test_random_selector_is_bit_identical(partitionable_threefry, L):
    """The numpy threefry draws equal jax.random.uniform bit for bit, and
    the random selector picks the same layers, for seeds 0-49."""
    import jax
    for seed in range(50):
        want = np.asarray(jax.random.uniform(jax.random.PRNGKey(seed), (L,)))
        got = tsel.random_scores(seed, L).numpy()
        np.testing.assert_array_equal(got.view(np.uint32),
                                      want.view(np.uint32))
        kw = dict(ratio=0.5, selector="random", seed=seed)
        np.testing.assert_array_equal(
            tsel.select_layers(None, L, KVCommConfig(**kw)).numpy(),
            np.asarray(jsel.select_layers(None, L, JKVCommConfig(**kw))))
