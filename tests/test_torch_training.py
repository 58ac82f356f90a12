"""The port's training against the reference: AdamW (clipping, the
schedule, the decay rule, float32 moments), the loss, gradients and train
steps on ``tiny_cfg`` with bridged weights, checkpoints that cross both
ways, the data pipelines, one train step per reduced registered config,
the trained-pair loader and the train launcher on the CPU. The
counterparts of ``tests/test_training.py`` and of
``tests/test_archs.py::TestArchSmoke::test_one_train_step``.

Tolerances, stated: ``adamw_update`` 1e-6 (float32 arithmetic, XLA may
fuse a multiply-add); gradients 1e-5 relative in norm per leaf and losses
1e-5 relative (sums in another order); checkpoints, pipelines and bf16
parameters bit for bit. No test here quick-trains the pair: the loader is
driven with a checkpoint the test writes."""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_bridge import as_reference, port_cfg, port_params, t
from repro.configs.registry import get_config as jget_config
from repro.data import pipeline as jpipeline
from repro.launch import pairs as jpairs
from repro.models import transformer as jtfm
from repro.training import checkpoint as jcheckpoint
from repro.training import optimizer as jopt
from repro.training import train_loop as jtl
from repro_torch.configs.registry import get_config, list_archs
from repro_torch.data import pipeline
from repro_torch.data.synthetic import SyntheticTask, TaskConfig
from repro_torch.launch import pairs
from repro_torch.launch import train as train_launch
from repro_torch.models import transformer as tfm
from repro_torch.training import checkpoint
from repro_torch.training.optimizer import (OptimizerConfig, OptState,
                                            adamw_update, global_norm,
                                            init_opt_state, leaves, schedule)
from repro_torch.training.train_loop import (TrainState, _grads,
                                             cross_entropy, init_train_state,
                                             make_eval_step,
                                             make_train_step, to_batch, train)
from repro_torch.weights import params_to_jax


def _flat(tree):
    """{checkpoint key: numpy array} of a reference-layout tree."""
    return dict(checkpoint._paths(jax.tree.map(np.asarray, tree)))


def _bits(a):
    return np.ascontiguousarray(a).view(np.uint8).tobytes()


@pytest.fixture(scope="module")
def tiny(tiny_cfg, tiny_params):
    return port_cfg(tiny_cfg), port_params(tiny_params)


def _batch(cfg, B=4, S=12, seed=0):
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, cfg.vocab_size, (B, S)).astype(
                np.int32),
            "targets": rng.integers(0, cfg.vocab_size, (B, S)).astype(
                np.int32)}


# ---------------------------------------------------------------------------
# the optimizer (tests/test_training.py::TestOptimizer)
# ---------------------------------------------------------------------------
def test_quadratic_convergence():
    """AdamW minimizes a quadratic: ||x - t||^2 -> 0."""
    target = torch.tensor([1.0, -2.0, 3.0])
    params = {"x": torch.zeros(3)}
    cfg = OptimizerConfig(lr=0.1, weight_decay=0.0, total_steps=300,
                          warmup_steps=0)
    state = init_opt_state(params)
    for _ in range(300):
        grads = {"x": 2 * (params["x"] - target)}
        params, state, _ = adamw_update(cfg, params, grads, state)
    np.testing.assert_allclose(params["x"].numpy(), target.numpy(),
                               atol=1e-2)
    assert state.step == 300


def test_clipping():
    params = {"x": torch.zeros(4)}
    cfg = OptimizerConfig(lr=1.0, clip_norm=1.0, warmup_steps=0)
    _, _, m = adamw_update(cfg, params, {"x": torch.full((4,), 1e6)},
                           init_opt_state(params))
    assert float(m["grad_norm"]) > 1e6      # reported pre-clip


def test_schedule_shape():
    cfg = OptimizerConfig(lr=1e-3, warmup_steps=10, total_steps=100,
                          min_lr_ratio=0.1)
    lrs = [float(schedule(cfg, s)) for s in (0, 10, 55, 100)]
    assert lrs[0] < lrs[1] == pytest.approx(1e-3)
    assert lrs[1] > lrs[2] > lrs[3]
    assert lrs[3] == pytest.approx(1e-4, rel=0.05)
    jcfg = jopt.OptimizerConfig(lr=1e-3, warmup_steps=10, total_steps=100)
    for s in (0, 1, 7, 10, 11, 55, 99, 100, 150):
        assert float(schedule(cfg, s)) == float(
            jopt.schedule(jcfg, jnp.asarray(s)))


@pytest.mark.parametrize("n", [1, 2, 3, 4, 5])
def test_global_norm_property(n):
    tree = {"a": torch.ones((n,)), "b": torch.zeros((3,))}
    assert float(global_norm(tree)) == pytest.approx(np.sqrt(n))


def test_shared_tensor_is_one_parameter():
    """A tensor that sits twice in the tree (Zamba2's shared block) has
    one moment and one update."""
    w = torch.ones(2, 2)
    params = {"layers": [{"w": w}, {"w": w}]}
    state = init_opt_state(params)
    assert len(leaves(params)) == 1 and len(leaves(state.m)) == 1
    grads = {"layers": [{"w": torch.ones(2, 2)}] * 2}
    adamw_update(OptimizerConfig(warmup_steps=0, clip_norm=10.0), params,
                 grads, state)
    assert state.m["layers"][0]["w"] is state.m["layers"][1]["w"]
    assert float(state.m["layers"][0]["w"][0, 0]) == pytest.approx(0.1)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_adamw_update_matches_reference(dtype):
    """The same numpy params, grads and moments through both packages'
    ``adamw_update`` at step 6: parameters, moments, grad norm and lr
    within 1e-6; a 1-D parameter takes no decay, 2-D and 3-D do; bf16
    parameters keep their dtype and are bit-equal."""
    rng = np.random.default_rng(0)
    shapes = {"w": (6, 5), "b": (5,), "e": (3, 4, 2), "n": (7,)}
    p = {k: rng.standard_normal(s).astype(np.float32)
         for k, s in shapes.items()}
    g = {k: (0.3 * rng.standard_normal(s)).astype(np.float32)
         for k, s in shapes.items()}
    m = {k: (0.1 * rng.standard_normal(s)).astype(np.float32)
         for k, s in shapes.items()}
    v = {k: (0.01 * rng.random(s)).astype(np.float32)
         for k, s in shapes.items()}
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    kw = dict(lr=1e-2, warmup_steps=3, total_steps=20, weight_decay=0.1,
              clip_norm=0.5)
    jp, js, jm = jopt.adamw_update(
        jopt.OptimizerConfig(**kw),
        {k: jnp.asarray(a, jdt) for k, a in p.items()},
        {k: jnp.asarray(a, jdt) for k, a in g.items()},
        jopt.OptState(jnp.asarray(5, jnp.int32),
                      {k: jnp.asarray(a) for k, a in m.items()},
                      {k: jnp.asarray(a) for k, a in v.items()}))
    tp = {k: t(a).to(tdt) for k, a in p.items()}
    tp, ts, tm = adamw_update(
        OptimizerConfig(**kw), tp, {k: t(a).to(tdt) for k, a in g.items()},
        OptState(5, {k: t(a) for k, a in m.items()},
                 {k: t(a) for k, a in v.items()}))
    assert ts.step == int(js.step) == 6
    for k in shapes:
        assert tp[k].dtype == tdt
        want = np.asarray(jp[k].astype(jnp.float32))
        got = tp[k].float().numpy()
        if dtype == "bfloat16":
            np.testing.assert_array_equal(got, want)
        else:
            np.testing.assert_allclose(got, want, atol=1e-6, rtol=1e-6)
        for a, b in ((ts.m, js.m), (ts.v, js.v)):
            assert a[k].dtype == torch.float32
            np.testing.assert_allclose(a[k].numpy(), np.asarray(b[k]),
                                       atol=1e-6, rtol=1e-6)
    for key in ("grad_norm", "lr"):
        assert float(tm[key]) == pytest.approx(float(jm[key]), rel=1e-6)
    # the decay rule: with zero gradients only the matrices move
    z = {k: torch.zeros(s) for k, s in shapes.items()}
    q = {k: t(a) for k, a in p.items()}
    adamw_update(OptimizerConfig(**kw), q, z, init_opt_state(q))
    for k in shapes:
        moved = not np.array_equal(q[k].numpy(), p[k])
        assert moved == (len(shapes[k]) >= 2), k


# ---------------------------------------------------------------------------
# the loss (tests/test_training.py::TestLoss)
# ---------------------------------------------------------------------------
def test_ce_perfect_prediction():
    logits = torch.full((1, 2, 4), -30.0)
    logits[0, :, 1] = 30.0
    assert float(cross_entropy(logits, torch.ones((1, 2),
                                                  dtype=torch.long))) < 1e-5


def test_ce_uniform():
    ce = cross_entropy(torch.zeros((1, 3, 8)), torch.zeros((1, 3),
                                                           dtype=torch.long))
    assert float(ce) == pytest.approx(np.log(8), rel=1e-4)


def test_weights_mask():
    logits = torch.zeros((1, 2, 4))
    logits[0, 1, 0] = 10.0
    w = torch.tensor([[0.0, 1.0]])
    assert float(cross_entropy(logits, torch.zeros((1, 2), dtype=torch.long),
                               w)) < 1e-3


def test_cross_entropy_matches_reference():
    rng = np.random.default_rng(1)
    lg = (3 * rng.standard_normal((2, 5, 11))).astype(np.float32)
    tg = rng.integers(0, 11, (2, 5)).astype(np.int32)
    w = rng.random((2, 5)).astype(np.float32)
    for weights in (None, w):
        want = jtl.cross_entropy(jnp.asarray(lg), jnp.asarray(tg),
                                 None if weights is None
                                 else jnp.asarray(weights))
        got = cross_entropy(t(lg), t(tg), None if weights is None
                            else t(weights))
        assert float(got) == pytest.approx(float(want), rel=1e-6)


# ---------------------------------------------------------------------------
# gradients and train steps against the reference
# ---------------------------------------------------------------------------
def test_loss_gradients_match_reference(tiny_cfg, tiny_params, tiny):
    """Every leaf of the port's autograd gradient, restacked into the
    reference's layout, within 1e-5 (relative, in norm) of jax.grad."""
    cfg, p = tiny
    batch = _batch(cfg)
    (jl, _), jg = jax.value_and_grad(jtl.loss_fn, has_aux=True)(
        tiny_params, tiny_cfg, {k: jnp.asarray(a) for k, a in batch.items()})
    loss, parts, g = _grads(p, cfg, to_batch(batch, "cpu"))
    assert float(loss) == pytest.approx(float(jl), rel=1e-5)
    assert all(not x.requires_grad for x in leaves(p))
    want, got = _flat(jg), dict(checkpoint._paths(params_to_jax(g, cfg)))
    assert set(want) == set(got)
    for key, a in want.items():
        err = np.linalg.norm(got[key] - a) / max(np.linalg.norm(a), 1e-30)
        assert err <= 1e-5, (key, err)


@pytest.mark.parametrize("microbatches", [1, 2])
def test_train_steps_match_reference(tiny_cfg, tiny_params, microbatches):
    """Three ``make_train_step`` steps from the same weights and batches:
    losses within 1e-5 relative, with gradient accumulation at 2."""
    cfg = port_cfg(tiny_cfg)
    ocfg = dict(lr=3e-3, total_steps=10, warmup_steps=2)
    jstep = jax.jit(jtl.make_train_step(tiny_cfg, jopt.OptimizerConfig(
        **ocfg), microbatches))
    step = make_train_step(cfg, OptimizerConfig(**ocfg), microbatches)
    js = jtl.TrainState(tiny_params, jopt.init_opt_state(tiny_params))
    p = port_params(tiny_params)
    s = TrainState(p, init_opt_state(p))
    for i in range(3):
        batch = _batch(cfg, seed=i)
        js, jm = jstep(js, {k: jnp.asarray(a) for k, a in batch.items()})
        s, m = step(s, to_batch(batch, "cpu"))
        assert float(m["loss"]) == pytest.approx(float(jm["loss"]),
                                                 rel=1e-5), i
        assert float(m["aux"]) == float(jm["aux"]) == 0.0
    assert s.opt.step == 3
    ev = make_eval_step(cfg)(s.params, to_batch(_batch(cfg, seed=9), "cpu"))
    assert np.isfinite(float(ev["loss"]))


def test_tiny_model_loss_decreases(tiny_cfg, tok):
    """tests/test_training.py::TestConvergence on the port."""
    cfg = port_cfg(tiny_cfg)
    task = SyntheticTask(tok, TaskConfig("retrieval", num_facts=3, seed=0))
    losses = []
    train(cfg, OptimizerConfig(lr=2e-3, total_steps=40, warmup_steps=5),
          pipeline.synthetic_lm_iter(task, 16), steps=40,
          log_fn=lambda s: losses.append(float(s.split()[3])),
          log_every=13, device="cpu")
    assert len(losses) == 4 and losses[-1] < losses[0]


# ---------------------------------------------------------------------------
# one train step per reduced registered config
# ---------------------------------------------------------------------------
def _extra_batch(cfg, B):
    """tests/test_archs.py::_extra's ones as frames / patches."""
    out = {}
    if cfg.encoder_layers:
        out["frames"] = torch.ones((B, cfg.encoder_seq, cfg.d_model))
    if cfg.num_patches:
        out["patches"] = torch.ones((B, cfg.num_patches, cfg.d_model))
    return out


@pytest.mark.parametrize("name", list_archs())
def test_one_train_step(name):
    cfg = get_config(name).reduced()
    state = init_train_state(cfg, 0, device="cpu")
    before = [x.clone() for x in leaves(state.params)]
    B, S = 2, 16
    batch = to_batch(_batch(cfg, B, S), "cpu")
    batch.update(_extra_batch(cfg, B))
    state2, metrics = make_train_step(cfg, OptimizerConfig(total_steps=10))(
        state, batch)
    assert np.isfinite(float(metrics["loss"]))
    assert state2.opt.step == 1
    assert all(m.dtype == torch.float32 for m in leaves(state2.opt.m))
    delta = sum(float((a.float() - b.float()).abs().sum())
                for a, b in zip(before, leaves(state2.params)))
    assert delta > 0


# ---------------------------------------------------------------------------
# checkpoints (tests/test_training.py::TestCheckpoint, and across packages)
# ---------------------------------------------------------------------------
def test_checkpoint_roundtrip(tmp_path, tiny):
    cfg, p = tiny
    path = os.path.join(tmp_path, "ck")
    checkpoint.save(path, p, {"role": "test"}, cfg=cfg)
    restored = checkpoint.restore(path, tfm.init_params(cfg, 1,
                                                        device="cpu"),
                                  cfg=cfg)
    for a, b in zip(leaves(p), leaves(restored)):
        assert torch.equal(a, b)
    assert checkpoint.load_metadata(path)["role"] == "test"
    assert "blocks/0/attn/wq" in checkpoint.load_metadata(path)["keys"]


def test_shape_mismatch_raises(tmp_path):
    path = os.path.join(tmp_path, "ck2")
    checkpoint.save(path, {"w": torch.zeros((2, 2))})
    assert torch.equal(checkpoint.restore(path, {"w": torch.ones(2, 2)})["w"],
                       torch.zeros(2, 2))
    with pytest.raises(AssertionError):
        checkpoint.restore(path, {"w": torch.zeros((3, 3))})


@pytest.mark.parametrize("name,dtype", [("tiny", "float32"),
                                        ("tiny", "bfloat16"),
                                        ("zamba2-2.7b", "float32"),
                                        ("whisper-medium", "bfloat16")])
def test_checkpoints_cross_packages(tmp_path, tiny_cfg, name, dtype):
    """A checkpoint the reference saves restores into the port bit for
    bit, and the port's file holds the reference's keys, dtypes and bytes
    (Zamba2's shared block and whisper's encoder included). At float32
    the reference restores the port's file bit for bit; its restore
    refuses any bfloat16 file, its own included (a reference caveat)."""
    jcfg = tiny_cfg if name == "tiny" else jget_config(name).reduced()
    jcfg = dataclasses.replace(jcfg, dtype=dtype)
    cfg = port_cfg(jcfg)
    jp = jtfm.init_params(jcfg, jax.random.PRNGKey(3))
    jpath, path = os.path.join(tmp_path, "ref"), os.path.join(tmp_path,
                                                              "port")
    jcheckpoint.save(jpath, jp, {"role": "ref"})
    p = checkpoint.restore(jpath, tfm.init_params(cfg, 0, device="cpu"),
                           cfg=cfg)
    want = _flat(jp)
    got = dict(checkpoint._paths(params_to_jax(p, cfg)))
    assert set(got) == set(want)
    for key, a in want.items():
        assert _bits(got[key]) == _bits(a), key
    checkpoint.save(path, p, {"role": "port"}, cfg=cfg)
    jfile, pfile = np.load(jpath + ".npz"), np.load(path + ".npz")
    assert sorted(jfile.files) == sorted(pfile.files)
    for key in jfile.files:
        assert jfile[key].dtype.str == pfile[key].dtype.str
        assert _bits(jfile[key]) == _bits(pfile[key]), key
    assert checkpoint.load_metadata(path)["keys"] == \
        jcheckpoint.load_metadata(jpath)["keys"]
    if dtype == "float32":
        back = jcheckpoint.restore(path, jp)
        for a, b in zip(jax.tree.leaves(jp), jax.tree.leaves(back)):
            assert _bits(np.asarray(a)) == _bits(np.asarray(b))
    else:
        with pytest.raises(ValueError):
            jcheckpoint.restore(jpath, jp)


# ---------------------------------------------------------------------------
# data pipelines, the pair loader, the launcher
# ---------------------------------------------------------------------------
def test_pipelines_match_reference(tok):
    from repro.data.synthetic import SyntheticTask as JTask
    from repro.data.synthetic import TaskConfig as JTaskConfig
    a = pipeline.synthetic_byte_corpus(5000, seed=3)
    np.testing.assert_array_equal(a, jpipeline.synthetic_byte_corpus(
        5000, seed=3))
    corpus = a % 97
    for x, y in zip(
            [next(it) for it in [pipeline.token_stream_iter(
                corpus, 3, 16, seed=4)] for _ in range(3)],
            [next(it) for it in [jpipeline.token_stream_iter(
                corpus, 3, 16, seed=4)] for _ in range(3)]):
        for k in ("tokens", "targets"):
            np.testing.assert_array_equal(x[k], y[k])
    it = pipeline.mixed_lm_iter(pairs.task_suite(tok, seed=2), 4, seed=5)
    jit = jpipeline.mixed_lm_iter(jpairs.task_suite(tok, seed=2), 4, seed=5)
    for _ in range(4):
        x, y = next(it), next(jit)
        assert set(x) == set(y)
        for k in x:
            np.testing.assert_array_equal(x[k], y[k])


def test_task_suite_matches_reference(tok):
    got, want = pairs.task_suite(tok, seed=7), jpairs.task_suite(tok, seed=7)
    assert [as_reference(a.cfg, b.cfg) for a, b in zip(got, want)] == \
        [dataclasses.asdict(b.cfg) for b in want]
    assert len(got) == len(want)


def test_load_pair_reads_a_reference_checkpoint(tmp_path, monkeypatch):
    """``load_pair`` restores a ``base.npz`` the reference wrote (here an
    untrained one this test writes, so nothing quick-trains), both roles
    one parameter set, and caches it per device."""
    jcfg = jpairs.pair_config()
    jp = jtfm.init_params(jcfg, jax.random.PRNGKey(4))
    jcheckpoint.save(os.path.join(tmp_path, "base"), jp, {"role": "base"})
    monkeypatch.setattr(pairs, "CKPT_DIR", str(tmp_path))
    monkeypatch.setattr(pairs, "_CACHE", {})
    monkeypatch.setattr(pairs, "_quick_train", None)   # never trains here
    cfg, tk, sender, receiver = pairs.load_pair(device="cpu")
    assert sender is receiver and cfg == port_cfg(jcfg)
    assert tk == pairs.pair_tokenizer()
    got = dict(checkpoint._paths(params_to_jax(sender, cfg)))
    for key, a in _flat(jp).items():
        assert _bits(got[key]) == _bits(a), key
    assert pairs.load_pair(device="cpu")[2] is sender


def test_train_launcher_on_cpu(tmp_path, capsys):
    """``python -m repro_torch.launch.train`` on reduced whisper (zero
    frames) for two steps, saving a checkpoint the reference reads."""
    path = os.path.join(tmp_path, "w")
    train_launch.main(["--arch", "whisper-medium", "--reduced", "--steps",
                       "2", "--batch", "2", "--seq", "8", "--device", "cpu",
                       "--save", path])
    out = capsys.readouterr().out
    assert "arch=whisper-medium device=cpu" in out and "step 1 loss" in out
    assert checkpoint.load_metadata(path)["steps"] == 2
    keys = np.load(path + ".npz").files
    assert "encoder/blocks/0/xattn/wq" not in keys
    assert "blocks/0/xattn/wq" in keys and "encoder/final_norm" in keys


def test_serve_launcher_loads_the_trained_pair(tmp_path, monkeypatch,
                                               capsys):
    """``launch.serve --weights trained`` serves the checkpointed pair
    (one this test writes: nothing quick-trains); random weights stay the
    default, and the trained pair needs ``--config pair``."""
    from repro_torch.launch import serve
    jp = jtfm.init_params(jpairs.pair_config(), jax.random.PRNGKey(5))
    jcheckpoint.save(os.path.join(tmp_path, "base"), jp, {"role": "base"})
    monkeypatch.setattr(pairs, "CKPT_DIR", str(tmp_path))
    monkeypatch.setattr(pairs, "_CACHE", {})
    monkeypatch.setattr(pairs, "_quick_train", None)
    serve.main(["--device", "cpu", "--decode-backend", "reference",
                "--requests", "3", "--max-new", "2", "--weights",
                "trained"])
    assert "served 3 requests" in capsys.readouterr().out
    assert ("pair", "cpu") in pairs._CACHE
    with pytest.raises(SystemExit):
        serve.main(["--device", "cpu", "--weights", "trained", "--config",
                    "full"])
