"""The port's distribution layer held to the reference's, in process (no
process group: the sharded runs are in ``tests/test_torch_sharded.py``).

``param_spec`` equals the reference's ``PartitionSpec`` for every leaf of
every registered config on both production axis layouts, and the port's
per-layer specs are the reference's stacked ones with the layer axis
dropped; ``_sanitize``, ``combo_skip_reason`` and ``utils/analytic.py``
equal the reference's; ``utils/costs.py`` counts collectives by
``hlo.py``'s rules; the hints leave plain tensors untouched; and
checkpointing each layer (``cfg.remat``) leaves train-step gradients bit
for bit what they are without it, within 1e-5 of ``jax.grad``."""
import dataclasses
import functools
import os
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_bridge import port_cfg, port_params
from repro.configs.base import INPUT_SHAPES as JINPUT_SHAPES
from repro.configs.registry import ASSIGNED_ARCHS as JASSIGNED
from repro.configs.registry import get_config as jget_config
from repro.distributed import sharding as jshd
from repro.models import transformer as jtfm
from repro.training import train_loop as jtl
from repro.utils import analytic as janalytic
from repro_torch.configs.base import INPUT_SHAPES
from repro_torch.configs.registry import ASSIGNED_ARCHS, get_config, \
    reference_archs
from repro_torch.distributed import hints
from repro_torch.distributed import sharding as shd
from repro_torch.launch import dryrun
from repro_torch.launch.specs import params_specs
from repro_torch.training import checkpoint
from repro_torch.training.optimizer import leaves
from repro_torch.training.train_loop import _grads, to_batch
from repro_torch.utils import analytic
from repro_torch.utils.costs import CostMode, collective_kind
from repro_torch.weights import params_to_jax

MESHES = {"pod": (("data", "model"), (16, 16)),
          "multipod": (("pod", "data", "model"), (2, 16, 16))}


def _mesh(layout):
    names, shape = MESHES[layout]
    return SimpleNamespace(mesh_dim_names=names, shape=shape,
                           ndim=len(shape))


def _jmesh(layout):
    """A stand-in with the reference's ``mesh.shape`` mapping."""
    names, shape = MESHES[layout]
    return SimpleNamespace(shape=dict(zip(names, shape)), axis_names=names)


@functools.lru_cache(maxsize=None)
def _jshapes(arch):
    """{path: stacked shape} of the reference's parameter tree."""
    tree = jax.eval_shape(lambda: jtfm.init_params(jget_config(arch),
                                                   jax.random.PRNGKey(0)))
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        key = tuple(getattr(p, "key", getattr(p, "idx", p)) for p in path)
        out[key] = tuple(leaf.shape)
    return out


def _port_leaves(cfg, params):
    """(reference path, port leaf) of every port parameter: each layer of
    run ``ri`` maps to ``blocks/ri``, the encoder's to
    ``encoder/blocks/0``, Zamba2's shared block to ``shared_attn``."""
    def walk(tree, prefix):
        for k, v in tree.items():
            if isinstance(v, dict):
                yield from walk(v, prefix + (k,))
            else:
                yield prefix + (k,), v

    top = {k: v for k, v in params.items()
           if k not in ("layers", "encoder")}
    yield from walk(top, ())
    i = 0
    for ri, spec in enumerate(cfg.layer_plan()):
        if spec.kind != "shared_attn":
            for lp in params["layers"][i:i + spec.count]:
                yield from walk(lp, ("blocks", ri))
        i += spec.count
    if "encoder" in params:
        for lp in params["encoder"]["layers"]:
            yield from walk(lp, ("encoder", "blocks", 0))
        yield ("encoder", "final_norm"), params["encoder"]["final_norm"]


# ---------------------------------------------------------------------------
# sharding rules (a superset of tests/test_distributed.py::TestParamSpecRules)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("layout", sorted(MESHES))
@pytest.mark.parametrize("arch", reference_archs())
def test_param_spec_matches_reference_for_every_leaf(arch, layout):
    """Every leaf of the reference's tree: the same spec from the same
    stacked shape at tp_size 16; then the port's per-layer tree gets the
    reference's sanitized spec with its stacked axis dropped."""
    dp = "data" if layout == "pod" else ("pod", "data")
    jcfg, cfg = jget_config(arch), get_config(arch)
    jshapes = _jshapes(arch)
    for path, shape in jshapes.items():
        name = str(path[-1])
        want = jshd.param_spec(jcfg, name, shape, dp=dp, tp="model",
                               tp_size=16)
        got = shd.param_spec(cfg, name, shape, dp=dp, tp="model",
                             tp_size=16)
        assert tuple(want) == got, (path, want, got)
    params = params_specs(cfg)
    specs = shd.param_specs(cfg, _mesh(layout), params)
    by_id = {id(t): s for t, s in zip(leaves(params), leaves_specs(
        params, specs))}
    n = 0
    for path, leaf in _port_leaves(cfg, params):
        shape = jshapes[path]
        want = tuple(jshd._sanitize(jshd.param_spec(
            jcfg, str(path[-1]), shape, dp=dp, tp="model", tp_size=16),
            shape, _jmesh(layout)))
        lead = len(shape) - leaf.dim()
        want = tuple(want[lead:])
        assert by_id[id(leaf)] == want, (path, want, by_id[id(leaf)])
        n += 1
    assert n >= len(jshapes)


def leaves_specs(params, specs):
    """The spec tree's leaves in the parameter tree's leaf order."""
    out, seen = [], set()

    def walk(p, s):
        if isinstance(p, torch.Tensor):
            if id(p) not in seen:
                seen.add(id(p))
                out.append(s)
            return
        items = p.items() if isinstance(p, dict) else enumerate(p)
        for k, v in items:
            walk(v, s[k])
    walk(params, specs)
    return out


@pytest.mark.parametrize("spec,shape,layout", [
    (("data", "model"), (7, 7), "pod"),
    (("data", "model"), (32, 48), "pod"),
    ((None, ("data", "model")), (3, 512), "pod"),
    ((None, ("data", "model")), (3, 384), "pod"),
    ((("pod", "data"), "model"), (64, 16), "multipod"),
    ((("pod", "data"), "model"), (48, 16), "multipod"),
    (("model", None, "data", None), (16, 2, 32, 5), "pod"),
])
def test_sanitize_matches_reference(spec, shape, layout):
    from jax.sharding import PartitionSpec as P
    want = jshd._sanitize(P(*spec), shape, _jmesh(layout))
    assert shd._sanitize(spec, shape, _mesh(layout)) == tuple(want)


def test_to_placements_orders_axes_as_the_mesh():
    from torch.distributed.tensor import Replicate, Shard
    mesh = _mesh("multipod")
    assert shd.to_placements((("pod", "data"), "model"), mesh) == (
        Shard(0), Shard(0), Shard(1))
    assert shd.to_placements((None, None), mesh) == (Replicate(),) * 3
    assert shd.replicated(mesh, {"a": [torch.zeros(2)]}) == {
        "a": [(Replicate(),) * 3]}
    with pytest.raises(ValueError):
        shd.to_placements((("data", "pod"),), mesh)


# ---------------------------------------------------------------------------
# the dry run's combo table, the analytic model
# ---------------------------------------------------------------------------
def test_combo_table_matches_reference():
    """40 combos, 6 documented skips, the reference's for each."""
    # the reference's dry run sets XLA_FLAGS (512 host devices) when
    # imported: bring JAX's backend up first and restore the variable
    jax.devices()
    saved = os.environ.get("XLA_FLAGS")
    from repro.launch import dryrun as jdryrun
    if saved is None:
        os.environ.pop("XLA_FLAGS", None)
    else:
        os.environ["XLA_FLAGS"] = saved
    assert ASSIGNED_ARCHS == JASSIGNED
    assert list(INPUT_SHAPES) == list(JINPUT_SHAPES)
    n_ok = n_skip = 0
    for a in ASSIGNED_ARCHS:
        for s in INPUT_SHAPES:
            reason = dryrun.combo_skip_reason(a, s)
            assert reason == jdryrun.combo_skip_reason(a, s)
            assert INPUT_SHAPES[s].__dict__ == JINPUT_SHAPES[s].__dict__
            n_skip += reason is not None
            n_ok += reason is None
    assert (n_ok + n_skip, n_skip) == (40, 6)


@pytest.mark.parametrize("arch", reference_archs())
def test_analytic_matches_reference(arch):
    """job_cost, forward_flops (window-aware and not), param_count,
    active_param_count and param_bytes: identical for every shape."""
    cfg, jcfg = get_config(arch), jget_config(arch)
    for f in ("param_count", "active_param_count", "param_bytes"):
        assert getattr(analytic, f)(cfg) == getattr(janalytic, f)(jcfg), f
    for name, shape in INPUT_SHAPES.items():
        got, want = analytic.job_cost(cfg, shape), janalytic.job_cost(
            jcfg, JINPUT_SHAPES[name])
        assert dataclasses.asdict(got) == dataclasses.asdict(want), name
        assert got.total_bytes == want.total_bytes
        T = shape.global_batch * shape.seq_len
        for wa in (False, True):
            assert analytic.forward_flops(
                cfg, T, shape.seq_len, batch=shape.global_batch,
                window_aware=wa) == janalytic.forward_flops(
                jcfg, T, shape.seq_len, batch=shape.global_batch,
                window_aware=wa), (name, wa)


# ---------------------------------------------------------------------------
# cost counters (the counterpart of tests/test_distributed.py::TestHLOParsing)
# ---------------------------------------------------------------------------
def _op(namespace, opname):
    return SimpleNamespace(namespace=namespace, _opname=opname)


def test_collective_kinds():
    assert collective_kind(_op("_c10d_functional",
                               "all_gather_into_tensor")) == "all-gather"
    assert collective_kind(_op("_c10d_functional",
                               "reduce_scatter_tensor")) == "reduce-scatter"
    assert collective_kind(_op("_c10d_functional", "all_reduce")) == \
        "all-reduce"
    assert collective_kind(_op("c10d", "allreduce_")) == "all-reduce"
    assert collective_kind(_op("_c10d_functional",
                               "all_to_all_single")) == "all-to-all"
    assert collective_kind(_op("aten", "all")) is None
    assert collective_kind(_op("_c10d_functional", "wait_tensor")) is None


def test_collective_bytes_of_a_known_trace():
    """A trace of known collectives, as ``collective_bytes`` reads HLO: an
    all-gather's bf16[16, 128] result, an f32[4, 4] all-reduce (twice its
    bytes) and a tuple all-reduce of two f32[8], then plain ops that count
    nothing."""
    mode = CostMode()
    ag = torch.zeros(16, 128, dtype=torch.bfloat16)
    ar = torch.zeros(4, 4)
    pair = (torch.zeros(8), torch.zeros(8))
    for name, out in (("all_gather_into_tensor", ag), ("all_reduce", ar),
                      ("all_reduce_coalesced", pair)):
        mode._collective(collective_kind(_op("_c10d_functional", name)),
                         out)
    with mode:
        torch.ones(2, 2) + torch.ones(2, 2)
    out = mode.summary()["collectives"]
    assert out["all-gather"] == 16 * 128 * 2
    assert out["all-reduce"] == 2 * (4 * 4 * 4) + 2 * (8 * 4 * 2)
    assert out["total"] == out["all-gather"] + out["all-reduce"]
    assert mode.summary()["op_census"]["all-reduce"] == 2


def test_cost_mode_counts_an_unsharded_step():
    """Without a mesh: FLOPs of the products (flops_job = flops), bytes
    of every non-view op, no collectives."""
    a, b = torch.randn(8, 16), torch.randn(16, 4)
    with CostMode() as mode:
        c = (a @ b).t()
    s = mode.summary()
    assert s["flops"] == s["flops_job"] == 2 * 8 * 16 * 4
    assert s["bytes_accessed"] == (8 * 16 + 16 * 4 + 8 * 4) * 4
    assert s["collectives"] == {"total": 0}
    assert s["op_census"] == {"dot": 1, "transpose": 1}
    assert c.shape == (4, 8)


# ---------------------------------------------------------------------------
# hints: no-ops on plain tensors
# ---------------------------------------------------------------------------
def test_hints_leave_plain_tensors_untouched():
    x = torch.randn(4, 8, 16)
    for fn in (hints.shard_activations, hints.shard_logits,
               hints.gather_sequence):
        assert fn(x) is x
    hints.set_axes("data", "model")
    try:
        for fn in (hints.shard_activations, hints.shard_logits,
                   hints.gather_sequence):
            assert fn(x) is x
    finally:
        hints.clear()
    assert shd.unshard_data({"w": x})["w"] is x
    assert shd.reduce_partial(x) is x


# ---------------------------------------------------------------------------
# remat: checkpointed layers change no value
# ---------------------------------------------------------------------------
def test_remat_gradients_bit_equal_and_match_reference(tiny_cfg,
                                                       tiny_params):
    """tiny_cfg with ``remat`` on: the port's gradients equal those with it
    off bit for bit, and every leaf is within 1e-5 (relative, in norm) of
    the reference's ``jax.grad`` with its own checkpointed scans."""
    jcfg = dataclasses.replace(tiny_cfg, remat=True)
    cfg, p = port_cfg(jcfg), port_params(tiny_params)
    rng = np.random.default_rng(0)
    batch = {k: rng.integers(0, cfg.vocab_size, (4, 12)).astype(np.int32)
             for k in ("tokens", "targets")}
    l1, _, g1 = _grads(p, cfg, to_batch(batch, "cpu"))
    l0, _, g0 = _grads(p, dataclasses.replace(cfg, remat=False),
                       to_batch(batch, "cpu"))
    assert torch.equal(l1, l0)
    assert all(torch.equal(a, b) for a, b in zip(leaves(g1), leaves(g0)))
    (jl, _), jg = jax.value_and_grad(jtl.loss_fn, has_aux=True)(
        tiny_params, jcfg, {k: jnp.asarray(a) for k, a in batch.items()})
    assert float(l1) == pytest.approx(float(jl), rel=1e-5)
    want = dict(checkpoint._paths(jax.tree.map(np.asarray, jg)))
    got = dict(checkpoint._paths(params_to_jax(g1, cfg)))
    assert set(want) == set(got)
    for key, a in want.items():
        err = np.linalg.norm(got[key] - a) / max(np.linalg.norm(a), 1e-30)
        assert err <= 1e-5, (key, err)
