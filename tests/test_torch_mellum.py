"""mellum2-12b in the port, on the CPU at a small size: one period of its
layer pattern (3 windowed layers, window 8, then a full one under YaRN
with an original length of 16, so the window and the ramp both bite
within the tests' positions), 8 experts top 2, d 128, float32 weights
drawn from a seed. The program is held against the float32 plain
reference of the benchmark's ``moe_window`` family
(``kvbench/families/moe_window.py``, which imports nothing of the
program): a prefill and then decode through the cache against the
reference's full forward, and a whole ``Scheduler.run`` with a KVComm
session on the int8 wire against the reference's round. Tolerances are
float32 ones (the same arithmetic in another summation order); each is
written beside its reason."""
import dataclasses
import math
import sys
from pathlib import Path
from types import SimpleNamespace
from unittest import mock

import numpy as np
import pytest
import torch
from torch.distributed.tensor import DTensor

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from kvbench import check, generator  # noqa: E402
from kvbench.families import moe_window  # noqa: E402
from kvbench.harness import Bench, make_cell  # noqa: E402
from repro_torch.configs.registry import get_config  # noqa: E402
from repro_torch.kernels.moe_grouped import (dispatch,  # noqa: E402
                                             grouped_experts_reference)
from repro_torch.models import layers  # noqa: E402
from repro_torch.models import transformer as tfm  # noqa: E402

CFG = get_config("mellum2-12b").reduced(num_experts=8, num_experts_per_tok=2,
                                        dtype="float32")
# the reference's view of the same model (the port's field names)
MODEL = {f: getattr(CFG, f) for f in (
    "num_layers", "d_model", "num_heads", "num_kv_heads", "d_ff",
    "vocab_size", "rope_theta", "local_global_ratio", "local_window",
    "num_experts", "num_experts_per_tok", "norm_eps")}
MODEL.update(head_dim=CFG.resolved_head_dim, yarn=list(CFG.yarn))


def test_registered_config_is_the_published_model():
    cfg = get_config("mellum2-12b")
    assert (cfg.num_layers, cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
            cfg.resolved_head_dim, cfg.d_ff, cfg.vocab_size) == \
        (28, 2304, 32, 4, 128, 896, 98304)
    assert (cfg.num_experts, cfg.num_experts_per_tok, cfg.moe_impl) == \
        (64, 8, "dense_all")
    assert (cfg.local_global_ratio, cfg.local_window, cfg.rope_theta,
            cfg.norm_eps, cfg.tie_embeddings, cfg.ring_cache) == \
        (3, 1024, 5e5, 1e-6, False, False)
    assert cfg.yarn == (16.0, 8192, 32.0, 1.0, 1.2772588722239782)


def test_layer_plan_is_seven_periods_of_experts():
    cfg = get_config("mellum2-12b")
    plan = cfg.layer_plan()
    assert [(s.count, s.window) for s in plan] == [(3, 1024), (1, None)] * 7
    assert all(s.moe and s.kind == "attn" for s in plan)
    assert cfg.attn_layer_count == 28
    # the CPU size keeps one whole period, experts in each layer
    assert [(s.count, s.window, s.moe) for s in CFG.layer_plan()] == \
        [(3, 8, True), (1, None, True)]
    assert CFG.yarn[1] == 16
    # gemma3's pattern carries no experts, as before
    assert not any(s.moe for s in get_config("gemma3-4b").layer_plan())


# ---- YaRN -------------------------------------------------------------------
def _yarn_written_out(d, theta, factor, orig, beta_fast, beta_slow, att,
                      x, pos):
    """YaRN's rotation in float64 from its formula: ramp ends floor / ceil
    of d ln(L0 / (2 pi beta)) / (2 ln theta) clamped to [0, d/2 - 1];
    interpolated frequencies theta^(-2i/d) / factor past the ramp, the
    plain ones before it; cos and sin times the attention factor."""
    half = d // 2
    i = np.arange(half, dtype=np.float64)
    plain = theta ** (-2 * i / d)
    low = math.floor(d * math.log(orig / (2 * math.pi * beta_fast))
                     / (2 * math.log(theta)))
    high = math.ceil(d * math.log(orig / (2 * math.pi * beta_slow))
                     / (2 * math.log(theta)))
    low, high = min(max(low, 0), half - 1), min(max(high, 0), half - 1)
    ramp = np.clip((i - low) / max(high - low, 1e-3), 0, 1)
    freq = plain / factor * ramp + plain * (1 - ramp)
    ang = np.asarray(pos, np.float64)[:, None, None] * freq
    c, s = np.cos(ang) * att, np.sin(ang) * att
    x1, x2 = x[..., :half], x[..., half:]
    return np.concatenate([x1 * c - x2 * s, x2 * c + x1 * s], -1), low, high


@pytest.mark.parametrize("d,theta,orig", [(32, 5e5, 16), (128, 5e5, 8192)])
def test_rope_with_yarn_matches_the_formula(d, theta, orig):
    """Below and above the original length. The program computes the
    angles in float32 (as the plain RoPE does): at position 20,000 an
    angle is off by up to half an ulp of 20,000 in float32, 1e-3 radians,
    on components of x up to ~3 scaled by the attention factor 1.28, so
    4e-3 absolute; the CPU size's ramp is 0..2 and the published
    widths' 18..35."""
    yarn = (16.0, orig, 32.0, 1.0, 1.2772588722239782)
    pos = np.array([0, 1, 7, orig - 1, orig, orig + 1, 3 * orig, 20000])
    x = np.random.default_rng(0).standard_normal((len(pos), 2, d))
    want, low, high = _yarn_written_out(d, theta, *yarn, x, pos)
    assert (low, high) == ((0, 2) if d == 32 else (18, 35))
    got = layers.rope(torch.tensor(x, dtype=torch.float32)[None],
                      torch.tensor(pos)[None], theta, yarn)[0]
    np.testing.assert_allclose(got.numpy(), want, atol=4e-3, rtol=0)
    # without YaRN the same call is the plain rotation, bit for bit
    plain = layers.rope(torch.tensor(x, dtype=torch.float32)[None],
                        torch.tensor(pos)[None], theta)
    assert not torch.equal(plain[0], got)
    freq = torch.exp(-math.log(theta) * torch.arange(d // 2) / (d // 2))
    f = layers.yarn_freqs(freq, theta, yarn)
    assert torch.equal(f[:low + 1], freq[:low + 1])
    assert torch.allclose(f[high:], freq[high:] / 16.0, rtol=1e-6)


def test_windowed_layers_keep_plain_rope():
    assert layers.layer_yarn(CFG, 8) is None
    assert layers.layer_yarn(CFG, None) == CFG.yarn
    assert layers.layer_yarn(get_config("gemma3-4b"), None) is None


# ---- the grouped expert path ------------------------------------------------
@pytest.mark.parametrize("bm", [16, 2])
def test_grouped_dispatch_and_combine_equal_dense_all(bm):
    """In float32 on the CPU the plain grouped path (the sort by expert,
    the tile table, each tile's products, the gated rows summed over each
    token's slots) computes dense_all's function: equal up to float32
    summation order, 1e-5 of the largest output. ``bm`` 2 cuts an
    expert's rows into several tiles."""
    p = tfm.init_params(CFG, 3, device="cpu")["layers"][0]["moe"]
    x = torch.randn(2, 13, CFG.d_model, generator=torch.Generator()
                    .manual_seed(1))
    k = CFG.num_experts_per_tok
    want, aux = layers.apply_moe_dense_all(p, x, k)
    gates, idx, _ = layers.router_probs(p, x, k)
    got = grouped_experts_reference(
        x.reshape(26, -1), p["w_gate"], p["w_up"], p["w_down"],
        gates.reshape(26, k), idx.reshape(26, k), bm).reshape(x.shape)
    assert float((got - want).abs().max()) <= 1e-5 * float(
        want.abs().max())
    out, aux2 = layers.apply_moe_grouped(p, x, k)
    assert float((out - want).abs().max()) <= 1e-5 * float(
        want.abs().max())
    assert torch.equal(aux, aux2)


def test_dispatch_tiles_cover_every_assignment_once():
    idx = torch.tensor([[3, 1], [3, 0], [1, 3], [3, 2], [0, 3]])
    order, tile_e, row0, rend = dispatch(idx, 5, 2)
    assert tile_e.shape == (-(-10 // 2) + 5,)
    eid = idx.reshape(-1)[order]
    seen = []
    for e, a, b in zip(tile_e.tolist(), row0.tolist(), rend.tolist()):
        rows = list(range(a, min(b, a + 2)))
        assert all(int(eid[r]) == e for r in rows)
        seen += rows
    assert sorted(seen) == list(range(10))
    # each expert's assignments in token order
    assert order.tolist() == [3, 8, 1, 4, 7, 0, 2, 5, 6, 9]


def _moe_x(dtype=torch.bfloat16, is_cuda=True, requires_grad=False,
           dtensor=False):
    """A stand-in for the MoE's input: what the rule reads of a tensor."""
    x = mock.MagicMock(spec=DTensor) if dtensor else SimpleNamespace()
    x.dtype, x.is_cuda, x.requires_grad = dtype, is_cuda, requires_grad
    return x


def _moe_p(grad=()):
    """Stand-ins for the router and experts, ``grad`` naming those that
    need a gradient."""
    return {n: SimpleNamespace(requires_grad=n in grad)
            for n in ("router", "w_gate", "w_up", "w_down")}


def test_grouped_path_is_taken_on_the_card_only():
    x = torch.zeros(1, 2, CFG.d_model, dtype=torch.bfloat16)
    bf16 = dataclasses.replace(CFG, dtype="bfloat16")
    p = _moe_p()
    assert not layers.moe_on_kernel(p, x, bf16)         # the CPU: the loop
    assert not layers.moe_on_kernel(p, x.float(), CFG)
    assert not layers.moe_on_kernel(
        p, x, dataclasses.replace(bf16, moe_impl="dropping"))
    assert layers.moe_on_kernel(p, _moe_x(), bf16)       # the card's call
    assert layers.moe_on_kernel(p, _moe_x(torch.float16), bf16)


@pytest.mark.parametrize("case", [
    "float32", "cpu", "dtensor", "x_grad", "router_grad", "w_gate_grad",
    "w_up_grad", "w_down_grad"])
def test_grouped_path_keeps_the_loop(case):
    """Each single departure from the card's call keeps the loop: float32,
    the CPU, a DTensor (a mesh), and autograd through x or through any of
    the weights, which the kernel reads as raw pointers (a frozen input
    with trained experts must still get their gradients)."""
    bf16 = dataclasses.replace(CFG, dtype="bfloat16")
    x = _moe_x(dtype=torch.float32 if case == "float32" else torch.bfloat16,
               is_cuda=case != "cpu", dtensor=case == "dtensor",
               requires_grad=case == "x_grad")
    p = _moe_p(grad=(case[:-5],) if case.endswith("_grad") else ())
    assert not layers.moe_on_kernel(p, x, bf16)
    with torch.no_grad():           # without autograd the weights' flag
        if case.endswith("_grad"):  # does not matter
            assert layers.moe_on_kernel(p, x, bf16)


# ---- the model against the reference ----------------------------------------
@pytest.fixture(scope="module")
def params():
    return tfm.init_params(CFG, 0, device="cpu")


@pytest.mark.parametrize("backend", ["reference", "kernel"])
def test_prefill_then_decode_match_the_reference(params, backend):
    """A prefill of 20 tokens and 20 one-token decode steps through the
    cache (teacher forced) give the reference's full-forward logits at
    every position: positions run past the window (8) and YaRN's original
    length (16). float32 on both sides; 2e-5 of the largest logit covers
    summation order and the program's float32 rotary angles (the largest
    difference read is 3e-6 of it)."""
    g = torch.Generator().manual_seed(5)
    toks = torch.randint(0, CFG.vocab_size, (1, 40), generator=g)
    ref = moe_window.Reference(MODEL, "swiglu", params)
    want = ref.receiver([toks[0]], [0], [{}], [40])[0]
    cache = tfm.init_cache(CFG, 1, 40, device="cpu")
    out = tfm.apply_model(params, CFG, toks[:, :20], mode="cached",
                          cache=cache, decode_backend=backend)
    got = [out.logits[0]]
    cache = out.cache
    for i in range(20, 40):
        out = tfm.apply_model(params, CFG, toks[:, i:i + 1], mode="cached",
                              cache=cache, decode_backend=backend)
        cache = out.cache
        got.append(out.logits[0])
    got = torch.cat(got)
    tol = 2e-5 * float(want.abs().max())
    assert float((got - want).abs().max()) <= tol
    # the window and YaRN matter at these positions: the reference
    # without either lies past the tolerance by a factor of ten
    for drop in ({"local_window": 10 ** 9}, {"yarn": None}):
        wrong = moe_window.Reference(dict(MODEL, **drop), "swiglu",
                                     params).receiver(
            [toks[0]], [0], [{}], [40])[0]
        assert float((wrong - want).abs().max()) > 10 * tol


def _cell(limits):
    mix = {"context": {"dist": "log_uniform", "min": 24, "max": 60},
           "query": {"dist": "uniform", "min": 4, "max": 9},
           "answer": {"dist": "uniform", "min": 3, "max": 7},
           "wave": 4, "capacity": 4, "transport": "serialized",
           "wire_dtype": "int8"}
    model = {**MODEL, "name": "mellum2-tiny", "arch_type": "moe",
             "head_dim": CFG.resolved_head_dim, "tie_embeddings": False,
             "ring_cache": False, "dtype": "float32"}
    return make_cell("mellum2-tiny.t", {"chips": 1}, {
        "name": "mellum2-tiny", "model": model, "mlp": "swiglu",
        "parameter_sets": 2, "family": "moe_window"},
        generator.validate(mix), {"sample_tokens": 30, "limits": limits})


@pytest.mark.parametrize("seed", [100, 2**31 + 7])
def test_scheduler_round_matches_the_reference(seed):
    """Two float32 agents (seed, seed + 1), calibrated, a wave of 4
    requests through ``Scheduler.run`` on the kernel backend and the int8
    wire: every served token lies within 1e-4 of the reference's best
    logit at its position (float32 on both sides; the int8 wire is the
    same rounding in both; read: 0), the Eq. (1) scores within 1e-5
    (read: 4e-7), and the
    selection follows the paper's rule exactly. The window (8) and YaRN
    (original length 16) both act: contexts are 24-60 tokens."""
    limits = {"gap_max": 1e-4, "score_err": 1e-5, "sel_mismatch": 0,
              "failed": 0, "gap_p99": 1e-4, "gap_mean": 1e-4}
    cell = _cell(limits)
    b = Bench(cell, seed, "cpu")
    wave = b.run_wave(generator.wave(cell.mix, seed, 0,
                                     MODEL["vocab_size"]))
    calib = check.Served(rid=-1, context=b.calib.context,
                         query=b.calib.query, answer=0, tokens=None)
    fam = cell.family
    nums = check.numbers(
        sender=fam.Reference(cell.model, "swiglu", b.params[0]),
        receiver=fam.Reference(cell.model, "swiglu", b.params[1]),
        served=b.served([wave]), calib=calib, prog_scores=b.scores,
        prog_select=b.select, ratio=0.5, alpha=0.7, wire=b.wire, bos=1,
        seed=seed, sample_tokens=30, family=fam)
    assert check.verdict(nums, limits, cell.numbers), nums
    assert nums["sampled_tokens"] >= 12
