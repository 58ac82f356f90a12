"""tools/moe_gap_witness.py on the CPU at the tiny mellum2 cell of
``kvbench/tests/test_kvbench_moe_window.py``: its float32 reference with
the routing hooks on computes the family's reference, forcing the bf16
references onto their own routing changes nothing, the bf16-throughout
one lies nearer float32 than float8 does, and one seed's reading is
whole."""
import importlib.util
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from kvbench import generator, reference as ref  # noqa: E402
from kvbench.families import moe_window  # noqa: E402
from kvbench.harness import make_cell, make_param_sets  # noqa: E402

_spec = importlib.util.spec_from_file_location(
    "moe_gap_witness", ROOT / "tools" / "moe_gap_witness.py")
W = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(W)


def tiny_cell():
    """One period of mellum2's pattern (window 8, YaRN over 16 positions),
    8 experts top 2, bf16 weights, waves of 4 on the int8 wire."""
    model = dict(name="mellum2-tiny", arch_type="moe", num_layers=4,
                 d_model=128, num_heads=4, num_kv_heads=2, head_dim=32,
                 d_ff=64, vocab_size=512, rope_theta=5e5,
                 local_global_ratio=3, local_window=8,
                 yarn=[16.0, 16, 32.0, 1.0, 1.2772588722239782],
                 num_experts=8, num_experts_per_tok=2, norm_eps=1e-6,
                 tie_embeddings=False, ring_cache=False, dtype="bfloat16")
    mix = {"context": {"dist": "log_uniform", "min": 24, "max": 60},
           "query": {"dist": "uniform", "min": 4, "max": 9},
           "answer": {"dist": "uniform", "min": 3, "max": 7},
           "wave": 4, "capacity": 4, "transport": "serialized",
           "wire_dtype": "int8"}
    limits = {"gap_max": 1.0, "score_err": 1.0, "sel_mismatch": 0,
              "failed": 0, **{n: 1.0 for n in moe_window.EXTRA_NUMBERS}}
    return make_cell("mellum2-tiny.w", {"chips": 1}, {
        "name": "mellum2-tiny", "model": model, "mlp": "swiglu",
        "parameter_sets": 2, "family": "moe_window"},
        generator.validate(mix), {"sample_tokens": 20, "limits": limits})


@pytest.fixture(scope="module")
def setup():
    cell = tiny_cell()
    params = make_param_sets(cell, 5, torch.device("cpu"))
    g = np.random.default_rng(0)
    v = cell.model["vocab_size"]
    req = dict(contexts=[torch.as_tensor(g.integers(2, v, 30))],
               queries=[torch.as_tensor(g.integers(2, v, 5))],
               served=[torch.as_tensor(g.integers(2, v, 4))])
    return cell, params, req


def _logits(refs, req):
    return ref.served_logits(refs[0], refs[1], req["contexts"],
                             req["queries"], req["served"], [0, 3], "int8",
                             1)[0]


def test_hooked_float32_reference_is_the_familys(setup):
    cell, params, req = setup
    m, mlp = cell.model, cell.mlp
    Wit = W.witness_class(moe_window.Reference)
    want = _logits([moe_window.Reference(m, mlp, p) for p in params], req)
    hooked = [Wit(m, mlp, p, role=r)
              for p, r in zip(params, ("sender", "receiver"))]
    for x in hooked:
        x.record = {}
    got = _logits(hooked, req)
    assert torch.allclose(got, want, rtol=0, atol=1e-5 * float(
        want.abs().max()))
    # every layer of both roles recorded (the sender's last runs no ffn)
    L = m["num_layers"]
    assert {k for x in hooked for k in x.record} == \
        {("sender", i) for i in range(L - 1)} | \
        {("receiver", i) for i in range(L)}


@pytest.mark.parametrize("mode", ["bf16", "bf16_all"])
def test_forcing_a_bf16_reference_onto_its_own_routing(setup, mode):
    cell, params, req = setup
    m, mlp, k = cell.model, cell.mlp, cell.model["num_experts_per_tok"]
    Wit = W.witness_class(moe_window.Reference)
    rb = [Wit(m, mlp, p, role=r, **{mode: True})
          for p, r in zip(params, ("sender", "receiver"))]
    plain = _logits(rb, req)
    for x in rb:
        x.record = {}
    _logits(rb, req)
    force = W.top_idx({**rb[0].record, **rb[1].record}, k)
    for x in rb:
        x.record, x.force = None, force
    assert torch.equal(_logits(rb, req), plain)


def test_one_seed_reading_is_whole():
    out = W.witness(tiny_cell(), 7, torch.device("cpu"))
    prog = out["token_gaps"]["program"]
    assert len(prog) == out["sampled_requests"]
    assert sum(len(g) for g in prog) == out["sampled_tokens"]
    for side in ("program", "control_fp8", "bf16_reference",
                 "bf16_all_reference"):
        s = out[side]
        assert 0 <= s["median"] <= s["p90"] <= s["p99"] <= s["max"]
        assert len(s["request_max"]) == out["sampled_requests"]
    w = out["worst"]
    assert w["program_gap"] == out["program"]["max"]
    assert len(w["routing"]) == cell_layers()
    assert np.isfinite(w["bf16_ref_forced_gap"])
    assert 0 <= w["request_flips"]["pairs_flipped"] <= \
        w["request_flips"]["pairs"]


def cell_layers():
    return tiny_cell().model["num_layers"]


def test_bf16_all_reference_rounds_more_than_products_alone(setup):
    """Rounding the residual stream and the rest moves the logits further
    from float32 than bf16 products alone, and less than float8."""
    cell, params, req = setup
    m, mlp = cell.model, cell.mlp
    Wit = W.witness_class(moe_window.Reference)

    def run(**kw):
        return _logits([Wit(m, mlp, p, role=r, **kw)
                        for p, r in zip(params, ("sender", "receiver"))],
                       req)
    exact = run()
    err = {n: float((run(**kw) - exact).abs().max()) for n, kw in (
        ("bf16", dict(bf16=True)), ("all", dict(bf16_all=True)),
        ("fp8", dict(mode="fp8")))}
    assert 0 < err["bf16"] < err["all"] < err["fp8"], err
