"""The ``moe_window`` family (``mellum2-12b``): its configuration file,
leaves and counts at the published widths, and a tiny cell of it run
whole on the CPU: one period of the layer pattern (3 windowed layers,
window 8, then a full one under YaRN with an original length of 16), 8
experts top 2, bf16. The limits below were read from seeds 100-105 at
this size: the program's widest gap <= 0.22 and its p99 <= 0.18; the
float8 control's >= 0.47 and >= 0.44; the planted faults' (seed 100)
>= 0.67 (routing without renormalisation), 0.69 (YaRN left out) and
1.4 (a window one position wider). At four layers a bf16 routing flip
can push one request's gap past these limits on a rare seed (2^31 + 3
reads 0.68, one seed in ten read): the tests here run seeds of the range
read, and it is the cell's own check at the published widths that holds
the program on the card; ``tests/test_torch_mellum.py`` holds it to the
reference in float32 at 1e-4."""
import json
import math
import time

import numpy as np
import pytest
import torch

from conftest import ROOT
from kvbench import check, counts, families, generator, weights
from kvbench.families import moe_window
from kvbench.harness import Bench, Record, Wave, load_cell, make_cell

CELL = "mellum2-12b.doc_qa_8k"
H100 = "NVIDIA H100 80GB HBM3"
TINY = dict(name="mellum2-tiny", arch_type="moe", num_layers=4, d_model=128,
            num_heads=4, num_kv_heads=2, head_dim=32, d_ff=64,
            vocab_size=512, rope_theta=5e5, local_global_ratio=3,
            local_window=8, yarn=[16.0, 16, 32.0, 1.0, 1.2772588722239782],
            num_experts=8, num_experts_per_tok=2, norm_eps=1e-6,
            tie_embeddings=False, ring_cache=False, dtype="bfloat16")
LIMITS = {"gap_max": 0.35, "score_err": 0.02, "sel_mismatch": 0,
          "failed": 0, "gap_p99": 0.3, "gap_mean": 0.05}


def tiny_cell():
    mix = {"context": {"dist": "log_uniform", "min": 24, "max": 60},
           "query": {"dist": "uniform", "min": 4, "max": 9},
           "answer": {"dist": "uniform", "min": 3, "max": 7},
           "wave": 4, "capacity": 4, "transport": "serialized",
           "wire_dtype": "int8"}
    return make_cell("mellum2-tiny.t", {"chips": 1}, {
        "name": "mellum2-tiny", "model": TINY, "mlp": "swiglu",
        "parameter_sets": 2, "family": "moe_window"},
        generator.validate(mix), {"sample_tokens": 20, "limits": LIMITS})


# ---- the configuration ------------------------------------------------------
def test_config_resolves_to_the_family(manifest):
    cf = json.loads((ROOT / "kvbench/configs/mellum2-12b.json").read_text())
    assert families.of(cf) is moe_window
    cell = load_cell(manifest, CELL)
    assert cell.family is moe_window
    assert cell.numbers == check.NUMBERS + ("gap_p99", "gap_mean")
    m = cf["model"]
    # the published config's numbers, kept under their own keys, are the
    # ones run
    assert (cf["num_hidden_layers"], cf["hidden_size"],
            cf["num_attention_heads"], cf["num_key_value_heads"],
            cf["head_dim"], cf["moe_intermediate_size"], cf["vocab_size"],
            cf["num_experts"], cf["num_experts_per_tok"],
            cf["sliding_window"], cf["rms_norm_eps"]) == \
        (m["num_layers"], m["d_model"], m["num_heads"], m["num_kv_heads"],
         m["head_dim"], m["d_ff"], m["vocab_size"], m["num_experts"],
         m["num_experts_per_tok"], m["local_window"], m["norm_eps"])
    yarn = cf["rope_parameters"]["full_attention"]
    assert m["yarn"] == [yarn["factor"],
                         yarn["original_max_position_embeddings"],
                         yarn["beta_fast"], yarn["beta_slow"],
                         yarn["attention_factor"]]
    assert m["rope_theta"] == yarn["rope_theta"] == cf["rope_parameters"][
        "sliding_attention"]["rope_theta"]
    kinds = ["sliding_attention" if w else "full_attention"
             for w in moe_window.windows(m)]
    assert kinds == cf["layer_types"]
    assert cf["reduced"] == {} and cf["parameter_sets"] == 2


def test_config_file_matches_the_registered_widths():
    """The configuration as run is the port's registered one, nothing cut;
    a JSON list (``yarn``) is the registered tuple."""
    import dataclasses
    from repro_torch.configs.registry import get_config
    reg = dataclasses.asdict(get_config("mellum2-12b"))
    cf = json.loads((ROOT / "kvbench/configs/mellum2-12b.json").read_text())
    for k, v in cf["model"].items():
        assert reg[k] == (tuple(v) if isinstance(v, list) else v), k
    assert cf["reduced"] == {}


def test_manifest_entries_of_the_cell(manifest):
    """The cell reads each accepted per-layer metric of the doc_qa cells
    once, under ``<metric>.mellum2``, with the accepted entry's unit,
    layer, source and end-to-end metric, and the three new readers under
    their own names; it is held to both timed end-to-end metrics."""
    cell = "mellum2-12b.doc_qa_8k"
    per = {e["name"]: e for e in manifest["per_layer"]}
    e2e = {e["name"]: e for e in manifest["end_to_end"]}
    base = [n for n, e in per.items() if "." not in n
            and "starcoder2-7b.doc_qa" in e.get("workloads", [])]
    assert len(base) == 13
    keys = ("unit", "better", "layer", "source", "moves")
    for n in base:
        mel = per[n + ".mellum2"]
        assert {k: mel[k] for k in keys} == {k: per[n][k] for k in keys}
        assert mel["workloads"] == [cell]
        assert cell not in per[n]["workloads"]
    for n in ("moe_roofline_pct", "moe_stream_ms", "decode_kernel_pct"):
        assert per[n]["workloads"] == [cell]
        assert per[n]["moves"] == "tokens_per_s"
    for n in ("tokens_per_s", "ttft_p90_ms"):
        assert e2e[n]["workloads"][-1] == cell
    reading = [n for n, e in per.items() if cell in e.get("workloads", [])]
    assert len(reading) == 16


def test_leaves_at_the_published_widths():
    cf = json.loads((ROOT / "kvbench/configs/mellum2-12b.json").read_text())
    m = cf["model"]
    spec = moe_window.leaves(m, "swiglu")
    by = {leaf[0]: leaf for leaf in spec}
    d, E, F = 2304, 64, 896
    for i in range(28):
        r = by[("layers", i, "moe", "router")]
        assert (r[1], r[3]) == ((d, E), torch.float32)
        assert r[2] == pytest.approx(2.0 / math.sqrt(d))
        assert by[("layers", i, "moe", "w_gate")][1] == (E, d, F)
        assert by[("layers", i, "moe", "w_up")][1] == (E, d, F)
        assert by[("layers", i, "moe", "w_down")][1] == (E, F, d)
        assert len(by[("layers", i, "moe", "w_down")]) == 3   # served dtype
        assert ("layers", i, "mlp", "w_up") not in by
    n = sum(math.prod(leaf[1]) for leaf in spec)
    experts = sum(math.prod(leaf[1]) for leaf in spec
                  if leaf[0][-1].startswith("w_") and "moe" in leaf[0])
    assert round(n / 1e9, 2) == 12.15 and round(experts / 1e9, 2) == 11.10


# ---- counts -----------------------------------------------------------------
def test_counts_take_8_of_64_experts():
    cf = json.loads((ROOT / "kvbench/configs/mellum2-12b.json").read_text())
    m = cf["model"]
    d, F = 2304, 896
    attn = 2 * (d * (32 * 128 + 2 * 4 * 128) + 32 * 128 * d)
    assert moe_window.linear_per_token(m) == attn + 2 * d * 64 \
        + 8 * 2 * 3 * d * F
    assert moe_window.moe_flops(m, 10) == 10 * 8 * 6 * d * F
    # a decode step of 16 rows touches ~56 of the 64 experts
    touched = (moe_window.moe_bytes(m, 16) - 2 * 16 * d * 2) / (3 * d * F * 2)
    assert touched == pytest.approx(64 * (1 - (56 / 64) ** 16))
    assert moe_window.moe_bytes(m, 4096) == pytest.approx(
        64 * 3 * d * F * 2 + 2 * 4096 * d * 2)


@pytest.mark.parametrize("window", [None, 3, 8])
@pytest.mark.parametrize("prefix", [False, True])
def test_attended_counts_by_brute_force(window, prefix):
    sc = 10
    for p in range(sc, sc + 20):
        want = sum(1 for j in range(p + 1)
                   if (window is None or p - j < window)
                   and (j >= sc or prefix))
        assert int(moe_window.attended(p, sc, window, prefix)) == want


def test_request_flops_by_brute_force():
    """The family's grouped counts equal a count position by position,
    layer by layer."""
    m, sel = TINY, (0, 2)
    win = moe_window.windows(m)
    sc, sq, n = 30, 5, 6
    lin = moe_window.linear_per_token(m)

    def attn(p, i, pre, start=sc):
        return counts.attn_ops(m, int(moe_window.attended(p, start, win[i],
                                                          pre)))
    # the sender's [BOS | context] attends its own positions from 0
    sender = sum(sc * lin + sum(attn(p, i, False, 0) for p in range(sc))
                 for i in range(2)) + sc * 2 * 128 * 2 * 2 * 32
    logits = 2 * 128 * 512
    receiver = 4 * sq * lin + logits + sum(
        attn(p, i, i in sel) for i in range(4) for p in range(sc, sc + sq))
    decode = sum(4 * lin + logits + sum(attn(sc + sq + j - 1, i, i in sel)
                                        for i in range(4))
                 for j in range(1, n))
    got = moe_window.request_flops(m, sc, sq, n, sel)
    assert got == {"sender": sender, "receiver": receiver, "decode": decode}


def test_k1_bytes_count_the_full_layers():
    items = generator.wave(tiny_cell().mix, 3, 0, 512)
    every = counts.k1_bytes({**TINY, "num_layers": 1}, items, (0,))
    assert moe_window.k1_bytes(TINY, items, (1, 3)) == every
    assert moe_window.k1_bytes(TINY, items, (0,)) == counts.k1_bytes(
        {**TINY, "num_layers": 1}, items, ())


def test_moe_calls_of_a_wave():
    items = generator.wave(tiny_cell().mix, 3, 0, 512)
    calls = moe_window.moe_calls(TINY, items, (1, 2))
    steps = max(it.answer for it in items) - 1
    assert len(calls) == len(items) * (2 + 4) + steps * 4
    assert sum(calls) == sum(2 * (len(it.context) + 1) + 4 * len(it.query)
                             + 4 * (it.answer - 1) for it in items)


# ---- the readers ------------------------------------------------------------
def _traced(counters=None, spans=(), groups=None):
    cell = load_cell(json.loads((ROOT / "BENCHMARK.json").read_text()),
                     CELL)
    items = generator.wave(cell.mix, 9, 0, cell.model["vocab_size"])
    stats = {"iterations": 1, "steps": 1, "occupancy": 1.0, "tokens": 1}
    if counters is not None:
        stats["trace"] = {"spans": list(spans), "counters": counters,
                          "anchor": [0, 0]}
    rec = Record(cell=cell, device_kind=H100, layers=(1, 3))
    rec.traced = Wave(items=items, completions={}, stats=stats)
    if groups is not None:
        rec.trace = {"groups": groups}
    return rec


def test_decode_kernel_pct_reads_the_counters():
    from kvbench.metrics import decode_kernel_pct
    assert decode_kernel_pct.read(_traced()) is None
    rec = _traced({"decode.attn_kernel": 7, "decode.attn_plain": 21})
    assert decode_kernel_pct.read(rec) == 25.0
    assert decode_kernel_pct.read(_traced({"decode.attn_kernel": 0,
                                           "decode.attn_plain": 0})) is None


def test_moe_stream_ms_reads_the_spans_inside_steps():
    from kvbench.metrics import moe_stream_ms

    def span(i, name, parent, ms):
        return {"name": name, "id": i, "parent": parent, "rid": None,
                "start_ns": 0, "end_ns": 1, "stream_ms": ms}
    spans = [span(1, "scheduler.run", None, 9.0),
             span(2, "scheduler.admit", 1, 5.0),
             span(3, "moe.experts", 2, 4.0),         # a prefill's: left out
             span(4, "scheduler.step", 1, 3.0),
             span(5, "moe.experts", 4, 1.5),
             span(6, "scheduler.step", 1, 3.0),
             span(7, "moe.experts", 6, 0.5)]
    assert moe_stream_ms.read(_traced({}, spans)) == 1.0
    assert moe_stream_ms.read(_traced()) is None
    assert moe_stream_ms.read(_traced({}, spans[:4])) is None


def test_moe_roofline_pct_counts_each_call():
    from kvbench.metrics import moe_roofline_pct
    rec = _traced({}, groups={"moe_roofline_pct": 2.0})
    fam, m = rec.cell.family, rec.cell.model
    need = sum(max(fam.moe_flops(m, n) / 989e12,
                   fam.moe_bytes(m, n) / 3.35e12)
               for n in fam.moe_calls(m, rec.traced.items, (1, 3)))
    assert moe_roofline_pct.read(rec) == pytest.approx(100 * need / 2.0)
    assert moe_roofline_pct.read(_traced({}, groups={})) is None
    assert set(moe_roofline_pct.KERNELS) == {"moe_grouped_gate_up",
                                             "moe_grouped_down"}


def test_new_readers_read_nothing_in_a_dense_cell(manifest):
    from kvbench.metrics import moe_roofline_pct
    rec = Record(cell=load_cell(manifest, "starcoder2-7b.doc_qa"),
                 device_kind=H100)
    rec.trace = {"groups": {"moe_roofline_pct": 1.0}}
    rec.traced = Wave(items=[], completions={}, stats={})
    assert moe_roofline_pct.read(rec) is None


# ---- a tiny cell run whole --------------------------------------------------
def _run(seed):
    from kvbench import run
    man = json.loads((ROOT / "BENCHMARK.json").read_text())
    return run.execute(man, tiny_cell(), seed, 0.3, False,
                       torch.device("cpu"), time.perf_counter())


@pytest.mark.parametrize("seed", [100, 101, 102])
def test_honest_run_is_correct(seed):
    result, lines = _run(seed)
    assert result["correct"], lines
    assert list(result["check"])[-2:] == ["gap_p99", "gap_mean"]
    assert result["check"]["gap_mean"]["value"] <= \
        result["check"]["gap_p99"]["value"] <= \
        result["check"]["gap_max"]["value"]


@pytest.mark.parametrize("seed", [100, 102, 105])
def test_control_is_refused(seed):
    cell = tiny_cell()
    b = Bench(cell, seed, "cpu")
    served = b.served([b.run_wave(generator.wave(cell.mix, seed, k, 512))
                       for k in range(2)])
    calib = check.Served(rid=-1, context=b.calib.context,
                         query=b.calib.query, answer=0, tokens=None)

    def R(i, mode="fp32"):
        return moe_window.Reference(TINY, "swiglu", b.params[i], mode)
    honest = check.numbers(
        sender=R(0), receiver=R(1), served=served, calib=calib,
        prog_scores=b.scores, prog_select=b.select, ratio=0.5, alpha=0.7,
        wire=b.wire, bos=1, seed=seed, sample_tokens=20, family=moe_window)
    assert check.verdict(honest, LIMITS, cell.numbers)
    ctl = check.control_numbers(
        sender=R(0), receiver=R(1), sender8=R(0, "fp8"),
        receiver8=R(1, "fp8"), picked=check.sample(served, seed, 20),
        calib=calib, layers=list(b.layers), wire=b.wire, bos=1,
        family=moe_window)
    assert not check.verdict({**honest, **ctl}, LIMITS, cell.numbers)


def _route_not_renormalised(orig):
    def route(p, x, k):
        logits = x.float() @ p["router"]
        probs = torch.softmax(logits, dim=-1)
        order = torch.sort(probs, dim=-1, descending=True, stable=True)
        gates, idx = order.values[..., :k], order.indices[..., :k]
        _, _, me, ce = orig(p, x, k)
        return gates.to(x.dtype), idx, me, ce
    return route


def _window_wider(orig):
    def self_attention(p, cfg, x, *, window=None, **kw):
        return orig(p, cfg, x, window=None if window is None else window + 1,
                    **kw)
    return self_attention


FAULTS = {
    "routing_not_renormalised": ("models.layers", "route",
                                 _route_not_renormalised),
    "yarn_left_out": ("models.attention", "layer_yarn",
                      lambda orig: lambda cfg, window: None),
    "window_off_by_one": ("models.attention", "self_attention",
                          _window_wider),
}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_planted_fault_is_refused(monkeypatch, fault):
    import importlib
    mod_name, attr, make = FAULTS[fault]
    mod = importlib.import_module(f"repro_torch.{mod_name}")
    monkeypatch.setattr(mod, attr, make(getattr(mod, attr)))
    result, lines = _run(100)
    assert not result["correct"], lines
    assert result["check"]["gap_max"]["value"] > LIMITS["gap_max"]


def test_weights_draw_the_router_in_float32():
    spec = moe_window.leaves(TINY, "swiglu")
    p = weights.make_params(spec, 7, "cpu", torch.bfloat16)
    moe = p["layers"][0]["moe"]
    assert moe["router"].dtype == torch.float32
    assert moe["w_gate"].dtype == torch.bfloat16
    assert float(moe["router"].std()) == pytest.approx(
        2.0 / math.sqrt(128), rel=0.1)
    assert np.isfinite(float(moe["w_down"].float().abs().max()))


def test_family_imports_nothing_of_the_program():
    import subprocess
    import sys
    code = ("import sys; sys.path[:0] = [{r!r}, {r!r} + '/src'];"
            "import kvbench.families.moe_window;"
            "print(sorted({{m.split('.')[0] for m in sys.modules}}))"
            ).format(r=str(ROOT))
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=300)
    assert p.returncode == 0, p.stderr
    assert "repro_torch" not in p.stdout and "'repro'" not in p.stdout
    assert "'jax'" not in p.stdout
