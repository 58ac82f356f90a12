"""Configurations resolve to a family module (``kvbench.families``) that
picks their weights, reference, counts and extra check numbers. The two
accepted configurations are dense, and their weights are drawn bit for
bit as before families existed; a stub family registered here, with a
float32 leaf, its own reference, its own counts and one extra number, runs
a tiny whole run on the CPU with no file of the harness edited."""
import json
import math
import sys
import time
import types

import numpy as np
import pytest
import torch

from conftest import ROOT, TINY_MODEL, tiny_cell
from kvbench import counts, families, generator, weights
from kvbench.families import dense
from kvbench.harness import Bench, Record, Wave, load_cell, make_param_sets

H100 = "NVIDIA H100 80GB HBM3"


# ---- the parent's draw, frozen ----------------------------------------------
def _parent_make_params(model, mlp, seed, device, dtype, chunk):
    """``kvbench.weights.make_params`` as it was before families, with
    its chunk size as an argument."""
    device = torch.device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    spec = sorted(weights.leaves(model, mlp), key=lambda t: -t[2])
    flat = torch.empty(sum(math.prod(s) for _, s, _ in spec), dtype=dtype,
                       device=device)
    for a in range(0, flat.numel(), chunk):
        flat[a:a + chunk].normal_(generator=gen)
    params = {"layers": [dict(attn={}, mlp={})
                         for _ in range(model["num_layers"])]}
    off, run_start, run_scale = 0, 0, None
    for path, shape, scale in spec:
        if scale != run_scale:
            if run_scale is not None:
                flat[run_start:off].mul_(run_scale)
            run_start, run_scale = off, scale
        n = math.prod(shape)
        leaf = flat[off:off + n].view(shape)
        off += n
        node = params
        for key in path[:-1]:
            node = node[key]
        node[path[-1]] = leaf
    flat[run_start:off].mul_(run_scale)
    return params


def _flat(tree, path=()):
    """{path: leaf} of a parameter tree."""
    if isinstance(tree, torch.Tensor):
        return {path: tree}
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    out = {}
    for k, v in items:
        out.update(_flat(v, path + (k,)))
    return out


def _bits(t):
    return t.contiguous().view(torch.uint8)


def test_accepted_configs_are_dense(manifest):
    for c in manifest["configs"]:
        cf = json.loads((ROOT / c["file"]).read_text())
        assert "family" not in cf
        assert families.of(cf) is dense
    for w in manifest["workloads"]:
        assert load_cell(manifest, w["name"]).family is dense


@pytest.mark.parametrize("mlp,dtype,seed", [
    ("gelu", torch.bfloat16, 7), ("swiglu", torch.bfloat16, 2**31 + 5),
    ("gelu", torch.float32, 11)])
def test_weights_match_the_parent_draw(monkeypatch, mlp, dtype, seed):
    chunk = 10_007                  # several draws a buffer, one ragged
    monkeypatch.setattr(weights, "CHUNK", chunk)
    new = _flat(weights.make_params(dense.leaves(TINY_MODEL, mlp), seed,
                                    "cpu", dtype))
    old = _flat(_parent_make_params(TINY_MODEL, mlp, seed, "cpu", dtype,
                                    chunk))
    assert set(new) == set(old)
    for path, leaf in old.items():
        assert new[path].dtype == leaf.dtype == dtype, path
        assert new[path].shape == leaf.shape, path
        assert torch.equal(_bits(new[path]), _bits(leaf)), path


def test_counts_through_the_family(manifest):
    """What ``mfu_pct`` and ``k1_roofline_pct`` divide by, through the
    family, equals ``kvbench.counts`` on each cell's generated waves."""
    mfu = __import__("kvbench.metrics.mfu_pct", fromlist=["read"])
    k1 = __import__("kvbench.metrics.k1_roofline_pct", fromlist=["read"])
    for w in manifest["workloads"]:
        cell = load_cell(manifest, w["name"])
        vocab = cell.model["vocab_size"]
        items = [it for k in range(2)
                 for it in generator.wave(cell.mix, 2**31 + 17, k, vocab)]
        sel = tuple(range(0, cell.model["num_layers"], 2))
        fam = cell.family
        flops = counts.window_flops(cell.model, cell.mlp, items, sel)
        need = counts.k1_bytes(cell.model, items, sel)
        assert fam.window_flops(cell.model, cell.mlp, items, sel) == flops
        assert fam.k1_bytes(cell.model, items, sel) == need
        rec = Record(cell=cell, device_kind=H100, window_s=2.0,
                     waves=[Wave(items=items, completions={}, stats={})],
                     layers=sel)
        rec.traced = rec.waves[0]
        rec.trace = {"groups": {"k1_roofline_pct": 0.5}}
        assert mfu.read(rec) == 100.0 * flops / (2.0 * 989e12)
        assert k1.read(rec) == 100.0 * need / 3.35e12 / 0.5


# ---- refusals ---------------------------------------------------------------
def _no_weights(monkeypatch):
    def made(*a, **k):
        raise AssertionError("weights were made")
    monkeypatch.setattr(weights, "make_params", made)


@pytest.mark.parametrize("family,why", [
    ("no_such_family", "unknown family 'no_such_family'"),
    ("../reference", "is not a module name"),
    ("partial", r"lacks \['Reference', 'window_flops', 'k1_bytes'\]")])
def test_unknown_family_is_refused_before_weights(monkeypatch, family, why):
    _no_weights(monkeypatch)
    partial = types.ModuleType("kvbench.families.partial")
    partial.leaves = dense.leaves
    monkeypatch.setitem(sys.modules, partial.__name__, partial)
    with pytest.raises(ValueError, match=why):
        tiny_cell(family=family)    # no cell, so no Bench and no weights


def _new_cell_files(base, family, limits=None):
    """A configuration ``x`` of ``family``, a traffic mix ``t`` and the
    cell ``x.t``'s workloads file under ``base``, as a new model's PR
    adds them: the tiny cell's contents."""
    cell = tiny_cell()
    for d in ("configs", "traffic", "workloads"):
        (base / d).mkdir()
    (base / "configs" / "x.json").write_text(json.dumps(
        {**cell.config, "family": family}))
    (base / "traffic" / "t.json").write_text(json.dumps(cell.mix))
    (base / "workloads" / "x.t.json").write_text(json.dumps(
        {**cell.spec, "limits": {**cell.spec["limits"], **(limits or {})}}))
    return {"name": "x.t", "config": "x", "traffic": "t", "chips": 1,
            "why": "a new model's cell"}


def test_load_cell_refuses_an_unknown_family(tmp_path):
    man = {"workloads": [_new_cell_files(tmp_path, "no_such_family")]}
    with pytest.raises(ValueError, match="unknown family"):
        load_cell(man, "x.t", base=tmp_path)


# ---- a stub family, registered here -----------------------------------------
@pytest.fixture
def stub(monkeypatch):
    """``kvbench.families.stub``: the dense decoder with a float32 leaf,
    a reference that notes what it was built on, counts of its own and
    one extra number, the mean gap of the judged tokens."""
    mod = types.ModuleType("kvbench.families.stub")
    mod.seen = []

    def leaves(model, mlp):
        return dense.leaves(model, mlp) + [
            (("stub_gate",), (model["d_model"], 3), 0.5, torch.float32)]

    class Reference(dense.Reference):
        def __init__(self, model, mlp, params, mode="fp32"):
            super().__init__(model, mlp, params, mode)
            mod.seen.append((mode, params["stub_gate"].dtype,
                             params["embed"].dtype))

    mod.leaves, mod.Reference = leaves, Reference
    mod.window_flops = lambda model, mlp, items, sel: 2 * \
        counts.window_flops(model, mlp, items, sel)
    mod.k1_bytes = lambda model, items, sel: 3 * counts.k1_bytes(
        model, items, sel)
    mod.EXTRA_NUMBERS = ("gap_mean",)
    mod.extra_numbers = lambda view: {"gap_mean": float(np.mean(
        np.concatenate(view["token_gaps"])))}
    monkeypatch.setitem(sys.modules, mod.__name__, mod)
    return mod


def _stub_cell(limit=1.0):
    return tiny_cell(family="stub",
                     limits=None if limit is None else {"gap_mean": limit})


def test_stub_family_weights(stub):
    cell = _stub_cell()
    assert cell.family is stub
    got = _flat(make_param_sets(cell, 100, "cpu")[0])
    want = _flat(make_param_sets(tiny_cell(), 100, "cpu")[0])
    assert got.pop(("stub_gate",)).dtype == torch.float32
    assert set(got) == set(want)
    for path, leaf in want.items():       # the served buffer drawn first
        assert torch.equal(_bits(got[path]), _bits(leaf)), path


def test_stub_family_counts(stub):
    cell, base = _stub_cell(), tiny_cell()
    items = generator.wave(cell.mix, 5, 0, TINY_MODEL["vocab_size"])
    mfu = __import__("kvbench.metrics.mfu_pct", fromlist=["read"])
    k1 = __import__("kvbench.metrics.k1_roofline_pct", fromlist=["read"])
    reads = []
    for c in (cell, base):
        rec = Record(cell=c, device_kind=H100, window_s=1.0,
                     waves=[Wave(items=items, completions={}, stats={})],
                     layers=(0, 2))
        rec.traced, rec.trace = rec.waves[0], {"groups": {
            "k1_roofline_pct": 1.0}}
        reads.append((mfu.read(rec), k1.read(rec)))
    assert reads[0][0] == pytest.approx(2 * reads[1][0], rel=1e-12)
    assert reads[0][1] == pytest.approx(3 * reads[1][1], rel=1e-12)


def _run(manifest, cell, seed=100):
    from kvbench import run
    return run.execute(manifest, cell, seed, 0.5, False, torch.device("cpu"),
                       time.perf_counter())


def test_stub_family_runs_and_its_number_is_checked(manifest, stub):
    result, lines = _run(manifest, _stub_cell())
    assert result["correct"], lines
    assert list(result["check"]) == ["gap_max", "score_err", "sel_mismatch",
                                     "failed", "gap_mean"]
    chk = result["check"]["gap_mean"]
    assert chk["limit"] == 1.0
    assert 0 <= chk["value"] <= result["check"]["gap_max"]["value"]
    assert lines[-5:] == [l for l in lines if l.startswith("check ")]
    assert lines[-1].startswith("check gap_mean ")
    # sender and receiver references of the stub, on the float32 leaf
    assert stub.seen == [("fp32", torch.float32, torch.bfloat16)] * 2


def test_stub_family_breach_is_refused(manifest, stub, monkeypatch):
    honest = stub.extra_numbers
    monkeypatch.setattr(stub, "extra_numbers", lambda view: {
        "gap_mean": honest(view)["gap_mean"] + 2.0})
    result, lines = _run(manifest, _stub_cell())
    assert not result["correct"], lines
    chk = result["check"]
    assert chk["gap_mean"]["value"] > chk["gap_mean"]["limit"]
    assert all(chk[n]["value"] <= chk[n]["limit"]
               for n in ("gap_max", "score_err", "sel_mismatch", "failed"))


def test_stub_family_missing_limit_is_an_error(manifest, stub, monkeypatch):
    _no_weights(monkeypatch)
    with pytest.raises(ValueError, match=r"no limit for \['gap_mean'\]"):
        _run(manifest, _stub_cell(limit=None))    # raises making the cell


def test_stub_family_control_reads_its_number(stub):
    from kvbench import check
    cell = _stub_cell()
    b = Bench(cell, 101, "cpu")
    served = b.served([b.run_wave(generator.wave(cell.mix, 101, 0, 512))])
    calib = check.Served(rid=-1, context=b.calib.context,
                         query=b.calib.query, answer=0, tokens=None)
    R = [stub.Reference(TINY_MODEL, "gelu", p, m)
         for m in ("fp32", "fp8") for p in b.params]
    ctl = check.control_numbers(
        sender=R[0], receiver=R[1], sender8=R[2], receiver8=R[3],
        picked=check.sample(served, 101, 20), calib=calib,
        layers=list(b.layers), wire=b.wire, bos=1, family=stub)
    assert list(ctl) == ["gap_max", "score_err", "gap_mean"]
    assert 0 <= ctl["gap_mean"] <= ctl["gap_max"]


def test_new_cell_reports_per_layer_metrics_from_new_entries(
        manifest, stub, tmp_path, monkeypatch):
    """A new model's cell as its PR adds it: new files, a configuration
    and a cell appended to BENCHMARK.json, and per-layer entries of its
    own, ``mfu_pct.x.t`` and ``k1_roofline_pct.x.t``, read by the
    accepted readers through the stub family's counts. No accepted entry
    changes."""
    import copy
    from kvbench import run, trace
    from kvbench.metrics import k1_roofline_pct, mfu_pct
    accepted = copy.deepcopy(manifest)
    man = copy.deepcopy(manifest)
    man["configs"].append({"name": "x", "file": "kvbench/configs/x.json"})
    man["workloads"].append(_new_cell_files(tmp_path, "stub",
                                            {"gap_mean": 1.0}))
    by_name = {m["name"]: m for m in manifest["per_layer"]}
    for name in ("mfu_pct", "k1_roofline_pct"):
        man["per_layer"].append({**by_name[name], "name": f"{name}.x.t",
                                 "workloads": ["x.t"]})
    for key in ("configs", "workloads", "end_to_end", "per_layer"):
        assert man[key][:len(accepted[key])] == accepted[key]
    cell = load_cell(man, "x.t", base=tmp_path)
    assert cell.family is stub

    # the card's peaks and 0.5 s of K1 in the trace, on the CPU
    for mod in (mfu_pct, k1_roofline_pct):
        monkeypatch.setattr(mod, "peak", lambda kind, what: {
            "bf16_flops": 989e12, "hbm_bytes": 3.35e12}[what])
    summarize = trace.summarize

    def with_k1(events, groups):
        out = summarize(events, groups)
        assert set(groups) == {"k1_roofline_pct"}
        out["groups"]["k1_roofline_pct"] = 0.5
        return out
    monkeypatch.setattr(trace, "summarize", with_k1)
    calls = {}
    for fn in ("window_flops", "k1_bytes"):
        def counted(*a, fn=fn, orig=getattr(stub, fn)):
            calls[fn] = orig(*a)
            return calls[fn]
        monkeypatch.setattr(stub, fn, counted)

    result, lines = run.execute(man, cell, 104, 0.3, True,
                                torch.device("cpu"), time.perf_counter())
    assert result["correct"], lines
    m = result["metrics"]
    assert {"mfu_pct.x.t", "k1_roofline_pct.x.t"} <= set(m)
    # the accepted entries, which do not name the cell, stay out
    assert not set(by_name) & set(m)
    assert m["k1_roofline_pct.x.t"]["value"] == \
        100.0 * calls["k1_bytes"] / 3.35e12 / 0.5
    assert m["mfu_pct.x.t"]["value"] > 0 and calls["window_flops"] > 0
    assert m["mfu_pct.x.t"]["unit"] == "%"
