"""BENCHMARK.json against the contract it is written to, and every name
in it resolved to its file."""
import json
import re
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
KV = ROOT / "kvbench"
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
TOP = {"command", "paths", "run_seconds", "configs", "workloads",
       "end_to_end", "per_layer"}
WIDTHS = ("d_model", "d_ff", "head_dim", "num_heads", "num_kv_heads",
          "num_experts_per_tok")


def line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s \
        and "\t" not in s


def test_shape_of_the_file(manifest):
    assert set(manifest) == TOP
    assert (ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024
    assert 1 <= len(manifest["paths"]) <= 16
    for p in manifest["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
    cmd = manifest["command"]
    assert 1 <= len(cmd) <= 32 and all(line(w) for w in cmd)
    rs = manifest["run_seconds"]
    assert isinstance(rs, int) and 1 <= rs <= 51
    # a full check of 24 cells fits 43,200 s
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_names_units_and_keys(manifest):
    names = set()
    for c in manifest["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and line(c["source"]) and line(c["why"])
        assert len(c["reduced"]) <= 16
        assert all(NAME.match(k) and k not in WIDTHS for k in c["reduced"])
    for w in manifest["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert all(NAME.match(w[k]) for k in ("name", "config", "traffic"))
        assert w["chips"] in (1, 4) and line(w["why"])
    for m in manifest["end_to_end"] + manifest["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert m["name"] not in names
        names.add(m["name"])
    for m in manifest["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert "setup_s" in {m["name"] for m in manifest["end_to_end"]}
    for m in manifest["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert line(m["layer"])


def test_every_name_resolves(manifest):
    from kvbench import check
    from kvbench.harness import load_cell, metric_module
    configs = {c["name"]: c for c in manifest["configs"]}
    cells = {w["name"] for w in manifest["workloads"]}
    e2e = {m["name"] for m in manifest["end_to_end"]}
    files = set()
    for c in configs.values():
        path = ROOT / c["file"]
        assert path.is_file() and c["file"].startswith("kvbench/")
        assert c["file"] not in files
        files.add(c["file"])
        cf = json.loads(path.read_text())
        assert cf["name"] == c["name"] and cf["source"] == c["source"]
        assert sorted(cf["reduced"]) == sorted(c["reduced"])
    used = set()
    for w in manifest["workloads"]:
        cell = load_cell(manifest, w["name"])
        used.add(w["config"])
        assert set(cell.spec["limits"]) == set(check.names(cell.family))
    assert used == set(configs)
    for m in manifest["end_to_end"] + manifest["per_layer"]:
        assert callable(metric_module(m["name"]).read)
        assert set(m.get("workloads", cells)) <= cells
    for m in manifest["per_layer"]:
        assert m["moves"] in e2e
    for w in cells:   # every cell reports a per-layer metric
        assert [m for m in manifest["per_layer"]
                if w in m.get("workloads", cells)]


def test_each_cell_reports_what_its_per_layer_metrics_move(manifest):
    """A per-layer metric's cells each report the end-to-end metric it
    moves, and every cell reports set-up and one more end-to-end metric."""
    cells = [w["name"] for w in manifest["workloads"]]
    e2e = {m["name"]: m for m in manifest["end_to_end"]}
    for w in cells:
        held = [n for n, m in e2e.items() if w in m.get("workloads", cells)]
        assert "setup_s" in held and len(held) >= 2, w
    for m in manifest["per_layer"]:
        reported = e2e[m["moves"]].get("workloads", cells)
        assert set(m.get("workloads", cells)) <= set(reported), m["name"]


def test_files_under_paths_are_named_from_name_characters():
    for p in KV.rglob("*"):
        if "__pycache__" in p.parts or p.is_dir():
            continue
        rel = p.relative_to(ROOT).as_posix()
        assert all(NAME.match(part) for part in rel.split("/")), rel


PUBLISHED = {"starcoder2-7b": {"rope_theta": 1e6}}


@pytest.mark.parametrize("name", ["starcoder2-7b", "internlm2-20b"])
def test_config_files_match_the_registered_widths(name):
    """The configuration as run: the registered config's widths, nothing
    cut; a key that differs is one the file takes from the published
    model (starcoder2-7b's rope_theta, 1e6 where the port registers 1e5)."""
    import dataclasses
    import importlib
    mod = importlib.import_module(
        "repro_torch.configs." + name.replace("-", "_").replace(".", "_"))
    reg = dataclasses.asdict(mod.CONFIG)
    cf = json.loads((KV / "configs" / f"{name}.json").read_text())
    published = PUBLISHED.get(name, {})
    for k, v in cf["model"].items():
        assert published.get(k, reg[k]) == v, k
    assert cf["reduced"] == {}
