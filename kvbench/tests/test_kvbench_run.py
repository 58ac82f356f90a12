"""The harness at a tiny size on the CPU: a whole run but the look for a
card, with the program honest, with the timed path broken underneath in
each way a serving cell can break, and with the control (the reference at
float8) in the program's place. The command itself refuses to run
without a card."""
import json
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from conftest import ROOT, TINY_LIMITS, TINY_MODEL, tiny_cell

SEEDS = (100, 101, 102)


def run_tiny(manifest, seed, trace=False, transport="serialized",
             name="starcoder2-7b.doc_qa"):
    from kvbench import run
    cell = tiny_cell(name=name, transport=transport)
    return run.execute(manifest, cell, seed, 0.5, trace, torch.device("cpu"),
                       time.perf_counter())


@pytest.mark.parametrize("seed", SEEDS)
def test_honest_run_is_correct(manifest, seed):
    result, lines = run_tiny(manifest, seed)
    assert result["correct"], lines
    assert result["failed"] == 0 and result["attempted"] >= 4
    assert set(result["metrics"]) == {"tokens_per_s", "ttft_p90_ms",
                                      "setup_s"}
    assert list(result)[-1] == "check"
    assert lines[-4:] == [l for l in lines if l.startswith("check ")]


def test_traced_run_reports_the_layers(manifest):
    result, _ = run_tiny(manifest, 100, trace=True)
    assert result["correct"]
    m = result["metrics"]
    assert {"occupancy_pct", "wire_bytes_per_ctx_token",
            "launches_per_token", "device_idle_pct"} <= set(m)
    # 2 of 4 layers x K and V x 2 heads x 32 x 1 byte, plus the scales
    assert 256 <= m["wire_bytes_per_ctx_token"]["value"] < 260
    assert result["device"]["window_s"] > 0
    assert "breakdown" in result


def test_long_answer_cell_has_no_wire_metric(manifest):
    result, _ = run_tiny(manifest, 101, trace=True, transport="in_memory",
                         name="starcoder2-7b.long_answer")
    assert result["correct"]
    assert "wire_bytes_per_ctx_token" not in result["metrics"]


# ---- the timed path broken underneath --------------------------------------
def _step_unchanged(orig):
    def step(params, cfg, tokens, cache, shared, prefix_lens, active,
             backend="reference"):
        _, logits, cache = orig(params, cfg, tokens, cache, shared,
                                prefix_lens, active, backend=backend)
        return tokens[:, 0], logits, cache
    return step


def _half_left_out(orig):
    def step(params, cfg, tokens, cache, shared, prefix_lens, active,
             backend="reference"):
        ntok, logits, cache = orig(params, cfg, tokens, cache, shared,
                                   prefix_lens, active, backend=backend)
        h = ntok.shape[0] // 2
        return torch.cat([ntok[:h], tokens[h:, 0]]), logits, cache
    return step


def _token_altered(orig):
    def step(params, cfg, tokens, cache, shared, prefix_lens, active,
             backend="reference"):
        ntok, logits, cache = orig(params, cfg, tokens, cache, shared,
                                   prefix_lens, active, backend=backend)
        return (ntok + 1) % cfg.vocab_size, logits, cache
    return step


def _first_token_altered(orig):
    def prefill(params, cfg, query_tokens, shared, **kw):
        out = orig(params, cfg, query_tokens, shared, **kw)
        lg = out.logits
        best = lg.argmax(dim=-1, keepdim=True)
        lg.scatter_(-1, (best + 1) % cfg.vocab_size,
                    lg.max(dim=-1, keepdim=True).values + 1.0)
        return out
    return prefill


def _exchange_left_out(orig):
    def roundtrip(payload, wire_dtype, dtype, device):
        out, n = orig(payload, wire_dtype, dtype, device)
        return {p: torch.zeros_like(t) for p, t in out.items()}, n
    return roundtrip


FAULTS = {
    "step_returns_state_unchanged": ("core.protocol", "ragged_decode_step",
                                     _step_unchanged),
    "half_the_batch_left_out": ("core.protocol", "ragged_decode_step",
                                _half_left_out),
    "decode_token_altered": ("core.protocol", "ragged_decode_step",
                             _token_altered),
    "first_token_altered": ("core.protocol", "receiver_prefill",
                            _first_token_altered),
    "kv_exchange_left_out": ("comm.transport", "roundtrip_kv",
                             _exchange_left_out),
}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_planted_fault_is_refused(manifest, monkeypatch, fault):
    import importlib
    mod_name, attr, make = FAULTS[fault]
    mod = importlib.import_module(f"repro_torch.{mod_name}")
    monkeypatch.setattr(mod, attr, make(getattr(mod, attr)))
    result, lines = run_tiny(manifest, 100)
    assert not result["correct"], lines


def test_lost_request_is_refused(manifest, monkeypatch):
    from repro_torch.serving import scheduler
    orig = scheduler.Scheduler.run

    def run(self, requests):
        comps, stats = orig(self, requests)
        return comps[1:], stats
    monkeypatch.setattr(scheduler.Scheduler, "run", run)
    result, _ = run_tiny(manifest, 100)
    assert not result["correct"] and result["failed"] > 0


# ---- the control ------------------------------------------------------------
@pytest.mark.parametrize("seed", SEEDS)
def test_control_is_refused(seed):
    from kvbench import check, generator
    from kvbench import reference as ref
    from kvbench.harness import Bench
    cell = tiny_cell()
    b = Bench(cell, seed, "cpu")
    waves = [b.run_wave(generator.wave(cell.mix, seed, k, 512))
             for k in range(2)]
    served = b.served(waves)
    calib = check.Served(rid=-1, context=b.calib.context,
                         query=b.calib.query, answer=0, tokens=None)

    def R(i, mode="fp32"):
        return ref.Reference(TINY_MODEL, "gelu", b.params[i], mode)
    honest = check.numbers(
        sender=R(0), receiver=R(1), served=served, calib=calib,
        prog_scores=b.scores, prog_select=b.select, ratio=0.5, alpha=0.7,
        wire=b.wire, bos=1, seed=seed, sample_tokens=20)
    assert check.verdict(honest, TINY_LIMITS)
    ctl = check.control_numbers(
        sender=R(0), receiver=R(1), sender8=R(0, "fp8"),
        receiver8=R(1, "fp8"), picked=check.sample(served, seed, 20),
        calib=calib, layers=list(b.layers), wire=b.wire, bos=1)
    assert not check.verdict({**honest, **ctl}, TINY_LIMITS)


# ---- the command and its imports ------------------------------------------
def test_command_refuses_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the refusal is for one "
                    "without")
    p = subprocess.run([sys.executable, "-m", "kvbench.run", "--workload",
                        "starcoder2-7b.doc_qa", "--seed", "1", "--seconds",
                        "1", "--trace", "0"], cwd=ROOT, capture_output=True,
                       text=True, timeout=300)
    assert p.returncode != 0 and p.stdout.strip() == ""


_PROBE = r"""
import json, sys, time
sys.path[:0] = [{root!r}, {root!r} + "/src"]
import torch
from conftest import tiny_cell
from kvbench import run
with open({root!r} + "/BENCHMARK.json") as f:
    man = json.load(f)
res, _ = run.execute(man, tiny_cell(), 100, 0.3, True, torch.device("cpu"),
                     time.perf_counter())
import kvbench.readings, kvbench.metrics
from kvbench.harness import metric_module
for m in man["end_to_end"] + man["per_layer"]:
    metric_module(m["name"])
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def test_no_jax_in_the_measuring_process():
    """Every module a run loads, by whole top-level name: neither JAX nor
    flax nor the JAX package ``repro`` (``repro_torch`` is another
    name)."""
    p = subprocess.run([sys.executable, "-c",
                        _PROBE.format(root=str(ROOT))],
                       cwd=str(ROOT / "kvbench" / "tests"),
                       capture_output=True, text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-3000:]
    tops = set(json.loads(p.stdout.strip().splitlines()[-1]))
    assert "repro_torch" in tops
    assert not tops & {"jax", "jaxlib", "flax", "repro"}


def test_reference_imports_nothing_of_the_program():
    code = ("import sys; sys.path[:0] = [{r!r}, {r!r} + '/src'];"
            "import kvbench.reference, kvbench.check, kvbench.counts, "
            "kvbench.generator, kvbench.weights, kvbench.families, "
            "kvbench.families.dense;"
            "print(sorted({{m.split('.')[0] for m in sys.modules}}))"
            ).format(r=str(ROOT))
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=300)
    assert p.returncode == 0, p.stderr
    assert "repro_torch" not in p.stdout and "'repro'" not in p.stdout
