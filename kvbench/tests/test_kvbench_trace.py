"""The per-layer metrics that read the program's spans and counters: a
tiny traced run on the CPU reads the host-clock ones, leaves out the
stream times (no card timed them), and every one of them reads nothing,
without raising, from a program that records no spans."""
import time

import pytest
import torch

from conftest import tiny_cell
from kvbench.harness import Record, Wave, metric_module, reader_name

SPAN_METRICS = {
    "step_host_ms": ("ms", "model step dispatch (host)", "tokens_per_s"),
    "step_stream_ms": ("ms", "model (models/, core/protocol.py)",
                       "tokens_per_s"),
    "sender_prefill_stream_ms": ("ms/admission",
                                 "model (models/, core/protocol.py)",
                                 "ttft_p90_ms"),
    "wire_stream_ms": ("ms/admission", "session / transport "
                       "(comm/session.py, comm/transport.py)",
                       "ttft_p90_ms"),
    "host_syncs_per_admission": ("syncs/admission", "session / transport "
                                 "(comm/session.py, comm/transport.py)",
                                 "ttft_p90_ms"),
    "host_wait_pct": ("%", "scheduler (serving/scheduler.py)",
                      "tokens_per_s"),
}
ON_THE_CPU = {"step_host_ms", "host_syncs_per_admission", "host_wait_pct"}


def traced(manifest, name, transport):
    from kvbench import run
    cell = tiny_cell(name=name, transport=transport)
    return run.execute(manifest, cell, 103, 0.3, True, torch.device("cpu"),
                       time.perf_counter())


@pytest.mark.parametrize("name,transport", [
    ("starcoder2-7b.doc_qa", "serialized"),
    ("starcoder2-7b.long_answer", "in_memory")])
def test_traced_run_reads_the_spans(manifest, name, transport):
    result, _ = traced(manifest, name, transport)
    assert result["correct"]
    # the decode-paced cell reports them under names of its own
    m = {reader_name(k): v for k, v in result["metrics"].items()}
    assert ON_THE_CPU <= set(m)
    # stream times come only from a card
    assert not {"step_stream_ms", "sender_prefill_stream_ms",
                "wire_stream_ms"} & set(m)
    assert m["step_host_ms"]["value"] > 0
    assert m["host_syncs_per_admission"]["value"] == 0     # no card
    assert 0 <= m["host_wait_pct"]["value"] < 100
    for k, v in result["metrics"].items():
        assert v["unit"] == next(e["unit"] for e in manifest["per_layer"]
                                 + manifest["end_to_end"] if e["name"] == k)


def test_manifest_lists_the_span_metrics(manifest):
    cells = [w["name"] for w in manifest["workloads"]]
    e2e = {m["name"]: m for m in manifest["end_to_end"]}
    per = {m["name"]: m for m in manifest["per_layer"]}
    la = "starcoder2-7b.long_answer"
    for name, (unit, layer, moves) in SPAN_METRICS.items():
        m = per[name]
        assert (m["unit"], m["layer"], m["moves"]) == (unit, layer, moves)
        assert m["source"] in ("program_span", "program_counter")
        # the cells that report what it moves: the doc_qa cells
        want = [c for c in cells if ".doc_qa" in c]
        assert m["workloads"] == want == e2e[moves]["workloads"]
        if name == "wire_stream_ms":      # no wire in memory
            assert name + ".long_answer" not in per
            continue
        # the decode-paced cell reads it under a name of its own, tied to
        # the one end-to-end metric it holds besides set-up
        own = per[name + ".long_answer"]
        assert {k: own[k] for k in ("unit", "layer", "source")} \
            == {k: m[k] for k in ("unit", "layer", "source")}
        assert (own["moves"], own["workloads"]) == ("peak_mem_gb", [la])
    # accepted entries keep their order; later ones may follow them
    assert [n for n in per if n in SPAN_METRICS] == list(SPAN_METRICS)


@pytest.mark.parametrize("name", sorted(SPAN_METRICS))
def test_reads_nothing_without_spans(name):
    rec = Record(cell=tiny_cell(), device_kind="cpu")
    read = metric_module(name).read
    assert read(rec) is None                        # no traced wave
    rec.traced = Wave(items=[], completions={}, stats={
        "iterations": 3, "steps": 2, "occupancy": 0.5, "tokens": 6})
    assert read(rec) is None                        # a program without it
