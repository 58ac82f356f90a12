"""The reader of ``prefill_kernel_pct``: the share of prefill attention
calls on the prefill kernel from the program's two counters, and nothing,
without raising, where the traced wave has no such counters."""
import pytest

from conftest import tiny_cell
from kvbench.harness import Record, Wave, metric_module

STATS = {"iterations": 3, "steps": 2, "occupancy": 0.5, "tokens": 6}


def _record(counters):
    rec = Record(cell=tiny_cell(), device_kind="cpu")
    if counters is not None:
        rec.traced = Wave(items=[], completions={}, stats={
            **STATS, "trace": {"spans": [], "counters": counters,
                               "anchor": [0, 0]}})
    return rec


@pytest.mark.parametrize("counters,want", [
    ({"prefill.attn_kernel": 32, "prefill.attn_plain": 32}, 50.0),
    ({"prefill.attn_kernel": 4, "prefill.attn_plain": 0}, 100.0),
    ({"prefill.attn_kernel": 0, "prefill.attn_plain": 7}, 0.0),
    (None, None),                                    # no traced wave
    ({"admit.count": 4}, None),                      # a program without them
    ({"prefill.attn_kernel": 0, "prefill.attn_plain": 0}, None),
])
def test_reader(counters, want):
    assert metric_module("prefill_kernel_pct").read(_record(counters)) \
        == want


def test_reads_nothing_from_a_wave_without_a_recording():
    rec = _record(None)
    rec.traced = Wave(items=[], completions={}, stats=dict(STATS))
    assert metric_module("prefill_kernel_pct").read(rec) is None


def test_manifest_entry(manifest):
    """Every cell reads it once: the cells that hold TTFT end to end under
    its own name, the decode-paced cell (which holds none) under
    ``.long_answer``, tied to the end-to-end metric that cell reports."""
    per = {e["name"]: e for e in manifest["per_layer"]}
    ttft = next(e for e in manifest["end_to_end"]
                if e["name"] == "ttft_p90_ms")
    same = {"unit": "%", "better": "higher", "source": "program_counter",
            "layer": "model (models/, core/protocol.py)"}
    assert per["prefill_kernel_pct"] == {
        "name": "prefill_kernel_pct", **same, "moves": "ttft_p90_ms",
        "workloads": ttft["workloads"]}
    assert per["prefill_kernel_pct.long_answer"] == {
        "name": "prefill_kernel_pct.long_answer", **same,
        "moves": "peak_mem_gb",
        "workloads": ["starcoder2-7b.long_answer"]}
    assert sorted(ttft["workloads"] + ["starcoder2-7b.long_answer"]) \
        == sorted(w["name"] for w in manifest["workloads"])
