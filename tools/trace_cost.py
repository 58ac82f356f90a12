"""What the recorder (``repro_torch.utils.trace``) costs, and where one
traced wave's time goes, in one benchmark cell on one card.

    python3 tools/trace_cost.py --workload starcoder2-7b.doc_qa \\
        --seed 12345 --windows 6 --seconds 25

Sets the cell up as ``kvbench.run`` does (weights from the seed, K1,
calibration, one warm-up wave), then measures ``--windows`` windows of
``--seconds`` each, the recorder off and on in turns (off, on, on, off,
...), each window's tokens per second and TTFT p90 counted as the
benchmark's readers count them. Then it serves one wave inside
``trace.recording()`` and one under ``torch.profiler`` (the benchmark's
traced wave), and prints for each the spans by name (count, host ms,
stream ms), the counters, the stream time of the set-up, the admissions
and the steps against the ``scheduler.run`` span's wall, and for the
profiled wave the device's idle seconds by the host event under each gap
(``kvbench.trace``) with the share that no program span names (``host
python`` and the bare ``scheduler.run``). One JSON object a line on
standard output.
"""
import argparse
import json
import statistics
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]


def window(bench, seconds: float, recorded: bool):
    """Waves until ``seconds`` have passed: (tokens/s, TTFT p90 ms,
    waves)."""
    import contextlib

    import numpy as np

    from kvbench import generator
    from repro_torch.utils import trace
    waves, k = [], 0
    t0 = time.perf_counter()
    with trace.recording() if recorded else contextlib.nullcontext():
        while time.perf_counter() - t0 < seconds:
            waves.append(bench.run_wave(generator.wave(
                bench.cell.mix, bench.seed, k, bench.cfg.vocab_size)))
            k += 1
    wall = time.perf_counter() - t0
    tokens = sum(len(c.tokens) for w in waves
                 for c in w.completions.values())
    ttft = [c.ttft_s for w in waves for c in w.completions.values()]
    return tokens / wall, float(np.percentile(ttft, 90)) * 1e3, len(waves)


def split(exported):
    """Stream ms of the set-up, the admissions and the steps, and the
    ``scheduler.run`` span's host wall."""
    from repro_torch.utils import trace
    rows = trace.summary(exported)

    def stream(name):
        return (rows.get(name) or {}).get("stream_ms") or 0.0

    parts = {n: stream(n) for n in ("scheduler.setup", "scheduler.admit",
                                    "scheduler.step")}
    run_ms = rows["scheduler.run"]["host_ms"]
    return {"stream_ms": parts, "run_wall_ms": run_ms,
            "stream_over_wall": sum(parts.values()) / run_ms}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 tools/trace_cost.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--windows", type=int, default=6)
    ap.add_argument("--seconds", type=float, default=25.0)
    args = ap.parse_args(argv)
    import torch

    from kvbench import generator
    from kvbench import trace as ktrace
    from kvbench.harness import Bench, load_cell
    from repro_torch.utils import trace
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    with open(ROOT / "BENCHMARK.json") as f:
        cell = load_cell(json.load(f), args.workload)
    dev = torch.device("cuda" if torch.cuda.is_available() else "cpu")
    bench = Bench(cell, args.seed, dev)
    bench.warmup()
    out = {"on": [], "off": []}
    for i in range(args.windows):
        recorded = i % 4 in (1, 2)
        tps, ttft, n = window(bench, args.seconds, recorded)
        key = "on" if recorded else "off"
        out[key].append(tps)
        print(json.dumps({"workload": cell.name, "window": i,
                          "recorder": key, "tokens_per_s": tps,
                          "ttft_p90_ms": ttft, "waves": n}), flush=True)
    for key, v in out.items():
        if v:
            q = statistics.quantiles(v, n=4) if len(v) > 1 else [v[0]] * 3
            print(json.dumps({"workload": cell.name, "recorder": key,
                              "median": statistics.median(v),
                              "iqr_share": (q[2] - q[0])
                              / statistics.median(v), "runs": v}),
                  flush=True)

    items = generator.wave(cell.mix, args.seed, 0, bench.cfg.vocab_size)
    with trace.recording():
        w = bench.run_wave(items)
    tr = w.stats["trace"]
    print(json.dumps({"workload": cell.name, "wave": "recorded",
                      "seconds": w.seconds, "spans": trace.summary(tr),
                      "counters": tr["counters"], **split(tr)}), flush=True)

    from torch.profiler import ProfilerActivity, profile, record_function
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                     if dev.type == "cuda" else [])
    with profile(activities=acts) as prof:
        with record_function(ktrace.WAVE):
            w = bench.run_wave(items)
    ktrace.TOP = None                     # every label, not the top ten
    summ = ktrace.summarize(
        ktrace.rows(prof.profiler.kineto_results.events()), {})
    idle = summ["window_s"] - summ["busy_s"]
    gaps = dict(summ["idle_gaps"])
    tr = w.stats["trace"]
    print(json.dumps({"workload": cell.name, "wave": "profiled",
                      "seconds": w.seconds, "busy_s": summ["busy_s"],
                      "window_s": summ["window_s"], "idle_s": idle,
                      "unnamed_idle_share": (gaps.get("host python", 0.0)
                                             + gaps.get("scheduler.run",
                                                        0.0)) / idle,
                      "idle_gaps": summ["idle_gaps"][:25],
                      "spans": trace.summary(tr),
                      "counters": tr["counters"], **split(tr)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
