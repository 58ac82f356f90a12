"""One run of one cell of the port's benchmark.

    python3 -m kvbench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout that holds ``BENCHMARK.json``, ``kvbench/`` and
the program (``src/repro_torch``). Set-up (weights from the seed, the K1
build or load, calibration, one warm-up wave), then the window, then, with
``--trace 1``, one more wave under ``torch.profiler``; then the program's
state is freed and the reference of the configuration's family
(``kvbench.families``) judges a sample of what the window served. The
last line of standard output is the result as one JSON object; the last
lines of standard error are the numbers compared, each beside its limit.
Exits 2 without a CUDA card (or with fewer than the cell asks for) and 3
if JAX or the JAX package was loaded, printing no result either way.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden_modules():
    """Loaded modules whose top-level name is JAX's, flax's or the JAX
    package's (compared whole: ``repro_torch`` is not ``repro``)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def applies(metric, cell: str, e2e_by_name) -> bool:
    """Does ``metric`` belong in ``cell``'s line: its own cells, or, without
    them, every cell that reports the end-to-end metric it moves."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    if "moves" in metric:
        return applies(e2e_by_name[metric["moves"]], cell, e2e_by_name)
    return True


def execute(manifest, cell, seed: int, seconds: float, trace_on: bool,
            dev, t_start: float):
    """Set-up, window, traced wave and check of one run on ``dev``.
    Returns (result dict, stderr lines)."""
    import torch
    from kvbench import check, generator, trace
    from kvbench.harness import (ALPHA, BOS, RATIO, Bench, Record,
                                 metric_module, reader_name)

    cuda = dev.type == "cuda"
    kind = torch.cuda.get_device_name(dev) if cuda else "cpu"
    names = cell.numbers

    # ---- set-up -----------------------------------------------------------
    bench = Bench(cell, seed, dev)
    warmup_s = bench.warmup()
    setup_peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    rec = Record(cell=cell, device_kind=kind, warmup_s=warmup_s)
    rec.setup_s = time.perf_counter() - t_start

    # ---- the window -------------------------------------------------------
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    k = bench.window(rec, seconds)
    rec.peak_bytes = torch.cuda.max_memory_allocated(dev) if cuda else 0
    memory_peak = max(setup_peak, rec.peak_bytes)

    e2e = {m["name"]: m for m in manifest["end_to_end"]}
    wanted = [m for m in (manifest["per_layer"] if trace_on
                          else manifest["end_to_end"])
              if applies(m, cell.name, e2e)]
    readers = {m["name"]: metric_module(m["name"]) for m in wanted}
    if trace_on:
        from torch.profiler import ProfilerActivity, profile, record_function
        groups = {reader_name(n): r.KERNELS for n, r in readers.items()
                  if hasattr(r, "KERNELS")}
        items = generator.wave(cell.mix, seed, k, bench.cfg.vocab_size)
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda
                                         else [])
        with profile(activities=acts) as prof:
            with record_function(trace.WAVE):
                rec.traced = bench.run_wave(items)
        rec.trace = trace.summarize(
            trace.rows(prof.profiler.kineto_results.events()), groups)
        del prof
    metrics = {}
    for m in wanted:
        v = readers[m["name"]].read(rec)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}

    # ---- the check: the program's state freed, the reference after -------
    served = bench.served(rec.waves)
    calib = check.Served(rid=-1, context=bench.calib.context,
                         query=bench.calib.query, answer=0, tokens=None)
    scores, select, wire = bench.scores, bench.select, bench.wire
    params = bench.params
    bench.release()
    del bench
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    limits = cell.spec["limits"]
    fam = cell.family
    nums = check.numbers(
        sender=fam.Reference(cell.model, cell.mlp, params[0]),
        receiver=fam.Reference(cell.model, cell.mlp, params[1]),
        served=served, calib=calib, prog_scores=scores, prog_select=select,
        ratio=RATIO, alpha=ALPHA, wire=wire, bos=BOS, seed=seed,
        sample_tokens=cell.spec["sample_tokens"], family=fam)

    device = {"platform": "gpu" if cuda else "cpu", "kind": kind,
              "count": cell.entry["chips"],
              "memory_peak_bytes": int(memory_peak)}
    result = {"correct": check.verdict(nums, limits, names),
              "attempted": len(served), "failed": int(nums["failed"]),
              "metrics": metrics, "device": device}
    if rec.trace is not None:
        device["busy_s"] = rec.trace["busy_s"]
        device["window_s"] = rec.trace["window_s"]
        result["breakdown"] = {
            "device_ops": [[n, s] for n, s in rec.trace["device_ops"]],
            "idle_gaps": [[n, s] for n, s in rec.trace["idle_gaps"]]}
    result["check"] = {n: {"value": nums[n], "limit": limits[n]}
                       for n in names}
    lines = [f"kvbench: {cell.name} seed {seed}: {len(rec.waves)} waves in "
             f"{rec.window_s:.3f} s (each {[w.seconds for w in rec.waves]} "
             f"s, the warm-up's {rec.warmup_s} s), sampled "
             f"{nums['sampled_requests']} "
             f"requests / {nums['sampled_tokens']} tokens, layers "
             f"{list(rec.layers)}, gaps {nums['gaps']}"]
    return result, lines + check.lines(nums, limits, names)


def parse(argv):
    ap = argparse.ArgumentParser(prog="python3 -m kvbench.run")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    build = ROOT / "build"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")
    with open(ROOT / "BENCHMARK.json") as f:
        manifest = json.load(f)
    import torch
    from kvbench.harness import load_cell

    cell = load_cell(manifest, args.workload)
    chips = cell.entry["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"kvbench: {args.workload} needs {chips} CUDA card(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    result, lines = execute(manifest, cell, args.seed, args.seconds,
                            bool(args.trace), torch.device("cuda", 0),
                            T_START)
    leaked = forbidden_modules()
    if leaked:
        print(f"kvbench: loaded {leaked} in the measuring process",
              file=sys.stderr)
        return 3
    for line in lines:
        print(line, file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
