"""The readings the check's limits are set from, on the card, at a cell's
own size and load: for each seed, the program set up as a run sets it up,
a few waves at the cell's load, and the check's numbers on them; for the
first ``--control`` seeds also the control's (the reference at float8 in
the program's place, on the same prompts and served tokens). The
benchmark's own runs never run this.

    python3 -m kvbench.readings --workload <cell> --seeds 1 2 3 [--control 3]

One JSON line per seed on standard output (and appended to ``--out``).
"""
from __future__ import annotations

import argparse
import gc
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m kvbench.readings")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control", type=int, default=0,
                    help="read the control on the first N seeds")
    ap.add_argument("--waves", type=int, default=1)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    import torch
    sys.path.insert(0, str(ROOT / "src"))
    from kvbench import check, generator
    from kvbench.harness import (ALPHA, BOS, RATIO, Bench, load_cell,
                                 load_json, make_param_sets)
    if not torch.cuda.is_available():
        print("kvbench.readings needs a CUDA card", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cell = load_cell(load_json(ROOT / "BENCHMARK.json"), args.workload)
    fam = cell.family
    dev = torch.device("cuda", 0)
    for n, seed in enumerate(args.seeds):
        t = time.perf_counter()
        params = make_param_sets(cell, seed, dev)
        bench = Bench(cell, seed, dev, params)
        waves = [bench.run_wave(generator.wave(cell.mix, seed, k,
                                               bench.cfg.vocab_size))
                 for k in range(args.waves)]
        t_prog = time.perf_counter()
        served = bench.served(waves)
        calib = check.Served(rid=-1, context=bench.calib.context,
                             query=bench.calib.query, answer=0, tokens=None)
        scores, select, wire = bench.scores, bench.select, bench.wire
        layers = list(bench.layers)
        bench.release()
        del bench
        gc.collect()
        torch.cuda.empty_cache()
        r32 = (fam.Reference(cell.model, cell.mlp, params[0]),
               fam.Reference(cell.model, cell.mlp, params[1]))
        nums = check.numbers(
            sender=r32[0], receiver=r32[1], served=served, calib=calib,
            prog_scores=scores, prog_select=select, ratio=RATIO,
            alpha=ALPHA, wire=wire, bos=BOS, seed=seed,
            sample_tokens=cell.spec["sample_tokens"], family=fam)
        t_ref = time.perf_counter()
        line = {"cell": cell.name, "seed": seed,
                **{k: nums[k] for k in check.names(fam)},
                "sampled_requests": nums["sampled_requests"],
                "sampled_tokens": nums["sampled_tokens"],
                "layers": layers,
                "ref_rule_mismatch": int((check.paper_selection(
                    nums["ref_scores"], RATIO, ALPHA) != select).sum()),
                "prog_scores": [float(x) for x in scores],
                "ref_scores": [float(x) for x in nums["ref_scores"]]}
        if n < args.control:
            picked = check.sample(served, seed, cell.spec["sample_tokens"])
            ctl = check.control_numbers(
                sender=r32[0], receiver=r32[1],
                sender8=fam.Reference(cell.model, cell.mlp, params[0],
                                      "fp8"),
                receiver8=fam.Reference(cell.model, cell.mlp, params[1],
                                        "fp8"),
                picked=picked, calib=calib, layers=layers, wire=wire,
                bos=BOS, family=fam)
            for k, v in ctl.items():
                line[f"control_{k}"] = v
        line["program_s"] = t_prog - t
        line["check_s"] = t_ref - t_prog
        line["seconds"] = time.perf_counter() - t
        line["gaps"] = nums["gaps"]
        print(json.dumps(line), flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(json.dumps(line) + "\n")
        del params, r32
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
