"""KVComm serving launcher of the port: continuous-batching
sender -> receiver serving on the card.

A sender Agent holds contexts, a receiver Agent answers queries, KV flows
through a byte-accounted transport under a calibrated, frozen layer
selection. The default path is the continuous-batching scheduler with the
ragged decode kernel; ``--serial`` runs the blocking reference loop.
Weights are random from ``--seed`` unless ``--weights trained`` loads the
trained pair (``launch/pairs.py``: its checkpoint under experiments/ckpt,
quick-trained there first when absent).

    PYTHONPATH=src python -m repro_torch.launch.serve --config full
    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \\
        --decode-backend reference --requests 8

``--trace`` serves inside ``repro_torch.utils.trace.recording()`` and
prints one line per span name of the scheduler's run (how many, host ms,
stream ms on the card) and its counters.
"""
from __future__ import annotations

import argparse
import contextlib
import time

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.comm import (Agent, CommSession, InMemoryTransport,
                              SerializedTransport)
from repro_torch.core.types import KVCommConfig
from repro_torch.data.synthetic import SyntheticTask, TaskConfig
from repro_torch.launch import pairs
from repro_torch.serving.scheduler import (Scheduler, SchedulerConfig,
                                           accuracy, make_requests,
                                           serve_serial)
from repro_torch.utils import trace


def build_requests(tok, task: str, n: int, max_new: int):
    """A mixed-length request stream: contexts over several fact counts."""
    per = -(-n // 3)
    batches = [SyntheticTask(tok, TaskConfig(task, num_facts=nf,
                                             seed=42 + i)).batch(per)
               for i, nf in enumerate((4, 6, 8))]
    return make_requests(batches, max_new=max_new, pad=tok.PAD)[:n]


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--requests", type=int, default=32)
    ap.add_argument("--ratio", type=float, default=0.5)
    ap.add_argument("--alpha", type=float, default=0.7)
    ap.add_argument("--task", default="retrieval",
                    choices=["retrieval", "multihop", "decision"])
    ap.add_argument("--transport", default="inmemory",
                    choices=["inmemory", "serialized"])
    ap.add_argument("--wire-dtype", default="int8",
                    choices=["float16", "bfloat16", "float32", "int8"])
    ap.add_argument("--serial", action="store_true",
                    help="blocking reference: per-request share -> stream")
    ap.add_argument("--max-new", type=int, default=8)
    ap.add_argument("--capacity", type=int, default=8,
                    help="slot-table rows (in-flight requests)")
    ap.add_argument("--decode-backend", default="kernel",
                    choices=["reference", "kernel"],
                    help="per-step decode attention: the CUDA ragged "
                         "decode kernel or the masked-dense plain path")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    ap.add_argument("--config", default="pair", choices=["pair", "full"],
                    help="the tiny 8-layer pair or llama3.2-3b-pair at "
                         "full width")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--weights", default="random",
                    choices=["random", "trained"],
                    help="random weights from --seed, or the trained pair "
                         "(--config pair only; quick-trains when no "
                         "checkpoint exists)")
    ap.add_argument("--trace", action="store_true",
                    help="record the scheduler's spans and counters and "
                         "print them by span name")
    args = ap.parse_args(argv)
    if args.weights == "trained" and args.config != "pair":
        ap.error("--weights trained needs --config pair")
    if args.trace and args.serial:
        ap.error("--trace reads the scheduler's spans; drop --serial")

    device = resolve_device(args.device)
    cfg = (pairs.full_width_config() if args.config == "full"
           else pairs.pair_config())
    tok = pairs.pair_tokenizer()
    if args.weights == "trained":
        cfg, tok, sender, receiver = pairs.load_pair(device=device)
    else:
        sender, receiver = pairs.random_pair(cfg, args.seed, device=device)
    transport = (SerializedTransport(args.wire_dtype)
                 if args.transport == "serialized" else InMemoryTransport())
    session = CommSession(Agent("sender", cfg, sender, tok),
                          Agent("receiver", cfg, receiver, tok), transport)
    task = SyntheticTask(tok, TaskConfig(args.task, num_facts=6, seed=42))
    calib = task.batch(1)
    scores = session.calibrate(calib["context"], calib["query"],
                               key=args.task)
    kvcfg = KVCommConfig(ratio=args.ratio, alpha=args.alpha)
    print(f"calibrated scores: {np.round(scores.numpy(), 3)}")

    reqs = build_requests(tok, args.task, args.requests, args.max_new)
    t0 = time.perf_counter()
    if args.serial:
        comps, stats = serve_serial(session, reqs, kvcfg,
                                    calib_key=args.task,
                                    backend=args.decode_backend)
        mode = f"serial[{args.decode_backend}]"
    else:
        sched = Scheduler(session, kvcfg, calib_key=args.task,
                          config=SchedulerConfig(
                              capacity=args.capacity,
                              decode_backend=args.decode_backend))
        with (trace.recording() if args.trace
              else contextlib.nullcontext()):
            comps, stats = sched.run(reqs)
        mode = f"scheduler(cap={args.capacity}, {args.decode_backend})"
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dt = time.perf_counter() - t0
    ttft = [c.ttft_s for c in comps]
    where = (torch.cuda.get_device_name(device) if device.type == "cuda"
             else "cpu")
    print(f"[{mode} on {where}] served {len(comps)} requests / "
          f"{stats['tokens']} tokens in {dt:.2f}s "
          f"({stats['tokens'] / dt:.1f} tok/s; TTFT p50 "
          f"{np.median(ttft) * 1e3:.0f} ms)")
    print(f"accuracy {accuracy(comps, reqs):.3f} | "
          f"transport[{args.transport}] moved "
          f"{session.transport.total_bytes / 1e6:.2f} MB over "
          f"{len(session.transport.log)} transfers")
    if args.trace:
        print_trace(stats["trace"])


def print_trace(exported) -> None:
    """One line per span name (count, host ms, stream ms), then the
    counters."""
    for name, row in trace.summary(exported).items():
        stream = ("-" if row["stream_ms"] is None
                  else f"{row['stream_ms']:.3f}")
        print(f"span {name} count {row['count']} host_ms "
              f"{row['host_ms']:.3f} stream_ms {stream}")
    for name, n in exported["counters"].items():
        print(f"counter {name} {n}")


if __name__ == "__main__":
    main()
