#!/usr/bin/env python3
"""Hold the port's trained pair to the reference's, on the CPU.

    PYTHONPATH=src JAX_PLATFORMS=cpu python3 tools/parity/trained_pair.py \
        [--requests 30] [--max-new 4] [--out chiprun_out/trained_pair.json]

Reads the reference's quick-trained pair from experiments/ckpt/base.npz
(the reference's ``load_pair`` trains it there first when it is missing:
1,200 steps of the 8-layer float32 pair, minutes on a CPU), restores the
same file into the port (``repro_torch.launch.pairs.load_pair`` with
``device="cpu"``), and serves the same request streams of each task of
the suite (retrieval, multihop, decision) through both packages'
``serve_serial`` at kvcomm 0.5 / 0.7 on one calibration sample: selections,
greedy tokens and ``accuracy`` side by side, with each package's accuracy
on random weights beside them (one random init from seed 0 each). Prints
one JSON object, and writes it to ``--out`` too. Needs the reference
package (JAX): like the parity tests, this is a check of the port against
the reference, not part of the port, so it lives apart from the port's
own tools (``tools/*.py``, which import neither JAX nor the reference).
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "..")
sys.path.insert(0, os.path.join(ROOT, "src"))


def _serve(pkg, cfg, tok, sender, receiver, task, n, max_new):
    """(selection, tokens per request, accuracy) through one package."""
    if pkg == "ref":
        from repro.comm import Agent, CommSession
        from repro.core.types import KVCommConfig
        from repro.data.synthetic import SyntheticTask, TaskConfig
        from repro.serving.scheduler import (accuracy, make_requests,
                                             serve_serial)
    else:
        from repro_torch.comm import Agent, CommSession
        from repro_torch.core.types import KVCommConfig
        from repro_torch.data.synthetic import SyntheticTask, TaskConfig
        from repro_torch.serving.scheduler import (accuracy, make_requests,
                                                   serve_serial)
    sess = CommSession(Agent("sender", cfg, sender, tok),
                       Agent("receiver", cfg, receiver, tok))
    calib = SyntheticTask(tok, TaskConfig(task, num_facts=6,
                                          seed=42)).batch(1)
    sess.calibrate(calib["context"], calib["query"], key=task)
    kvcfg = KVCommConfig(ratio=0.5, alpha=0.7)
    per = -(-n // 3)
    batches = [SyntheticTask(tok, TaskConfig(task, num_facts=nf,
                                             seed=100 + i)).batch(per)
               for i, nf in enumerate((4, 6, 8))]
    reqs = make_requests(batches, max_new=max_new, pad=tok.PAD)[:n]
    comps, _ = serve_serial(sess, reqs, kvcfg, calib_key=task)
    sel = np.asarray(sess.selection(kvcfg, key=task)).astype(int).tolist()
    return sel, [c.tokens.tolist() for c in comps], accuracy(comps, reqs)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--requests", type=int, default=30)
    ap.add_argument("--max-new", type=int, default=4)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    import jax
    import torch
    from repro.launch import pairs as jpairs
    from repro.models import transformer as jtfm
    from repro_torch.launch import pairs
    from repro_torch.models import transformer as tfm
    torch.set_num_threads(4)

    t0 = time.time()
    trained = os.path.exists(os.path.join(jpairs.CKPT_DIR, "base.npz"))
    jcfg, jtok, js, jr = jpairs.load_pair()
    cfg, tok, s, r = pairs.load_pair(device="cpu")
    res = {"checkpoint": "experiments/ckpt/base.npz",
           "trained_by": "existing file" if trained else "reference now",
           "requests_per_task": args.requests, "max_new": args.max_new,
           "tasks": {}}
    rand_j = jtfm.init_params(jcfg, jax.random.PRNGKey(0))
    rand_p = tfm.init_params(cfg, 0, device="cpu")
    for task in ("retrieval", "multihop", "decision"):
        jsel, jtoks, jacc = _serve("ref", jcfg, jtok, js, jr, task,
                                   args.requests, args.max_new)
        psel, ptoks, pacc = _serve("port", cfg, tok, s, r, task,
                                   args.requests, args.max_new)
        same = sum(a == b for a, b in zip(jtoks, ptoks))
        _, _, jrand = _serve("ref", jcfg, jtok, rand_j, rand_j, task,
                             args.requests, args.max_new)
        _, _, prand = _serve("port", cfg, tok, rand_p, rand_p, task,
                             args.requests, args.max_new)
        res["tasks"][task] = {
            "selection_equal": jsel == psel, "selection": psel,
            "requests_token_identical": same, "requests": len(jtoks),
            "accuracy_ref": jacc, "accuracy_port": pacc,
            "accuracy_random_ref": jrand, "accuracy_random_port": prand}
    res["seconds"] = round(time.time() - t0, 1)
    line = json.dumps(res)
    print(line)
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            f.write(line + "\n")


if __name__ == "__main__":
    main()
