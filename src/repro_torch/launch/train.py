"""Single-device training launcher of the port (the counterpart of the
reference's ``launch/train.py``): a registered config, optionally reduced,
trained on the packed byte corpus with AdamW.

    PYTHONPATH=src python -m repro_torch.launch.train --arch gemma3-4b \\
        --reduced --steps 20 --batch 8 --seq 128 --device cpu
    PYTHONPATH=src python -m repro_torch.launch.train --steps 4 --batch 4

It runs on one device (the card by default). The reference's sharded
state and ``--production-mesh`` are not ported yet: sharding waits for the
distributed slice of the port.
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs.registry import get_config
from repro_torch.data.pipeline import synthetic_byte_corpus, token_stream_iter
from repro_torch.training import checkpoint
from repro_torch.training.optimizer import OptimizerConfig
from repro_torch.training.train_loop import (init_train_state,
                                             make_train_step, to_batch)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(
        description=__doc__.split("\n\n")[0],
        epilog="Single device only: the reference's sharded training and "
               "--production-mesh wait for the port's distributed slice.")
    ap.add_argument("--arch", default="llama3.2-3b-pair")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--save", default=None)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = dataclasses.replace(cfg.reduced(), vocab_size=260)
    layers = sum(s.count for s in cfg.layer_plan())
    where = (torch.cuda.get_device_name(device) if device.type == "cuda"
             else "cpu")
    print(f"arch={cfg.name} device={where} layers={layers} d={cfg.d_model}")

    opt = OptimizerConfig(lr=args.lr, total_steps=args.steps,
                          warmup_steps=max(args.steps // 10, 1))
    step_fn = make_train_step(cfg, opt)
    state = init_train_state(cfg, args.seed, device=device)
    corpus = synthetic_byte_corpus(1 << 18) % cfg.vocab_size
    it = token_stream_iter(corpus, args.batch, args.seq)
    t0 = time.time()
    for i in range(args.steps):
        batch = next(it)
        if cfg.encoder_layers:        # the stub frames and patches: zeros
            batch["frames"] = np.zeros(
                (args.batch, cfg.encoder_seq, cfg.d_model), np.float32)
        if cfg.num_patches:
            batch["patches"] = np.zeros(
                (args.batch, cfg.num_patches, cfg.d_model), np.float32)
        state, m = step_fn(state, to_batch(batch, device))
        if i % 10 == 0 or i == args.steps - 1:
            print(f"step {i} loss {float(m['loss']):.4f} "
                  f"({time.time() - t0:.1f}s)")
    if args.save:
        checkpoint.save(args.save, state.params,
                        {"arch": cfg.name, "steps": args.steps}, cfg=cfg)
        print(f"saved {args.save}")


if __name__ == "__main__":
    main()
