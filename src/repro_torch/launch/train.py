"""Training launcher of the port (the counterpart of the reference's
``launch/train.py``): a registered config, optionally reduced, trained on
the packed byte corpus with AdamW, its state sharded over a mesh by
``distributed.sharding.param_shardings`` (parameters and moments alike)
and each batch over the data axes.

    PYTHONPATH=src python -m repro_torch.launch.train --arch gemma3-4b \\
        --reduced --steps 20 --batch 8 --seq 128 --device cpu
    PYTHONPATH=src python -m repro_torch.launch.train --steps 4 --batch 4
    PYTHONPATH=src torchrun --nproc-per-node 4 -m repro_torch.launch.train \\
        --device cpu --reduced

Under ``torchrun`` with more than one process the state lies on the host
mesh (world, 1) over ("data", "model"), gloo on the CPU and NCCL on
cards; ``--production-mesh`` takes the 16x16 mesh (256 ranks). Every
rank draws the same parameters from the seed and keeps its own shards.
``--save`` gathers the full tensors and rank 0 writes the reference's
checkpoint layout. One process runs on plain tensors: a mesh of one
device moves no data, and DTensor's dispatch would only slow each step.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import time

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

from repro_torch import resolve_device
from repro_torch.configs.base import InputShape
from repro_torch.configs.registry import get_config
from repro_torch.data.pipeline import synthetic_byte_corpus, token_stream_iter
from repro_torch.distributed import hints
from repro_torch.distributed import sharding as shd
from repro_torch.launch.mesh import make_host_mesh, make_production_mesh, \
    mesh_axes
from repro_torch.models import transformer as tfm
from repro_torch.training import checkpoint
from repro_torch.training.optimizer import OptimizerConfig, init_opt_state
from repro_torch.training.train_loop import TrainState, make_train_step, \
    to_batch


def scalar(x) -> float:
    """A metric as a Python float (a DTensor's pending sum or mean
    carried out)."""
    return float(x.full_tensor() if isinstance(x, DTensor) else x)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="llama3.2-3b-pair")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--save", default=None)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--production-mesh", action="store_true",
                    help="use the 16x16 mesh (needs 256 ranks)")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = dataclasses.replace(cfg.reduced(), vocab_size=260)
    started = not dist.is_initialized()
    mesh = None
    if args.production_mesh:
        mesh = make_production_mesh(device_type=device.type)
    elif int(os.environ.get("WORLD_SIZE", "1")) > 1:
        mesh = make_host_mesh(device)
    if device.type == "cuda":
        device = torch.device("cuda", torch.cuda.current_device())
    try:
        _train(args, cfg, device, mesh)
    finally:
        hints.clear()
        if started and dist.is_initialized():
            dist.destroy_process_group()


def _train(args, cfg, device, mesh) -> None:
    """The training loop; on plain tensors without a ``mesh``."""
    rank = dist.get_rank() if mesh is not None else 0
    say = print if rank == 0 else (lambda *a, **k: None)
    where = (torch.cuda.get_device_name(device) if device.type == "cuda"
             else "cpu")
    axes = dict(zip(mesh.mesh_dim_names, mesh.shape)) if mesh else None
    say(f"arch={cfg.name} device={where} mesh={axes} "
        f"layers={cfg.total_layers} d={cfg.d_model}")

    opt = OptimizerConfig(lr=args.lr, total_steps=args.steps,
                          warmup_steps=max(args.steps // 10, 1))
    step_fn = make_train_step(cfg, opt)
    params = tfm.init_params(cfg, args.seed, device=device)
    if mesh is not None:
        params = shd.distribute(params, mesh,
                                shd.param_shardings(cfg, mesh, params))
        hints.set_axes(*mesh_axes(mesh))
    state = TrainState(params, init_opt_state(params))
    shape = InputShape("train", args.seq, args.batch, "train")
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
        batch = to_batch(batch, device)
        if mesh is not None:
            batch = shd.distribute(batch, mesh, shd.input_shardings(
                cfg, mesh, shape, batch))
        state, m = step_fn(state, batch)
        if i % 10 == 0 or i == args.steps - 1:
            say(f"step {i} loss {scalar(m['loss']):.4f} "
                f"({time.time() - t0:.1f}s)")
    if args.save:
        full = shd.gather(state.params)
        if rank == 0:
            checkpoint.save(args.save, full,
                            {"arch": cfg.name, "steps": args.steps},
                            cfg=cfg)
            say(f"saved {args.save}")


if __name__ == "__main__":
    main()
