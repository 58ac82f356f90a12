#!/usr/bin/env python3
"""Readings of the port's sharded path on the CPU (PERF.md §6 cites them).

    # rwkv6-1.6b (reduced, float32) on a 2x2 gloo mesh of four processes:
    # its sharded gradients against the unsharded ones, element by element
    # over the largest, for parameter seeds 0-5, beside the unsharded
    # gradients' own change under a 1e-7 relative parameter perturbation
    python3 tools/sharded_readings.py seeds
    # the same reading with a fault planted in the sharded backward:
    # rwkv6's u gradient from one batch shard only, and (llama3.2-3b-pair
    # with one KV head) the query-head split's k / v gradients without
    # their sum over "model"
    python3 tools/sharded_readings.py fault
    # per-device FLOPs x 8 over whole-job FLOPs of reduced configs on a
    # fake 2x4 process group (1.0: no work repeated across ranks)
    python3 tools/sharded_readings.py ratios
    # one production-mesh dry-run combo with its depth cut to N layers
    # (published widths; shape-only stand-ins, well under 1 GB of host
    # memory)
    python3 tools/sharded_readings.py depth qwen1.5-110b train_4k 2
    python3 tools/sharded_readings.py depth gemma3-4b prefill_32k 2 --kvcomm
    python3 tools/sharded_readings.py depth mixtral-8x22b decode_32k 2 \\
        --multi-pod

Each prints JSON lines. The gloo readings run the train step of
``tests/test_torch_sharded.py`` (batch 2 x 8, vocabulary 128).
"""
import argparse
import dataclasses
import json
import os
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

B, S = 2, 8


def rel(a, b) -> float:
    """max |a - b| over max |b|."""
    a, b = a.detach().double(), b.detach().double()
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))


def _config(arch: str, kv_heads: int = 0):
    from repro_torch.configs.registry import get_config
    cfg = dataclasses.replace(get_config(arch).reduced(), dtype="float32",
                              vocab_size=128)
    return dataclasses.replace(cfg, num_kv_heads=kv_heads) if kv_heads \
        else cfg


def _plant(fault: str) -> None:
    """Drop a sum over shards from one shard-by-shard region's backward:
    its ``in_grad_placements`` for the given inputs replaced by their
    forward placements."""
    from repro_torch.distributed import sharding
    region, inputs = {"u": ("local_wkv", (4,)),
                      "kv": ("local_attention", (1, 2))}[fault]
    local_map = sharding.local_map

    def planted(fn, **kw):
        if fn.__qualname__.startswith(region + "."):
            grads = list(kw["in_grad_placements"])
            for i in inputs:
                grads[i] = kw["in_placements"][i]
            kw["in_grad_placements"] = tuple(grads)
        return local_map(fn, **kw)

    sharding.local_map = planted


def _rank(rank: int, store: str, arch: str, kv_heads: int, seeds,
          fault: str) -> None:
    """One of the four gloo ranks: per seed, the sharded gradients'
    largest element-wise reading and the unsharded gradients' change
    under a 1e-7 relative parameter perturbation."""
    import torch.distributed as dist
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store, 4),
                            rank=rank, world_size=4)
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.configs.base import InputShape
    from repro_torch.distributed import hints
    from repro_torch.distributed import sharding as shd
    from repro_torch.models import transformer as tfm
    from repro_torch.training.optimizer import leaves, tree_map
    from repro_torch.training.train_loop import _grads
    if fault:
        _plant(fault)
    mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
    cfg = _config(arch, kv_heads)
    for seed in seeds:
        params = tfm.init_params(cfg, seed, device="cpu")
        rng = np.random.default_rng(seed)
        batch = {k: torch.from_numpy(rng.integers(0, 128, (B, S)))
                 for k in ("tokens", "targets")}
        _, _, g_u = _grads(params, cfg, batch)
        gen = torch.Generator().manual_seed(1)
        bumped = tree_map(lambda t: t * (1 + 1e-7 * torch.randn(
            t.shape, generator=gen)), params)
        kappa = max(rel(a, b) for a, b in zip(
            leaves(_grads(bumped, cfg, batch)[2]), leaves(g_u)))
        sp = shd.distribute(params, mesh,
                            shd.param_shardings(cfg, mesh, params))
        sb = shd.distribute(batch, mesh, shd.input_shardings(
            cfg, mesh, InputShape("t", S, B, "train"), batch))
        hints.set_axes("data", "model")
        _, _, g_s = _grads(sp, cfg, sb)
        hints.clear()
        got = max(rel(a.full_tensor(), b)
                  for a, b in zip(leaves(g_s), leaves(g_u)))
        if rank == 0:
            print(json.dumps({"arch": arch, "kv_heads": kv_heads or None,
                              "seed": seed, "fault": fault or None,
                              "grads_max_rel": got,
                              "unsharded_1e-7_perturbation": kappa}),
                  flush=True)
    dist.destroy_process_group()


def _gloo(arch: str, seeds, fault: str = "", kv_heads: int = 0) -> None:
    with tempfile.TemporaryDirectory() as tmp:
        args = [sys.executable, __file__, "_rank", "--store",
                os.path.join(tmp, "store"), "--arch", arch, "--kv-heads",
                str(kv_heads), "--seeds", ",".join(map(str, seeds)),
                "--fault", fault]
        procs = [subprocess.Popen(args + ["--rank", str(r)],
                                  stdout=None if r == 0 else
                                  subprocess.DEVNULL,
                                  stderr=subprocess.DEVNULL)
                 for r in range(4)]
        try:
            for p in procs:
                p.wait(timeout=600)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
        if any(p.returncode for p in procs):
            raise SystemExit(f"a rank failed: {[p.returncode for p in procs]}")


def _fake_group(world: int) -> None:
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)


def ratios() -> None:
    """Per-device FLOPs x 8 / job FLOPs on a fake 2x4 group."""
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.configs.base import InputShape
    from repro_torch.configs.registry import get_config
    from repro_torch.launch import dryrun, specs
    _fake_group(8)
    mesh = init_device_mesh("cpu", (2, 4), mesh_dim_names=("data", "model"))
    cases = [(a, {}) for a in ("llama3.2-3b-pair", "gemma3-4b",
                               "olmoe-1b-7b", "mixtral-8x22b",
                               "whisper-medium", "rwkv6-1.6b",
                               "zamba2-2.7b")]
    cases.append(("olmoe-1b-7b", {"moe_impl": "dropping", "moe_groups": 2}))
    for arch, extra in cases:
        cfg = dataclasses.replace(get_config(arch).reduced(),
                                  vocab_size=128, **extra)
        for mode in ("train", "prefill"):
            shape = InputShape("t", 32, 8, mode)
            fn, args = specs.make_step_fn(cfg, shape)
            rec = dryrun.measure(fn, args, mesh, dryrun.shardings_for(
                cfg, mesh, shape, args))
            print(json.dumps({"arch": arch, **extra, "mode": mode,
                              "per_device_x8_over_job":
                                  8 * rec["flops"] / rec["flops_job"],
                              "collectives": rec["collectives"]["total"]}),
                  flush=True)


def depth(arch: str, shape: str, layers: int, multi_pod: bool,
          kvcomm: bool) -> None:
    """``dryrun.run_one`` with ``arch``'s depth cut to ``layers``."""
    from repro_torch.configs.registry import get_config
    from repro_torch.launch import dryrun
    dryrun.get_config = lambda a: dataclasses.replace(  # noqa: E731
        get_config(a), num_layers=layers) if a == arch else get_config(a)
    rec = dryrun.run_one(arch, shape, multi_pod, kvcomm=kvcomm)
    rec.pop("traceback", None)
    print(json.dumps({"layers": layers, **rec}))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("what", choices=["seeds", "fault", "ratios", "depth",
                                     "_rank"])
    ap.add_argument("combo", nargs="*", help="depth: ARCH SHAPE LAYERS")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--kvcomm", action="store_true")
    ap.add_argument("--rank", type=int)
    ap.add_argument("--store")
    ap.add_argument("--arch")
    ap.add_argument("--kv-heads", type=int, default=0)
    ap.add_argument("--seeds")
    ap.add_argument("--fault", default="")
    args = ap.parse_args()
    if args.what == "_rank":
        _rank(args.rank, args.store, args.arch, args.kv_heads,
              [int(s) for s in args.seeds.split(",")], args.fault)
    elif args.what == "seeds":
        _gloo("rwkv6-1.6b", range(6))
    elif args.what == "fault":
        _gloo("rwkv6-1.6b", [0], fault="u")
        _gloo("llama3.2-3b-pair", [0], fault="kv", kv_heads=1)
    elif args.what == "ratios":
        ratios()
    else:
        arch, shape, layers = args.combo
        depth(arch, shape, int(layers), args.multi_pod, args.kvcomm)


if __name__ == "__main__":
    main()
