"""Production-mesh dry run of the port (the counterpart of the reference's
``launch/dryrun.py``): every (architecture x input shape) traced on the
production meshes, recording FLOPs, bytes, memory, collectives and an op
census.

The reference lowers and compiles on 512 fake host devices. Here the
process is rank 0 of a fake process group of 256 (16x16) or 512
(2x16x16) ranks: the parameters, optimizer state, batch and cache are
shape-only stand-ins (``launch.specs``) placed by the sharding rules as
DTensors, and the step runs eagerly once under ``utils.costs.CostMode``
and ``MemTracker``; the fake group's collectives move nothing. Eager
execution runs and counts every layer, so the reference's ``--unroll``
(exact costs from an unrolled scan) has no counterpart and is dropped.
An SSM prefill steps its scans through time in Python, so
``prefill_32k`` on rwkv6 / zamba2 takes very long.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen1.5-110b \\
        --shape train_4k --mesh pod
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both \\
        --out experiments/dryrun_torch.json

Record keys, where they mean the reference's: ``flops`` (per device),
``flops_job`` (whole job), ``bytes_accessed`` (per device, unfused),
``argument_size_in_bytes`` (the local shards of the arguments),
``output_size_in_bytes`` (the local shards of the outputs),
``peak_memory_in_bytes`` (``MemTracker``'s peak on the device, the
arguments included), ``collectives``, ``op_census``, ``status``,
``error``, ``trace_s`` and ``total_s``.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
import traceback
from typing import Any, Dict

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor
from torch.utils._pytree import tree_leaves

from repro_torch.configs.base import INPUT_SHAPES
from repro_torch.configs.registry import ASSIGNED_ARCHS, get_config
from repro_torch.distributed import hints
from repro_torch.distributed import sharding as shd
from repro_torch.launch.mesh import PRODUCTION_MESHES, make_production_mesh, \
    mesh_axes
from repro_torch.launch.specs import make_kvcomm_prefill_fn, make_step_fn
from repro_torch.training.optimizer import OptState
from repro_torch.training.train_loop import TrainState
from repro_torch.utils import costs
from repro_torch.utils.costs import CostMode

# combos skipped, as the reference's (pure full-attention archs at 500k)
LONG_OK = {"rwkv6-1.6b", "zamba2-2.7b", "mixtral-8x22b", "gemma3-4b"}


def combo_skip_reason(arch: str, shape_name: str) -> str | None:
    if shape_name == "long_500k" and arch not in LONG_OK:
        return ("full-attention arch without sub-quadratic variant; "
                "skip noted in DESIGN.md §6")
    return None


def shardings_for(cfg, mesh, shape, args_spec):
    """Placements matching ``make_step_fn``'s arguments."""
    if shape.mode == "train":
        state, batch = args_spec
        pshard = shd.param_shardings(cfg, mesh, state.params)
        state_sh = TrainState(params=pshard, opt=OptState(
            step=None, m=shd.param_shardings(cfg, mesh, state.opt.m),
            v=shd.param_shardings(cfg, mesh, state.opt.v)))
        return (state_sh, shd.input_shardings(cfg, mesh, shape, batch))
    if shape.mode == "prefill":
        params, batch = args_spec
        return (shd.param_shardings(cfg, mesh, params),
                shd.input_shardings(cfg, mesh, shape, batch))
    params, token, cache = args_spec
    return (shd.param_shardings(cfg, mesh, params),
            shd.input_shardings(cfg, mesh, shape, {"tokens": token})[
                "tokens"],
            shd.cache_shardings(cfg, mesh, shape, cache))


def _local_bytes(tree) -> int:
    return sum((t.to_local() if isinstance(t, DTensor) else t).nbytes
               for t in tree_leaves(tree) if isinstance(t, torch.Tensor))


def _DeviceMemTracker():
    """``MemTracker`` that leaves out DTensor's shape-inference runs (fake
    tensors of global shapes, no device's memory). torch 2.11's tracker
    counts them (a peak of terabytes); 2.13's skips them itself."""
    from torch.distributed._tools.mem_tracker import MemTracker

    class Tracker(MemTracker):
        def __enter__(self):
            self._fake_at_entry = costs.fake_mode()
            return super().__enter__()

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if not any(issubclass(t, DTensor) for t in types) and \
                    costs.propagating(self._fake_at_entry):
                return func(*args, **(kwargs or {}))
            return super().__torch_dispatch__(func, types, args, kwargs)

    return Tracker()


def measure(fn, args, mesh, shardings) -> Dict[str, Any]:
    """Place ``args`` by ``shardings`` on ``mesh``, run ``fn`` once under
    the cost counters and the memory tracker, and return the record's
    numbers (see the module docstring)."""
    placed = shd.distribute(args, mesh, shardings)
    hints.set_axes(*mesh_axes(mesh))
    try:
        mem = _DeviceMemTracker()
        mem.track_external(*[t.to_local() if isinstance(t, DTensor) else t
                             for t in tree_leaves(placed)
                             if isinstance(t, torch.Tensor)])
        with mem, CostMode() as costs:
            out = fn(*placed)
    finally:
        hints.clear()
    peak = mem.get_tracker_snapshot("peak")
    rec = costs.summary()
    rec["argument_size_in_bytes"] = _local_bytes(placed)
    rec["output_size_in_bytes"] = _local_bytes(out)
    rec["peak_memory_in_bytes"] = int(sum(d["Total"]
                                          for d in peak.values()))
    return rec


def _fake_group(world: int) -> None:
    """This process as rank 0 of a fake process group of ``world``
    ranks (collectives move nothing)."""
    if dist.is_initialized() and dist.get_world_size() == world:
        return
    if dist.is_initialized():
        dist.destroy_process_group()
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)


def run_one(arch: str, shape_name: str, multi_pod: bool,
            kvcomm: bool = False, moe_impl: str | None = None,
            attn_impl: str | None = None, microbatches: int = 1,
            ring_cache: bool = False) -> Dict[str, Any]:
    rec: Dict[str, Any] = {
        "arch": arch, "shape": shape_name,
        "mesh": "2x16x16" if multi_pod else "16x16", "kvcomm": kvcomm,
    }
    reason = combo_skip_reason(arch, shape_name)
    if reason:
        rec["status"] = "skipped"
        rec["reason"] = reason
        return rec
    cfg = get_config(arch)
    if moe_impl:
        groups = 16 if moe_impl == "dropping" else 1
        cfg = dataclasses.replace(cfg, moe_impl=moe_impl, moe_groups=groups)
        rec["moe_impl"] = moe_impl
    if attn_impl:
        cfg = dataclasses.replace(cfg, attn_impl=attn_impl)
        rec["attn_impl"] = attn_impl
    if microbatches > 1:
        rec["microbatches"] = microbatches
    if ring_cache:
        cfg = dataclasses.replace(cfg, ring_cache=True)
        rec["ring_cache"] = True
    shape = INPUT_SHAPES[shape_name]
    shape_, _ = PRODUCTION_MESHES[multi_pod]
    world = 1
    for n in shape_:
        world *= n
    t0 = time.time()
    try:
        _fake_group(world)
        mesh = make_production_mesh(multi_pod=multi_pod, device_type="cpu")
        if kvcomm:
            fn, args = make_kvcomm_prefill_fn(cfg, shape, context_len=2048)
            sh = (shd.param_shardings(cfg, mesh, args[0]),
                  shd.input_shardings(cfg, mesh, shape, args[1]),
                  shd.cache_shardings(cfg, mesh, shape, args[2]), None)
        else:
            fn, args = make_step_fn(cfg, shape, microbatches=microbatches)
            sh = shardings_for(cfg, mesh, shape, args)
        t1 = time.time()
        rec.update(measure(fn, args, mesh, sh))
        rec["trace_s"] = round(time.time() - t1, 1)
        rec["status"] = "ok"
    except Exception as e:  # noqa: BLE001 — record and continue the sweep
        rec["status"] = "error"
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc(limit=8)
    rec["total_s"] = round(time.time() - t0, 1)
    return rec


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(
        description=__doc__.split("\n\n")[0],
        epilog="The reference's --unroll is dropped: eager execution "
               "counts every layer.")
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", choices=["pod", "multipod", "both"],
                    default="pod")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--kvcomm", action="store_true",
                    help="trace the KVComm receiver prefill variant")
    ap.add_argument("--moe-impl", default=None,
                    choices=["dense_all", "dropping"])
    ap.add_argument("--attn-impl", default=None,
                    choices=["xla", "chunked"])
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--ring-cache", action="store_true")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    archs = ASSIGNED_ARCHS if (args.all or not args.arch) else [args.arch]
    shapes = (list(INPUT_SHAPES) if (args.all or not args.shape)
              else [args.shape])
    meshes = {"pod": [False], "multipod": [True],
              "both": [False, True]}[args.mesh]
    combos = [(a, s, m) for a in archs for s in shapes for m in meshes]

    results = []
    if args.out and os.path.exists(args.out):
        with open(args.out) as f:
            results = json.load(f)
    key_of = lambda r: (r["arch"], r["shape"], r["mesh"],  # noqa: E731
                        r.get("kvcomm", False), r.get("moe_impl"),
                        r.get("attn_impl"))
    done = {key_of(r) for r in results
            if r.get("status") in ("ok", "skipped")}
    for a, s, m in combos:
        key = (a, s, "2x16x16" if m else "16x16", args.kvcomm,
               args.moe_impl, args.attn_impl)
        if key in done:
            print(f"[cached] {key}")
            continue
        print(f"[dryrun] arch={a} shape={s} mesh={key[2]} "
              f"kvcomm={args.kvcomm}", flush=True)
        rec = run_one(a, s, m, kvcomm=args.kvcomm, moe_impl=args.moe_impl,
                      attn_impl=args.attn_impl,
                      microbatches=args.microbatches,
                      ring_cache=args.ring_cache)
        print(f"  -> {rec['status']} "
              f"flops={rec.get('flops', 0):.3g} "
              f"coll={rec.get('collectives', {}).get('total', 0):.3g}B "
              f"({rec.get('total_s', 0)}s)"
              + (f" ERR {rec.get('error')}" if rec["status"] == "error"
                 else ""), flush=True)
        results = [r for r in results if key_of(r) != key]
        results.append(rec)
        if args.out:
            os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
            with open(args.out, "w") as f:
                json.dump(results, f, indent=1)
    if dist.is_initialized():
        dist.destroy_process_group()
    if not args.out:
        print(json.dumps(results, indent=1))


if __name__ == "__main__":
    main()
