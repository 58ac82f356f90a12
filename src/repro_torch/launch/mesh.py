"""Device meshes of the port (the counterpart of the reference's
``launch/mesh.py``).

Single pod: 256 ranks as (data=16, model=16). Multi-pod: 2 pods x 256 as
(pod=2, data=16, model=16); the ``pod`` axis extends data parallelism and
tensor parallelism never crosses it. Both are ``init_device_mesh`` over
the process group in place, which must have exactly that many ranks (the
dry run runs them on a fake process group, as rank 0).

The host mesh is (world, 1) over ("data", "model"): NCCL on the card,
gloo on the CPU. Without a process group it starts one of a single rank;
under ``torchrun`` it joins the launcher's group.

Functions, not module-level constants: importing this module starts no
process group.
"""
from __future__ import annotations

import os

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from repro_torch import resolve_device

PRODUCTION_MESHES = {False: ((16, 16), ("data", "model")),
                     True: ((2, 16, 16), ("pod", "data", "model"))}


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda") -> DeviceMesh:
    """The reference's production mesh over the process group in place;
    raises unless the group has 256 (``multi_pod``: 512) ranks."""
    shape, axes = PRODUCTION_MESHES[multi_pod]
    need = 1
    for n in shape:
        need *= n
    have = dist.get_world_size() if dist.is_initialized() else 0
    if have != need:
        raise ValueError(f"the {'x'.join(map(str, shape))} mesh needs a "
                         f"process group of {need} ranks, not {have}")
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


def make_host_mesh(device=None) -> DeviceMesh:
    """(world, 1) over ("data", "model") on ``device`` (the card unless
    the caller passes "cpu"; a CUDA request without a card raises)."""
    dev = resolve_device(device)
    if not dist.is_initialized():
        backend = "nccl" if dev.type == "cuda" else "gloo"
        if "RANK" in os.environ:            # started by torchrun
            dist.init_process_group(backend)
        else:
            dist.init_process_group(backend, store=dist.HashStore(),
                                    world_size=1, rank=0)
    if dev.type == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
    return init_device_mesh(dev.type, (dist.get_world_size(), 1),
                            mesh_dim_names=("data", "model"))


def mesh_axes(mesh) -> tuple:
    """Returns (dp_axes, tp_axis): dp_axes is 'data' or ('pod', 'data')."""
    if "pod" in mesh.mesh_dim_names:
        return ("pod", "data"), "model"
    return "data", "model"


# NVIDIA H100 SXM5 80GB datasheet figures (dense, at the card's 700 W
# power limit), per card; not measured
PEAK_FLOPS_BF16 = 989e12        # FLOP/s
HBM_BW = 3.35e12                # bytes/s
NVLINK_BW = 450e9               # bytes/s per direction
