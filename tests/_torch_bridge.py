"""Helpers the PyTorch-port parity tests share: carry a reference config
and reference parameters over to the port, and turn arrays into tensors."""
import dataclasses

import jax
import numpy as np
import torch

from repro_torch.configs.base import ModelConfig as PortConfig
from repro_torch.weights import params_from_jax

# the port's CPU tests run inside the multi-worker tier-1 run: keep each
# worker's intra-op pool small
torch.set_num_threads(2)


def port_cfg(cfg) -> PortConfig:
    return PortConfig(**dataclasses.asdict(cfg))


def as_reference(cfg, ref) -> dict:
    """``dataclasses.asdict`` of the port's ``cfg`` over the fields of the
    reference's ``ref``, after holding every field the port alone has
    (``yarn``) at its default: a config both packages have is the same
    config."""
    theirs = [f.name for f in dataclasses.fields(ref)]
    for f in dataclasses.fields(cfg):
        if f.name not in theirs:
            assert getattr(cfg, f.name) == f.default, (cfg.name, f.name)
    mine = dataclasses.asdict(cfg)
    return {k: mine[k] for k in theirs}


def port_params(params, device="cpu"):
    return params_from_jax(jax.tree.map(np.asarray, params), device=device)


def t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))
