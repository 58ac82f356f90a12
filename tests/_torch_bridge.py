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


def port_params(params, device="cpu"):
    return params_from_jax(jax.tree.map(np.asarray, params), device=device)


def t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))
