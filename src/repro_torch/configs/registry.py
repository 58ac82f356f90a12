"""Registry of the configs the port runs: the paper's pair, the
attention-free RWKV6 and the hybrid Zamba2 (Mamba2 plus shared attention)."""
from __future__ import annotations

from typing import Dict

from repro_torch.configs.base import ModelConfig
from repro_torch.configs.llama3_3b_pair import CONFIG as _LLAMA_PAIR
from repro_torch.configs.rwkv6_1_6b import CONFIG as _RWKV6
from repro_torch.configs.zamba2_2_7b import CONFIG as _ZAMBA2

_REGISTRY: Dict[str, ModelConfig] = {
    c.name: c for c in (_LLAMA_PAIR, _RWKV6, _ZAMBA2)}


def get_config(name: str) -> ModelConfig:
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def list_archs() -> list[str]:
    return sorted(_REGISTRY)
