"""Registry of the configs the port runs (attention-only dense for now)."""
from __future__ import annotations

from typing import Dict

from repro_torch.configs.base import ModelConfig
from repro_torch.configs.llama3_3b_pair import CONFIG as _LLAMA_PAIR

_REGISTRY: Dict[str, ModelConfig] = {_LLAMA_PAIR.name: _LLAMA_PAIR}


def get_config(name: str) -> ModelConfig:
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def list_archs() -> list[str]:
    return sorted(_REGISTRY)
