"""Registry of the configs the port runs: the reference's eleven (the
paper's pair, the decoder-only attention models (dense, MoE,
sliding-window, the VLM with its stub patch embeddings), the
encoder-decoder ``whisper-medium`` with its stub audio frames, the
attention-free RWKV6 and the hybrid Zamba2 (Mamba2 plus shared
attention)), and ``PORT_ONLY``, those the reference package does not
have: ``mellum2-12b`` (sparse experts in every layer, sliding-window and
YaRN full attention 3:1)."""
from __future__ import annotations

from typing import Dict

from repro_torch.configs.base import ModelConfig
from repro_torch.configs.gemma3_4b import CONFIG as _GEMMA3
from repro_torch.configs.internlm2_20b import CONFIG as _INTERNLM2
from repro_torch.configs.llama3_3b_pair import CONFIG as _LLAMA_PAIR
from repro_torch.configs.mellum2_12b import CONFIG as _MELLUM2
from repro_torch.configs.mixtral_8x22b import CONFIG as _MIXTRAL
from repro_torch.configs.olmoe_1b_7b import CONFIG as _OLMOE
from repro_torch.configs.pixtral_12b import CONFIG as _PIXTRAL
from repro_torch.configs.qwen1_5_110b import CONFIG as _QWEN
from repro_torch.configs.rwkv6_1_6b import CONFIG as _RWKV6
from repro_torch.configs.starcoder2_7b import CONFIG as _STARCODER2
from repro_torch.configs.whisper_medium import CONFIG as _WHISPER
from repro_torch.configs.zamba2_2_7b import CONFIG as _ZAMBA2

_REGISTRY: Dict[str, ModelConfig] = {
    c.name: c for c in (_MIXTRAL, _STARCODER2, _WHISPER, _INTERNLM2, _QWEN,
                        _PIXTRAL, _GEMMA3, _RWKV6, _OLMOE, _ZAMBA2,
                        _LLAMA_PAIR, _MELLUM2)}
PORT_ONLY = ("mellum2-12b",)


def get_config(name: str) -> ModelConfig:
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def list_archs() -> list[str]:
    return sorted(_REGISTRY)


def reference_archs() -> list[str]:
    """The registered configs the reference package has too."""
    return sorted(set(_REGISTRY) - set(PORT_ONLY))


ASSIGNED_ARCHS = [
    "mixtral-8x22b", "starcoder2-7b", "whisper-medium", "internlm2-20b",
    "qwen1.5-110b", "pixtral-12b", "gemma3-4b", "rwkv6-1.6b",
    "olmoe-1b-7b", "zamba2-2.7b",
]
