"""The sender/receiver pair definitions of the port.

``pair_config`` is the reference's tiny 8-layer Llama-3.2-family stand-in
and ``deep_receiver_config`` its 12-layer receiver of a heterogeneous pair;
``full_width_config`` is ``llama3.2-3b-pair`` as published. All run on
random weights drawn from a seed: the trained checkpoints are not in the
repository, and training is not ported yet, so accuracy on random weights
is near zero and only the plumbing and speed are meaningful.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Tuple

from repro_torch.configs.base import ModelConfig
from repro_torch.configs.registry import get_config
from repro_torch.data.tokenizer import SymbolTokenizer
from repro_torch.models import transformer as tfm


def pair_tokenizer() -> SymbolTokenizer:
    return SymbolTokenizer(num_entities=32, num_attributes=16)


def pair_config() -> ModelConfig:
    """Tiny Llama-3.2-family stand-in: 8 layers, float32."""
    tok = pair_tokenizer()
    return dataclasses.replace(
        get_config("llama3.2-3b-pair"),
        num_layers=8, d_model=192, d_ff=512, num_heads=6, num_kv_heads=6,
        head_dim=32, vocab_size=tok.vocab_size, dtype="float32",
        remat=False, tie_embeddings=False)


def deep_receiver_config() -> ModelConfig:
    """The heterogeneous counterpart of ``pair_config``: a deeper receiver
    (12 layers against 8) with the same KV geometry and tokenizer."""
    return dataclasses.replace(pair_config(), num_layers=12)


def full_width_config() -> ModelConfig:
    """``llama3.2-3b-pair`` as published: 28 layers, d_model 3072, 24/8
    heads of 128, d_ff 8192, vocab 128256, bf16, tied embeddings."""
    return get_config("llama3.2-3b-pair")


def random_pair(cfg: ModelConfig, seed: int = 0, *, device
                ) -> Tuple[Any, Any]:
    """(sender, receiver) parameters: ONE random parameter set from
    ``seed`` serves both roles, as the reference does when only a shared
    base checkpoint exists."""
    params = tfm.init_params(cfg, seed, device=device)
    return params, params
