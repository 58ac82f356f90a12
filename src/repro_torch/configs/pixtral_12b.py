"""Pixtral-12B — VLM: pixtral-ViT (stub) + mistral-nemo-style decoder.

[hf:mistralai/Pixtral-12B-2409]. The vision encoder + projector is a STUB per
the assignment: ``input_specs`` supplies precomputed patch embeddings of shape
(batch, num_patches, d_model) that are prepended to the token embeddings.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="pixtral-12b",
    arch_type="vlm",
    source="hf:mistralai/Pixtral-12B-2409",
    num_layers=40,
    d_model=5120,
    num_heads=32,
    num_kv_heads=8,
    head_dim=160,
    d_ff=14336,
    vocab_size=131072,
    num_patches=256,
    rope_theta=1_000_000.0,
    tie_embeddings=False,
)
