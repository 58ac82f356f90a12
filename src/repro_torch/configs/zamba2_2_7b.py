"""Zamba2-2.7B — hybrid: Mamba2 backbone + shared attention blocks.

[arXiv:2411.15242]. 54 Mamba2 layers; a single shared-parameter attention
block is invoked after every 6th Mamba layer (9 invocations, each with its own
KV cache). ssm_state=64.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-2.7b",
    arch_type="hybrid",
    source="arXiv:2411.15242",
    num_layers=54,
    d_model=2560,
    num_heads=32,
    num_kv_heads=32,
    head_dim=80,
    d_ff=10240,
    vocab_size=32000,
    ssm_state=64,
    ssm_head_dim=64,
    hybrid_attn_every=6,
    tie_embeddings=True,
)
