"""RWKV6 "Finch" 1.6B — attention-free, data-dependent decay.

[arXiv:2404.05892]. KVComm's KV protocol is inapplicable (no KV cache); the
framework runs this arch without it and offers the state-sharing analogue
(DESIGN.md §Arch-applicability).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="rwkv6-1.6b",
    arch_type="ssm",
    source="arXiv:2404.05892",
    num_layers=24,
    d_model=2048,
    num_heads=0,
    num_kv_heads=0,
    d_ff=7168,
    vocab_size=65536,
    ssm_head_dim=64,          # wkv head size -> 32 heads
    tie_embeddings=False,
)
