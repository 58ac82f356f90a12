"""Gemma3-4B — dense, 5:1 local:global attention, 128k context.

[hf:google/gemma-3-1b-pt family]
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="gemma3-4b",
    arch_type="dense",
    source="hf:google/gemma-3-1b-pt",
    num_layers=34,
    d_model=2560,
    num_heads=8,
    num_kv_heads=4,
    head_dim=256,
    d_ff=10240,
    vocab_size=262144,
    local_global_ratio=5,
    local_window=1024,
    rope_theta=1_000_000.0,
    tie_embeddings=True,
)
