"""Mellum2-12B-A2.5B — 64-expert top-8 MoE in every layer, 3:1
sliding-window (1,024, RoPE at 5e5) and full attention (YaRN, factor 16
over 8,192 original positions).

[hf:JetBrains/Mellum2-12B-A2.5B-Instruct, config.json]
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="mellum2-12b",
    arch_type="moe",
    source="hf:JetBrains/Mellum2-12B-A2.5B-Instruct",
    num_layers=28,
    d_model=2304,
    num_heads=32,
    num_kv_heads=4,
    head_dim=128,
    d_ff=896,
    vocab_size=98304,
    rope_theta=500_000.0,
    local_global_ratio=3,
    local_window=1024,
    yarn=(16.0, 8192, 32.0, 1.0, 1.2772588722239782),
    num_experts=64,
    num_experts_per_tok=8,
    norm_eps=1e-6,
    tie_embeddings=False,
    ring_cache=False,
)
