"""The paper's own evaluation family: Llama-3.2-3B-class pair (Table 5 #6).

M_s: huihui-ai/Llama-3.2-3B-Instruct-abliterated
M_r: suayptalha/DeepSeek-R1-Distill-Llama-3B
Both are fine-tunes of the same base, so layer indices match 1:1 (§3.1 fn 2).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llama3.2-3b-pair",
    arch_type="dense",
    source="paper Table 5 pair #6 (Llama-3.2-3B base)",
    num_layers=28,
    d_model=3072,
    num_heads=24,
    num_kv_heads=8,
    head_dim=128,
    d_ff=8192,
    vocab_size=128256,
    rope_theta=500_000.0,
    tie_embeddings=True,
)
