"""Whisper-medium — encoder-decoder, conv frontend stubbed to frame embeddings.

[arXiv:2212.04356]. The mel-spectrogram and conv feature extractor are a
stub: callers pass precomputed frame embeddings of shape (batch,
encoder_seq, d_model) as ``extra["frames"]``; the transformer backbone is
the model.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-medium",
    arch_type="audio",
    source="arXiv:2212.04356",
    num_layers=24,             # decoder layers
    encoder_layers=24,
    encoder_seq=1500,
    d_model=1024,
    num_heads=16,
    num_kv_heads=16,
    head_dim=64,
    d_ff=4096,
    vocab_size=51865,
    tie_embeddings=True,
)
