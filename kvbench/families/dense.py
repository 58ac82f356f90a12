"""The dense decoder of ``starcoder2-7b`` and ``internlm2-20b``: RMSNorm,
RoPE, grouped-query attention in every layer, a gelu or swiglu MLP, one
dtype for every leaf. The pieces are the harness's own modules."""
from kvbench.counts import k1_bytes, window_flops
from kvbench.reference import Reference
from kvbench.weights import leaves

__all__ = ["leaves", "Reference", "window_flops", "k1_bytes"]
