"""The kernels' public entry point, named as the reference's
``repro.kernels.ops``: (B, S, H, D) and (B, Hq, D) layouts at every
function, same return shapes.

The reference's TPU-only arguments (``interpret``, the block sizes
``blk_q``/``blk_k``/``blk_t`` and the 128-lane head-dim padding) have no
counterpart: each kernel reads the caller's layout through strides and
masks its own ragged edges, so the wrappers here are the kernel modules'
own. Each runs its CUDA kernel on CUDA tensors and its plain PyTorch
version on CPU tensors.
"""
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.flash_decode import combine_decode_partials
from repro_torch.kernels.flash_decode import flash_decode as decode_attention
from repro_torch.kernels.flash_decode import (
    flash_decode_partials as decode_attention_partials)
# the serving hot loop's two-segment packed-prefix decode
from repro_torch.kernels.ragged_decode import ragged_decode
from repro_torch.kernels.rwkv_scan import wkv6 as wkv6_scan

__all__ = ["flash_attention", "decode_attention",
           "decode_attention_partials", "combine_decode_partials",
           "wkv6_scan", "ragged_decode"]
