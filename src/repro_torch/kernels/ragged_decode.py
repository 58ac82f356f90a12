"""Ragged one-token decode over the two-segment slot-table layout.

Replaces the Pallas kernel ``src/repro/kernels/ragged_decode.py``
(``_ragged_decode_kernel``), which the reference serving loop launches once
per layer per ragged step. A slot-table row is

    [ shared prefix bucket (prefix_len) | self tokens | pad ]

and position j of row b is attended when
``j < prefix_len ? j < prefix_lens[b] : j < kv_len[b]``. RoPE is applied by
the caller. Rows that attend nothing (dead slots) give exact zeros.

On Hopper the step is bound by the bytes of K and V it reads (a few flops
per byte), so the CUDA kernel (``csrc/ragged_decode.cu``) reads each
attended K/V row once for all G query heads of its KV-head group, straight
from the cache's own (B, Skv, Hkv, D) layout through strides, and skips
masked positions before loading them. See the source for the design.

``ragged_decode`` takes its plain PyTorch version only for tensors on the
CPU; for CUDA tensors it launches the kernel or raises.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from repro_torch.kernels import _build

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_ARGTYPES = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 6
             + [ctypes.c_longlong] * 10 + [ctypes.c_float, ctypes.c_int,
                                           ctypes.c_void_p])


def per_row(x, B: int, device) -> torch.Tensor:
    """A (B,) int32 tensor from an int or a scalar/(B,) tensor, built on
    ``device`` without a host-to-device copy."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=torch.int32).expand(B)
    return torch.full((B,), int(x), dtype=torch.int32, device=device)


def ragged_decode_reference(q, k, v, kv_len, prefix_lens=None, *,
                            prefix_len: int = 0) -> torch.Tensor:
    """Plain PyTorch version (a port of ``ref.ragged_decode_reference``).

    q: (B, Hq, D); k/v: (B, Skv, Hkv, D); kv_len, prefix_lens: (B,) int.
    Returns (B, Hq, D) in q's dtype."""
    B, S, Hkv, Dh = k.shape
    Hq = q.shape[1]
    G = Hq // Hkv
    qg = q.reshape(B, Hkv, G, Dh)
    s = torch.einsum("bhgd,bkhd->bhgk", qg, k).float() / math.sqrt(Dh)
    kv_len = per_row(kv_len, B, q.device)
    pfx = per_row(prefix_len if prefix_lens is None else prefix_lens, B,
                  q.device)
    idx = torch.arange(S, device=q.device)[None, :]
    allow = torch.where(idx < prefix_len, idx < pfx[:, None],
                        idx < kv_len[:, None])[:, None, None, :]
    s = torch.where(allow, s, torch.full_like(s, -1e30))
    m = s.amax(dim=-1, keepdim=True)
    e = torch.where(allow, torch.exp(s - m), torch.zeros_like(s))
    l = e.sum(dim=-1, keepdim=True)
    p = torch.where(l > 0, e / l.clamp_min(1e-30), torch.zeros_like(e))
    out = torch.einsum("bhgk,bkhd->bhgd", p.to(v.dtype), v)
    return out.reshape(B, Hq, Dh)


def _launch(q, k, v, kv_len, pfx, prefix_len: int) -> torch.Tensor:
    B, Hq, D = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    if q.dtype not in _DTYPE_CODE or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"ragged_decode takes one of {list(_DTYPE_CODE)} for "
                        f"q, k and v; got {q.dtype}, {k.dtype}, {v.dtype}")
    if Hq % Hkv or not 1 <= Hq // Hkv <= 8 or not 1 <= D <= 256:
        raise ValueError(f"unsupported geometry Hq={Hq} Hkv={Hkv} D={D} "
                         "(needs G = Hq/Hkv in 1..8 and D <= 256)")
    if k.shape != v.shape or k.shape[0] != B or k.shape[3] != D:
        raise ValueError(f"shape mismatch q{tuple(q.shape)} "
                         f"k{tuple(k.shape)} v{tuple(v.shape)}")
    if not 0 <= prefix_len <= Skv:
        raise ValueError(f"prefix_len {prefix_len} outside [0, {Skv}]")
    if q.stride(-1) != 1 or k.stride(-1) != 1 or v.stride(-1) != 1:
        raise ValueError("ragged_decode needs a contiguous head dim")
    for t in (k, v, kv_len, pfx):
        if t.device != q.device:
            raise ValueError("all ragged_decode inputs must share a device")
    kv_len = kv_len.to(torch.int32).contiguous()
    pfx = pfx.to(torch.int32).contiguous()
    out = torch.empty((B, Hq, D), dtype=q.dtype, device=q.device)
    if B == 0:
        return out
    lib = _build.load("ragged_decode")
    fn = lib.ragged_decode_launch
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), kv_len.data_ptr(),
             pfx.data_ptr(), out.data_ptr(), B, Hkv, Hq // Hkv, D, Skv,
             prefix_len, q.stride(0), q.stride(1), k.stride(0), k.stride(1),
             k.stride(2), v.stride(0), v.stride(1), v.stride(2),
             out.stride(0), out.stride(1), 1.0 / math.sqrt(D),
             _DTYPE_CODE[q.dtype], torch.cuda.current_stream(q.device)
             .cuda_stream)
    if err != 0:
        raise RuntimeError(f"ragged_decode kernel launch failed: CUDA error "
                           f"{err}")
    ragged_decode.launches += 1
    return out


def ragged_decode(q, k, v, kv_len, prefix_lens=None, *,
                  prefix_len: int = 0) -> torch.Tensor:
    """Fused one-token ragged decode over a two-segment cache row.

    q: (B, Hq, D); k/v: (B, Skv, Hkv, D) laid out
    ``[prefix bucket (prefix_len) | self | pad]``; ``kv_len`` (B,) counts
    all valid entries (bucket + self); ``prefix_lens`` (B,) the real
    entries in the bucket (None = the whole bucket). Returns (B, Hq, D)
    in q's dtype. ``ragged_decode.launches`` counts kernel launches."""
    B = q.shape[0]
    if q.device.type == "cpu":
        return ragged_decode_reference(q, k, v, kv_len, prefix_lens,
                                       prefix_len=prefix_len)
    if q.device.type != "cuda":
        raise ValueError(f"ragged_decode runs on cuda or cpu, not {q.device}")
    pfx = prefix_len if prefix_lens is None else prefix_lens
    return _launch(q, k, v, per_row(kv_len, B, q.device),
                   per_row(pfx, B, q.device), prefix_len)


ragged_decode.launches = 0
