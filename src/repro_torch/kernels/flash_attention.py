"""Prefill attention over ``[context | self]`` with the fused Eq. (1)
context mass.

Replaces the Pallas kernel ``src/repro/kernels/flash_attention.py``
(``_flash_kernel``). KV rows ``[0, context_len)`` are the sender prefix at
absolute positions ``[0, context_len)``; self rows sit at ``q_offset + j``
and query row i at ``q_offset + i``. Masks: causal on those positions,
optional sliding ``window``, GQA. With ``collect_mass`` the second result
is the attention mass on the context prefix, averaged over heads and query
rows (the paper's Eq. (1)), shape (B,).

The function is the oracle's (``ref.mha_reference``): no padding takes
part, whatever the causal flag. (The Pallas kernel pads Sq and Skv to its
block sizes and masks only with the padded lengths, so with
``causal=False`` and unaligned lengths its zero keys leak into the
softmax.) Rows that attend nothing give zeros.

A long prefill is bound by operations, a short query over a long context
by bytes. The CUDA source (``csrc/flash_attention.cu``) has two kernels,
picked by dtype and counted as one launch: for bf16/fp16, tensor cores
(``wgmma``) fed by TMA with the GQA rows of a KV head packed into one tile
and, when the grid would be small, the KV range split over blocks and
merged with the log-sum-exp rule (``flash_attention_split_reference`` is
that decomposition in plain PyTorch, for the tests); for float32, the
CUDA-core kernel. Both skip tiles outside the causal or window band. See
the source for the design.

``flash_attention`` takes its plain PyTorch version only for tensors on the
CPU; for CUDA tensors it launches the kernel or raises. ``supports`` is the
kernel's geometry rule.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch

from repro_torch.kernels import _build

NEG_INF = -1e30
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_ARGTYPES = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 12
             + [ctypes.c_longlong] * 12 + [ctypes.c_float, ctypes.c_int,
                                           ctypes.c_void_p])
BLOCK_M = 64            # packed (query row, head) rows per block
_SMS = {}
MAX_D = 256


def supports(G: int, D: int, dtype) -> bool:
    """Does the CUDA kernel take ``G = Hq / Hkv`` query heads per KV head,
    head dim ``D`` and ``dtype``? Any G >= 1, D up to 256, float32 /
    bfloat16 / float16; bfloat16 and float16 run on the tensor cores, whose
    k-steps need D a multiple of 16."""
    return (dtype in _DTYPE_CODE and G >= 1 and 1 <= D <= MAX_D
            and (dtype == torch.float32 or D % 16 == 0))


def kv_tile(D: int) -> int:
    """KV positions per tile of the bf16/fp16 kernel (64; 32 when the head
    dim pads past 192, for the output accumulator's registers)."""
    return 32 if -(-D // 64) * 64 > 192 else 64


def split_plan(B: int, Sq: int, Skv: int, Hkv: int, G: int, D: int,
               sms: int) -> Tuple[int, int]:
    """(nsplit, KV tiles per split) of the bf16/fp16 kernel: a grid of
    fewer blocks than SMs splits each query tile's KV tiles over about
    2 * sms / blocks blocks, at least two tiles each."""
    nkt = -(-Skv // kv_tile(D))
    blocks = -(-Sq * G // BLOCK_M) * Hkv * B
    nsplit = 1
    if blocks < sms and nkt >= 4:
        nsplit = min(-(-2 * sms // blocks), nkt // 2)
    per = -(-nkt // nsplit)
    return -(-nkt // per), per


def attention_mask(Sq: int, Skv: int, *, context_len: int = 0,
                   q_offset: int = 0, causal: bool = True,
                   window: Optional[int] = None, device=None) -> torch.Tensor:
    """(Sq, Skv) bool mask of the attended (query row, KV row) pairs."""
    q_pos = q_offset + torch.arange(Sq, device=device)[:, None]
    idx = torch.arange(Skv, device=device)[None, :]
    kv_pos = torch.where(idx < context_len, idx,
                         q_offset + (idx - context_len))
    allow = torch.ones((Sq, Skv), dtype=torch.bool, device=device)
    if causal:
        allow &= kv_pos <= q_pos
    if window is not None:
        allow &= (q_pos - kv_pos) < window
    return allow


def flash_attention_reference(q, k, v, *, context_len: int = 0,
                              q_offset: int = 0, causal: bool = True,
                              window: Optional[int] = None,
                              collect_mass: bool = False):
    """Plain PyTorch version (a port of ``ref.mha_reference``), computed in
    float32 and returned in q's dtype; rows that attend nothing give zeros.
    q: (B, Sq, Hq, D); k/v: (B, Skv, Hkv, D). Returns (out, mass|None)."""
    B, Sq, Hq, D = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    allow = attention_mask(Sq, Skv, context_len=context_len,
                           q_offset=q_offset, causal=causal, window=window,
                           device=q.device)
    qg = q.float().reshape(B, Sq, Hkv, G, D)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg, k.float()).mul_(
        1.0 / math.sqrt(D))
    s.masked_fill_(~allow, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = s.sub_(m).exp_().masked_fill_(~allow, 0.0)       # in place: s is big
    l = p.sum(dim=-1, keepdim=True)
    p.div_(l.clamp_min(1e-30))
    out = torch.einsum("bhgqk,bkhd->bqhgd", p, v.float())
    out = out.reshape(B, Sq, Hq, D).to(q.dtype)
    mass = None
    if collect_mass:
        ctx = (torch.arange(Skv, device=q.device) < context_len).float()
        mass = (p @ ctx).mean(dim=(1, 2, 3))
    return out, mass


def flash_attention_split_reference(q, k, v, *, context_len: int = 0,
                                    q_offset: int = 0, causal: bool = True,
                                    window: Optional[int] = None,
                                    collect_mass: bool = False,
                                    nsplit: int = 1, kt_per_split=None):
    """The bf16/fp16 CUDA kernel's decomposition in plain PyTorch (float32),
    for the tests: GQA rows packed per KV head (row r = query row r // G,
    head r % G), the KV range cut into ``nsplit`` splits of
    ``kt_per_split`` tiles (``kv_tile(D)`` positions each), a float32
    partial (o, m, l, context mass) per split, merged with the log-sum-exp
    rule. Returns (out in q's dtype, mass (B,) or None) like
    ``flash_attention_reference``."""
    from repro_torch.kernels.ragged_decode import lse_merge
    B, Sq, Hq, D = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    nkt = max(1, -(-Skv // kv_tile(D)))
    per = kt_per_split or -(-nkt // nsplit)
    span = per * kv_tile(D)
    allow = attention_mask(Sq, Skv, context_len=context_len,
                           q_offset=q_offset, causal=causal, window=window,
                           device=q.device)
    # packed rows (B, Hkv, Sq * G, D): r = i * G + g
    qp = q.float().reshape(B, Sq, Hkv, G, D).permute(0, 2, 1, 3, 4)
    qp = qp.reshape(B, Hkv, Sq * G, D) / math.sqrt(D)
    allow_p = allow.repeat_interleave(G, dim=0)              # (Sq * G, Skv)
    ctx = torch.arange(Skv, device=q.device) < context_len
    parts = []
    for c0 in range(0, nsplit * span, span):
        c1 = min(c0 + span, Skv)
        if c0 >= c1:
            continue
        kk, vv = (x.float()[:, c0:c1].permute(0, 2, 1, 3) for x in (k, v))
        s = torch.einsum("bhrd,bhcd->bhrc", qp, kk)
        live = allow_p[:, c0:c1]
        s = s.masked_fill(~live, NEG_INF)
        m = s.amax(-1)
        p = torch.exp(s - m[..., None]).masked_fill(~live, 0.0)
        parts.append((torch.einsum("bhrc,bhcd->bhrd", p, vv), m,
                      p.sum(-1), (p * ctx[c0:c1]).sum(-1)))
    o, m, l, ms = (torch.stack(x, dim=2) for x in zip(*parts))
    # the mass rides along with o as one more trailing column
    om, _, l = lse_merge(torch.cat([o, ms[..., None]], -1), m, l, dim=2)
    inv = torch.where(l > 0, 1.0 / l.clamp_min(1e-30), torch.zeros_like(l))
    out = (om[..., :D] * inv[..., None]).reshape(B, Hkv, Sq, G, D)
    out = out.permute(0, 2, 1, 3, 4).reshape(B, Sq, Hq, D).to(q.dtype)
    mass = (om[..., D] * inv).mean(dim=(1, 2)) if collect_mass else None
    return out, mass


def _sm_count(device) -> int:
    idx = device.index if device.index is not None else \
        torch.cuda.current_device()
    if idx not in _SMS:
        _SMS[idx] = torch.cuda.get_device_properties(idx).multi_processor_count
    return _SMS[idx]


def _check_tma(q, k, v):
    """bf16/fp16 inputs are read by TMA (k, v) and 16-byte loads (q): every
    base and stride must be a multiple of 16 bytes."""
    for name, x in (("q", q), ("k", k), ("v", v)):
        es = x.element_size()
        if x.data_ptr() % 16 or any((st * es) % 16 for st, n in
                                    zip(x.stride()[:3], x.shape[:3])
                                    if n > 1):
            raise ValueError(
                f"flash_attention in {q.dtype} reads {name} with TMA and "
                f"16-byte loads: its base address and its strides "
                f"{tuple(x.stride())} must be multiples of 16 bytes")


def _launch(q, k, v, context_len, q_offset, causal, window, collect_mass):
    B, Sq, Hq, D = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    if q.dtype not in _DTYPE_CODE or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention takes one of {list(_DTYPE_CODE)} "
                        f"for q, k and v; got {q.dtype}, {k.dtype}, "
                        f"{v.dtype}")
    if Hkv < 1 or Hq % Hkv or not supports(Hq // Hkv, D, q.dtype):
        raise ValueError(f"unsupported geometry Hq={Hq} Hkv={Hkv} D={D} "
                         f"{q.dtype} (needs Hq a multiple of Hkv, D <= "
                         f"{MAX_D}, and at bfloat16 / float16 D a multiple "
                         "of 16 for the tensor-core kernel)")
    if k.shape != v.shape or k.shape[0] != B or k.shape[3] != D:
        raise ValueError(f"shape mismatch q{tuple(q.shape)} "
                         f"k{tuple(k.shape)} v{tuple(v.shape)}")
    if q.stride(-1) != 1 or k.stride(-1) != 1 or v.stride(-1) != 1:
        raise ValueError("flash_attention needs a contiguous head dim")
    if k.device != q.device or v.device != q.device:
        raise ValueError("all flash_attention inputs must share a device")
    if window is not None and window < 0:
        raise ValueError(f"window must be >= 0, got {window}")
    tc = q.dtype != torch.float32
    if tc and B and Sq:
        _check_tma(q, k, v)
    out = torch.empty((B, Sq, Hq, D), dtype=q.dtype, device=q.device)
    rows = (torch.empty((B, Hq, Sq), dtype=torch.float32, device=q.device)
            if collect_mass else None)
    if tc and B and Sq and not Skv:      # nothing to attend: zeros, no launch
        out.zero_()
        if rows is not None:
            rows.zero_()
    elif B and Sq:
        G = Hq // Hkv
        nsplit, per = (split_plan(B, Sq, Skv, Hkv, G, D, _sm_count(q.device))
                       if tc and Skv else (1, 0))
        # split partials: o (B, Hkv, nsplit, Sq*G, DP), then m, l and mass
        scratch = (torch.empty(B * Hkv * nsplit * Sq * G
                               * (-(-D // 64) * 64 + 3),
                               dtype=torch.float32, device=q.device)
                   if nsplit > 1 else None)
        lib = _build.load("flash_attention")
        fn = lib.flash_attention_launch
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 None if rows is None else rows.data_ptr(),
                 None if scratch is None else scratch.data_ptr(), B, Sq, Skv,
                 Hq, Hkv, D, int(context_len), int(q_offset),
                 int(bool(causal)), -1 if window is None else int(window),
                 nsplit, per, *q.stride()[:3], *k.stride()[:3],
                 *v.stride()[:3], *out.stride()[:3], 1.0 / math.sqrt(D),
                 _DTYPE_CODE[q.dtype],
                 torch.cuda.current_stream(q.device).cuda_stream)
        if err != 0:
            raise RuntimeError(f"flash_attention kernel launch failed: CUDA "
                               f"error {err}")
        flash_attention.launches += 1
    # the per-row masses reduce to Eq. (1) outside the kernel, as the
    # reference's wrapper does
    mass = rows.mean(dim=(1, 2)) if collect_mass else None
    return out, mass


def flash_attention(q, k, v, *, context_len: int = 0, q_offset: int = 0,
                    causal: bool = True, window: Optional[int] = None,
                    collect_mass: bool = False
                    ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """(B, S, H, D)-layout attention with KVComm prefix semantics.

    q: (B, Sq, Hq, D); k/v: (B, Skv, Hkv, D). Returns (out in q's dtype,
    mass (B,) float32 or None). ``flash_attention.launches`` counts kernel
    launches."""
    if q.device.type == "cpu":
        return flash_attention_reference(
            q, k, v, context_len=context_len, q_offset=q_offset,
            causal=causal, window=window, collect_mass=collect_mass)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cuda or cpu, not "
                         f"{q.device}")
    return _launch(q, k, v, context_len, q_offset, causal, window,
                   collect_mass)


flash_attention.launches = 0
