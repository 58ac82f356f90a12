"""One-token decode over a single-segment KV cache, normalised or as
partials for the sequence-sharded log-sum-exp combine.

Replaces the Pallas kernel ``src/repro/kernels/flash_decode.py``
(``_decode_kernel``) in both of its forms. Row b attends position j when
``j < kv_len[b]`` (and ``j < S``) and, with a ``window``,
``(kv_len[b] - 1) - j < window``. ``flash_decode`` returns the normalised
output, with exact zeros for rows that attend nothing (``kv_len == 0``), as
the Pallas kernel does; ``flash_decode_partials`` returns the unnormalised
``(o, m, l)`` that ``combine_decode_partials`` merges across shards, so a
sequence-sharded cache is never gathered.

A decode is bound by the bytes of K and V it reads, so the CUDA kernel
(``csrc/flash_decode.cu``) reads each attended K/V row once for all G query
heads of its KV-head group, straight from the cache's (B, S, Hkv, D)
layout through a TMA-fed ring (a group of more than 16 query heads, 8 in
float32, is split into head groups, one block each, which read the row
once per group), and cuts each row's attended range into
fixed chunks of ``chunk_positions(D, dtype)`` positions, one block each,
whose float32 partials a second kernel merges with the log-sum-exp rule.
The grid is sized from S alone, so a launch never reads the lengths back
to the host. ``decode_split_reference`` is that decomposition in plain
PyTorch, for the tests. See the source for the design.

Both wrappers take their plain PyTorch version only for tensors on the CPU;
for CUDA tensors they launch the kernel or raise. ``supports`` is the
kernel's geometry rule. ``flash_decode.launches`` counts the kernel's
launches from either wrapper.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ragged_decode import lse_merge, per_row

NEG_INF = -1e30
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_ARGTYPES = ([ctypes.c_void_p] * 11 + [ctypes.c_int] * 7
             + [ctypes.c_longlong] * 8 + [ctypes.c_float, ctypes.c_int,
                                          ctypes.c_int, ctypes.c_void_p])
_CHUNKS = {}
MAX_D = 256


def supports(G: int, D: int, dtype) -> bool:
    """Does the CUDA kernel take ``G = Hq / Hkv`` query heads per KV head,
    head dim ``D`` and ``dtype``? Any G >= 1 (groups wider than 16, or 8
    in float32, are split over blocks), D up to 256, float32 / bfloat16 /
    float16."""
    return dtype in _DTYPE_CODE and G >= 1 and 1 <= D <= MAX_D


def decode_mask(S: int, kv_len: torch.Tensor, window: Optional[int] = None
                ) -> torch.Tensor:
    """(B, S) bool mask of the attended positions, for (B,) ``kv_len``."""
    idx = torch.arange(S, device=kv_len.device)[None, :]
    allow = idx < kv_len[:, None]
    if window is not None:
        allow = allow & ((kv_len[:, None] - 1 - idx) < window)
    return allow


def decode_partial_reference(q, k, v, kv_len, *, window=None):
    """Plain PyTorch version of the partials (a port of
    ``ref.decode_partial_reference``): float32 ``o`` (B, Hq, D), the
    unnormalised sum of exp(s - m) v, and ``m``, ``l`` (B, Hq). A row that
    attends nothing has o = 0, m = -1e30, l = 0."""
    B, S, Hkv, D = k.shape
    Hq = q.shape[1]
    G = Hq // Hkv
    qg = q.float().reshape(B, Hkv, G, D)
    s = torch.einsum("bhgd,bkhd->bhgk", qg, k.float()) / math.sqrt(D)
    allow = decode_mask(S, per_row(kv_len, B, q.device),
                        window)[:, None, None]
    s = s.masked_fill(~allow, NEG_INF)
    m = s.amax(dim=-1)
    e = torch.exp(s - m[..., None]).masked_fill_(~allow, 0.0)
    l = e.sum(dim=-1)
    o = torch.einsum("bhgk,bkhd->bhgd", e, v.float())
    return o.reshape(B, Hq, D), m.reshape(B, Hq), l.reshape(B, Hq)


def flash_decode_reference(q, k, v, kv_len, *, window=None):
    """Plain PyTorch version of the normalised decode: (B, Hq, D) in q's
    dtype, exact zeros for rows that attend nothing (the Pallas kernel's
    behaviour; ``ref.decode_reference`` would average uniformly there)."""
    o, _, l = decode_partial_reference(q, k, v, kv_len, window=window)
    l = l[..., None]
    out = torch.where(l > 0, o / l.clamp_min(1e-30), torch.zeros_like(o))
    return out.to(q.dtype)


def combine_decode_partials(os, ms, ls):
    """Log-sum-exp combine of per-shard partials stacked on axis 0 (a port
    of ``ref.combine_decode_partials``; plain PyTorch, as the reference
    computes it outside Pallas). Returns float32 (B, Hq, D)."""
    m_star = ms.amax(dim=0)
    scale = torch.exp(ms - m_star[None])
    o = (os * scale[..., None]).sum(dim=0)
    l = (ls * scale).sum(dim=0)
    return o / l.clamp_min(1e-30)[..., None]


def attended_range(kv_len, S: int, window: Optional[int] = None):
    """(B,) bounds [lo, hi) of each row's attended positions:
    ``hi = min(kv_len, S)``, ``lo = max(0, kv_len - window)`` with a
    window, else 0 (empty where hi <= lo)."""
    hi = kv_len.clamp(max=S)
    lo = (kv_len - window).clamp_min(0) if window is not None \
        else torch.zeros_like(kv_len)
    return lo, hi


def num_splits(S: int, window: Optional[int], chunk: int) -> int:
    """Split blocks per (row, KV head): ceil(S_eff / chunk), S_eff the most
    positions a row can attend (S, or min(S, window)); at least one."""
    longest = S if window is None else max(0, min(S, window))
    return max(1, -(-longest // chunk))


def decode_split_reference(q, k, v, kv_len, *, window=None, chunk: int = 256,
                           partials: bool = False):
    """The CUDA kernel's decomposition in plain PyTorch (float32), for the
    tests: each row's attended range [lo, hi) is cut into ``num_splits``
    chunks of ``chunk`` positions starting at lo; each chunk gives a partial
    (o, m, l) and the chunks merge with the log-sum-exp rule. Returns the
    normalised output (exact zeros for an empty row) or, with ``partials``,
    the merged float32 (o, m, l) (m = -1e30, l = 0 for an empty row)."""
    B, S, Hkv, D = k.shape
    Hq = q.shape[1]
    G = Hq // Hkv
    lo, hi = attended_range(per_row(kv_len, B, q.device).long(), S, window)
    nsplit = num_splits(S, window, chunk)
    pos = lo[:, None] + torch.arange(nsplit * chunk, device=q.device)[None]
    live = pos < hi[:, None]                                    # (B, T)
    pos = torch.where(live, pos, torch.zeros_like(pos))
    rows = torch.arange(B, device=q.device)[:, None]
    kt, vt = k.float()[rows, pos], v.float()[rows, pos]         # (B,T,Hkv,D)
    qg = q.float().reshape(B, Hkv, G, D) / math.sqrt(D)
    s = torch.einsum("bhgd,bthd->bhgt", qg, kt)
    s = s.masked_fill(~live[:, None, None], NEG_INF)
    s = s.reshape(B, Hkv, G, nsplit, chunk)
    alive = live.reshape(B, 1, 1, nsplit, chunk)
    m = s.amax(-1)
    e = torch.where(alive, torch.exp(s - m[..., None]), torch.zeros_like(s))
    o = torch.einsum("bhgsc,bschd->bhgsd", e,
                     vt.reshape(B, nsplit, chunk, Hkv, D))
    o, m, l = lse_merge(o, m, e.sum(-1), dim=3)
    if partials:
        return o.reshape(B, Hq, D), m.reshape(B, Hq), l.reshape(B, Hq)
    out = torch.where(l[..., None] > 0, o / l.clamp_min(1e-30)[..., None],
                      torch.zeros_like(o))
    return out.reshape(B, Hq, D)


def chunk_positions(D: int, dtype) -> int:
    """Positions one split block of the CUDA kernel covers (the grid and
    the scratch are sized with it); asked of the library once per
    geometry."""
    key = (D, dtype)
    if key not in _CHUNKS:
        fn = _build.load("flash_decode").flash_decode_chunk
        fn.argtypes = [ctypes.c_int] * 2
        fn.restype = ctypes.c_int
        _CHUNKS[key] = fn(D, _DTYPE_CODE[dtype])
    return _CHUNKS[key]


def uses_tma(k, v) -> bool:
    """Whether the kernel reads these CUDA K and V views by TMA (bases,
    strides and rows multiples of 16 bytes); other views are staged by
    plain loads in the same kernel."""
    fn = _build.load("flash_decode").flash_decode_tma_route
    fn.argtypes = ([ctypes.c_void_p] * 2 + [ctypes.c_int] * 4
                   + [ctypes.c_longlong] * 6 + [ctypes.c_int])
    fn.restype = ctypes.c_int
    B, S, Hkv, D = k.shape
    return bool(fn(k.data_ptr(), v.data_ptr(), B, Hkv, D, S,
                   *k.stride()[:3], *v.stride()[:3], _DTYPE_CODE[k.dtype]))


def _launch(q, k, v, kv_len, window, normalize: bool):
    B, Hq, D = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    if q.dtype not in _DTYPE_CODE or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_decode takes one of {list(_DTYPE_CODE)} for "
                        f"q, k and v; got {q.dtype}, {k.dtype}, {v.dtype}")
    if Hkv < 1 or Hq % Hkv or not supports(Hq // Hkv, D, q.dtype):
        raise ValueError(f"unsupported geometry Hq={Hq} Hkv={Hkv} D={D} "
                         f"{q.dtype} (needs Hq a multiple of Hkv and "
                         f"D <= {MAX_D})")
    if k.shape != v.shape or k.shape[0] != B or k.shape[3] != D:
        raise ValueError(f"shape mismatch q{tuple(q.shape)} "
                         f"k{tuple(k.shape)} v{tuple(v.shape)}")
    if q.stride(-1) != 1 or k.stride(-1) != 1 or v.stride(-1) != 1:
        raise ValueError("flash_decode needs a contiguous head dim")
    for x in (k, v, kv_len):
        if x.device != q.device:
            raise ValueError("all flash_decode inputs must share a device")
    if window is not None and window < 0:
        raise ValueError(f"window must be >= 0, got {window}")
    kv_len = kv_len.to(torch.int32).contiguous()
    f32 = dict(dtype=torch.float32, device=q.device)
    if normalize:
        res = (torch.empty((B, Hq, D), dtype=q.dtype, device=q.device),)
    else:
        res = (torch.empty((B, Hq, D), **f32), torch.empty((B, Hq), **f32),
               torch.empty((B, Hq), **f32))
    if B == 0:
        return res[0] if normalize else res
    G = Hq // Hkv
    nsplit = num_splits(S, window, chunk_positions(D, q.dtype))
    po = torch.empty((B, Hkv, nsplit, G, D), **f32)
    pm = torch.empty((B, Hkv, nsplit, G), **f32)
    pl = torch.empty((B, Hkv, nsplit, G), **f32)
    lib = _build.load("flash_decode")
    fn = lib.flash_decode_launch
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    outs = ((res[0].data_ptr(), None, None, None) if normalize
            else (None, *(x.data_ptr() for x in res)))
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), kv_len.data_ptr(),
             po.data_ptr(), pm.data_ptr(), pl.data_ptr(), *outs,
             B, Hkv, G, D, S, -1 if window is None else int(window), nsplit,
             q.stride(0), q.stride(1), k.stride(0), k.stride(1), k.stride(2),
             v.stride(0), v.stride(1), v.stride(2), 1.0 / math.sqrt(D),
             _DTYPE_CODE[q.dtype], int(normalize),
             torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_decode kernel launch failed: CUDA error "
                           f"{err}")
    flash_decode.launches += 1
    return res[0] if normalize else res


def _check_device(q):
    if q.device.type != "cuda":
        raise ValueError(f"flash_decode runs on cuda or cpu, not {q.device}")


def flash_decode(q, k, v, kv_len, *, window: Optional[int] = None
                 ) -> torch.Tensor:
    """One-token decode. q: (B, Hq, D); k/v: (B, S, Hkv, D); kv_len: an int
    or a scalar or (B,) tensor. Returns (B, Hq, D) in q's dtype, zeros for
    rows that attend nothing."""
    if q.device.type == "cpu":
        return flash_decode_reference(q, k, v, kv_len, window=window)
    _check_device(q)
    return _launch(q, k, v, per_row(kv_len, q.shape[0], q.device), window,
                   normalize=True)


def flash_decode_partials(q, k, v, kv_len, *, window: Optional[int] = None
                          ) -> Tuple[torch.Tensor, torch.Tensor,
                                     torch.Tensor]:
    """Shard-local partials: float32 o (B, Hq, D) unnormalised, m and l
    (B, Hq); see ``combine_decode_partials``."""
    if q.device.type == "cpu":
        return decode_partial_reference(q, k, v, kv_len, window=window)
    _check_device(q)
    return _launch(q, k, v, per_row(kv_len, q.shape[0], q.device), window,
                   normalize=False)


flash_decode.launches = 0
