"""Ragged one-token decode over the two-segment slot-table layout.

Replaces the Pallas kernel ``src/repro/kernels/ragged_decode.py``
(``_ragged_decode_kernel``), which the reference serving loop launches once
per layer per ragged step. A slot-table row is

    [ shared prefix bucket (prefix_len) | self tokens | pad ]

and position j of row b is attended when
``j < prefix_len ? j < prefix_lens[b] : j < kv_len[b]``. RoPE is applied by
the caller. Rows that attend nothing (dead slots) give exact zeros.

On Hopper the step is bound by the bytes of K and V it reads (a few flops
per byte), so the CUDA kernel (``csrc/ragged_decode.cu``) visits only the
attended positions of each row, splits them over blocks of ``chunk``
positions (split-KV) and merges the float32 partials with the log-sum-exp
rule in a second kernel of the same launch. bf16 / fp16 run the tensor-core
split block K3 shares, with up to 16 query heads of a KV head in one tile
(so each K/V row is read once for G <= 16), fed by TMA into a
shared-memory ring straight from the cache's own (B, Skv, Hkv, D) layout
(the tensor maps cached per buffer); float32 runs on the CUDA cores with
``cp.async``. ``split_plan`` sizes the grid from
shapes alone (about one wave of the blocks an SM holds), so a launch never
reads the lengths back to the host. ``ragged_decode_split_reference`` is
that decomposition in plain PyTorch, for the tests. See the source for the
design.

``ragged_decode`` takes its plain PyTorch version only for tensors on the
CPU; for CUDA tensors it launches the kernel or raises. ``supports`` is
the kernel's geometry rule.
"""
from __future__ import annotations

import ctypes
import math
from typing import NamedTuple, Optional, Tuple

import torch

from repro_torch.kernels import _build

NEG_INF = -1e30
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_ARGTYPES = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 8
             + [ctypes.c_longlong] * 10 + [ctypes.c_float, ctypes.c_int,
                                           ctypes.c_void_p])
_GEOMETRY = {}
_PLANS = {}
_SMS = {}
_ENTRY = {}
MAX_D = 256
# grids of about PLAN_WAVES waves of the split blocks the card holds at once
PLAN_WAVES = 1


def supports(G: int, D: int, dtype) -> bool:
    """Does the CUDA kernel take ``G = Hq / Hkv`` query heads per KV head,
    head dim ``D`` and ``dtype``? Any G >= 1 (groups wider than 16, or 8
    in float32, are split over blocks), D up to 256, float32 / bfloat16 /
    float16."""
    return dtype in _DTYPE_CODE and G >= 1 and 1 <= D <= MAX_D


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


def attended_counts(kv_len, pfx, Skv: int, prefix_len: int):
    """(B,) attended positions of each row and its real bucket entries:
    ``n = min(pfx, prefix_len) + max(min(kv_len, Skv) - prefix_len, 0)``."""
    pc = pfx.clamp(0, prefix_len)
    return pc + (kv_len.clamp(max=Skv) - prefix_len).clamp_min(0), pc


def lse_merge(o, m, l, dim: int):
    """Merge float32 softmax partials along ``dim`` with the log-sum-exp
    rule (o unnormalised, m the running max, l the denominator; o has one
    more trailing axis than m and l). Partials with l == 0 add nothing;
    returns the merged (o, m, l)."""
    live = l > 0
    M = torch.where(live, m, torch.full_like(m, NEG_INF)).amax(dim)
    f = torch.where(live, torch.exp(m - M.unsqueeze(dim)),
                    torch.zeros_like(m))
    return ((o * f.unsqueeze(-1)).sum(dim), M, (l * f).sum(dim))


def ragged_decode_split_reference(q, k, v, kv_len, prefix_lens=None, *,
                                  prefix_len: int = 0, chunk: int = 128):
    """The CUDA kernel's decomposition in plain PyTorch (float32), for the
    tests: each row's attended positions are indexed ``t < n`` (the dead
    bucket gap and the tail skipped), cut into splits of ``chunk``; each
    split gives a partial (o, m, l) and the splits merge with the
    log-sum-exp rule. Rows that attend nothing give exact zeros."""
    B, S, Hkv, D = k.shape
    Hq = q.shape[1]
    G = Hq // Hkv
    kv_len = per_row(kv_len, B, q.device)
    pfx = per_row(prefix_len if prefix_lens is None else prefix_lens, B,
                  q.device)
    n, pc = attended_counts(kv_len, pfx, S, prefix_len)
    nsplit = max(1, -(-S // chunk))
    t = torch.arange(nsplit * chunk, device=q.device)
    pos = torch.where(t[None] < pc[:, None], t[None],
                      prefix_len + t[None] - pc[:, None])      # (B, T)
    live = t[None] < n[:, None]
    pos = torch.where(live, pos, torch.zeros_like(pos)).long()
    rows = torch.arange(B, device=q.device)[:, None]
    kt, vt = k.float()[rows, pos], v.float()[rows, pos]         # (B,T,Hkv,D)
    qg = q.float().reshape(B, Hkv, G, D) / math.sqrt(D)
    s = torch.einsum("bhgd,bthd->bhgt", qg, kt)
    s = s.masked_fill(~live[:, None, None], NEG_INF)
    s = s.reshape(B, Hkv, G, nsplit, chunk)
    alive = live.reshape(B, 1, 1, nsplit, chunk)
    m = s.amax(-1)
    e = torch.where(alive, torch.exp(s - m[..., None]), torch.zeros_like(s))
    l = e.sum(-1)
    o = torch.einsum("bhgsc,bschd->bhgsd", e,
                     vt.reshape(B, nsplit, chunk, Hkv, D))
    o, _, l = lse_merge(o, m, l, dim=3)
    out = torch.where(l[..., None] > 0, o / l.clamp_min(1e-30)[..., None],
                      torch.zeros_like(o))
    return out.reshape(B, Hq, D)


class Geometry(NamedTuple):
    """How the CUDA kernel runs a (G, D, dtype): on the tensor cores or the
    CUDA cores, the split blocks one SM holds, the attended positions of
    one tile (a split is a whole number of them), the CUDA cores' fixed
    split (0 on the tensor cores) and the most query heads a block takes."""
    tensor_cores: bool
    resident: int
    tile: int
    fixed_chunk: int
    head_cap: int


def geometry(G: int, D: int, dtype, device) -> Geometry:
    """The kernel's ``Geometry`` on ``device``, asked of the library once
    per (G, D, dtype, device)."""
    key = (G, D, dtype, device)
    if key not in _GEOMETRY:
        fn = _build.load("ragged_decode").ragged_decode_geometry
        fn.argtypes = [ctypes.c_int] * 3 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        out = (ctypes.c_int * 5)()
        with torch.cuda.device(device):
            err = fn(G, D, _DTYPE_CODE[dtype], ctypes.addressof(out))
        if err != 0:
            raise RuntimeError(f"ragged_decode geometry query failed: CUDA "
                               f"error {err}")
        _GEOMETRY[key] = Geometry(bool(out[0]), *out[1:])
    return _GEOMETRY[key]


def split_plan(B: int, Hkv: int, G: int, Skv: int, geom: Geometry,
               sms: int) -> Tuple[int, int]:
    """(nsplit, chunk): split blocks per (row, head group) and the attended
    positions each takes, from shapes alone. The CUDA cores take their
    fixed chunk. The tensor cores take whole tiles, as few per block as
    keep the grid within ``PLAN_WAVES`` waves of ``geom.resident`` blocks
    on each of ``sms`` SMs, so a full row's blocks all start at once and
    none starts past Skv. nsplit stays within the grid's 65,535."""
    ntile = max(1, -(-Skv // geom.tile))
    if not geom.tensor_cores:
        per = max(1, geom.fixed_chunk // geom.tile)
    else:
        groups = B * Hkv * -(-G // geom.head_cap)
        want = max(1, PLAN_WAVES * geom.resident * sms // groups)
        per = -(-ntile // min(want, ntile))
    per = max(per, -(-ntile // 65535))
    return max(1, -(-Skv // (per * geom.tile))), per * geom.tile


def _sm_count(device) -> int:
    if device not in _SMS:
        _SMS[device] = torch.cuda.get_device_properties(
            device).multi_processor_count
    return _SMS[device]


def plan(B: int, Hkv: int, G: int, D: int, Skv: int, dtype, device
         ) -> Tuple[int, int]:
    """``split_plan`` for a launch on ``device``, kept per shape."""
    key = (B, Hkv, G, D, Skv, dtype, device)
    if key not in _PLANS:
        _PLANS[key] = split_plan(B, Hkv, G, Skv,
                                 geometry(G, D, dtype, device),
                                 _sm_count(device))
    return _PLANS[key]


def _entry():
    """The library's launch function, its argument types set once per
    library (a per-call set costs ~3 us of host time)."""
    lib = _build.load("ragged_decode")
    fn = _ENTRY.get(lib)
    if fn is None:
        fn = lib.ragged_decode_launch
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
        _ENTRY[lib] = fn
    return fn


def _launch(q, k, v, kv_len, pfx, prefix_len: int) -> torch.Tensor:
    B, Hq, D = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    if q.dtype not in _DTYPE_CODE or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"ragged_decode takes one of {list(_DTYPE_CODE)} for "
                        f"q, k and v; got {q.dtype}, {k.dtype}, {v.dtype}")
    if Hq % Hkv or not supports(Hq // Hkv, D, q.dtype):
        raise ValueError(f"unsupported geometry Hq={Hq} Hkv={Hkv} D={D} "
                         f"(needs Hkv | Hq and D <= {MAX_D})")
    if k.shape != v.shape or k.shape[0] != B or k.shape[3] != D:
        raise ValueError(f"shape mismatch q{tuple(q.shape)} "
                         f"k{tuple(k.shape)} v{tuple(v.shape)}")
    if not 0 <= prefix_len <= Skv:
        raise ValueError(f"prefix_len {prefix_len} outside [0, {Skv}]")
    if q.stride(-1) != 1 or k.stride(-1) != 1 or v.stride(-1) != 1:
        raise ValueError("ragged_decode needs a contiguous head dim")
    if k.device != q.device or v.device != q.device:
        raise ValueError("all ragged_decode inputs must share a device")
    # per_row made the lengths int32 on q's device
    kv_len, pfx = kv_len.contiguous(), pfx.contiguous()
    out = torch.empty((B, Hq, D), dtype=q.dtype, device=q.device)
    if B == 0:
        return out
    G = Hq // Hkv
    nsplit, chunk = plan(B, Hkv, G, D, Skv, q.dtype, q.device)
    # float32 partials: o (B, Hkv, nsplit, G, D), then m and l
    rows = B * Hkv * nsplit * G
    scratch = torch.empty(rows * (D + 2), dtype=torch.float32,
                          device=q.device)
    base = scratch.data_ptr()
    err = _entry()(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), kv_len.data_ptr(),
        pfx.data_ptr(), base, base + 4 * rows * D, base + 4 * rows * (D + 1),
        out.data_ptr(), B, Hkv, G, D, Skv, prefix_len, nsplit, chunk,
        q.stride(0), q.stride(1), k.stride(0), k.stride(1), k.stride(2),
        v.stride(0), v.stride(1), v.stride(2), out.stride(0), out.stride(1),
        1.0 / math.sqrt(D), _DTYPE_CODE[q.dtype],
        torch.cuda.current_stream(q.device).cuda_stream)
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
