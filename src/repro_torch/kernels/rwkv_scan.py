"""RWKV6 WKV recurrence with the (key x value) state kept on chip.

Replaces the Pallas kernel ``src/repro/kernels/rwkv_scan.py``
(``_wkv_kernel``). Per batch row and head:

    y_t = r_t . (S + diag(u) k_t v_t^T)
    S   <- diag(w_t) S + k_t v_t^T

Layout (B, T, H, hd) for r, k, v, w (float32), u (H, hd), state
(B, H, hd, hd); returns (y (B, T, H, hd), final state). The Pallas
version's time chunk (``blk_t``) is a TPU tiling and has no counterpart
here.

The CUDA source (``csrc/rwkv_scan.cu``) has two kernels, chosen per call
by ``wkv6_plan`` from the shapes:

* the chunked form for prefills: chunks of 64 steps (32 at hd 128), the
  state carried across them in registers, the chunk's products (its rows
  against the state, the intra-chunk scores against v, the state update)
  on tensor cores in error-compensated TF32, a block a head, and for few
  heads each head's steps in time segments; each head's block then
  streams the steps past the last whole chunk as the streaming kernel
  does; ``wkv6_chunk_reference`` is that decomposition in plain PyTorch,
  for the tests;
* a state-streaming kernel for a few steps (decode): the state read once,
  the steps run from registers, the state written once.

``wkv6`` takes its plain PyTorch version only for tensors on the CPU; for
CUDA tensors it launches a kernel or raises.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import _build

HEAD_DIMS = (8, 16, 32, 64, 128)
# At or below this many steps a call takes the state-streaming kernel: its
# steps run one after another, each a few hundred cycles, while the
# chunked kernel pays a fixed cost per chunk (a 64-step chunk at T 16
# computes 4x the rows it keeps). PERF.md has the measurement.
STREAM_MAX_T = 16
# The chunked kernel puts a block on each head; where that leaves the grid
# under PLAN_FILL x the SM count (a single row's prefill, as of
# rwkv6-1.6b's long_500k context: 32 heads), it cuts each head's steps
# into up to SEGMENT_MAX time segments of at least SEGMENT_MIN_CHUNKS
# chunks (a first pass finds each segment's end state from a zero start,
# the second starts each segment from the states before it).
PLAN_FILL = 0.9
SEGMENT_MAX = 8
SEGMENT_MIN_CHUNKS = 4
_SUB = 16  # steps per sub-chunk (the tensor-core tile's 16 rows)
_ARGTYPES = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 4
             + [ctypes.POINTER(ctypes.c_longlong)] + [ctypes.c_int] * 2
             + [ctypes.c_void_p] * 3)
_ENTRY: Dict[ctypes.CDLL, object] = {}
_SMS: Dict[torch.device, int] = {}
_PLANS: Dict[tuple, Tuple[str, int]] = {}


def wkv6_reference(r, k, v, w, u, state) -> Tuple[torch.Tensor,
                                                  torch.Tensor]:
    """Plain PyTorch version (a port of ``ref.wkv6_reference``): a Python
    loop over t in float32."""
    s = state.float()
    u = u.float()[None, :, :, None]
    ys = []
    for t in range(r.shape[1]):
        kv = k[:, t, :, :, None].float() * v[:, t, :, None, :].float()
        ys.append(torch.einsum("bhk,bhkv->bhv", r[:, t].float(), s + u * kv))
        s = w[:, t, :, :, None].float() * s + kv
    y = (torch.stack(ys, dim=1) if ys
         else torch.zeros(r.shape, dtype=torch.float32, device=r.device))
    return y, s


def _excl_cumprod(x, dim):
    """Exclusive running product along ``dim`` (1 first)."""
    ones = torch.ones_like(x.narrow(dim, 0, 1))
    return torch.cumprod(torch.cat([ones, x.narrow(dim, 0, x.shape[dim] - 1)],
                                   dim), dim)


def wkv6_chunk_reference(r, k, v, w, u, state, *, chunk: int = 64,
                         sub: int = _SUB, segments: int = 1
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The chunked kernel's decomposition in plain PyTorch (float32), for
    the tests. Per chunk of ``chunk`` steps (the tail padded with r = k =
    v = 0 and w = 1) and its sub-chunks of ``sub``, with S the state
    entering the chunk and P(a, b) the product of w over steps a..b-1:

        y_t   = (r_t * P(0, t)) S + sum_{s <= t} A_ts v_s
        S_out = diag(P(0, C)) S + sum_s (k_s * P(s + 1, C)) v_s^T

    where A_ts = sum_i r_ti k_si P(s + 1, t)_i for s < t and A_tt =
    sum_i r_ti u_i k_ti. Every factor is a product of w taken outward
    from a sub-chunk boundary: F_t = P(beta, t) from the start beta of t's
    sub-chunk, G_s = P(s + 1, end) to the end of s's, and the totals of
    whole sub-chunks. So for s, t in sub-chunks j < i,
    P(s + 1, t) = G_s * (totals of the sub-chunks between) * F_t, a
    product of (r_t F_t) and (k_s G_s) over keys: a matrix product. The
    diagonal sub-chunk blocks (s < t in one sub-chunk) take their
    products step by step, elementwise. Each factor lies in [0, 1] for w
    in [0, 1]: never a quotient of products and never a difference of
    log-decays, so w = 0 gives the reference's exact 0 and no floor is
    needed (a difference of log prefixes loses about ulp(|log P|) of its
    exponent, 2e-4 relative at log P ~ -2,400, beyond the 1e-4 gate).

    The steps past the last whole chunk run the plain recurrence from the
    state the chunks leave, as the kernel's do (so [C; Q] in one call and
    Q continued from C's state give the same y for Q).

    ``segments`` > 1 cuts the whole chunks into that many time segments,
    as the kernel does for few heads: each segment's end state from a zero
    start (segment 0: from ``state``) and its decay P(start, end), then
    each segment run from S_k = P_{k-1} S_{k-1} + E_{k-1}."""
    B, T, H, hd = r.shape
    if chunk % sub:
        raise ValueError(f"chunk {chunk} is not a multiple of sub {sub}")
    if T % chunk:
        head = T - T % chunk
        y, s = wkv6_chunk_reference(*(x[:, :head] for x in (r, k, v, w)), u,
                                    state, chunk=chunk, sub=sub,
                                    segments=segments)
        yt, s = wkv6_reference(*(x[:, head:] for x in (r, k, v, w)), u, s)
        return torch.cat([y, yt], dim=1), s
    if segments > 1 and T > 0:
        seg = math.ceil(math.ceil(T / segments) / chunk) * chunk
        bounds = [(t, min(T, t + seg)) for t in range(0, T, seg)]
        part = lambda x, i: x[:, bounds[i][0]:bounds[i][1]]  # noqa: E731
        one = functools.partial(wkv6_chunk_reference, chunk=chunk, sub=sub)
        ends = [one(*(part(x, i) for x in (r, k, v, w)), u,
                    state if i == 0 else torch.zeros_like(state.float()))[1]
                for i in range(len(bounds) - 1)]
        ys, s = [], state.float()
        for i in range(len(bounds)):
            if i == 1:
                s = ends[0]
            elif i > 1:
                s = (torch.prod(part(w, i - 1).float(), dim=1)[..., None] * s
                     + ends[i - 1])
            y, s_out = one(*(part(x, i) for x in (r, k, v, w)), u, s)
            ys.append(y)
        return torch.cat(ys, dim=1), s_out
    ns = chunk // sub
    r, k, v, w = (x.float().transpose(1, 2) for x in (r, k, v, w))
    bonus_u = u.float()[None, :, None, :]                     # (1, H, 1, hd)
    S = state.float().clone()                                 # key x value
    ys = []
    for t0 in range(0, T, chunk):
        n = min(chunk, T - t0)
        pad = (0, 0, 0, chunk - n)
        rc, kc, vc = (F.pad(x[:, :, t0:t0 + n], pad) for x in (r, k, v))
        wc = F.pad(w[:, :, t0:t0 + n], pad, value=1.0)
        rs, ks, ws = (x.reshape(B, H, ns, sub, hd) for x in (rc, kc, wc))
        fw = _excl_cumprod(ws, 3)                       # P(beta, t)
        bw = _excl_cumprod(ws.flip(3), 3).flip(3)       # P(s + 1, end)
        tot = fw[:, :, :, -1] * ws[:, :, :, -1]         # (B, H, ns, hd)
        pre = _excl_cumprod(tot, 2)                     # P(0, beta)
        suf = _excl_cumprod(tot.flip(2), 2).flip(2)     # P(end, C)
        dec = pre[:, :, -1] * tot[:, :, -1]             # P(0, C)
        rq, kq = rs * fw, ks * bw
        A = torch.zeros((B, H, chunk, chunk), dtype=torch.float32,
                        device=r.device)
        for i in range(ns):
            ti = slice(i * sub, (i + 1) * sub)
            for j in range(i):
                gap = torch.prod(tot[:, :, j + 1:i], dim=2)     # 1 if none
                A[:, :, ti, j * sub:(j + 1) * sub] = torch.einsum(
                    "bhtk,bhsk->bhts", rq[:, :, i] * gap[:, :, None],
                    kq[:, :, j])
            # the diagonal block: k_s carried forward step by step
            kp = ks[:, :, i].clone()                    # (B, H, s, hd)
            blk = torch.zeros((B, H, sub, sub), dtype=torch.float32,
                              device=r.device)
            for t in range(sub):
                blk[:, :, t, :t] = torch.einsum(
                    "bhk,bhsk->bhs", rs[:, :, i, t], kp[:, :, :t])
                kp[:, :, :t] = kp[:, :, :t] * ws[:, :, i, t, None]
            blk = blk + torch.diag_embed(
                (rs[:, :, i] * bonus_u * ks[:, :, i]).sum(-1))
            A[:, :, ti, ti] = blk
        y = (torch.einsum("bhtk,bhkv->bhtv",
                          (rq * pre[:, :, :, None]).reshape(B, H, chunk, hd),
                          S)
             + A @ vc)
        S = dec[..., None] * S + torch.einsum(
            "bhsk,bhsv->bhkv",
            (kq * suf[:, :, :, None]).reshape(B, H, chunk, hd), vc)
        ys.append(y[:, :, :n])
    y = (torch.cat(ys, dim=2).transpose(1, 2) if ys
         else torch.zeros((B, T, H, hd), dtype=torch.float32,
                          device=r.device))
    return y, S


def chunk_steps(hd: int) -> int:
    """Steps in one chunk of the chunked kernel at head dim ``hd``."""
    return 64 if hd <= 64 else 32


def wkv6_plan(B: int, T: int, H: int, hd: int, sms: int) -> Tuple[str, int]:
    """(kernel, segments) for a call, from shapes alone: ``"stream"`` at
    T <= ``STREAM_MAX_T`` (T 0 included); else ``"chunk"`` with a block a
    head, each head's steps in the fewest time segments (at most
    ``SEGMENT_MAX``, each at least ``SEGMENT_MIN_CHUNKS`` chunks) that give
    the grid ``PLAN_FILL * sms`` blocks, or one where T is too short."""
    if T <= STREAM_MAX_T:
        return "stream", 1
    heads = B * H
    nseg = min(math.ceil(PLAN_FILL * sms / heads), SEGMENT_MAX,
               T // (SEGMENT_MIN_CHUNKS * chunk_steps(hd)))
    return "chunk", max(1, nseg)


def plan(B: int, T: int, H: int, hd: int, device) -> Tuple[str, int]:
    """``wkv6_plan`` on ``device``'s SM count, kept per shape."""
    key = (B, T, H, hd, device)
    if key not in _PLANS:
        if device not in _SMS:
            _SMS[device] = torch.cuda.get_device_properties(
                device).multi_processor_count
        _PLANS[key] = wkv6_plan(B, T, H, hd, _SMS[device])
    return _PLANS[key]


def _entry():
    """The library's launch function, its argument types set once per
    library."""
    lib = _build.load("rwkv_scan")
    fn = _ENTRY.get(lib)
    if fn is None:
        fn = lib.wkv6_launch
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
        _ENTRY[lib] = fn
    return fn


def _launch(r, k, v, w, u, state):
    B, T, H, hd = r.shape
    xs = (r, k, v, w, u, state)
    if any(x.dtype != torch.float32 for x in xs):
        raise TypeError("wkv6 takes float32 r, k, v, w, u and state; got "
                        f"{[x.dtype for x in xs]}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"wkv6 head dim {hd} not in {HEAD_DIMS}")
    if any(x.shape != r.shape for x in (k, v, w)) \
            or tuple(u.shape) != (H, hd) \
            or tuple(state.shape) != (B, H, hd, hd):
        raise ValueError(f"shape mismatch r{tuple(r.shape)} "
                         f"u{tuple(u.shape)} state{tuple(state.shape)}")
    if any(x.stride(-1) != 1 for x in (r, k, v, w)):
        raise ValueError("wkv6 needs a contiguous head dim")
    if any(x.device != r.device for x in xs):
        raise ValueError("all wkv6 inputs must share a device")
    u, state = u.contiguous(), state.contiguous()
    if state.data_ptr() % 16:          # the state is read as float4
        state = state.clone()
    y = torch.empty((B, T, H, hd), dtype=torch.float32, device=r.device)
    sfin = torch.empty_like(state)
    if B == 0:
        return y, sfin
    kind, nseg = plan(B, T, H, hd, r.device)
    # the segments' end states and decays (pass 0 of the chunked kernel)
    scratch = (torch.empty(B * H * nseg * hd * (hd + 1), dtype=torch.float32,
                           device=r.device) if nseg > 1 else None)
    strides = (ctypes.c_longlong * 12)(
        *[s for x in (r, k, v, w) for s in x.stride()[:3]])
    err = _entry()(r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
                   u.data_ptr(), state.data_ptr(), y.data_ptr(),
                   sfin.data_ptr(), B, T, H, hd, strides,
                   int(kind == "chunk"), nseg,
                   scratch.data_ptr() if nseg > 1 else None,
                   (scratch.data_ptr() + 4 * B * H * nseg * hd * hd)
                   if nseg > 1 else None,
                   torch.cuda.current_stream(r.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"wkv6 kernel launch failed: CUDA error {err}")
    wkv6.launches += 1
    return y, sfin


def wkv6(r, k, v, w, u, state) -> Tuple[torch.Tensor, torch.Tensor]:
    """RWKV6 WKV scan. r/k/v/w: (B, T, H, hd) float32; u: (H, hd); state:
    (B, H, hd, hd). Returns (y (B, T, H, hd), final state (B, H, hd, hd)),
    float32. ``wkv6.launches`` counts kernel launches."""
    if r.device.type == "cpu":
        return wkv6_reference(r, k, v, w, u, state)
    if r.device.type != "cuda":
        raise ValueError(f"wkv6 runs on cuda or cpu, not {r.device}")
    return _launch(r, k, v, w, u, state)


wkv6.launches = 0
