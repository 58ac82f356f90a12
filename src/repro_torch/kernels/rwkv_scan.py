"""RWKV6 WKV recurrence with the (key x value) state kept on chip.

Replaces the Pallas kernel ``src/repro/kernels/rwkv_scan.py``
(``_wkv_kernel``). Per batch row and head:

    y_t = r_t . (S + diag(u) k_t v_t^T)
    S   <- diag(w_t) S + k_t v_t^T

Layout (B, T, H, hd) for r, k, v, w (float32), u (H, hd), state
(B, H, hd, hd); returns (y (B, T, H, hd), final state). The Pallas
version's time chunk (``blk_t``) is a TPU tiling and has no counterpart
here.

The CUDA kernel (``csrc/rwkv_scan.cu``) splits each (batch row, head)
over blocks of value columns (column j of S and y depends only on v's
column j), keeps each block's columns of the state in registers, and
stages the time axis through double-buffered shared memory, so device
memory sees about one read of r, k, v, w and one write of y per token.
``wkv6_split_reference`` is that decomposition in plain PyTorch, for the
tests. See the source for the design.

``wkv6`` takes its plain PyTorch version only for tensors on the CPU; for
CUDA tensors it launches the kernel or raises.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from repro_torch.kernels import _build

HEAD_DIMS = (8, 16, 32, 64, 128)
_ARGTYPES = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 4
             + [ctypes.POINTER(ctypes.c_longlong), ctypes.c_void_p])


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


def wkv6_split_reference(r, k, v, w, u, state, *, jb: int = 32,
                         chunk: int = 32) -> Tuple[torch.Tensor,
                                                   torch.Tensor]:
    """The CUDA kernel's decomposition in plain PyTorch (float32), for the
    tests: the value columns in blocks of ``jb``, each block's columns of
    the state carried across time chunks of ``chunk`` steps, and
    ``y_j = sum_i r_i S_ij + v_j sum_i r_i u_i k_i`` (the reference's
    function with the u term summed once per key)."""
    B, T, H, hd = r.shape
    r, k, v, w = (x.float() for x in (r, k, v, w))
    ruk = (r * u.float()[None, None] * k).sum(-1)               # (B, T, H)
    y = torch.zeros((B, T, H, hd), dtype=torch.float32, device=r.device)
    sfin = torch.empty((B, H, hd, hd), dtype=torch.float32, device=r.device)
    for j0 in range(0, hd, jb):
        cols = slice(j0, min(hd, j0 + jb))
        s = state.float()[..., cols]
        for t0 in range(0, T, chunk):
            for t in range(t0, min(T, t0 + chunk)):
                vt = v[:, t, :, cols]
                y[:, t, :, cols] = (torch.einsum("bhk,bhkv->bhv", r[:, t], s)
                                    + vt * ruk[:, t, :, None])
                s = w[:, t, :, :, None] * s + k[:, t, :, :, None] * vt[
                    :, :, None, :]
        sfin[..., cols] = s
    return y, sfin


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
    y = torch.empty((B, T, H, hd), dtype=torch.float32, device=r.device)
    sfin = torch.empty_like(state)
    if B == 0:
        return y, sfin
    strides = (ctypes.c_longlong * 12)(
        *[s for x in (r, k, v, w) for s in x.stride()[:3]])
    lib = _build.load("rwkv_scan")
    fn = lib.wkv6_launch
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    err = fn(r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
             u.data_ptr(), state.data_ptr(), y.data_ptr(), sfin.data_ptr(),
             B, T, H, hd, strides,
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
