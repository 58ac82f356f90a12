"""K5: the dropless grouped expert layer of a top-k MoE, in Triton.

Replaces no kernel of the reference package: there the dense_all MoE runs
every expert on every token (``models/layers.py``'s loop). This kernel
computes the same function over only the routed rows: each (token,
expert) assignment is computed once, none is dropped.

  dispatch  — the assignments sorted by expert (stably, so each expert's
              come in token order) and each expert's row range found by
              ``searchsorted``, all on the device: no host sync, no loop
              over experts. The sorted rows are cut into tiles of
              ``block_m`` rows that never straddle two experts; the
              tile table (expert, first row, end row) has a fixed length
              (``-(-M // block_m) + E``, the most a routing can need), so
              the grid is known from shapes alone and a tile past the
              routing's own count exits at once.
  gate|up   — ``moe_grouped_gate_up``: one grouped GEMM over the routed
              rows, gathering each row of x by its token, both
              projections into two float32 accumulators, and
              ``silu(gate) * up`` in the epilogue: h (M, F) in x's dtype.
  down      — ``moe_grouped_down``: h by its expert's down projection,
              scaled by the assignment's gate in float32 and written to
              the row of the assignment's own (token, slot), so the
              combine is a sum over each token's k slots in float32: a
              weighted scatter back to the tokens whose order, unlike an
              atomic ``index_add_``'s, is fixed.

Bounds on the H100: a prefill's rows (thousands a expert) are bound by
operations, 6 d F a assignment; a decode step's few rows by the bytes of
the experts it touches (3 d F each), read once by each tile of rows.
The design keeps every expert's weights read once a tile of rows,
intermediates in float32 until h, and no (M, d) copy of the gathered
rows. Tile sizes follow the mean rows per expert (``block_m``).

``grouped_experts`` launches the kernels for CUDA tensors and takes the
plain PyTorch version (``grouped_experts_reference``, the same dispatch
and tiles, matrix products per tile) for tensors on the CPU.
``grouped_experts.launches`` counts kernel launches (two a call).
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

_KERNELS: Dict[str, object] = {}


def block_m(M: int, E: int) -> int:
    """Rows per tile: the power of two from 16 to 128 nearest above the
    mean rows per expert, so a decode step's few rows a expert take one
    small tile and a prefill's many rows full tensor-core tiles."""
    mean = -(-M // E)
    for b in (16, 32, 64):
        if mean <= b:
            return b
    return 128


def dispatch(idx: torch.Tensor, E: int, bm: int):
    """The device-side routing of top-k indices ``idx`` (N, k): (order
    (M,), the assignment index t * k + slot of each sorted row; tile_e,
    row0, rend (T,), each tile's expert, first row and end row, an empty
    range past the routing's own tiles)."""
    dev = idx.device
    M = idx.numel()
    eid = idx.reshape(M)
    order = torch.sort(eid, stable=True).indices
    eid_s = eid[order]
    experts = torch.arange(E, device=dev, dtype=eid_s.dtype)
    starts = torch.searchsorted(eid_s, experts)
    ends = torch.searchsorted(eid_s, experts, right=True)
    tiles = (ends - starts + bm - 1) // bm
    tile_end = torch.cumsum(tiles, 0)
    T = -(-M // bm) + E
    pid = torch.arange(T, device=dev, dtype=tile_end.dtype)
    tile_e = torch.searchsorted(tile_end, pid, right=True)
    e = tile_e.clamp(max=E - 1)
    row0 = starts[e] + (pid - (tile_end[e] - tiles[e])) * bm
    rend = torch.where(tile_e < E, ends[e], torch.zeros_like(ends[e]))
    return order, tile_e, row0, rend


def grouped_experts_reference(x, w_gate, w_up, w_down, gates, idx,
                              bm: int = 16):
    """The plain version: ``dispatch``'s tiles, each tile's rows through
    its expert by matrix products, gated, written to their (token, slot)
    rows and summed over the slots in float32. x (N, D); gates, idx
    (N, k); experts (E, D, F), (E, D, F), (E, F, D)."""
    N, k = idx.shape
    E = w_gate.shape[0]
    order, tile_e, row0, rend = dispatch(idx, E, bm)
    tok = order // k
    gate_s = gates.reshape(-1)[order].float()
    y = torch.zeros((N * k, x.shape[1]), dtype=x.dtype, device=x.device)
    for e, a, b in zip(tile_e.tolist(), row0.tolist(), rend.tolist()):
        if a >= b:
            continue
        b = min(b, a + bm)
        xs = x[tok[a:b]]
        h = F.silu(xs.float() @ w_gate[e].float()) * (
            xs.float() @ w_up[e].float())
        out = h.to(x.dtype).float() @ w_down[e].float()
        y[order[a:b]] = (out * gate_s[a:b, None]).to(x.dtype)
    return y.view(N, k, -1).sum(1, dtype=torch.float32).to(x.dtype)


def _kernels():
    """Build the two Triton kernels once (``triton`` is imported here, not
    when the module is)."""
    if _KERNELS:
        return _KERNELS["gate_up"], _KERNELS["down"]
    import triton
    import triton.language as tl

    @triton.jit
    def moe_grouped_gate_up(x_ptr, tok_ptr, wg_ptr, wu_ptr, h_ptr,
                            tile_e_ptr, row0_ptr, rend_ptr, D, Fdim,
                            stride_x, stride_we, stride_wd, stride_h,
                            BM: tl.constexpr, BN: tl.constexpr,
                            BK: tl.constexpr):
        pid_m = tl.program_id(0)
        pid_n = tl.program_id(1)
        row0 = tl.load(row0_ptr + pid_m)
        rend = tl.load(rend_ptr + pid_m)
        if row0 >= rend:
            return
        e = tl.load(tile_e_ptr + pid_m).to(tl.int64)
        rows = row0 + tl.arange(0, BM)
        rmask = rows < rend
        tok = tl.load(tok_ptr + rows, mask=rmask, other=0).to(tl.int64)
        cols = pid_n * BN + tl.arange(0, BN)
        cmask = cols < Fdim
        ks = tl.arange(0, BK)
        a_ptrs = x_ptr + tok[:, None] * stride_x + ks[None, :]
        w_off = e * stride_we + ks[:, None] * stride_wd + cols[None, :]
        acc_g = tl.zeros((BM, BN), dtype=tl.float32)
        acc_u = tl.zeros((BM, BN), dtype=tl.float32)
        for k0 in range(0, D, BK):
            kmask = (k0 + ks) < D
            a = tl.load(a_ptrs + k0, mask=rmask[:, None] & kmask[None, :],
                        other=0.0)
            wmask = kmask[:, None] & cmask[None, :]
            bg = tl.load(wg_ptr + w_off + k0 * stride_wd, mask=wmask,
                         other=0.0)
            bu = tl.load(wu_ptr + w_off + k0 * stride_wd, mask=wmask,
                         other=0.0)
            acc_g += tl.dot(a, bg)
            acc_u += tl.dot(a, bu)
        h = acc_g / (1.0 + tl.exp(-acc_g)) * acc_u
        tl.store(h_ptr + rows.to(tl.int64)[:, None] * stride_h
                 + cols[None, :], h.to(h_ptr.dtype.element_ty),
                 mask=rmask[:, None] & cmask[None, :])

    @triton.jit
    def moe_grouped_down(h_ptr, wd_ptr, y_ptr, order_ptr, gate_ptr,
                         tile_e_ptr, row0_ptr, rend_ptr, Fdim, D,
                         stride_h, stride_we, stride_wf, stride_y,
                         BM: tl.constexpr, BN: tl.constexpr,
                         BK: tl.constexpr):
        pid_m = tl.program_id(0)
        pid_n = tl.program_id(1)
        row0 = tl.load(row0_ptr + pid_m)
        rend = tl.load(rend_ptr + pid_m)
        if row0 >= rend:
            return
        e = tl.load(tile_e_ptr + pid_m).to(tl.int64)
        rows = row0 + tl.arange(0, BM)
        rmask = rows < rend
        cols = pid_n * BN + tl.arange(0, BN)
        cmask = cols < D
        ks = tl.arange(0, BK)
        a_ptrs = h_ptr + rows.to(tl.int64)[:, None] * stride_h + ks[None, :]
        w_off = e * stride_we + ks[:, None] * stride_wf + cols[None, :]
        acc = tl.zeros((BM, BN), dtype=tl.float32)
        for k0 in range(0, Fdim, BK):
            kmask = (k0 + ks) < Fdim
            a = tl.load(a_ptrs + k0, mask=rmask[:, None] & kmask[None, :],
                        other=0.0)
            b = tl.load(wd_ptr + w_off + k0 * stride_wf,
                        mask=kmask[:, None] & cmask[None, :], other=0.0)
            acc += tl.dot(a, b)
        dst = tl.load(order_ptr + rows, mask=rmask, other=0).to(tl.int64)
        g = tl.load(gate_ptr + dst, mask=rmask, other=0.0).to(tl.float32)
        tl.store(y_ptr + dst[:, None] * stride_y + cols[None, :],
                 (acc * g[:, None]).to(y_ptr.dtype.element_ty),
                 mask=rmask[:, None] & cmask[None, :])

    _KERNELS["gate_up"], _KERNELS["down"] = moe_grouped_gate_up, \
        moe_grouped_down
    return moe_grouped_gate_up, moe_grouped_down


def _check(x, w_gate, w_up, w_down, gates, idx) -> Tuple[int, int, int]:
    E, D, Fdim = w_gate.shape
    if x.dtype not in (torch.bfloat16, torch.float16):
        raise ValueError(f"grouped_experts takes bf16 / fp16, not {x.dtype}")
    for w, shape in ((w_gate, (E, D, Fdim)), (w_up, (E, D, Fdim)),
                     (w_down, (E, Fdim, D))):
        if tuple(w.shape) != shape or w.dtype != x.dtype \
                or not w.is_contiguous() or w.device != x.device:
            raise ValueError("grouped_experts needs contiguous experts of "
                             f"x's dtype and device, shaped {shape}")
    if x.dim() != 2 or x.shape[1] != D or x.stride(1) != 1:
        raise ValueError(f"x must be (N, {D}) with unit column stride")
    if idx.shape != gates.shape or idx.shape[0] != x.shape[0]:
        raise ValueError("gates and idx must both be (N, k)")
    return E, D, Fdim


def grouped_experts(x, w_gate, w_up, w_down, gates, idx):
    """sum over each token's k routed experts of gate * expert(x): x
    (N, D); gates (N, k) and idx (N, k) from the router; experts (E, D, F),
    (E, D, F), (E, F, D). Returns (N, D) in x's dtype. CUDA tensors run
    the two kernels, CPU tensors the plain version."""
    if not x.is_cuda:
        return grouped_experts_reference(x, w_gate, w_up, w_down, gates, idx,
                                         block_m(idx.numel(),
                                                 w_gate.shape[0]))
    E, D, Fdim = _check(x, w_gate, w_up, w_down, gates, idx)
    N, k = idx.shape
    M = N * k
    bm = block_m(M, E)
    order, tile_e, row0, rend = dispatch(idx, E, bm)
    tok = order // k
    gate_up, down = _kernels()
    T = tile_e.shape[0]
    warps = 8 if bm == 128 else 4
    h = torch.empty((M, Fdim), dtype=x.dtype, device=x.device)
    bn1 = 64
    gate_up[(T, -(-Fdim // bn1))](
        x, tok, w_gate, w_up, h, tile_e, row0, rend, D, Fdim,
        x.stride(0), D * Fdim, Fdim, Fdim,
        BM=bm, BN=bn1, BK=64, num_warps=warps, num_stages=3)
    y = torch.empty((M, D), dtype=x.dtype, device=x.device)
    bn2 = 128
    down[(T, -(-D // bn2))](
        h, w_down, y, order, gates.reshape(M).contiguous(), tile_e, row0,
        rend, Fdim, D, Fdim, Fdim * D, D, D,
        BM=bm, BN=bn2, BK=64, num_warps=warps, num_stages=3)
    grouped_experts.launches += 2
    return y.view(N, k, D).sum(1, dtype=torch.float32).to(x.dtype)


grouped_experts.launches = 0
