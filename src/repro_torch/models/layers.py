"""Core primitives of the port: init, RMSNorm, RoPE, masked GQA attention
with the Eq. (1) context mass, and the swiglu MLP.

Each function mirrors the reference's dtype steps: norms and rotary run in
float32 and cast back, attention scores are computed in the input dtype and
then cast to float32, softmax runs in float32 and the probabilities are cast
to v's dtype before the PV product.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

NEG_INF = -1e30


# ---------------------------------------------------------------------------
# init (same distributions as the reference; torch.Generator draws differ
# from jax.random, so parity tests bridge weights with ``weights.py``)
# ---------------------------------------------------------------------------
def dense_init(gen: torch.Generator, shape, dtype, device,
               scale: Optional[float] = None) -> torch.Tensor:
    fan_in = shape[0] if len(shape) >= 2 else 1
    scale = scale if scale is not None else 1.0 / math.sqrt(max(fan_in, 1))
    w = torch.randn(shape, generator=gen, device=device, dtype=torch.float32)
    return (w * scale).to(dtype)


def embed_init(gen: torch.Generator, shape, dtype, device) -> torch.Tensor:
    w = torch.randn(shape, generator=gen, device=device, dtype=torch.float32)
    return (w * 0.02).to(dtype)


# ---------------------------------------------------------------------------
# norm and rotary
# ---------------------------------------------------------------------------
def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-5):
    dt = x.dtype
    x = x.float()
    x = x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps)
    return (x * (1.0 + w.float())).to(dt)


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float):
    """Half-split rotary embedding. x: (B, S, H, D); positions: (B, S)."""
    half = x.shape[-1] // 2
    freq = torch.exp(-math.log(theta) * torch.arange(
        half, dtype=torch.float32, device=x.device) / half)
    ang = positions.float()[..., None] * freq            # (B, S, half)
    ang = ang[..., None, :]                              # (B, S, 1, half)
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# attention core (plain PyTorch; the decode kernel lives in kernels/)
# ---------------------------------------------------------------------------
def attention_core(
    q: torch.Tensor,                      # (B, Sq, Hq, D)
    k: torch.Tensor,                      # (B, Skv, Hkv, D)
    v: torch.Tensor,                      # (B, Skv, Hkv, D)
    *,
    q_pos: torch.Tensor,                  # (Sq,) or (B, Sq)
    kv_pos: torch.Tensor,                 # (Skv,) or (B, Skv)
    kv_valid: Optional[torch.Tensor] = None,   # (Skv,) or (B, Skv) bool
    causal: bool = True,
    mass_mask: Optional[torch.Tensor] = None,  # (Skv,) bool
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Masked GQA attention; returns (out, context_mass (B,) or None).

    The mass is the paper's Eq. (1) inner sum: softmax mass on
    ``mass_mask`` columns, averaged over heads and query rows."""
    B, Sq, Hq, Dh = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    qg = q.reshape(B, Sq, Hkv, G, Dh)
    scores = torch.einsum("bqhgd,bkhd->bhgqk", qg, k).float()
    scores = scores / math.sqrt(Dh)
    if q_pos.dim() == 1:
        q_pos = q_pos[None]
    if kv_pos.dim() == 1:
        kv_pos = kv_pos[None]
    qp = q_pos[:, None, None, :, None]
    kp = kv_pos[:, None, None, None, :]
    allow = torch.ones((max(q_pos.shape[0], kv_pos.shape[0]), 1, 1, Sq, Skv),
                       dtype=torch.bool, device=q.device)
    if causal:
        allow = allow & (kp <= qp)
    if kv_valid is not None:
        if kv_valid.dim() == 1:
            kv_valid = kv_valid[None]
        allow = allow & kv_valid[:, None, None, None, :]
    scores = torch.where(allow, scores, torch.full_like(scores, NEG_INF))
    probs = torch.softmax(scores, dim=-1)
    mass = None
    if mass_mask is not None:
        m = torch.einsum("bhgqk,k->b", probs, mass_mask.to(probs.dtype))
        mass = (m / (Hkv * G * Sq)).expand(B)
    out = torch.einsum("bhgqk,bkhd->bqhgd", probs.to(v.dtype), v)
    return out.reshape(B, Sq, Hq, Dh), mass


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------
def init_mlp(gen, d_model, d_ff, dtype, device):
    return {
        "w_gate": dense_init(gen, (d_model, d_ff), dtype, device),
        "w_up": dense_init(gen, (d_model, d_ff), dtype, device),
        "w_down": dense_init(gen, (d_ff, d_model), dtype, device),
    }


def apply_mlp(p, x):
    """swiglu: silu(x W_gate) * (x W_up), then W_down."""
    return (F.silu(x @ p["w_gate"]) * (x @ p["w_up"])) @ p["w_down"]
