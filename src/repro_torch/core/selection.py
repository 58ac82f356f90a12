"""The paper's KV layer-selection strategy (§3.2), on the host.

Raw per-layer context mass (Eq. 1, from a calibration prefill with every
layer shared) -> min-max normalize -> mix with a Gaussian depth prior ->
top-M layers. Everything runs on small (L,) float32 CPU tensors and returns
a CPU bool mask.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.core.types import KVCommConfig


def normalize_scores(raw: torch.Tensor) -> torch.Tensor:
    """Min-max normalize Eq. (1) masses to [0, 1] across layers.
    raw: (L,) or (L, B) (averaged over B first). Constant inputs give
    zeros (the denominator is floored), so top-k degrades to index order."""
    if raw.dim() == 2:
        raw = raw.mean(dim=1)
    lo, hi = raw.min(), raw.max()
    return (raw - lo) / torch.clamp(hi - lo, min=1e-9)


def _fma32(a, b, c) -> np.ndarray:
    """float32 fused multiply-add, rounded once: the product of two float32
    values is exact in float64; the sum is rounded to odd (an inexact
    result with an even last bit moves one ulp toward the lost part), so
    the final cast to float32 rounds exactly as a hardware FMA does."""
    p = np.asarray(a, np.float64) * np.asarray(b, np.float64)
    c = np.asarray(c, np.float64)
    s = p + c
    t = s - p
    err = (p - (s - t)) + (c - t)                  # TwoSum: s + err exact
    fix = (err != 0) & ((s.view(np.int64) & 1) == 0)
    s = np.where(fix, np.nextafter(s, np.where(err > 0, np.inf, -np.inf)), s)
    return s.astype(np.float32)


_F = np.float32
_EXP_POLY = (8.3334519073e-3, 4.1665795894e-2, 1.6666665459e-1,
             5.0000001201e-1)


def _exp_f32(x: np.ndarray) -> np.ndarray:
    """float32 exp as the reference's CPU backend (XLA) computes it, bit for
    bit: the Cephes range reduction e^x = e^a * 2^n, n = floor(x log2(e) +
    1/2) clamped to [-127, 127], a degree-5 polynomial for e^a, each step a
    fused multiply-add, and results below the smallest normal flushed to
    0. ``torch.exp`` rounds otherwise for ~10% of inputs, and one ulp of
    the depth prior reorders its ties (l = L/2 +- k), so a selection or a
    ``ScoreGreedy`` slot would differ from the reference's."""
    x = np.clip(np.asarray(x, _F), _F(-87.8), _F(88.8))
    n = np.clip(np.floor(_fma32(x, _F(1.44269504088896341), _F(0.5))),
                _F(-127), _F(127))
    a = _fma32(-_F(0.693359375), n, x)
    a = _fma32(-_F(-2.12194440e-4), n, a)
    z = _fma32(a, _F(1.9875691500e-4), _F(1.3981999507e-3))
    for c in _EXP_POLY:
        z = _fma32(z, a, _F(c))
    z = _F(1) + _fma32(z, a * a, a)
    pow2 = ((n.astype(np.int32) + 127).astype(np.uint32) << 23).view(_F)
    out = (z * pow2).astype(_F)
    return np.where(np.abs(out) < np.finfo(_F).tiny, _F(0), out).astype(_F)


def gaussian_prior(num_layers: int, mu: Optional[float] = None,
                   sigma: float = 10.0) -> torch.Tensor:
    """P^l = exp(-(l - mu)^2 / (2 sigma^2)), l = 1..L; |sigma| floored.
    The reference's float32 values, bit for bit (``_exp_f32``)."""
    if mu is None:
        mu = num_layers / 2
    l = np.arange(1, num_layers + 1, dtype=_F)
    sigma = max(abs(float(sigma)), 1e-6)
    arg = -np.square(l - _F(mu)) / _F(2.0 * sigma ** 2)
    return torch.from_numpy(_exp_f32(arg))


def interp_scores(scores, num_layers: int) -> torch.Tensor:
    """Resample a per-layer score vector onto a model of ``num_layers``
    layers by linear interpolation over normalized depth (the anchor
    alignment of heterogeneous pairs); a single-layer source broadcasts.
    float64 arithmetic, one rounding to float32, as the reference."""
    src = np.asarray(scores, np.float64).reshape(-1)
    L = src.shape[0]
    if L < 1 or num_layers < 1:
        raise ValueError(f"cannot resample {L} scores onto {num_layers} "
                         "layers")
    if L == num_layers:
        out = src
    elif L == 1:
        out = np.full((num_layers,), src[0])
    else:
        out = np.interp(np.linspace(0.0, 1.0, num_layers),
                        np.linspace(0.0, 1.0, L), src)
    return torch.from_numpy(out.astype(np.float32))


def selection_scores(attn_scores: torch.Tensor,
                     cfg: KVCommConfig) -> torch.Tensor:
    """S^l = alpha * S_a^l + (1 - alpha) * P^l."""
    prior = gaussian_prior(attn_scores.shape[0], cfg.mu, cfg.sigma)
    return cfg.alpha * attn_scores.float().cpu() + (1.0 - cfg.alpha) * prior


def topk_mask(scores: torch.Tensor, m: int) -> torch.Tensor:
    """Bool mask of the top-m entries, m clamped to [0, L].

    Ties go to the lower index, as ``jax.lax.top_k`` orders them; a plain
    ``torch.topk`` breaks ties otherwise and would select other layers
    under the symmetric Gaussian prior, so this is a stable descending
    sort."""
    L = scores.shape[0]
    m = max(0, min(m, L))
    mask = torch.zeros((L,), dtype=torch.bool)
    if m:
        order = torch.sort(scores.cpu(), descending=True, stable=True).indices
        mask[order[:m]] = True
    return mask


_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _threefry2x32(k0: int, k1: int, x0: np.ndarray, x1: np.ndarray):
    """Threefry-2x32 with 20 rounds (Salmon et al. 2011), the block cipher
    behind ``jax.random``'s default PRNG, on uint32 arrays."""
    ks = (np.uint32(k0), np.uint32(k1),
          np.uint32(k0 ^ k1 ^ 0x1BD11BDA))
    x0, x1 = x0 + ks[0], x1 + ks[1]
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = x0 + x1
            x1 = ((x1 << np.uint32(r)) | (x1 >> np.uint32(32 - r))) ^ x0
        x0 = x0 + ks[(i + 1) % 3]
        x1 = x1 + ks[(i + 2) % 3] + np.uint32(i + 1)
    return x0, x1


def random_scores(seed: int, num_layers: int) -> torch.Tensor:
    """``jax.random.uniform(jax.random.PRNGKey(seed), (num_layers,))``, bit
    for bit, under the partitionable threefry that jax defaults to: key
    words (0, seed), counters (0, i) for i < n, the two output words XORed,
    and the top 23 bits as the mantissa of a float in [1, 2), minus 1."""
    lo = np.arange(num_layers, dtype=np.uint32)
    with np.errstate(over="ignore"):
        x0, x1 = _threefry2x32((seed >> 32) & 0xFFFFFFFF, seed & 0xFFFFFFFF,
                               np.zeros_like(lo), lo)
    bits = ((x0 ^ x1) >> np.uint32(9)) | np.uint32(0x3F800000)
    return torch.from_numpy(bits.view(np.float32) - np.float32(1.0))


def select_layers(attn_scores: Optional[torch.Tensor], num_layers: int,
                  cfg: KVCommConfig) -> torch.Tensor:
    """The layer subset S as an (L,) CPU bool mask. Selectors: kvcomm,
    random (M layers drawn uniformly from ``cfg.seed``; the Table 2
    baseline), prior_only, contiguous, all."""
    m = cfg.num_selected(num_layers)
    if cfg.selector == "all":
        return torch.ones((num_layers,), dtype=torch.bool)
    if cfg.selector == "contiguous":
        start = max(0, min(cfg.layer_from, num_layers - m))
        idx = torch.arange(num_layers)
        return (idx >= start) & (idx < start + m)
    if cfg.selector == "prior_only":
        return topk_mask(gaussian_prior(num_layers, cfg.mu, cfg.sigma), m)
    if cfg.selector == "kvcomm":
        if attn_scores is None:
            raise ValueError("kvcomm selector needs calibration scores")
        return topk_mask(selection_scores(attn_scores, cfg), m)
    if cfg.selector == "random":
        return topk_mask(random_scores(cfg.seed, num_layers), m)
    raise ValueError(f"unknown selector {cfg.selector!r}")


def kendall_tau(rank_a, rank_b) -> torch.Tensor:
    """Kendall's tau between two layer-score vectors (paper Fig. 14): the
    mean over pairs i < j of sign(a_i - a_j) * sign(b_i - b_j), float32.
    A tie gives a sign of 0; L = 1 has no pair and gives NaN (0 / 0)."""
    a = torch.as_tensor(rank_a, dtype=torch.float32)
    b = torch.as_tensor(rank_b, dtype=torch.float32)
    L = a.shape[0]
    concordant = (torch.sign(a[:, None] - a[None, :])
                  * torch.sign(b[:, None] - b[None, :]))
    i, j = torch.triu_indices(L, L, 1)
    c = concordant[i, j]
    return c.sum() / c.shape[0]
