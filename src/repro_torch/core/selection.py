"""The paper's KV layer-selection strategy (§3.2), on the host.

Raw per-layer context mass (Eq. 1, from a calibration prefill with every
layer shared) -> min-max normalize -> mix with a Gaussian depth prior ->
top-M layers. Everything runs on small (L,) float32 CPU tensors and returns
a CPU bool mask.
"""
from __future__ import annotations

from typing import Optional

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


def gaussian_prior(num_layers: int, mu: Optional[float] = None,
                   sigma: float = 10.0) -> torch.Tensor:
    """P^l = exp(-(l - mu)^2 / (2 sigma^2)), l = 1..L; |sigma| floored."""
    if mu is None:
        mu = num_layers / 2
    l = torch.arange(1, num_layers + 1, dtype=torch.float32)
    sigma = max(abs(float(sigma)), 1e-6)
    return torch.exp(-torch.square(l - mu) / (2.0 * sigma ** 2))


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


def select_layers(attn_scores: Optional[torch.Tensor], num_layers: int,
                  cfg: KVCommConfig) -> torch.Tensor:
    """The layer subset S as an (L,) CPU bool mask. Selectors: kvcomm,
    prior_only, contiguous, all. The reference's ``random`` selector draws
    from ``jax.random``, whose bits torch cannot reproduce: not ported."""
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
        raise NotImplementedError("the random selector is not ported yet")
    raise ValueError(f"unknown selector {cfg.selector!r}")
