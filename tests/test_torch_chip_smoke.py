"""chip_smoke.py's kernel-vs-plain tolerance on the CPU: an honest result
(the same attention evaluated in float64, then rounded to bf16) passes it
against the float32 plain version, and a kernel that drops a KV tile or
counts every key as context fails it. The GPU run itself needs a card."""
import math
import sys
from pathlib import Path

import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke as cs  # noqa: E402
from repro_torch.kernels.flash_attention import (  # noqa: E402
    attention_mask, flash_attention_reference)


def _attention64(q, k, v, Sc, window, drop=None, all_context=False):
    """(out in q's dtype, Eq. (1) mass) computed in float64; ``drop`` takes
    KV positions out of every row that keeps some other position."""
    B, Sq, Hq, D = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    allow = attention_mask(Sq, Skv, context_len=Sc, q_offset=Sc,
                           window=window)
    if drop is not None:
        keep = allow.clone()
        keep[:, drop] = False
        allow = torch.where(keep.any(1, keepdim=True), keep, allow)
    qg = q.double().reshape(B, Sq, Hkv, Hq // Hkv, D)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg, k.double()) / math.sqrt(D)
    p = torch.softmax(s.masked_fill(~allow, -1e300), -1)
    out = torch.einsum("bhgqk,bkhd->bqhgd", p, v.double())
    ctx = (torch.arange(Skv) < (Skv if all_context else Sc)).double()
    return (out.reshape(B, Sq, Hq, D).to(q.dtype),
            (p @ ctx).mean(dim=(1, 2, 3)).float())


@pytest.mark.parametrize("B,Sq,Sc,Hq,Hkv,D,window", [
    (2, 16, 300, 4, 2, 64, None),     # a receiver prefill with the mass
    (1, 256, 0, 4, 2, 64, None),      # a causal prefill
    (1, 256, 0, 2, 1, 256, 96),       # a sliding window at D 256
])
def test_tolerance_passes_honest_and_rejects_faults(B, Sq, Sc, Hq, Hkv, D,
                                                    window):
    g = torch.Generator().manual_seed(Sq + Sc + D)
    q, k, v = (torch.randn(*s, generator=g).to(torch.bfloat16)
               for s in ((B, Sq, Hq, D), (B, Sc + Sq, Hkv, D),
                         (B, Sc + Sq, Hkv, D)))
    want, wmass = flash_attention_reference(
        q, k, v, context_len=Sc, q_offset=Sc, window=window,
        collect_mass=Sc > 0)
    honest, mass = _attention64(q, k, v, Sc, window)
    assert cs.tol_ratio(honest, want, *cs.BF16_TOLS)[0] < 0.6
    for drop in (slice(64, 128), slice(Sc + Sq - 64, Sc + Sq)):
        wrong, _ = _attention64(q, k, v, Sc, window, drop=drop)
        assert cs.tol_ratio(wrong, want, *cs.BF16_TOLS)[0] > 5
    if Sc:
        assert cs.tol_ratio(mass, wmass, *cs.MASS_TOLS)[0] < 0.1
        _, wrong = _attention64(q, k, v, Sc, window, all_context=True)
        assert cs.tol_ratio(wrong, wmass, *cs.MASS_TOLS)[0] > 5
