"""chip_smoke.py's gates on the CPU. The kernel-vs-plain tolerance: an
honest result (the same attention evaluated in float64, then rounded to
bf16) passes it against the float32 plain version, and a kernel that drops
a KV tile or counts every key as context fails it. RWKV6's state-sharing
gate on reduced rwkv6-1.6b (the plain scan) and Zamba2's on reduced
zamba2-2.7b: every state shared passes it, and each planted fault of the
hand-off fails it. The GPU run itself needs a card."""
import dataclasses
import math
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke as cs  # noqa: E402
from repro_torch.configs.registry import get_config  # noqa: E402
from repro_torch.core import protocol  # noqa: E402
from repro_torch.core.types import KVCommConfig  # noqa: E402
from repro_torch.core.types import SharedKV  # noqa: E402
from repro_torch.data.tokenizer import SymbolTokenizer  # noqa: E402
from repro_torch.kernels.flash_attention import (  # noqa: E402
    attention_mask, flash_attention_reference)
from repro_torch.models import transformer as tfm  # noqa: E402


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


FAULTS = ("f1_wkv_zeroed", "f2_wkv_transposed", "f3_context_off_by_one",
          "f4_stream_without_bonus", "f5_shift_zeroed")


@pytest.fixture(scope="module")
def rwkv6_gates():
    """``chip_smoke.rwkv6_fault_gates`` on reduced rwkv6-1.6b (2 layers, d
    128, bf16 with its float32 upcast), the bonus drawn as chip_smoke.py
    draws it, 2 contexts of 40 tokens and queries of 8."""
    torch.set_num_threads(2)
    tok = SymbolTokenizer(16, 8)
    cfg = dataclasses.replace(get_config("rwkv6-1.6b").reduced(),
                              vocab_size=tok.vocab_size)
    assert cfg.dtype == "bfloat16"
    params = cs.draw_rwkv6_bonus(tfm.init_params(cfg, 0, device="cpu"))
    rng = np.random.default_rng(0)
    ctx = rng.integers(4, cfg.vocab_size, (2, 40)).astype(np.int32)
    qry = rng.integers(4, cfg.vocab_size, (2, 8)).astype(np.int32)
    everything = lambda kv, states, export=None: SharedKV(  # noqa: E731
        states=states,
        state_select=torch.ones(cfg.num_layers, dtype=torch.bool))
    return cs.rwkv6_fault_gates(cfg, params, tok, ctx, qry, everything)


def test_rwkv6_state_gate_passes_every_state_shared(rwkv6_gates):
    honest = rwkv6_gates["honest"]
    assert honest["ok"], honest["gates"]
    assert set(honest["gates"]) == {n for n, _ in cs.RWKV6_GATES}
    assert set(rwkv6_gates) == {"honest", *FAULTS}


@pytest.mark.parametrize("fault", FAULTS)
def test_rwkv6_state_gate_refuses_planted_fault(rwkv6_gates, fault):
    """Refused at float32 and by a bf16 gate, each at twice its bound."""
    g = rwkv6_gates[fault]
    assert not g["ok"]
    x, bound = g["gates"]["fp32_max_rel"]
    assert x >= 2 * bound, g["gates"]
    assert any(x >= 2 * bound for name, (x, bound) in g["gates"].items()
               if name != "fp32_max_rel"), g["gates"]


Z_FAULTS = ("z1_ssm_zeroed", "z2_conv_zeroed", "z3_context_off_by_one",
            "z4_attn_kv_zeroed")


@pytest.fixture(scope="module")
def zamba2_gates():
    """``chip_smoke.zamba2_fault_gates`` on reduced zamba2-2.7b (2 Mamba2
    layers, 2 shared-attention invocations, d 128, bf16 with its float32
    upcast), 2 contexts of 40 tokens and queries of 8."""
    torch.set_num_threads(2)
    tok = SymbolTokenizer(16, 8)
    cfg = dataclasses.replace(get_config("zamba2-2.7b").reduced(),
                              vocab_size=tok.vocab_size)
    assert cfg.dtype == "bfloat16"
    params = tfm.init_params(cfg, 0, device="cpu")
    rng = np.random.default_rng(0)
    ctx = rng.integers(4, cfg.vocab_size, (2, 40)).astype(np.int32)
    qry = rng.integers(4, cfg.vocab_size, (2, 8)).astype(np.int32)
    L, n_ssm = cfg.attn_layer_count, protocol._n_ssm(cfg)
    everything = lambda kv, states, _: protocol.pack_shared(  # noqa: E731
        KVCommConfig(), kv, torch.ones(L, dtype=torch.bool), states,
        torch.ones(n_ssm, dtype=torch.bool))
    return cs.zamba2_fault_gates(cfg, params, tok, ctx, qry, everything)


def test_zamba2_state_gate_passes_every_state_shared(zamba2_gates):
    honest = zamba2_gates["honest"]
    assert honest["ok"], honest["gates"]
    assert set(honest["gates"]) == {n for n, _ in cs.ZAMBA2_GATES}
    assert set(zamba2_gates) == {"honest", *Z_FAULTS}


@pytest.mark.parametrize("fault", Z_FAULTS)
def test_zamba2_state_gate_refuses_planted_fault(zamba2_gates, fault):
    """Refused at float32 and by a bf16 gate, each at twice its bound."""
    g = zamba2_gates[fault]
    assert not g["ok"]
    x, bound = g["gates"]["fp32_max_rel"]
    assert x >= 2 * bound, g["gates"]
    assert any(x >= 2 * bound for name, (x, bound) in g["gates"].items()
               if name != "fp32_max_rel"), g["gates"]
