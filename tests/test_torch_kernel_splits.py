"""The CUDA kernels' decompositions on the CPU, in plain PyTorch: K1's
split over attended positions (``ragged_decode_split_reference``) and K2's
GQA row packing with a split KV range (``flash_attention_split_reference``),
each merged with the log-sum-exp rule. Both are held to the plain versions
the wrappers run for CPU tensors and to the JAX oracles
(``ref.ragged_decode_reference``, ``ref.mha_reference``) on the same numpy
inputs from a seed, in float32 at 2e-5 abs/rel (the same arithmetic summed
in another order). The kernels themselves are held to the plain versions on
the card (tests/test_torch_gpu.py, chip_smoke.py)."""
import jax
import numpy as np
import pytest
import torch

from _torch_bridge import t
from repro.kernels import ref
from repro_torch.kernels.flash_attention import (
    flash_attention_reference, flash_attention_split_reference, kv_tile,
    split_plan)
from repro_torch.kernels.ragged_decode import (
    attended_counts, ragged_decode_reference, ragged_decode_split_reference)

F32 = dict(atol=2e-5, rtol=2e-5)

ragged_oracle = jax.jit(ref.ragged_decode_reference,
                        static_argnames=("prefix_len",))
mha_oracle = jax.jit(ref.mha_reference, static_argnames=(
    "context_len", "q_offset", "causal", "window", "collect_mass"))


def _randn(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


# K1: (S, prefix_len, kv_len, pfx, chunk) per row set; rows cover a gap
# (pfx < prefix_len), a dead row, counts on and off a chunk boundary and a
# chunk larger than every count
@pytest.mark.parametrize("S,P,kv_len,pfx,chunk", [
    (24, 8, [13, 24, 0, 9], [3, 8, 0, 0], 8),      # gaps, dead, full row
    (40, 16, [32, 40, 17], [16, 0, 16], 16),        # n = 32: on a boundary
    (40, 16, [33, 25, 40], [15, 7, 1], 16),         # off a boundary
    (30, 10, [20, 30], [4, 10], 128),               # chunk > every count
    (37, 0, [37, 1, 0], [0, 0, 0], 8),              # no bucket, odd S
    (20, 20, [20, 20], [5, 0], 8),                  # bucket only; one dead
])
def test_ragged_split_matches_plain_and_oracle(S, P, kv_len, pfx, chunk):
    B = len(kv_len)
    rng = np.random.default_rng(S * 100 + P + chunk)
    Hq, Hkv, D = 6, 2, 16
    q, k, v = (_randn(rng, B, Hq, D), _randn(rng, B, S, Hkv, D),
               _randn(rng, B, S, Hkv, D))
    kl, pf = np.array(kv_len, np.int32), np.array(pfx, np.int32)
    split = ragged_decode_split_reference(t(q), t(k), t(v), t(kl), t(pf),
                                          prefix_len=P, chunk=chunk)
    plain = ragged_decode_reference(t(q), t(k), t(v), t(kl), t(pf),
                                    prefix_len=P)
    oracle = np.asarray(ragged_oracle(q, k, v, kv_len=kl, prefix_lens=pf,
                                      prefix_len=P))
    np.testing.assert_allclose(split.numpy(), plain.numpy(), **F32)
    np.testing.assert_allclose(split.numpy(), oracle, **F32)
    n, _ = attended_counts(t(kl), t(pf), S, P)
    dead = (n == 0).numpy()
    np.testing.assert_array_equal(split.numpy()[dead], 0.0)


@pytest.mark.parametrize("G", [1, 3, 8])
def test_ragged_split_over_group_sizes(G):
    """Many splits per row (chunk 4) at G = 1, 3 and 8 query heads per KV
    head."""
    rng = np.random.default_rng(G)
    B, S, P, Hkv, D = 3, 50, 12, 2, 32
    q, k, v = (_randn(rng, B, G * Hkv, D), _randn(rng, B, S, Hkv, D),
               _randn(rng, B, S, Hkv, D))
    kl = rng.integers(P + 1, S + 1, B).astype(np.int32)
    pf = rng.integers(0, P + 1, B).astype(np.int32)
    split = ragged_decode_split_reference(t(q), t(k), t(v), t(kl), t(pf),
                                          prefix_len=P, chunk=4)
    oracle = np.asarray(ragged_oracle(q, k, v, kv_len=kl, prefix_lens=pf,
                                      prefix_len=P))
    np.testing.assert_allclose(split.numpy(), oracle, **F32)


def test_attended_counts():
    """n = min(pfx, P) + max(min(kv_len, S) - P, 0), with pfx clamped."""
    kl = torch.tensor([0, 5, 30, 99, 12])
    pf = torch.tensor([0, 3, 9, 4, 20])
    n, pc = attended_counts(kl, pf, 40, 10)
    assert n.tolist() == [0, 3, 29, 34, 12]
    assert pc.tolist() == [0, 3, 9, 4, 10]


# K2: (B, Sq, Sc, G, Hkv, D, causal, window, mass, nsplit)
@pytest.mark.parametrize("B,Sq,Sc,G,Hkv,D,causal,window,mass,nsplit", [
    (2, 1, 70, 1, 2, 16, True, None, True, 2),       # one query row
    (2, 32, 150, 3, 2, 16, True, None, True, 3),     # receiver prefill
    (1, 100, 0, 8, 1, 16, True, None, False, 2),     # G 8, causal
    (1, 100, 20, 3, 1, 32, True, 17, True, 2),       # window with context
    (1, 32, 0, 1, 2, 16, True, 5, False, 1),         # G 1, window
    (1, 13, 6, 3, 1, 16, False, None, True, 1),      # non-causal, unaligned
    (1, 33, 40, 8, 1, 16, False, None, True, 2),     # non-causal, split
])
def test_flash_split_matches_plain_and_oracle(B, Sq, Sc, G, Hkv, D, causal,
                                              window, mass, nsplit):
    rng = np.random.default_rng(Sq * 10 + Sc + G)
    q = _randn(rng, B, Sq, G * Hkv, D)
    k, v = (_randn(rng, B, Sc + Sq, Hkv, D) for _ in range(2))
    kw = dict(context_len=Sc, q_offset=Sc, causal=causal, window=window,
              collect_mass=mass)
    out, m = flash_attention_split_reference(t(q), t(k), t(v),
                                             nsplit=nsplit, **kw)
    plain, pm = flash_attention_reference(t(q), t(k), t(v), **kw)
    oout, om = mha_oracle(q, k, v, **kw)
    np.testing.assert_allclose(out.numpy(), plain.numpy(), **F32)
    np.testing.assert_allclose(out.numpy(), np.asarray(oout), **F32)
    if mass:
        np.testing.assert_allclose(m.numpy(), pm.numpy(), **F32)
        np.testing.assert_allclose(m.numpy(), np.asarray(om), **F32)
    else:
        assert m is None


def test_split_plan_fills_the_card():
    """A short query over a long context (the receiver prefill) splits its
    KV tiles over about 2 * SMs / blocks blocks with no empty split; a grid
    of at least one block per SM is not split."""
    nsplit, per = split_plan(4, 32, 2081, 8, 3, 128, 132)
    nkt = -(-2081 // kv_tile(128))
    assert (nsplit, per) == (5, 7) and (nsplit - 1) * per < nkt
    assert split_plan(1, 2049, 2049, 8, 3, 128, 132) == (1, 33)
    assert split_plan(1, 4096, 4096, 4, 2, 256, 132) == (1, 128)
    assert kv_tile(256) == 32 and kv_tile(192) == 64 and kv_tile(16) == 64
