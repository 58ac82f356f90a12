"""The CUDA kernels' decompositions on the CPU, in plain PyTorch: K1's
split over attended positions (``ragged_decode_split_reference``), K2's
GQA row packing with a split KV range (``flash_attention_split_reference``),
K3's fixed chunks of the attended range (``decode_split_reference``), each
merged with the log-sum-exp rule, and K4's chunked form with its decays
factored at sub-chunk boundaries (``wkv6_chunk_reference``), with the
wrapper's plan of kernel and grid. Each is held to the plain version the
wrapper runs for CPU tensors and to the JAX oracles
(``ref.ragged_decode_reference``, ``ref.mha_reference``,
``ref.decode_partial_reference`` with ``ref.combine_decode_partials``,
``ref.wkv6_reference``) on the same numpy inputs from a seed, in float32 at
2e-5 abs/rel (the same arithmetic summed in another order; the RWKV6 scan
1e-4, as the reference's tests hold it). The kernels themselves are held to
the plain versions on the card (tests/test_torch_gpu.py, chip_smoke.py)."""
import jax
import numpy as np
import pytest
import torch

from _torch_bridge import t
from repro.kernels import ref
from repro_torch.kernels.flash_decode import (
    attended_range, decode_partial_reference, decode_split_reference,
    flash_decode_reference, num_splits)
from repro_torch.kernels.flash_attention import (
    flash_attention_reference, flash_attention_split_reference, kv_tile,
    split_plan)
from repro_torch.kernels.ragged_decode import (
    Geometry, attended_counts, ragged_decode_reference,
    ragged_decode_split_reference)
from repro_torch.kernels.ragged_decode import split_plan as ragged_plan
from repro_torch.kernels.rwkv_scan import (
    STREAM_MAX_T, wkv6_chunk_reference, wkv6_plan, wkv6_reference)

F32 = dict(atol=2e-5, rtol=2e-5)

ragged_oracle = jax.jit(ref.ragged_decode_reference,
                        static_argnames=("prefix_len",))
mha_oracle = jax.jit(ref.mha_reference, static_argnames=(
    "context_len", "q_offset", "causal", "window", "collect_mass"))
partial_oracle = jax.jit(ref.decode_partial_reference,
                         static_argnames=("window",))
combine_oracle = jax.jit(ref.combine_decode_partials)
wkv_oracle = jax.jit(ref.wkv6_reference)


@pytest.fixture(autouse=True)
def few_threads():
    """Small products: a few CPU threads, restored afterwards."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 4))
    yield
    torch.set_num_threads(n)


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


def _tc(resident):
    """K1's tensor-core geometry: 64-position tiles, 16 heads a block."""
    return Geometry(True, resident, 64, 0, 16)


# K1's host plan at the served geometries (B, Hkv, G, Skv) and the blocks
# an SM holds: llama3.2-3b-pair's table, the long cache, qwen1.5 (G 8),
# internlm2 (G 6), starcoder2 (G 9: one group of 9), pixtral, gemma3 (G 2
# at D 256: one block an SM), olmoe and whisper (MHA), zamba2 (MHA, 32 KV
# heads), a G 17 (two groups), a short and an empty table
@pytest.mark.parametrize("B,Hkv,G,Skv,resident", [
    (4, 8, 3, 2079, 2), (8, 8, 3, 4096, 2), (4, 8, 8, 1064, 2),
    (4, 8, 6, 1064, 3), (4, 4, 9, 1064, 2), (4, 8, 4, 1064, 2),
    (4, 4, 2, 2088, 1), (4, 16, 1, 2088, 3), (4, 16, 1, 408, 4),
    (4, 32, 1, 281, 3), (4, 2, 17, 3000, 2), (1, 1, 1, 40, 4),
    (2, 8, 3, 0, 2)])
def test_ragged_split_plan_fills_the_card(B, Hkv, G, Skv, resident):
    """The tensor cores' plan: whole 64-position tiles per split, no split
    that starts past Skv (so none is empty on a full row), a grid within
    one wave of the blocks the card holds (unless one split per head group
    already passes it) and over half of that wave where the rows have the
    tiles to fill it."""
    sms = 132
    geom = _tc(resident)
    nsplit, chunk = ragged_plan(B, Hkv, G, Skv, geom, sms)
    assert chunk % 64 == 0 and chunk >= 64
    assert nsplit == max(1, -(-Skv // chunk))
    assert (nsplit - 1) * chunk < max(Skv, 1)
    groups = B * Hkv * -(-G // 16)
    ntile = max(1, -(-Skv // 64))
    blocks, wave = groups * nsplit, resident * sms
    assert blocks <= max(wave, groups)
    assert 2 * blocks >= min(wave, groups * ntile)


def test_ragged_split_plan_routes_and_limits():
    """The CUDA cores keep their fixed chunk; PLAN_WAVES scales the grid;
    nsplit never passes the grid's 65,535, however long the cache."""
    from repro_torch.kernels import ragged_decode as rd
    core = Geometry(False, 4, 16, 64, 8)
    assert ragged_plan(4, 8, 3, 2079, core, 132) == (33, 64)
    assert ragged_plan(4, 8, 3, 0, core, 132) == (1, 64)
    one = ragged_plan(4, 8, 8, 1064, _tc(2), 132)
    saved = rd.PLAN_WAVES
    try:
        rd.PLAN_WAVES = 2
        two = ragged_plan(4, 8, 8, 1064, _tc(2), 132)
    finally:
        rd.PLAN_WAVES = saved
    assert one == (6, 192) and two == (9, 128)
    for geom in (_tc(1), core):
        nsplit, chunk = ragged_plan(1, 1, 1, 2 ** 23, geom, 132)
        assert nsplit <= 65535 and nsplit * chunk >= 2 ** 23


# K1's split at the chunks its plan gives (whole 64-position tiles) on a
# small card: runs that cross a chunk, a gap in the bucket, a dead row, a
# row whose bucket is empty and one that attends only its bucket
@pytest.mark.parametrize("sms,resident,G", [(1, 1, 9), (1, 2, 3), (2, 1, 1),
                                            (8, 4, 17)])
def test_ragged_split_at_planned_chunks(sms, resident, G):
    rng = np.random.default_rng(sms * 10 + resident + G)
    B, S, P, Hkv, D = 4, 700, 300, 2, 16
    nsplit, chunk = ragged_plan(B, Hkv, G, S, _tc(resident), sms)
    assert chunk % 64 == 0 and nsplit * chunk >= S
    q, k, v = (_randn(rng, B, G * Hkv, D), _randn(rng, B, S, Hkv, D),
               _randn(rng, B, S, Hkv, D))
    kl = np.array([650, 0, 700, 250], np.int32)
    pf = np.array([37, 0, 0, 250], np.int32)
    split = ragged_decode_split_reference(t(q), t(k), t(v), t(kl), t(pf),
                                          prefix_len=P, chunk=chunk)
    oracle = np.asarray(ragged_oracle(q, k, v, kv_len=kl, prefix_lens=pf,
                                      prefix_len=P))
    np.testing.assert_allclose(split.numpy(), oracle, **F32)
    np.testing.assert_array_equal(split.numpy()[1], 0.0)


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


# K3: (S, window, kv_len, chunk) per row set; rows cover dead rows, kv_len
# past S, counts on and off a chunk boundary, a window shorter than a chunk
# and one over several chunks, and a chunk larger than every count
@pytest.mark.parametrize("S,window,kv_len,chunk", [
    (50, None, [0, 50, 77, 13], 8),       # dead, full, kv_len > S, odd
    (48, None, [16, 48, 8, 9, 0], 8),     # on boundaries, one past, dead
    (48, 7, [48, 30, 0, 5], 8),           # window shorter than a chunk
    (48, 20, [48, 60, 70, 3], 8),         # window over chunks; kv_len > S,
                                          # one past S + window: empty
    (50, None, [50, 33, 1, 0], 128),      # chunk > every count
])
def test_decode_split_matches_plain_and_oracle(S, window, kv_len, chunk):
    B, Hq, Hkv, D = len(kv_len), 6, 2, 16
    rng = np.random.default_rng(S + chunk + (window or 0))
    q, k, v = (_randn(rng, B, Hq, D), _randn(rng, B, S, Hkv, D),
               _randn(rng, B, S, Hkv, D))
    kl = np.array(kv_len, np.int32)
    args = (t(q), t(k), t(v), t(kl))
    out = decode_split_reference(*args, window=window, chunk=chunk)
    o, m, l = decode_split_reference(*args, window=window, chunk=chunk,
                                     partials=True)
    np.testing.assert_allclose(
        out.numpy(), flash_decode_reference(*args, window=window).numpy(),
        **F32)
    for a, b in zip((o, m, l), decode_partial_reference(*args,
                                                        window=window)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), **F32)
    jo, jm, jl = partial_oracle(q, k, v, kv_len=kl, window=window)
    for a, b in zip((o, m, l), (jo, jm, jl)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **F32)
    joined = combine_oracle(jo[None], jm[None], jl[None])
    np.testing.assert_allclose(out.numpy(), np.asarray(joined), **F32)
    # an empty row: exact zeros, m = -1e30, l = 0
    lo, hi = attended_range(t(kl), S, window)
    dead = (hi <= lo).numpy()
    assert dead.any()
    np.testing.assert_array_equal(out.numpy()[dead], 0.0)
    np.testing.assert_array_equal(l.numpy()[dead], 0.0)
    np.testing.assert_array_equal(m.numpy()[dead], np.float32(-1e30))


def test_decode_split_counts():
    """The grid's split count comes from S (and the window) alone; the
    attended range is [max(0, kv_len - window), min(kv_len, S))."""
    assert num_splits(32768, None, 256) == 128
    assert num_splits(8192, 1024, 128) == 8
    assert num_splits(100, 0, 64) == 1 and num_splits(0, None, 64) == 1
    lo, hi = attended_range(torch.tensor([0, 5, 30, 99]), 40, 10)
    assert lo.tolist() == [0, 0, 20, 89] and hi.tolist() == [0, 5, 30, 40]


def _decays(rng, kind, shape):
    """w for a K4 case: ``sigmoid`` of a normal draw; ``law``, the model's
    exp(-exp(x)) with x uniform in [-6, 6] (exact zeros above x ~ 4.5, w
    near 1 at the bottom); ``law_ones``, the same with every other step's
    w 1 (the JAX wrapper's padding); ``slow``, w in [0.99, 1)."""
    if kind == "sigmoid":
        w = 1.0 / (1.0 + np.exp(-_randn(rng, *shape)))
    elif kind == "slow":
        w = rng.uniform(0.99, 1.0, shape)
    else:
        w = np.exp(-np.exp(rng.uniform(-6.0, 6.0, shape)))
        if kind == "law_ones":
            w[:, ::2] = 1.0
    return w.astype(np.float32)


# K4: (B, T, H, hd, chunk, decay, segments): T off the chunk and the
# sub-chunk, T 1 and T 0, hd 8 and 64, chunks of 64 and 32, the model's
# decay law with exact zeros, w = 1 steps, slow decays, time segments; a
# non-zero s0 throughout
@pytest.mark.parametrize("B,T,H,hd,chunk,decay,segments", [
    (2, 40, 3, 8, 64, "sigmoid", 1),   # hd 8, T off the chunk and sub-chunk
    (1, 150, 2, 64, 64, "law", 1),     # hd 64, three chunks, exact zeros
    (2, 37, 1, 16, 32, "law_ones", 1),  # chunk 32, w = 1 every other step
    (1, 99, 2, 64, 32, "slow", 1),     # w in [0.99, 1): the state grows
    (1, 1, 2, 8, 64, "law", 1),        # one step
    (1, 0, 2, 8, 64, "sigmoid", 1),    # no step: y empty, the state passes
    (1, 300, 2, 16, 64, "law", 3),     # three time segments, the last short
    (2, 129, 1, 8, 32, "sigmoid", 4),  # segments of whole chunks: 3 of 4
])
def test_wkv6_split_matches_plain_and_oracle(B, T, H, hd, chunk, decay,
                                             segments):
    rng = np.random.default_rng(T * hd + chunk)
    r, k, v = (_randn(rng, B, T, H, hd) for _ in range(3))
    w = _decays(rng, decay, (B, T, H, hd))
    if decay == "law" and T > 1:
        assert (w == 0).any() and (w > 0.99).any()
    u = _randn(rng, H, hd)
    s0 = _randn(rng, B, H, hd, hd)
    xs = (r, k, v, w, u, s0)
    y, s = wkv6_chunk_reference(*(t(x) for x in xs), chunk=chunk,
                                segments=segments)
    py, ps = wkv6_reference(*(t(x) for x in xs))
    jy, js = wkv_oracle(*xs)
    assert y.shape == (B, T, H, hd) and s.shape == (B, H, hd, hd)
    for a, b in ((y, py), (s, ps), (y, jy), (s, js)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-4,
                                   rtol=1e-4)


def test_wkv6_chunk_zero_decay_resets_the_state():
    """w = 0 at a step drops the state before it exactly, as the
    reference's 0 * S does: no log floor leaves a trace of s0."""
    rng = np.random.default_rng(5)
    B, T, H, hd = 1, 40, 1, 8
    r, k, v = (_randn(rng, B, T, H, hd) for _ in range(3))
    w = np.full((B, T, H, hd), 0.9, np.float32)
    w[:, 20] = 0.0
    u = _randn(rng, H, hd)
    s0 = _randn(rng, B, H, hd, hd)
    xs = [t(x) for x in (r, k, v, w, u, s0)]
    y, s = wkv6_chunk_reference(*xs)
    xs[5] = xs[5] * 1e6                    # a wildly different s0
    y2, s2 = wkv6_chunk_reference(*xs)
    assert torch.equal(y[:, 21:], y2[:, 21:]) and torch.equal(s, s2)


@pytest.mark.parametrize("B,T,H,hd,want", [
    (4, 1, 32, 64, ("stream", 1)),        # RWKV6's decode step
    (4, STREAM_MAX_T, 32, 64, ("stream", 1)),   # the receiver's T 16
    (4, 0, 32, 64, ("stream", 1)),        # no step
    (4, STREAM_MAX_T + 1, 32, 64, ("chunk", 1)),
    (4, 2049, 32, 64, ("chunk", 1)),      # the sender's prefill: 128 heads
    (2, 2049, 32, 64, ("chunk", 2)),      # 64 heads: two time segments
    (1, 8192, 32, 64, ("chunk", 4)),      # one row: four segments
    (1, 8192, 32, 128, ("chunk", 4)),     # (chunks of 32 at hd 128)
    (1, 100000, 2, 64, ("chunk", 8)),     # at most SEGMENT_MAX
    (1, 700, 32, 64, ("chunk", 2)),       # each segment >= 4 chunks
    (1, 500, 32, 64, ("chunk", 1)),       # too short for two
    (1, 200, 3, 8, ("chunk", 1)),
])
def test_wkv6_plan_regime_and_grid(B, T, H, hd, want):
    """The wrapper's plan, from shapes alone: the streaming kernel at T <=
    STREAM_MAX_T, else the chunked kernel with a block a head and, where
    that leaves 0.9 x 132 SMs unfilled, each head's steps in segments."""
    assert wkv6_plan(B, T, H, hd, 132) == want
