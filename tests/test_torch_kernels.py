"""The port's kernel entry point (``repro_torch.kernels.ops``) on the CPU:
the plain versions its wrappers run for CPU tensors, against the reference
``repro.kernels.ops`` (Pallas in interpret mode, as tests/test_kernels.py
runs it) and the ``ref`` oracles, on the same numpy inputs from a seed.

Tolerances are those of tests/test_kernels.py: float32 2e-5 abs/rel (the
same arithmetic summed in another order), RWKV6 1e-4 (a 40-64 step
recurrence), bf16 2e-2 (both sides round inputs and outputs to bf16). The
CUDA kernels are held to these plain versions on the card
(tests/test_torch_gpu.py, chip_smoke.py)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from _torch_bridge import t
from repro.kernels import ops as jops
from repro.kernels import ref
from repro_torch.kernels import ops
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.flash_decode import flash_decode
from repro_torch.kernels.ragged_decode import ragged_decode
from repro_torch.kernels.rwkv_scan import wkv6
from repro_torch.launch import distributed_decode

F32 = dict(atol=2e-5, rtol=2e-5)
BF16 = dict(atol=2e-2, rtol=2e-2)

# the oracles compiled whole: one XLA program per shape instead of one per
# eager op, which is most of this file's time on the CPU
mha_reference = jax.jit(ref.mha_reference, static_argnames=(
    "context_len", "q_offset", "causal", "window", "collect_mass"))
decode_reference = jax.jit(ref.decode_reference, static_argnames=("window",))


def _randn(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _np(x):
    return np.asarray(jnp.asarray(x, jnp.float32)) if not isinstance(
        x, torch.Tensor) else x.float().numpy()


class TestFlashAttention:
    @pytest.mark.parametrize("dtype,B,Sq,Sc,Hq,Hkv,D", [
        (dtype, *shape) for shape in [
            (1, 8, 0, 1, 1, 16),
            (2, 24, 16, 4, 2, 32),
            (1, 17, 5, 6, 3, 64),     # ragged: the reference pads to blocks
            (2, 32, 32, 8, 8, 16),    # MHA
        ] for dtype in ("float32", "bfloat16")] + [
        ("float32", 1, 64, 0, 4, 1, 128),   # MQA, no context; one dtype, as
    ])                                      # each dtype is a compile here
    def test_matches_reference(self, dtype, B, Sq, Sc, Hq, Hkv, D):
        rng = np.random.default_rng(B * 1000 + Sq * 10 + D)
        q = _randn(rng, B, Sq, Hq, D)
        k = _randn(rng, B, Sc + Sq, Hkv, D)
        v = _randn(rng, B, Sc + Sq, Hkv, D)
        jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
        kw = dict(context_len=Sc, q_offset=Sc, collect_mass=Sc > 0)
        jout, jmass = jops.flash_attention(
            *(jnp.asarray(x).astype(jdt) for x in (q, k, v)), blk_q=8,
            blk_k=8, **kw)
        out, mass = ops.flash_attention(
            *(t(x).to(tdt) for x in (q, k, v)), **kw)
        assert out.dtype == tdt and out.shape == (B, Sq, Hq, D)
        tol = F32 if dtype == "float32" else BF16
        # the oracle on the inputs as rounded to the dtype, in float32
        rq, rk, rv = (_np(jnp.asarray(x).astype(jdt)) for x in (q, k, v))
        rout, rmass = mha_reference(rq, rk, rv, **kw)
        np.testing.assert_allclose(_np(out), _np(jout), **tol)
        np.testing.assert_allclose(_np(out), np.asarray(rout), **tol)
        if Sc > 0:
            assert mass.shape == (B,) and mass.dtype == torch.float32
            np.testing.assert_allclose(mass.numpy(), np.asarray(jmass),
                                       **tol)
            np.testing.assert_allclose(mass.numpy(), np.asarray(rmass),
                                       **tol)
        else:
            assert mass is None

    @pytest.mark.parametrize("window", [1, 4, 9, 64])
    def test_sliding_window(self, window):
        rng = np.random.default_rng(window)
        q, k, v = (_randn(rng, 1, 32, 2, 16) for _ in range(3))
        jout, _ = jops.flash_attention(q, k, v, window=window, blk_q=8,
                                       blk_k=8)
        out, _ = ops.flash_attention(t(q), t(k), t(v), window=window)
        rout, _ = mha_reference(q, k, v, window=window)
        np.testing.assert_allclose(out.numpy(), np.asarray(jout), **F32)
        np.testing.assert_allclose(out.numpy(), np.asarray(rout), **F32)

    def test_noncausal_block_aligned(self):
        rng = np.random.default_rng(3)
        q, k, v = (_randn(rng, 2, 16, 2, 16) for _ in range(3))
        jout, _ = jops.flash_attention(q, k, v, causal=False, blk_q=8,
                                       blk_k=8)
        out, _ = ops.flash_attention(t(q), t(k), t(v), causal=False)
        np.testing.assert_allclose(out.numpy(), np.asarray(jout), **F32)

    @pytest.mark.parametrize("Sc,Sq,mass", [(0, 12, False), (5, 9, True)])
    def test_noncausal_unaligned_matches_oracle(self, Sc, Sq, mass):
        """Reference caveat (ROADMAP): with causal=False and lengths that
        are not block multiples, the reference Pallas wrapper's zero-padded
        keys reach the softmax (it masks with the padded lengths), so it
        is compared here with the oracle only, whose function the port
        computes."""
        rng = np.random.default_rng(Sc + Sq)
        q = _randn(rng, 1, Sq, 2, 16)
        k, v = (_randn(rng, 1, Sc + Sq, 2, 16) for _ in range(2))
        kw = dict(context_len=Sc, q_offset=Sc, causal=False,
                  collect_mass=mass)
        out, m = ops.flash_attention(t(q), t(k), t(v), **kw)
        rout, rm = mha_reference(q, k, v, **kw)
        np.testing.assert_allclose(out.numpy(), np.asarray(rout), **F32)
        if mass:
            np.testing.assert_allclose(m.numpy(), np.asarray(rm), **F32)

    def test_mass_excludes_self_segment(self):
        """mass sums only over the context prefix, never self tokens."""
        rng = np.random.default_rng(12)
        Sc, Sq = 12, 8
        q = _randn(rng, 1, Sq, 2, 16)
        k, v = (_randn(rng, 1, Sc + Sq, 2, 16) for _ in range(2))
        kw = dict(context_len=Sc, q_offset=Sc, collect_mass=True)
        _, mass = ops.flash_attention(t(q), t(k), t(v), **kw)
        _, jmass = jops.flash_attention(q, k, v, blk_q=8, blk_k=8, **kw)
        assert 0.0 < float(mass[0]) < 1.0
        np.testing.assert_allclose(mass.numpy(), np.asarray(jmass), **F32)
        # all-context keys: a query that sees only the prefix has mass 1
        _, whole = ops.flash_attention(t(q), t(k[:, :Sc]), t(v[:, :Sc]),
                                       context_len=Sc, q_offset=Sc,
                                       collect_mass=True)
        np.testing.assert_allclose(whole.numpy(), [1.0], **F32)


class TestFlashDecode:
    @pytest.mark.parametrize("B,S,Hq,Hkv,D", [
        (1, 16, 1, 1, 16),
        (2, 64, 4, 2, 32),
        (3, 40, 8, 8, 64),      # ragged
        (2, 128, 8, 2, 128),
    ])
    def test_matches_reference(self, B, S, Hq, Hkv, D):
        rng = np.random.default_rng(B * 100 + S)
        q, k, v = (_randn(rng, B, Hq, D), _randn(rng, B, S, Hkv, D),
                   _randn(rng, B, S, Hkv, D))
        kv_len = rng.integers(1, S + 1, (B,)).astype(np.int32)
        jout = jops.decode_attention(q, k, v, kv_len, blk_k=8)
        rout = decode_reference(q, k, v, kv_len=kv_len)
        out = ops.decode_attention(t(q), t(k), t(v), t(kv_len))
        np.testing.assert_allclose(out.numpy(), np.asarray(jout), **F32)
        np.testing.assert_allclose(out.numpy(), np.asarray(rout), **F32)
        jo, jm, jl = jops.decode_attention_partials(q, k, v, kv_len,
                                                    blk_k=8)
        o, m, l = ops.decode_attention_partials(t(q), t(k), t(v),
                                                t(kv_len))
        for a, b in ((o, jo), (m, jm), (l, jl)):
            assert a.dtype == torch.float32
            np.testing.assert_allclose(a.numpy(), np.asarray(b), **F32)

    def test_window(self):
        rng = np.random.default_rng(5)
        q, k, v = (_randn(rng, 2, 4, 16), _randn(rng, 2, 32, 2, 16),
                   _randn(rng, 2, 32, 2, 16))
        jout = jops.decode_attention(q, k, v, 32, window=5, blk_k=8)
        rout = decode_reference(q, k, v, kv_len=32, window=5)
        out = ops.decode_attention(t(q), t(k), t(v), 32, window=5)
        np.testing.assert_allclose(out.numpy(), np.asarray(jout), **F32)
        np.testing.assert_allclose(out.numpy(), np.asarray(rout), **F32)

    @pytest.mark.parametrize("S,blk_k", [(40, 16), (8, 256), (23, 7),
                                         (1, 8)])
    def test_unaligned_lengths(self, S, blk_k):
        """Any cache length: the port has no blocks to pad to; the
        reference is run at its own odd and clamped blocks."""
        rng = np.random.default_rng(S)
        q, k, v = (_randn(rng, 2, 4, 16), _randn(rng, 2, S, 2, 16),
                   _randn(rng, 2, S, 2, 16))
        kv_len = rng.integers(1, S + 1, (2,)).astype(np.int32)
        jout = jops.decode_attention(q, k, v, kv_len, blk_k=blk_k)
        out = ops.decode_attention(t(q), t(k), t(v), t(kv_len))
        np.testing.assert_allclose(out.numpy(), np.asarray(jout), **F32)

    def test_zero_length_rows_return_zeros(self):
        """Rows with kv_len == 0 give exact zeros, as the reference kernel
        does (``ref.decode_reference`` would average uniformly there); the
        partials of such a row are o = 0, m = -1e30, l = 0."""
        rng = np.random.default_rng(9)
        q, k, v = (_randn(rng, 3, 4, 16), _randn(rng, 3, 16, 2, 16),
                   _randn(rng, 3, 16, 2, 16))
        kv_len = np.array([0, 9, 0], np.int32)
        out = ops.decode_attention(t(q), t(k), t(v), t(kv_len)).numpy()
        jout = np.asarray(jops.decode_attention(q, k, v, kv_len, blk_k=8))
        assert np.all(np.isfinite(out))
        np.testing.assert_array_equal(out[[0, 2]], 0.0)
        np.testing.assert_allclose(out, jout, **F32)
        o, m, l = ops.decode_attention_partials(t(q), t(k), t(v),
                                                t(kv_len))
        np.testing.assert_array_equal(o[[0, 2]].numpy(), 0.0)
        np.testing.assert_array_equal(l[[0, 2]].numpy(), 0.0)
        np.testing.assert_array_equal(m[[0, 2]].numpy(), np.float32(-1e30))

    @given(st.integers(1, 4), st.integers(1, 3), st.booleans())
    @settings(max_examples=3, deadline=None)
    def test_sharded_combine_equals_full(self, n_shards, blocks, ragged):
        """Partials LSE-combined across shards == the full decode, in the
        port, and the port's partials == the reference's per shard."""
        per = 8 * blocks
        S = per * n_shards
        rng = np.random.default_rng(n_shards * 10 + blocks)
        q, k, v = (_randn(rng, 2, 4, 32), _randn(rng, 2, S, 2, 32),
                   _randn(rng, 2, S, 2, 32))
        kv_len = (rng.integers(1, S + 1, (2,)) if ragged
                  else np.full(2, S)).astype(np.int32)
        parts, jparts = [], []
        for i in range(n_shards):
            sl = slice(i * per, (i + 1) * per)
            local = np.clip(kv_len - i * per, 0, per).astype(np.int32)
            parts.append(ops.decode_attention_partials(
                t(q), t(k[:, sl]), t(v[:, sl]), t(local)))
            jparts.append(jops.decode_attention_partials(
                q, k[:, sl], v[:, sl], local, blk_k=8))
        comb = ops.combine_decode_partials(
            *(torch.stack(x) for x in zip(*parts)))
        jcomb = ref.combine_decode_partials(
            *(jnp.stack(x) for x in zip(*jparts)))
        full = ops.decode_attention(t(q), t(k), t(v), t(kv_len))
        np.testing.assert_allclose(comb.numpy(), full.numpy(), **F32)
        np.testing.assert_allclose(comb.numpy(), np.asarray(jcomb), **F32)
        for p, jp in zip(parts, jparts):
            for a, b in zip(p, jp):
                np.testing.assert_allclose(a.numpy(), np.asarray(b), **F32)


class TestWKV6:
    @staticmethod
    def _inputs(seed, B, T, H, hd, zero_state=False):
        rng = np.random.default_rng(seed)
        r, k, v = (_randn(rng, B, T, H, hd) for _ in range(3))
        w = 1.0 / (1.0 + np.exp(-_randn(rng, B, T, H, hd)))
        u = _randn(rng, H, hd)
        s0 = (np.zeros((B, H, hd, hd), np.float32) if zero_state
              else _randn(rng, B, H, hd, hd))
        return r, k, v, w.astype(np.float32), u, s0

    @pytest.mark.parametrize("B,T,H,hd,blk", [
        (1, 16, 1, 8, 8),
        (2, 40, 3, 16, 16),    # ragged T for the reference's chunks
        (1, 64, 2, 32, 32),
    ])
    def test_matches_reference(self, B, T, H, hd, blk):
        xs = self._inputs(B * 10 + T, B, T, H, hd)
        jy, js = jops.wkv6_scan(*xs, blk_t=blk)
        ry, rs = ref.wkv6_reference(*xs)
        y, s = ops.wkv6_scan(*(t(x) for x in xs))
        tol = dict(atol=1e-4, rtol=1e-4)
        for a, b in ((y, jy), (s, js), (y, ry), (s, rs)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), **tol)

    def test_state_continuation(self):
        """[0:T/2] then [T/2:T] from the carried state == the full run."""
        xs = [t(x) for x in self._inputs(4, 1, 32, 2, 16, zero_state=True)]
        r, k, v, w, u, s0 = xs
        y_full, s_full = ops.wkv6_scan(*xs)
        h = 16
        y1, s1 = ops.wkv6_scan(r[:, :h], k[:, :h], v[:, :h], w[:, :h], u, s0)
        y2, s2 = ops.wkv6_scan(r[:, h:], k[:, h:], v[:, h:], w[:, h:], u, s1)
        np.testing.assert_allclose(torch.cat([y1, y2], 1).numpy(),
                                   y_full.numpy(), atol=1e-5)
        np.testing.assert_allclose(s2.numpy(), s_full.numpy(), atol=1e-5)


@pytest.mark.parametrize("ragged", [False, True])
def test_distributed_decode_matches_reference_example(ragged):
    """``launch.distributed_decode.run`` on the CPU at a reduced size
    against the computation of examples/distributed_decode.py (reference
    partials per shard, ``ref.combine_decode_partials``) on the same
    inputs."""
    B, Hq, Hkv, D, S, n = 2, 8, 2, 64, 256, 4
    per = S // n
    kv_len = np.array([S - 37, 71], np.int32) if ragged else None
    res = distributed_decode.run(B, Hq, Hkv, D, S, n, "float32",
                                 device="cpu", seed=3, kv_len=kv_len)
    q, k, v = distributed_decode.make_inputs(B, Hq, Hkv, D, S, seed=3)
    lens = np.full(B, S, np.int32) if kv_len is None else kv_len
    jparts = [jops.decode_attention_partials(
        q, k[:, i * per:(i + 1) * per], v[:, i * per:(i + 1) * per],
        np.clip(lens - i * per, 0, per).astype(np.int32), blk_k=32)
        for i in range(n)]
    jcomb = ref.combine_decode_partials(*(jnp.stack(x)
                                          for x in zip(*jparts)))
    truth = decode_reference(q, k, v, kv_len=lens)
    np.testing.assert_allclose(res["combined"].numpy(), np.asarray(jcomb),
                               **F32)
    np.testing.assert_allclose(res["full"].numpy(), np.asarray(truth), **F32)
    assert res["max_abs_err"] < 1e-4
    assert res["shapes"] == {"o": (B, Hq, D), "m": (B, Hq), "l": (B, Hq)}
    assert res["partial_bytes_per_shard"] == 4 * (B * Hq * D + 2 * B * Hq)
    assert res["kv_bytes_per_shard"] == 2 * B * per * Hkv * D * 4


def test_cpu_paths_count_no_launch_and_other_devices_raise():
    """CPU tensors take the plain versions and count no kernel launch; a
    device that is neither CPU nor CUDA is refused, not run."""
    wrappers = (flash_attention, flash_decode, wkv6, ragged_decode)
    before = [w.launches for w in wrappers]
    rng = np.random.default_rng(0)
    q = t(_randn(rng, 1, 8, 2, 16))
    ops.flash_attention(q, q, q, collect_mass=True)
    d = t(_randn(rng, 1, 2, 16))
    kv = t(_randn(rng, 1, 8, 2, 16))
    ops.decode_attention(d, kv, kv, 8)
    ops.decode_attention_partials(d, kv, kv, 8)
    ops.ragged_decode(d, kv, kv, torch.tensor([8]))
    x = t(_randn(rng, 1, 4, 2, 8))
    ops.wkv6_scan(x, x, x, x, x[0, 0], torch.zeros(1, 2, 8, 8))
    assert [w.launches for w in wrappers] == before
    meta = lambda a: a.to("meta")                            # noqa: E731
    with pytest.raises(ValueError, match="cuda or cpu"):
        ops.flash_attention(meta(q), meta(q), meta(q))
    with pytest.raises(ValueError, match="cuda or cpu"):
        ops.decode_attention(meta(d), meta(kv), meta(kv), 8)
    with pytest.raises(ValueError, match="cuda or cpu"):
        ops.decode_attention_partials(meta(d), meta(kv), meta(kv), 8)
    with pytest.raises(ValueError, match="cuda or cpu"):
        ops.wkv6_scan(*(meta(a) for a in (x, x, x, x, x[0, 0])),
                      torch.zeros(1, 2, 8, 8, device="meta"))
