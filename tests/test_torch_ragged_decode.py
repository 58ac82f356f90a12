"""The port's ragged decode module on the CPU: its plain version (what the
wrapper runs for CPU tensors) against the reference Pallas kernel, run in
interpret mode as tests/test_ragged_decode.py runs it, and against the
reference oracle. Tolerance 2e-5 abs/rel in float32, as in that file: the
same arithmetic summed in another order. The CUDA kernel itself is held to
this plain version on the card (tests/test_torch_gpu.py, chip_smoke.py)."""
import numpy as np
import pytest
import torch

from _torch_bridge import t
from repro.kernels import ref
from repro.kernels.ragged_decode import ragged_decode as jax_ragged_decode
from repro_torch.kernels.ragged_decode import (ragged_decode,
                                               ragged_decode_reference)

TOL = dict(atol=2e-5, rtol=2e-5)


def _inputs(seed, B, S, Hq, Hkv, D):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, Hq, D)).astype(np.float32)
    k = rng.standard_normal((B, S, Hkv, D)).astype(np.float32)
    v = rng.standard_normal((B, S, Hkv, D)).astype(np.float32)
    return rng, q, k, v


@pytest.mark.parametrize("B,S,prefix_len,Hq,Hkv,D,blk_k", [
    (2, 24, 8, 4, 2, 16, 8),
    (2, 24, 8, 4, 2, 16, 7),
    (3, 5, 0, 2, 2, 32, 256),
    (2, 40, 16, 8, 2, 64, 16),
    (1, 17, 4, 6, 3, 16, 4),
])
def test_matches_reference_kernel(B, S, prefix_len, Hq, Hkv, D, blk_k):
    rng, q, k, v = _inputs(B * 100 + S, B, S, Hq, Hkv, D)
    kv_len = rng.integers(prefix_len + 1, S + 1, (B,)).astype(np.int32)
    pfx = (rng.integers(0, prefix_len + 1, (B,)).astype(np.int32)
           if prefix_len else None)
    jout = np.asarray(jax_ragged_decode(q, k, v, kv_len, pfx,
                                        prefix_len=prefix_len, blk_k=blk_k))
    rout = np.asarray(ref.ragged_decode_reference(
        q, k, v, kv_len=kv_len, prefix_lens=pfx, prefix_len=prefix_len))
    out = ragged_decode(t(q), t(k), t(v), t(kv_len),
                        None if pfx is None else t(pfx),
                        prefix_len=prefix_len).numpy()
    np.testing.assert_allclose(out, jout, **TOL)
    np.testing.assert_allclose(out, rout, **TOL)


def test_zeroed_prefix_equals_prefix_free_geometry():
    """pfx = 0 masks the whole bucket: the row attends only to its self
    segment, exactly like the same row with the bucket removed."""
    _, q, k, v = _inputs(1, 2, 24, 4, 2, 16)
    P = 8
    kv_len = np.array([P + 5, P + 9], np.int32)
    out = ragged_decode(t(q), t(k), t(v), t(kv_len),
                        torch.zeros(2, dtype=torch.int32), prefix_len=P)
    free = ragged_decode(t(q), t(k[:, P:]), t(v[:, P:]), t(kv_len - P))
    np.testing.assert_allclose(out.numpy(), free.numpy(), **TOL)
    rout = np.asarray(ref.decode_reference(q, k[:, P:], v[:, P:],
                                           kv_len=kv_len - P))
    np.testing.assert_allclose(out.numpy(), rout, **TOL)


@pytest.mark.parametrize("seed,n_dead", [(1, 1), (2, 2), (3, 4)])
def test_dead_rows_give_zeros(seed, n_dead):
    """Rows that attend nothing give exact zeros whatever their buffers
    hold, and do not disturb the live rows."""
    rng, q, k, v = _inputs(seed, 4, 24, 4, 2, 16)
    P = 8
    kv_len = rng.integers(P + 1, 25, (4,)).astype(np.int32)
    pfx = rng.integers(0, P + 1, (4,)).astype(np.int32)
    dead = rng.choice(4, size=n_dead, replace=False)
    kv_len[dead] = 0
    pfx[dead] = 0
    k[dead] = 1e4 * np.sign(rng.standard_normal(k[dead].shape))
    out = ragged_decode(t(q), t(k), t(v), t(kv_len), t(pfx),
                        prefix_len=P).numpy()
    assert np.all(np.isfinite(out))
    np.testing.assert_array_equal(out[dead], 0.0)
    live = np.setdiff1d(np.arange(4), dead)
    if len(live):
        jout = np.asarray(jax_ragged_decode(q, k, v, kv_len, pfx,
                                            prefix_len=P, blk_k=8))
        np.testing.assert_allclose(out[live], jout[live], **TOL)


def test_garbage_beyond_lengths_is_inert():
    _, q, k, v = _inputs(4, 2, 24, 4, 2, 16)
    P = 8
    kv_len = np.array([P + 4, P + 7], np.int32)
    pfx = np.array([3, 6], np.int32)
    base = ragged_decode(t(q), t(k), t(v), t(kv_len), t(pfx), prefix_len=P)
    idx = np.arange(24)
    masked = (((idx[None] < P) & (idx[None] >= pfx[:, None]))
              | (idx[None] >= kv_len[:, None]))
    poison = np.where(masked[:, :, None, None], 1e6, 0.0).astype(np.float32)
    dirty = ragged_decode(t(q), t(k + poison), t(v - poison), t(kv_len),
                          t(pfx), prefix_len=P)
    np.testing.assert_array_equal(base.numpy(), dirty.numpy())


def test_cpu_tensors_take_the_plain_version_only():
    """The CPU path is the plain version and counts no kernel launch;
    a device that is neither CPU nor CUDA is refused, not run."""
    _, q, k, v = _inputs(5, 2, 9, 4, 2, 16)
    before = ragged_decode.launches
    out = ragged_decode(t(q), t(k), t(v), torch.tensor([9, 3]))
    ref_out = ragged_decode_reference(t(q), t(k), t(v), torch.tensor([9, 3]))
    assert torch.equal(out, ref_out)
    assert ragged_decode.launches == before
    with pytest.raises(ValueError, match="cuda or cpu"):
        ragged_decode(t(q).to("meta"), t(k).to("meta"), t(v).to("meta"),
                      torch.tensor([9, 3]))
