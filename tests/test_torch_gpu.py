"""Tests that need the card: the CUDA ragged decode kernel against its
plain version, and the port's serving slice on the card. This file imports
neither jax nor the reference package, so it runs where only PyTorch is
installed:

    PYTHONPATH=src python -m pytest -q --noconftest -m gpu \\
        tests/test_torch_gpu.py

Without a card every test skips (the decision is made in the fixture).
Tolerances: float32 2e-5 abs/rel (same arithmetic, another summation
order); bf16/fp16 2e-2 relative to the largest output (the plain version
rounds the scores and probabilities to the input dtype, the kernel keeps
them in float32)."""
import types

import numpy as np
import pytest
import torch

from repro_torch.kernels.ragged_decode import (ragged_decode,
                                               ragged_decode_reference)

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    # float32 parity: no TF32 in matrix products or convolutions
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _case(dev, B, S, P, Hq, Hkv, D, dtype, seed=0, n_dead=0):
    g = torch.Generator().manual_seed(seed)
    q = torch.randn(B, Hq, D, generator=g).to(dev, dtype)
    k = torch.randn(B, S, Hkv, D, generator=g).to(dev, dtype)
    v = torch.randn(B, S, Hkv, D, generator=g).to(dev, dtype)
    kv_len = torch.randint(P + 1, S + 1, (B,), generator=g)
    pfx = torch.randint(0, P + 1, (B,), generator=g)
    kv_len[:n_dead] = 0
    pfx[:n_dead] = 0
    return (q, k, v, kv_len.to(dev, torch.int32), pfx.to(dev, torch.int32))


@pytest.mark.parametrize("B,S,P,Hq,Hkv,D", [
    (2, 24, 8, 4, 2, 16), (3, 5, 0, 2, 2, 32), (2, 40, 16, 8, 2, 64),
    (1, 17, 4, 6, 3, 16), (4, 33, 9, 4, 2, 16), (2, 70, 20, 8, 1, 256)])
def test_kernel_matches_plain_float32(cuda, B, S, P, Hq, Hkv, D):
    q, k, v, kv_len, pfx = _case(cuda, B, S, P, Hq, Hkv, D, torch.float32,
                                 n_dead=1)
    out = ragged_decode(q, k, v, kv_len, pfx, prefix_len=P)
    ref = ragged_decode_reference(q, k, v, kv_len, pfx, prefix_len=P)
    torch.cuda.synchronize()
    np.testing.assert_allclose(out.cpu().numpy(), ref.cpu().numpy(),
                               atol=2e-5, rtol=2e-5)
    assert torch.all(out[0] == 0)                     # the dead row


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_kernel_matches_plain_half(cuda, dtype):
    q, k, v, kv_len, pfx = _case(cuda, 4, 300, 128, 24, 8, 128, dtype,
                                 seed=1)
    out = ragged_decode(q, k, v, kv_len, pfx, prefix_len=128).float()
    ref = ragged_decode_reference(q, k, v, kv_len, pfx,
                                  prefix_len=128).float()
    rel = (out - ref).abs().max() / ref.abs().max()
    assert float(rel) <= 2e-2


def test_kernel_reads_through_strides_and_counts(cuda):
    """A layer slice of a stacked cache (non-contiguous batch stride) is
    read in place; every launch adds one to the counter."""
    stack = torch.randn(3, 2, 40, 2, 16, device=cuda)
    k, v = stack[1], stack[2]
    q = torch.randn(2, 4, 16, device=cuda)
    kv_len = torch.tensor([30, 12], dtype=torch.int32, device=cuda)
    before = ragged_decode.launches
    out = ragged_decode(q, k[:, :35], v[:, :35], kv_len)
    assert ragged_decode.launches == before + 1
    ref = ragged_decode_reference(q, k[:, :35].contiguous(),
                                  v[:, :35].contiguous(), kv_len)
    torch.testing.assert_close(out, ref, atol=2e-5, rtol=2e-5)


def _close(out, want, dtype):
    """float32: 2e-5 abs/rel; bf16/fp16: element by element within
    1e-2 * rms(want) + 1e-2 * |want| (the output's last rounding), against a
    plain version computed in float32."""
    out, want = out.float(), want.float()
    if dtype == torch.float32:
        torch.testing.assert_close(out, want, atol=2e-5, rtol=2e-5)
        return
    allow = 1e-2 * want.square().mean().sqrt() + 1e-2 * want.abs()
    assert bool(((out - want).abs() <= allow).all()), float(
        ((out - want).abs() / allow).max())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("G,D", [(1, 64), (3, 128), (8, 256), (3, 256),
                                 (5, 64), (2, 128), (3, 20)])
def test_split_kernel_many_splits_strided(cuda, dtype, G, D):
    """The split-KV kernel over many splits of a strided cache (a layer
    slice of a stacked (2, B, S, Hkv, D) buffer), gaps in the bucket and a
    dead row, against the plain version on the same inputs in float32.
    (D 20 in bf16/fp16 gives 40-byte rows, staged by plain loads.)"""
    g = torch.Generator().manual_seed(G * 1000 + D)
    B, S, P, Hkv = 4, 1500, 600, 2
    stack = torch.randn(2, B, S + 7, Hkv, D, generator=g).to(cuda, dtype)
    k, v = stack[0, :, :S], stack[1, :, :S]
    q = torch.randn(B, G * Hkv, D, generator=g).to(cuda, dtype)
    kv_len = torch.tensor([0, 1500, 900, 601], dtype=torch.int32,
                          device=cuda)
    pfx = torch.tensor([0, 600, 17, 0], dtype=torch.int32, device=cuda)
    out = ragged_decode(q, k, v, kv_len, pfx, prefix_len=P)
    want = ragged_decode_reference(q.float(), k.float(), v.float(), kv_len,
                                   pfx, prefix_len=P)
    torch.cuda.synchronize()
    _close(out, want, dtype)
    assert torch.all(out[0] == 0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("Hq,Hkv,D", [
    (36, 4, 128),      # starcoder2-7b: G 9, two head groups of 5 and 4
    (48, 8, 128),      # internlm2-20b: G 6 (the MAXG 8 instance)
    (64, 8, 128),      # qwen1.5-110b: G 8
    (32, 8, 160),      # pixtral-12b: D 160, 320-byte rows
    (8, 4, 256),       # gemma3-4b's global layers: G 2 at D 256
    (16, 16, 128),     # olmoe-1b-7b: MHA
    (16, 16, 64),      # whisper-medium's decoder: MHA at D 64
    (32, 2, 64),       # G 16: two full groups of 8
    (33, 3, 32)])      # G 11: groups of 6 and 5
def test_kernel_at_config_geometries(cuda, dtype, Hq, Hkv, D):
    """K1 at the (G, D) of every registered attention config and at wider
    groups than 8 (split over blocks), over a bucket with gaps, a dead row
    and many splits, against the plain version on the same inputs in
    float32; every call is one launch."""
    g = torch.Generator().manual_seed(Hq * 100 + D)
    B, S, P = 3, 1100, 400
    q = torch.randn(B, Hq, D, generator=g).to(cuda, dtype)
    k = torch.randn(B, S, Hkv, D, generator=g).to(cuda, dtype)
    v = torch.randn(B, S, Hkv, D, generator=g).to(cuda, dtype)
    kv_len = torch.tensor([0, 1100, 713], dtype=torch.int32, device=cuda)
    pfx = torch.tensor([0, 400, 133], dtype=torch.int32, device=cuda)
    before = ragged_decode.launches
    out = ragged_decode(q, k, v, kv_len, pfx, prefix_len=P)
    assert ragged_decode.launches == before + 1
    want = ragged_decode_reference(q.float(), k.float(), v.float(), kv_len,
                                   pfx, prefix_len=P)
    torch.cuda.synchronize()
    _close(out, want, dtype)
    assert torch.all(out[0] == 0)


def test_split_kernel_counts_once_and_zeroes_dead_rows(cuda):
    """One call is one launch (the split and merge kernels of one entry
    point); rows that attend nothing are exact zeros whatever the cache
    holds there."""
    B, S, P, Hq, Hkv, D = 4, 700, 256, 24, 8, 128
    q, k, v, kv_len, pfx = _case(cuda, B, S, P, Hq, Hkv, D, torch.bfloat16,
                                 seed=3)
    kv_len[1:3] = torch.tensor([0, 100], dtype=torch.int32)
    pfx[1:3] = 0                       # row 2: kv_len inside the bucket
    k[1:3] = 1e4
    before = ragged_decode.launches
    out = ragged_decode(q, k, v, kv_len, pfx, prefix_len=P)
    assert ragged_decode.launches == before + 1
    torch.cuda.synchronize()
    assert torch.all(out[1:3] == 0)
    assert bool(torch.isfinite(out.float()).all())


# --- K1's tensor-core kernel: two runs per row, 16-head tiles, bulk
# copies of whole rows (staged rows where a copy cannot take them)
def _plain_f32(q, k, v, kv_len, pfx, P):
    return ragged_decode_reference(q.float(), k.float(), v.float(), kv_len,
                                   pfx, prefix_len=P)


@pytest.fixture(params=[None, 8, 1], ids=["card", "sms8", "sms1"])
def sms(request, monkeypatch):
    """The plan on the card as it is, or as if it had 8 or 1 SMs (longer
    splits: runs that cross inside one block, one split a row)."""
    from repro_torch.kernels import ragged_decode as rd
    monkeypatch.setattr(rd, "_PLANS", {})
    if request.param is not None:
        monkeypatch.setattr(rd, "_sm_count", lambda device: request.param)
    return request.param


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("P,pfx", [
    (300, [0, 0, 0]),           # empty buckets: one run a row
    (300, [37, 100, 250]),      # the bucket's run ends inside a tile
    (300, [300, 300, 300]),     # full buckets: the runs touch
    (0, [0, 0, 0])])            # no bucket
def test_mma_run_boundaries(cuda, sms, dtype, P, pfx):
    """The bucket run and the self run of each row, wherever the bucket
    ends (at 0, inside a tile, at prefix_len, no bucket), at splits of one
    tile, of 8 tiles and of a whole row, element by element against the
    plain version in float32."""
    g = torch.Generator().manual_seed(P + sum(pfx))
    B, S, Hq, Hkv, D = 3, 900, 16, 2, 128
    q = torch.randn(B, Hq, D, generator=g).to(cuda, dtype)
    k = torch.randn(B, S, Hkv, D, generator=g).to(cuda, dtype)
    v = torch.randn(B, S, Hkv, D, generator=g).to(cuda, dtype)
    kv_len = torch.tensor([P + 77, S, P + 1], dtype=torch.int32,
                          device=cuda)
    pf = torch.tensor(pfx, dtype=torch.int32, device=cuda)
    out = ragged_decode(q, k, v, kv_len, pf, prefix_len=P)
    want = _plain_f32(q, k, v, kv_len, pf, P)
    torch.cuda.synchronize()
    _close(out, want, dtype)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16,
                                   torch.float32])
@pytest.mark.parametrize("G", [6, 8, 9, 12, 16, 17])
def test_mma_head_groups(cuda, dtype, G):
    """One 16-row tile for G up to 16 (rows 0-7 to G 8), two head groups at
    17; float32 on the CUDA cores; a dead row is exact zeros."""
    from repro_torch.kernels.ragged_decode import geometry
    g = torch.Generator().manual_seed(G)
    B, S, P, Hkv, D = 3, 700, 256, 2, 128
    q = torch.randn(B, G * Hkv, D, generator=g).to(cuda, dtype)
    k = torch.randn(B, S, Hkv, D, generator=g).to(cuda, dtype)
    v = torch.randn(B, S, Hkv, D, generator=g).to(cuda, dtype)
    kv_len = torch.tensor([0, 700, 401], dtype=torch.int32, device=cuda)
    pf = torch.tensor([0, 256, 99], dtype=torch.int32, device=cuda)
    before = ragged_decode.launches
    out = ragged_decode(q, k, v, kv_len, pf, prefix_len=P)
    assert ragged_decode.launches == before + 1
    want = _plain_f32(q, k, v, kv_len, pf, P)
    torch.cuda.synchronize()
    _close(out, want, dtype)
    assert torch.all(out[0] == 0)
    assert geometry(G, D, dtype, cuda).tensor_cores == (
        dtype != torch.float32)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16,
                                   torch.float32])
@pytest.mark.parametrize("D", [64, 80, 160, 256])
def test_mma_head_dims(cuda, dtype, D):
    """Head dims whose rows are not a multiple of 128 bytes (D 80, 160),
    and D 64 and 256, at G 9, over a bucket with gaps and a dead row."""
    g = torch.Generator().manual_seed(D)
    B, S, P, Hkv, G = 3, 600, 200, 2, 9
    q = torch.randn(B, G * Hkv, D, generator=g).to(cuda, dtype)
    k = torch.randn(B, S, Hkv, D, generator=g).to(cuda, dtype)
    v = torch.randn(B, S, Hkv, D, generator=g).to(cuda, dtype)
    kv_len = torch.tensor([600, 0, 333], dtype=torch.int32, device=cuda)
    pf = torch.tensor([200, 0, 51], dtype=torch.int32, device=cuda)
    out = ragged_decode(q, k, v, kv_len, pf, prefix_len=P)
    want = _plain_f32(q, k, v, kv_len, pf, P)
    torch.cuda.synchronize()
    _close(out, want, dtype)
    assert torch.all(out[1] == 0)


def _unaligned(x, how):
    """x's values in a view a bulk copy cannot take: a base 2 elements off
    16 bytes, or rows 4 elements apart beyond D."""
    B, S, H, D = x.shape
    if how == "base":
        buf = torch.empty(x.numel() + 2, dtype=x.dtype, device=x.device)
        view = buf[2:].view(B, S, H, D)
    else:
        view = torch.empty(B, S, H, D + 4, dtype=x.dtype,
                           device=x.device)[..., :D]
    view.copy_(x)
    return view


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("how", ["base", "stride"])
def test_mma_staged_rows(cuda, dtype, how):
    """K/V views whose base or row stride is not a multiple of 16 bytes are
    staged by the producer warp's plain loads: same kernel, same result."""
    g = torch.Generator().manual_seed(7)
    B, S, P, Hq, Hkv, D = 3, 500, 128, 24, 8, 128
    q = torch.randn(B, Hq, D, generator=g).to(cuda, dtype)
    k = torch.randn(B, S, Hkv, D, generator=g).to(cuda, dtype)
    v = torch.randn(B, S, Hkv, D, generator=g).to(cuda, dtype)
    ku, vu = _unaligned(k, how), _unaligned(v, how)
    assert ku.data_ptr() % 16 or any(
        (st * ku.element_size()) % 16 for st in ku.stride()[:3])
    kv_len = torch.tensor([500, 0, 300], dtype=torch.int32, device=cuda)
    pf = torch.tensor([100, 0, 128], dtype=torch.int32, device=cuda)
    out = ragged_decode(q, ku, vu, kv_len, pf, prefix_len=P)
    want = _plain_f32(q, k, v, kv_len, pf, P)
    torch.cuda.synchronize()
    _close(out, want, dtype)
    assert torch.all(out[1] == 0)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16,
                                   torch.float32])
@pytest.mark.parametrize("how", [None, "stride"])
def test_nan_past_lengths_is_inert(cuda, dtype, how):
    """NaN in every K and V row a row does not attend (the bucket's gap and
    everything past kv_len) reaches nothing: the output equals the run on
    zeros there, and dead rows stay exact zeros (the card twin of
    test_torch_ragged_decode's test_garbage_beyond_lengths_is_inert)."""
    g = torch.Generator().manual_seed(11)
    B, S, P, Hq, Hkv, D = 4, 700, 256, 36, 4, 128
    q = torch.randn(B, Hq, D, generator=g).to(cuda, dtype)
    k = torch.randn(B, S, Hkv, D, generator=g).to(cuda, dtype)
    v = torch.randn(B, S, Hkv, D, generator=g).to(cuda, dtype)
    kv_len = torch.tensor([290, 0, 700, 256], dtype=torch.int32,
                          device=cuda)
    pf = torch.tensor([13, 0, 256, 200], dtype=torch.int32, device=cuda)
    idx = torch.arange(S, device=cuda)[None]
    dead = ~torch.where(idx < P, idx < pf[:, None], idx < kv_len[:, None])
    dead = dead[:, :, None, None]
    clean = ragged_decode(q, k.masked_fill(dead, 0), v.masked_fill(dead, 0),
                          kv_len, pf, prefix_len=P)
    kn, vn = k.masked_fill(dead, float("nan")), v.masked_fill(dead,
                                                              float("nan"))
    if how is not None:
        kn, vn = _unaligned(kn, how), _unaligned(vn, how)
    out = ragged_decode(q, kn, vn, kv_len, pf, prefix_len=P)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(out.float()).all())
    assert torch.equal(out, clean)
    assert torch.all(out[1] == 0)


def test_scheduler_on_card_matches_serial(cuda):
    """The slice on the card at a small float32 size: the scheduler on the
    kernel backend is token-identical to serve_serial on the plain one."""
    import dataclasses
    from repro_torch.comm import Agent, CommSession, InMemoryTransport
    from repro_torch.configs.registry import get_config
    from repro_torch.core.types import KVCommConfig
    from repro_torch.data.synthetic import SyntheticTask, TaskConfig
    from repro_torch.data.tokenizer import SymbolTokenizer
    from repro_torch.models import transformer as tfm
    from repro_torch.serving.scheduler import (Scheduler, SchedulerConfig,
                                               make_requests, serve_serial)
    tok = SymbolTokenizer(16, 8)
    cfg = dataclasses.replace(
        get_config("llama3.2-3b-pair"), num_layers=4, d_model=64, d_ff=128,
        num_heads=4, num_kv_heads=2, head_dim=16, vocab_size=tok.vocab_size,
        dtype="float32", tie_embeddings=False)
    params = tfm.init_params(cfg, 0, device=cuda)
    sess = CommSession(Agent("s", cfg, params, tok),
                       Agent("r", cfg, params, tok), InMemoryTransport())
    batches = [SyntheticTask(tok, TaskConfig("retrieval", num_facts=nf,
                                             seed=11 + nf)).batch(3)
               for nf in (4, 8)]
    reqs = make_requests(batches, pad=tok.PAD)
    for i, r in enumerate(reqs):
        r.max_new = (4, 2, 1)[i % 3]
    kvcfg = KVCommConfig(ratio=0.5, selector="prior_only")
    ser, _ = serve_serial(sess, reqs, kvcfg)
    before = ragged_decode.launches
    got, stats = Scheduler(sess, kvcfg, config=SchedulerConfig(
        capacity=3, prefix_bucket=8, query_bucket=4,
        decode_backend="kernel")).run(reqs)
    assert ragged_decode.launches - before > 0
    for a, b in zip(ser, got):
        np.testing.assert_array_equal(a.tokens, b.tokens)


# --- K2 flash_attention, K3 flash_decode, K4 wkv6 against their plain
# versions (same tolerances as above; RWKV6 1e-4 as in the reference's
# tests, for a recurrence over up to 100 steps)

def _randn(dev, dtype, *shape, seed=0):
    g = torch.Generator().manual_seed(seed)
    return torch.randn(*shape, generator=g).to(dev, dtype)


@pytest.mark.parametrize("B,Sq,Sc,Hq,Hkv,D,causal,window,mass", [
    (1, 8, 0, 1, 1, 16, True, None, False),
    (2, 24, 16, 4, 2, 32, True, None, True),
    (1, 17, 5, 6, 3, 64, True, None, True),
    (1, 12, 0, 2, 2, 16, False, None, False),   # non-causal, unaligned
    (1, 9, 5, 2, 1, 16, False, None, True),     # non-causal with context
    (1, 70, 0, 2, 2, 16, True, 9, False),       # sliding window
    (2, 100, 30, 4, 2, 128, True, 40, True),
    (1, 65, 0, 2, 1, 256, True, None, False),   # D 256: the 32-row tiles
])
def test_flash_attention_matches_plain_float32(cuda, B, Sq, Sc, Hq, Hkv, D,
                                               causal, window, mass):
    from repro_torch.kernels.flash_attention import (
        flash_attention, flash_attention_reference)
    q = _randn(cuda, torch.float32, B, Sq, Hq, D, seed=1)
    k = _randn(cuda, torch.float32, B, Sc + Sq, Hkv, D, seed=2)
    v = _randn(cuda, torch.float32, B, Sc + Sq, Hkv, D, seed=3)
    kw = dict(context_len=Sc, q_offset=Sc, causal=causal, window=window,
              collect_mass=mass)
    before = flash_attention.launches
    out, m = flash_attention(q, k, v, **kw)
    assert flash_attention.launches == before + 1
    ref, rm = flash_attention_reference(q, k, v, **kw)
    torch.cuda.synchronize()
    torch.testing.assert_close(out, ref, atol=2e-5, rtol=2e-5)
    if mass:
        torch.testing.assert_close(m, rm, atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_flash_attention_matches_plain_half(cuda, dtype):
    from repro_torch.kernels.flash_attention import (
        flash_attention, flash_attention_reference)
    q = _randn(cuda, dtype, 2, 96, 24, 128, seed=4)
    k = _randn(cuda, dtype, 2, 96 + 200, 8, 128, seed=5)
    v = _randn(cuda, dtype, 2, 96 + 200, 8, 128, seed=6)
    kw = dict(context_len=200, q_offset=200, collect_mass=True)
    out, m = flash_attention(q, k, v, **kw)
    ref, rm = flash_attention_reference(q, k, v, **kw)
    rel = (out.float() - ref.float()).abs().max() / ref.float().abs().max()
    assert float(rel) <= 2e-2
    torch.testing.assert_close(m, rm, atol=2e-3, rtol=2e-2)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("B,Sq,Sc,Hq,Hkv,D,causal,window,mass", [
    (1, 130, 0, 6, 2, 64, True, None, False),      # GQA packing, D 64
    (2, 96, 200, 24, 8, 128, True, None, True),    # mass, D 128
    (1, 200, 0, 8, 4, 256, True, None, False),     # D 256: 32-row KV tiles
    (1, 300, 0, 8, 4, 256, True, 100, False),      # window at D 256
    (1, 150, 50, 4, 1, 128, True, 70, True),       # window over the context
    (2, 16, 2049, 24, 8, 128, True, None, True),   # the split path
    (1, 1, 2049, 8, 1, 64, True, None, True),      # one row, split, G 8
    (1, 45, 19, 3, 3, 32, False, None, True),      # non-causal, unaligned
    (2, 70, 0, 2, 2, 192, True, None, False),      # D 192
])
def test_flash_attention_tensor_cores(cuda, dtype, B, Sq, Sc, Hq, Hkv, D,
                                      causal, window, mass):
    """The bf16/fp16 kernel (wgmma, TMA, GQA rows packed per KV head, the
    split path where the grid is small) against the plain version computed
    in float32 on the same inputs; the mass within 1e-4."""
    from repro_torch.kernels.flash_attention import (
        flash_attention, flash_attention_reference)
    q = _randn(cuda, dtype, B, Sq, Hq, D, seed=21)
    k = _randn(cuda, dtype, B, Sc + Sq, Hkv, D, seed=22)
    v = _randn(cuda, dtype, B, Sc + Sq, Hkv, D, seed=23)
    kw = dict(context_len=Sc, q_offset=Sc, causal=causal, window=window,
              collect_mass=mass)
    before = flash_attention.launches
    out, m = flash_attention(q, k, v, **kw)
    assert flash_attention.launches == before + 1
    ref, rm = flash_attention_reference(q.float(), k.float(), v.float(),
                                        **kw)
    torch.cuda.synchronize()
    _close(out, ref, dtype)
    if mass:
        torch.testing.assert_close(m, rm, atol=1e-4, rtol=0)


def test_flash_attention_rejects_what_tma_cannot_describe(cuda):
    """bf16 K/V are read by TMA: a view whose base or strides are not
    16-byte multiples, or a head dim that is not a multiple of 16, raises
    instead of running."""
    from repro_torch.kernels.flash_attention import flash_attention
    q = torch.randn(1, 8, 2, 64, device=cuda, dtype=torch.bfloat16)
    buf = torch.randn(1, 8, 2, 72, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="16 bytes"):
        flash_attention(q, buf[..., 1:65], buf[..., 1:65])   # base + 2 B
    odd = torch.randn(1, 8, 2, 67, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="16 bytes"):
        flash_attention(q, odd[..., :64], odd[..., :64])     # stride 134 B
    q24 = torch.randn(1, 8, 2, 24, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="multiple of 16"):
        flash_attention(q24, q24, q24)


def test_flash_attention_reads_strided_inputs(cuda):
    """Views of a stacked (3, B, S, H, D) tensor with their heads sliced are
    read in place through strides."""
    from repro_torch.kernels.flash_attention import (
        flash_attention, flash_attention_reference)
    stack = torch.randn(3, 2, 40, 6, 32, device=cuda)
    q, k, v = stack[0, :, :, :4], stack[1, :, :, :2], stack[2, :, :, 2:4]
    assert not q.is_contiguous()
    out, m = flash_attention(q, k, v, context_len=8, q_offset=8,
                             collect_mass=True)
    ref, rm = flash_attention_reference(
        q.contiguous(), k.contiguous(), v.contiguous(), context_len=8,
        q_offset=8, collect_mass=True)
    torch.testing.assert_close(out, ref, atol=2e-5, rtol=2e-5)
    torch.testing.assert_close(m, rm, atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("B,S,Hq,Hkv,D,window", [
    (3, 40, 4, 2, 16, None), (2, 300, 8, 2, 64, None),
    (4, 1000, 24, 8, 128, None), (2, 700, 8, 4, 256, 100),
    (3, 33, 6, 6, 32, 5), (2, 5000, 8, 1, 64, 1024)])
def test_flash_decode_matches_plain_float32(cuda, B, S, Hq, Hkv, D, window):
    """Normalised and partial outputs, dead rows (kv_len 0) included, over
    lengths that split each row over several blocks."""
    from repro_torch.kernels.flash_decode import (
        decode_partial_reference, flash_decode, flash_decode_partials,
        flash_decode_reference)
    q = _randn(cuda, torch.float32, B, Hq, D, seed=7)
    k = _randn(cuda, torch.float32, B, S, Hkv, D, seed=8)
    v = _randn(cuda, torch.float32, B, S, Hkv, D, seed=9)
    g = torch.Generator().manual_seed(10)
    kv_len = torch.randint(1, S + 1, (B,), generator=g)
    kv_len[0] = 0
    kv_len = kv_len.to(cuda, torch.int32)
    before = flash_decode.launches
    out = flash_decode(q, k, v, kv_len, window=window)
    o, m, l = flash_decode_partials(q, k, v, kv_len, window=window)
    assert flash_decode.launches == before + 2
    ref = flash_decode_reference(q, k, v, kv_len, window=window)
    ro, rm, rl = decode_partial_reference(q, k, v, kv_len, window=window)
    torch.cuda.synchronize()
    torch.testing.assert_close(out, ref, atol=2e-5, rtol=2e-5)
    assert torch.all(out[0] == 0) and torch.all(l[0] == 0)
    for a, b in ((o, ro), (m, rm), (l, rl)):
        torch.testing.assert_close(a, b, atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_flash_decode_matches_plain_half(cuda, dtype):
    from repro_torch.kernels.flash_decode import (flash_decode,
                                                  flash_decode_reference)
    q = _randn(cuda, dtype, 4, 24, 128, seed=11)
    k = _randn(cuda, dtype, 4, 3000, 8, 128, seed=12)
    v = _randn(cuda, dtype, 4, 3000, 8, 128, seed=13)
    kv_len = torch.tensor([3000, 17, 1500, 2999], dtype=torch.int32,
                          device=cuda)
    out = flash_decode(q, k, v, kv_len).float()
    ref = flash_decode_reference(q, k, v, kv_len).float()
    assert float((out - ref).abs().max() / ref.abs().max()) <= 2e-2


def test_flash_decode_reads_strided_cache(cuda):
    """A layer slice of a stacked cache is read in place; every launch adds
    one to the counter."""
    from repro_torch.kernels.flash_decode import (flash_decode,
                                                  flash_decode_reference)
    stack = torch.randn(3, 2, 300, 2, 64, device=cuda)
    k, v = stack[1, :, :250], stack[2, :, :250]
    q = torch.randn(2, 6, 64, device=cuda)
    before = flash_decode.launches
    out = flash_decode(q, k, v, 200, window=77)
    assert flash_decode.launches == before + 1
    ref = flash_decode_reference(q, k.contiguous(), v.contiguous(), 200,
                                 window=77)
    torch.testing.assert_close(out, ref, atol=2e-5, rtol=2e-5)


# --- K3 (fixed chunks, TMA ring, shared merge): every dtype, D 64-256, G
# 1-8, many chunks, windows, sharded slices and staged rows

def _decode_inputs(dev, dtype, B, S, Hq, Hkv, D, seed):
    return (_randn(dev, dtype, B, Hq, D, seed=seed),
            _randn(dev, dtype, B, S, Hkv, D, seed=seed + 1),
            _randn(dev, dtype, B, S, Hkv, D, seed=seed + 2))


def _check_decode(q, k, v, kv_len, window=None):
    """Normalised output and partials against the plain versions on the
    same inputs in float32 (m and l at 2e-5, o as stated below); one launch
    each; dead rows exact zeros."""
    from repro_torch.kernels.flash_decode import (
        decode_partial_reference, flash_decode, flash_decode_partials,
        flash_decode_reference)
    before = flash_decode.launches
    out = flash_decode(q, k, v, kv_len, window=window)
    o, m, l = flash_decode_partials(q, k, v, kv_len, window=window)
    assert flash_decode.launches == before + 2
    qf, kf, vf = q.float(), k.float(), v.float()
    want = flash_decode_reference(qf, kf, vf, kv_len, window=window)
    ro, rm, rl = decode_partial_reference(qf, kf, vf, kv_len, window=window)
    torch.cuda.synchronize()
    _close(out, want, q.dtype)
    # bf16/fp16 run P V on the tensor cores with P as a 16-bit high part
    # plus the rounding of its residual (~2^-17 relative), so the
    # unnormalised o, a sum with cancellation, is held at 2e-5 of its rms
    o_atol = 2e-5 * (1.0 if q.dtype == torch.float32
                     else float(ro.square().mean().sqrt()))
    torch.testing.assert_close(o, ro, atol=o_atol, rtol=2e-5)
    for a, b in ((m, rm), (l, rl)):
        torch.testing.assert_close(a, b, atol=2e-5, rtol=2e-5)
    dead = (rl == 0).all(-1)
    assert torch.all(out[dead] == 0) and torch.all(l[dead] == 0)
    assert torch.all(m[dead] == -1e30)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("G,D", [(1, 64), (3, 128), (8, 256), (5, 64),
                                 (2, 256), (4, 128)])
def test_flash_decode_fixed_chunks(cuda, dtype, G, D):
    """Five chunks and a part per row, rows of every length class: dead,
    one position, on and off a chunk boundary, the whole cache, kv_len
    past S; read by TMA."""
    from repro_torch.kernels.flash_decode import chunk_positions, uses_tma
    c = chunk_positions(D, dtype)
    B, S, Hkv = 6, 5 * c + 37, 2
    q, k, v = _decode_inputs(cuda, dtype, B, S, G * Hkv, Hkv, D,
                             seed=G + D)
    kv_len = torch.tensor([0, 1, 2 * c, 2 * c + 5, S, S + 400],
                          dtype=torch.int32, device=cuda)
    assert uses_tma(k, v)
    _check_decode(q, k, v, kv_len)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("window", [1, 37, 100, 1024])
def test_flash_decode_windows(cuda, dtype, window):
    """Windows shorter and longer than a chunk, with rows shorter than the
    window, rows whose window starts mid-chunk and kv_len past S."""
    B, S, Hq, Hkv, D = 5, 2500, 8, 4, 128
    q, k, v = _decode_inputs(cuda, dtype, B, S, Hq, Hkv, D, seed=window)
    kv_len = torch.tensor([0, 50, 1777, 2500, 2600], dtype=torch.int32,
                          device=cuda)
    _check_decode(q, k, v, kv_len, window=window)


def test_flash_decode_sharded_slices_by_tma(cuda):
    """The sharded decode's sequence slices k[:, i*per:(i+1)*per] are
    strided views that the tensor maps take as they are."""
    from repro_torch.kernels.flash_decode import uses_tma
    B, S, Hq, Hkv, D, n = 3, 4096, 24, 8, 128, 4
    q, k, v = _decode_inputs(cuda, torch.bfloat16, B, S, Hq, Hkv, D, seed=3)
    lens = torch.tensor([4096, 2049, 17], dtype=torch.int32, device=cuda)
    per = S // n
    for i in range(n):
        ks, vs = k[:, i * per:(i + 1) * per], v[:, i * per:(i + 1) * per]
        assert not ks.is_contiguous() and uses_tma(ks, vs)
        _check_decode(q, ks, vs, (lens - i * per).clamp(0, per))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16,
                                   torch.float32])
def test_flash_decode_stages_what_tma_cannot_describe(cuda, dtype):
    """Rows a tensor map cannot describe are staged in the same kernel, not
    refused: 24-byte rows (D 12 in bf16/fp16, D 6 in float32) and a cache
    whose base sits 8 bytes past a 16-byte boundary."""
    from repro_torch.kernels.flash_decode import uses_tma
    D = 12 if dtype != torch.float32 else 6
    q, k, v = _decode_inputs(cuda, dtype, 3, 700, 6, 2, D, seed=5)
    lens = torch.tensor([700, 0, 333], dtype=torch.int32, device=cuda)
    assert not uses_tma(k, v)
    _check_decode(q, k, v, lens, window=500)
    off = 8 // q.element_size()
    buf = _randn(cuda, dtype, 2, 3, 900, 2, 64 + off, seed=6)
    k, v = buf[0, ..., off:], buf[1, ..., off:]
    q = _randn(cuda, dtype, 3, 8, 64, seed=7)
    assert not uses_tma(k, v)
    _check_decode(q, k, v, torch.tensor([900, 1, 513], dtype=torch.int32,
                                        device=cuda))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("G,D", [(9, 128), (16, 64), (12, 256)])
@pytest.mark.parametrize("window", [None, 300])
def test_flash_decode_wide_groups(cuda, dtype, G, D, window):
    """F7: groups of more than 8 query heads per KV head split into head
    groups of at most 8 (9 -> 5 + 4, 16 -> 8 + 8, 12 -> 6 + 6), normalised
    and partials, with a window and without, read by TMA; rows of every
    length class over several chunks."""
    from repro_torch.kernels.flash_decode import chunk_positions, uses_tma
    c = chunk_positions(D, dtype)
    B, S, Hkv = 4, 2 * c + 37, 2
    q, k, v = _decode_inputs(cuda, dtype, B, S, G * Hkv, Hkv, D,
                             seed=G * 10 + D)
    kv_len = torch.tensor([0, 1, c + 5, S], dtype=torch.int32, device=cuda)
    assert uses_tma(k, v)
    _check_decode(q, k, v, kv_len, window=window)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16,
                                   torch.float32])
@pytest.mark.parametrize("G", [9, 16])
def test_flash_decode_wide_groups_staged(cuda, dtype, G):
    """F7 on the staged route: 24-byte rows no tensor map describes."""
    from repro_torch.kernels.flash_decode import uses_tma
    D = 12 if dtype != torch.float32 else 6
    q, k, v = _decode_inputs(cuda, dtype, 3, 700, G * 2, 2, D, seed=G)
    assert not uses_tma(k, v)
    _check_decode(q, k, v, torch.tensor([700, 0, 333], dtype=torch.int32,
                                        device=cuda), window=500)


def test_flash_decode_dead_rows_zero_and_counts_once(cuda):
    """One call is one launch (split and merge kernels of one entry point);
    rows that attend nothing are exact zeros whatever the cache holds."""
    from repro_torch.kernels.flash_decode import flash_decode
    q, k, v = _decode_inputs(cuda, torch.bfloat16, 4, 2000, 24, 8, 128,
                             seed=9)
    k[1:3] = 1e4
    v[1:3] = float("nan")
    lens = torch.tensor([2000, 0, 0, 999], dtype=torch.int32, device=cuda)
    before = flash_decode.launches
    out = flash_decode(q, k, v, lens)
    assert flash_decode.launches == before + 1
    torch.cuda.synchronize()
    assert torch.all(out[1:3] == 0)
    assert bool(torch.isfinite(out.float()).all())


@pytest.mark.parametrize("B,T,H,hd", [(1, 16, 1, 8), (2, 40, 3, 16),
                                      (1, 64, 2, 32), (2, 100, 2, 64),
                                      (1, 20, 1, 128)])
def test_wkv6_matches_plain(cuda, B, T, H, hd):
    from repro_torch.kernels.rwkv_scan import wkv6, wkv6_reference
    r, k, v = (_randn(cuda, torch.float32, B, T, H, hd, seed=s)
               for s in (14, 15, 16))
    w = torch.sigmoid(_randn(cuda, torch.float32, B, T, H, hd, seed=17))
    u = _randn(cuda, torch.float32, H, hd, seed=18)
    s0 = _randn(cuda, torch.float32, B, H, hd, hd, seed=19)
    before = wkv6.launches
    y, s = wkv6(r, k, v, w, u, s0)
    assert wkv6.launches == before + 1
    ry, rs = wkv6_reference(r, k, v, w, u, s0)
    torch.cuda.synchronize()
    torch.testing.assert_close(y, ry, atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(s, rs, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("B,T,H,hd", [(4, 100, 32, 64), (2, 77, 8, 128),
                                      (1, 33, 40, 32), (3, 65, 5, 16),
                                      (2, 31, 7, 8)])
def test_wkv6_column_blocks_many_heads(cuda, B, T, H, hd):
    """B*H small and large, T off the 32-step chunk, every head dim's
    column split."""
    from repro_torch.kernels.rwkv_scan import wkv6, wkv6_reference
    r, k, v = (_randn(cuda, torch.float32, B, T, H, hd, seed=s)
               for s in (24, 25, 26))
    w = torch.sigmoid(_randn(cuda, torch.float32, B, T, H, hd, seed=27))
    u = _randn(cuda, torch.float32, H, hd, seed=28)
    s0 = _randn(cuda, torch.float32, B, H, hd, hd, seed=29)
    y, s = wkv6(r, k, v, w, u, s0)
    ry, rs = wkv6_reference(r, k, v, w, u, s0)
    torch.cuda.synchronize()
    torch.testing.assert_close(y, ry, atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(s, rs, atol=1e-4, rtol=1e-4)


def test_wkv6_stages_unaligned_inputs(cuda):
    """Inputs whose base is not 16-byte aligned are staged by plain loads
    through the same buffers."""
    from repro_torch.kernels.rwkv_scan import wkv6, wkv6_reference
    buf = torch.randn(4, 2, 45, 3, 33, device=cuda)
    r, k, v, w = (buf[i, ..., 1:] for i in range(4))
    w = torch.sigmoid(w)
    u = torch.randn(3, 32, device=cuda)
    s0 = torch.randn(2, 3, 32, 32, device=cuda)
    y, s = wkv6(r, k, v, w, u, s0)
    ry, rs = wkv6_reference(r, k, v, w, u, s0)
    torch.testing.assert_close(y, ry, atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(s, rs, atol=1e-4, rtol=1e-4)


def test_wkv6_reads_strided_inputs(cuda):
    """(B, H, T, hd) tensors transposed to (B, T, H, hd) are read in place."""
    from repro_torch.kernels.rwkv_scan import wkv6, wkv6_reference
    r, k, v, w = (torch.randn(2, 3, 50, 16, device=cuda).transpose(1, 2)
                  for _ in range(4))
    w = torch.sigmoid(w)
    u = torch.randn(3, 16, device=cuda)
    s0 = torch.zeros(2, 3, 16, 16, device=cuda)
    y, s = wkv6(r, k, v, w, u, s0)
    ry, rs = wkv6_reference(r, k, v, w, u, s0)
    torch.testing.assert_close(y, ry, atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(s, rs, atol=1e-4, rtol=1e-4)


def _wkv_inputs(dev, B, T, H, hd, decay, seed):
    """K4 inputs from a seed: ``sigmoid`` decays, the model's law
    exp(-exp(x)) with x uniform in [-6, 6] (exact zeros and w near 1), or
    slow decays in [0.99, 1)."""
    g = torch.Generator().manual_seed(seed)
    r, k, v = (torch.randn(B, T, H, hd, generator=g) for _ in range(3))
    x = torch.rand(B, T, H, hd, generator=g)
    w = {"sigmoid": lambda: torch.sigmoid(12 * x - 6),
         "law": lambda: torch.exp(-torch.exp(12 * x - 6)),
         "slow": lambda: 0.99 + 0.01 * x}[decay]()
    u = torch.randn(H, hd, generator=g)
    s0 = 0.1 * torch.randn(B, H, hd, hd, generator=g)
    return [t.to(dev) for t in (r, k, v, w, u, s0)]


def _within_rms_rule(got, want, tol=1e-4):
    """|kernel - plain| <= tol * rms(plain) + tol * |plain|, element by
    element (chip_smoke.py's rule)."""
    allow = tol * want.square().mean().sqrt() + tol * want.abs()
    return bool(((got - want).abs() <= allow).all())


@pytest.mark.parametrize("B,T,H,decay", [
    (4, 2049, 32, "law"),       # rwkv6-1.6b's prefill, exact zeros in w
    (4, 2049, 32, "slow"),      # state growing over 2,049 steps
    (1, 8192, 32, "sigmoid"),   # one row's long prefill (time segments)
])
def test_wkv6_chunked_at_long_prefills(cuda, B, T, H, decay):
    """The chunked kernel at the served widths (heads of 64) against the
    plain scan, with the decay laws that stress its factoring."""
    from repro_torch.kernels.rwkv_scan import plan, wkv6, wkv6_reference
    r, k, v, w, u, s0 = _wkv_inputs(cuda, B, T, H, 64, decay, seed=T + B)
    if decay == "law":
        assert bool((w == 0).any())
    assert plan(B, T, H, 64, cuda)[0] == "chunk"
    y, s = wkv6(r, k, v, w, u, s0)
    ry, rs = wkv6_reference(r, k, v, w, u, s0)
    torch.cuda.synchronize()
    assert _within_rms_rule(y, ry) and _within_rms_rule(s, rs)


@pytest.mark.parametrize("dT", [-15, -1, 0, 1, 2, 48])
def test_wkv6_both_regimes(cuda, dT):
    """T on both sides of the plan's threshold: the streaming kernel at
    T <= STREAM_MAX_T, the chunked one above (T 1 and the receiver's 16
    included), at the served heads and with the model's decay law."""
    from repro_torch.kernels.rwkv_scan import (STREAM_MAX_T, plan, wkv6,
                                               wkv6_reference)
    T = STREAM_MAX_T + dT
    r, k, v, w, u, s0 = _wkv_inputs(cuda, 4, T, 32, 64, "law", seed=T)
    want = "stream" if T <= STREAM_MAX_T else "chunk"
    assert plan(4, T, 32, 64, cuda)[0] == want
    y, s = wkv6(r, k, v, w, u, s0)
    ry, rs = wkv6_reference(r, k, v, w, u, s0)
    torch.cuda.synchronize()
    torch.testing.assert_close(y, ry, atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(s, rs, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("hd", [8, 16, 32, 64, 128])
def test_wkv6_chunked_every_head_dim(cuda, monkeypatch, hd):
    """The chunked kernel at each head dim (the plan forced: whole heads,
    one segment), T off the chunk, the model's decay law."""
    from repro_torch.kernels import rwkv_scan
    monkeypatch.setattr(rwkv_scan, "plan", lambda *args: ("chunk", 1))
    r, k, v, w, u, s0 = _wkv_inputs(cuda, 2, 150, 3, hd, "law", seed=hd)
    y, s = rwkv_scan.wkv6(r, k, v, w, u, s0)
    ry, rs = rwkv_scan.wkv6_reference(r, k, v, w, u, s0)
    torch.cuda.synchronize()
    torch.testing.assert_close(y, ry, atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(s, rs, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("hd,T,nseg", [(64, 1000, 2), (64, 1000, 3),
                                       (64, 2049, 4), (128, 777, 3),
                                       (16, 300, 5), (8, 129, 2)])
def test_wkv6_time_segments(cuda, monkeypatch, hd, T, nseg):
    """The chunked kernel with a head's steps in time segments of whole
    chunks (the state pass, then the output pass), the plan forced, the
    model's decay law, a non-zero s0; the last segment short."""
    from repro_torch.kernels import rwkv_scan
    monkeypatch.setattr(rwkv_scan, "plan", lambda *args: ("chunk", nseg))
    r, k, v, w, u, s0 = _wkv_inputs(cuda, 2, T, 3, hd, "law", seed=T + hd)
    y, s = rwkv_scan.wkv6(r, k, v, w, u, s0)
    ry, rs = rwkv_scan.wkv6_reference(r, k, v, w, u, s0)
    torch.cuda.synchronize()
    torch.testing.assert_close(y, ry, atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(s, rs, atol=1e-4, rtol=1e-4)


def test_wkv6_time_segments_stage_unaligned_inputs(cuda, monkeypatch):
    """Time segments through the staged route (a base off 16 bytes)."""
    from repro_torch.kernels import rwkv_scan
    monkeypatch.setattr(rwkv_scan, "plan", lambda *args: ("chunk", 3))
    buf = torch.randn(4, 2, 450, 3, 65, device=cuda)
    r, k, v, w = (buf[i, ..., 1:] for i in range(4))
    w = torch.sigmoid(w)
    u = torch.randn(3, 64, device=cuda)
    s0 = torch.randn(2, 3, 64, 64, device=cuda)
    y, s = rwkv_scan.wkv6(r, k, v, w, u, s0)
    ry, rs = rwkv_scan.wkv6_reference(r, k, v, w, u, s0)
    torch.testing.assert_close(y, ry, atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(s, rs, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("C,Q", [(150, 16), (128, 16), (2049, 40)])
def test_wkv6_continued_call_matches_one_call(cuda, C, Q):
    """A call over [C; Q] and a call over C, then one over Q from its
    state, give the same y for Q and the same state, bit for bit (the steps
    past a call's last whole chunk are streamed), as the sequential scan
    does: what state sharing's skyline compares."""
    from repro_torch.kernels.rwkv_scan import wkv6
    r, k, v, w, u, s0 = _wkv_inputs(cuda, 2, C + Q, 4, 64, "law", seed=C)
    y, s = wkv6(r, k, v, w, u, s0)
    _, sc = wkv6(*(x[:, :C] for x in (r, k, v, w)), u, s0)
    yq, sq = wkv6(*(x[:, C:] for x in (r, k, v, w)), u, sc)
    torch.cuda.synchronize()
    assert torch.equal(y[:, C:], yq) and torch.equal(s, sq)


@pytest.mark.parametrize("layout", ["strided", "unaligned"])
def test_wkv6_chunk_tail_reads_strided_and_unaligned_inputs(cuda, layout):
    """The steps past the last whole chunk, streamed by the chunked
    kernel's blocks, read transposed (16-byte copies) and unaligned (4-byte
    copies) inputs."""
    from repro_torch.kernels.rwkv_scan import plan, wkv6, wkv6_reference
    T = 150
    if layout == "strided":
        r, k, v, w = (torch.randn(2, 3, T, 64, device=cuda).transpose(1, 2)
                      for _ in range(4))
    else:
        buf = torch.randn(4, 2, T, 3, 65, device=cuda)
        r, k, v, w = (buf[i, ..., 1:] for i in range(4))
    w = torch.sigmoid(w)
    u = torch.randn(3, 64, device=cuda)
    s0 = torch.randn(2, 3, 64, 64, device=cuda)
    assert plan(2, T, 3, 64, cuda)[0] == "chunk"
    y, s = wkv6(r, k, v, w, u, s0)
    ry, rs = wkv6_reference(r, k, v, w, u, s0)
    torch.testing.assert_close(y, ry, atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(s, rs, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("T", [0, 5])
def test_wkv6_streams_unaligned_and_strided_inputs(cuda, T):
    """The streaming kernel reads any base and stride (4-byte copies); an
    unaligned state is copied to an aligned one; T 0 passes s0 through."""
    from repro_torch.kernels.rwkv_scan import wkv6, wkv6_reference
    buf = torch.randn(4, 2, T, 3, 33, device=cuda)
    r, k, v, w = (buf[i, ..., 1:] for i in range(4))
    w = torch.sigmoid(w)
    u = torch.randn(3, 32, device=cuda)
    s0 = torch.randn(2 * 3 * 32 * 32 + 1, device=cuda)[1:].view(2, 3, 32, 32)
    y, s = wkv6(r, k, v, w, u, s0)
    ry, rs = wkv6_reference(r, k, v, w, u, s0)
    assert y.shape == (2, T, 3, 32)
    torch.testing.assert_close(y, ry, atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(s, rs, atol=1e-4, rtol=1e-4)


def test_distributed_decode_on_card(cuda):
    """The sharded decode: one K3 launch per shard plus one for the
    monolithic decode, and the combine agrees with it."""
    from repro_torch.kernels.flash_decode import flash_decode
    from repro_torch.launch import distributed_decode
    before = flash_decode.launches
    res = distributed_decode.run(4, 24, 8, 128, 4096, 8, "float32",
                                 device="cuda", seed=1,
                                 kv_len=np.array([4096, 3000, 17, 2049]))
    assert flash_decode.launches == before + 9
    assert res["max_abs_err"] < 1e-4


def test_distributed_decode_g9_on_card(cuda):
    """The sharded decode at starcoder2-7b's G 9 (``--q-heads 36
    --kv-heads 4``), which raised before K3's head groups."""
    from repro_torch.kernels.flash_decode import flash_decode
    from repro_torch.launch import distributed_decode
    before = flash_decode.launches
    res = distributed_decode.run(2, 36, 4, 128, 4096, 4, "float32",
                                 device="cuda", seed=2,
                                 kv_len=np.array([4096, 1234]))
    assert flash_decode.launches == before + 5
    assert res["max_abs_err"] < 1e-4


# --- the wire codec and the paged store on the card: the CUDA codec gives
# the CPU codec's bytes, so pages hashed on the card carry the IDs a CPU
# (or reference) store gives the same payload

WIRE_TIERS = ["int8", "int4", "plan:float16,int4,int8", "bfloat16"]


def _wire_bytes(a):
    return a.contiguous().view(torch.uint8).cpu().numpy().tobytes()


def _bf16_payload(dev, seed=0, Sc=37):
    g = torch.Generator().manual_seed(seed)
    x = {p: (3 * torch.randn(3, 2, Sc, 2, 16, generator=g))
         for p in ("k", "v")}
    x["k"][1] = 0.0                                  # a floored scale
    x["k"][2, 0, 0, 0, :4] = torch.tensor([0.5, -0.5, 1.5, 2.5])
    return ({p: a.to(torch.bfloat16) for p, a in x.items()},
            {p: a.to(dev, torch.bfloat16) for p, a in x.items()})


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16,
                                   torch.float32])
@pytest.mark.parametrize("wire", WIRE_TIERS)
def test_codec_on_card_is_byte_identical_to_cpu(cuda, wire, dtype):
    from repro_torch.comm.transport import (decode_wire,
                                            device_wire_roundtrip,
                                            encode_wire)
    host, dev = _bf16_payload(cuda)
    x_cpu, x_dev = host["k"].to(dtype), dev["k"].to(dtype)
    got, n = encode_wire(x_dev, wire)
    want, n_cpu = encode_wire(x_cpu, wire)
    assert n == n_cpu and len(got) == len(want)
    for a, b in zip(got, want):
        assert a.device.type == "cpu" and _wire_bytes(a) == _wire_bytes(b)
    back = decode_wire(got, wire, dtype, cuda)
    assert back.device.type == "cuda"
    assert torch.equal(back.cpu(), decode_wire(want, wire, dtype, "cpu"))
    assert torch.equal(device_wire_roundtrip(x_dev, wire, dtype), back)


@pytest.mark.parametrize("wire", WIRE_TIERS)
def test_paging_and_gather_on_card(cuda, wire):
    """Page IDs from a card payload (encoded on the card, copied through
    pinned memory behind an event) equal a CPU payload's; gather_prefix on
    the card equals pad_prefix(materialize) and the CPU gather."""
    from repro_torch.comm.transport import encode_payload
    from repro_torch.core.protocol import pad_prefix
    from repro_torch.store import PageStore, split_payload
    host, dev = _bf16_payload(cuda, seed=1)
    kw = dict(layers=(0, 2, 3), select=(True, False, True, True),
              page_len=8, wire_dtype=wire)
    wire_dev = encode_payload(dev, wire)
    assert wire_dev.event is not None
    t_dev, p_dev = split_payload(wire_dev, **kw)
    t_cpu, p_cpu = split_payload(host, **kw)
    assert [p.page_id for p in p_dev] == [p.page_id for p in p_cpu]
    assert t_dev.meta() == t_cpu.meta()
    store = PageStore(page_len=8)
    table, _, _ = store.ingest(dev, **{k: v for k, v in kw.items()
                                        if k != "page_len"})
    shared = store.materialize(table, device=cuda)
    gathered = store.gather_prefix(table, 48, device=cuda)
    cpu_gather = store.gather_prefix(table, 48, device="cpu")
    padded = pad_prefix(shared, 48)
    for p in ("k", "v"):
        assert gathered[p].device.type == "cuda"
        assert torch.equal(gathered[p], padded.packed_kv[p])
        assert torch.equal(gathered[p].cpu(), cpu_gather[p])


def test_paged_scheduler_on_card_matches_unpaged(cuda):
    """The float32 tiny slice on the card: the scheduler over a
    store-attached transport (deferred ingests, paged admission) is
    token-identical to the unpaged one, and every repeated context hits."""
    import dataclasses
    from repro_torch.comm import Agent, CommSession, SerializedTransport
    from repro_torch.configs.registry import get_config
    from repro_torch.core.types import KVCommConfig
    from repro_torch.data.synthetic import SyntheticTask, TaskConfig
    from repro_torch.data.tokenizer import SymbolTokenizer
    from repro_torch.models import transformer as tfm
    from repro_torch.serving.scheduler import (Request, Scheduler,
                                               SchedulerConfig,
                                               make_requests)
    from repro_torch.store import PageStore
    tok = SymbolTokenizer(16, 8)
    cfg = dataclasses.replace(
        get_config("llama3.2-3b-pair"), num_layers=4, d_model=64, d_ff=128,
        num_heads=4, num_kv_heads=2, head_dim=16, vocab_size=tok.vocab_size,
        dtype="float32", tie_embeddings=False)
    params = tfm.init_params(cfg, 0, device=cuda)
    base = make_requests([SyntheticTask(tok, TaskConfig(
        "retrieval", num_facts=nf, seed=11 + nf)).batch(2)
        for nf in (4, 8)], pad=tok.PAD)
    reqs = [Request(rid=i, context=base[i // 2].context,
                    query=base[(3 * i) % 4].query, max_new=(4, 3)[i % 2])
            for i in range(8)]
    kvcfg = KVCommConfig(ratio=0.5, selector="prior_only")
    runs = []
    for wire in ("float32", "int8"):
        for store in (None, PageStore(page_len=4)):
            sess = CommSession(Agent("s", cfg, params, tok),
                               Agent("r", cfg, params, tok),
                               SerializedTransport(wire, store=store))
            got, _ = Scheduler(sess, kvcfg, config=SchedulerConfig(
                capacity=3, prefix_bucket=8, query_bucket=4,
                decode_backend="kernel")).run(reqs)
            runs.append(got)
        assert sess.dedup_summary()["hit_rate"] == 0.5
    for unpaged, paged in (runs[:2], runs[2:]):
        for a, b in zip(unpaged, paged):
            np.testing.assert_array_equal(a.tokens, b.tokens)


# --- the comparison methods (no kernel of their own): the card against the
# CPU on one parameter set drawn on the CPU, float32 with TF32 off

COMM_METHODS = ["ac_mean", "ac_replace", "ac_sum", "baseline", "cipher",
                "contiguous", "full_kv", "hetero_kvcomm", "kvcomm", "nld",
                "prior_only", "random", "skyline"]


def _methods_setup(dev):
    """(CPU session, card session, tokenizer, batch): the tiny float32
    pair with one parameter set on both sides of each session."""
    import dataclasses
    from repro_torch.comm import Agent, CommSession
    from repro_torch.configs.registry import get_config
    from repro_torch.data.synthetic import SyntheticTask, TaskConfig
    from repro_torch.data.tokenizer import SymbolTokenizer
    from repro_torch.models import transformer as tfm
    tok = SymbolTokenizer(16, 8)
    cfg = dataclasses.replace(
        get_config("llama3.2-3b-pair"), num_layers=4, d_model=64, d_ff=128,
        num_heads=4, num_kv_heads=2, head_dim=16, vocab_size=tok.vocab_size,
        dtype="float32", tie_embeddings=False)
    cpu = tfm.init_params(cfg, 0, device="cpu")
    card = {"embed": cpu["embed"].to(dev),
            "final_norm": cpu["final_norm"].to(dev),
            "lm_head": cpu["lm_head"].to(dev),
            "layers": [{k: ({n: t.to(dev) for n, t in v.items()}
                            if isinstance(v, dict) else v.to(dev))
                        for k, v in lp.items()} for lp in cpu["layers"]]}
    sessions = [CommSession(Agent("s", cfg, p, tok), Agent("r", cfg, p, tok))
                for p in (cpu, card)]
    batch = SyntheticTask(tok, TaskConfig("retrieval", num_facts=4,
                                          seed=3)).batch(4)
    return sessions[0], sessions[1], tok, batch


def test_method_registry_is_what_the_card_tests_cover():
    from repro_torch.comm import METHODS
    assert sorted(METHODS) == COMM_METHODS


@pytest.mark.parametrize("method", COMM_METHODS)
def test_method_on_card_matches_cpu(cuda, method):
    from repro_torch.core.types import KVCommConfig
    cpu, card, _, batch = _methods_setup(cuda)
    scores = cpu.calibrate(batch["context"][:1], batch["query"][:1])
    kw = dict(kvcfg=KVCommConfig(ratio=0.5, alpha=0.7), scores=scores,
              nld_tokens=4)
    a, b = cpu.run(method, batch, **kw), card.run(method, batch, **kw)
    np.testing.assert_array_equal(b.preds, a.preds)
    assert (b.wire_bytes, b.flops, b.extras.get("M")) == \
        (a.wire_bytes, a.flops, a.extras.get("M"))
    assert b.latency_s > 0


def test_message_and_hiddens_on_card_match_cpu(cuda):
    cpu, card, _, batch = _methods_setup(cuda)
    ta, ea = cpu.sender.message(batch["context"], 4)
    tb, eb = card.sender.message(batch["context"], 4)
    np.testing.assert_array_equal(tb, ta)
    np.testing.assert_allclose(eb.cpu().numpy(), ea.numpy(), atol=2e-5,
                               rtol=2e-5)
    np.testing.assert_allclose(
        card.sender.export_hiddens(batch["context"]).cpu().numpy(),
        cpu.sender.export_hiddens(batch["context"]).numpy(), atol=2e-5,
        rtol=2e-5)


def test_two_sender_mailbox_on_card_matches_cpu(cuda):
    from repro_torch.core.channel import combine_senders
    from repro_torch.core.types import KVCommConfig, SharedKV
    cpu, card, _, batch = _methods_setup(cuda)
    kvcfg = KVCommConfig(ratio=0.7, selector="prior_only")
    rng = np.random.default_rng(0)
    V = cpu.cfg.vocab_size
    ctxs = [rng.integers(4, V, (2, n)).astype(np.int32) for n in (6, 9)]
    qry = rng.integers(4, V, (2, 4)).astype(np.int32)
    views, logits = [], []
    for sess in (cpu, card):
        select = sess.selection(kvcfg)
        for c in ctxs:
            sess.attach_sender(sess.sender).send(c, kvcfg, select=select)
        views.append(sess.combined(clear=True))
        logits.append(sess.receiver.prefill(qry, views[-1],
                                            max_new=0).logits.cpu())
    dense = combine_senders([
        SharedKV(kv=kv, select=select, prefix_len=p)
        for kv, _, p in (card.sender.export_kv(c) for c in ctxs)])
    idx = np.nonzero(select.numpy())[0].tolist()
    for p in ("k", "v"):
        assert torch.equal(views[1].packed_kv[p], dense.kv[p][idx])
        np.testing.assert_allclose(views[1].packed_kv[p].cpu().numpy(),
                                   views[0].packed_kv[p].numpy(),
                                   atol=2e-5, rtol=2e-5)
    np.testing.assert_allclose(logits[1].numpy(), logits[0].numpy(),
                               atol=2e-5, rtol=2e-5)


# --- the remote wire on the card: frames built from card tensors are the
# CPU's frames byte for byte, and a frame decodes on the card bit-equal to
# the CPU decode, monolithic, streamed and paged

REMOTE_TIERS = ["float32", "float16", "bfloat16", "int8", "int4",
                "plan:float16,int4"]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16,
                                   torch.float32])
@pytest.mark.parametrize("wire", REMOTE_TIERS)
def test_remote_frames_from_card_tensors_match_cpu(cuda, wire, dtype):
    from repro_torch.comm.remote import KVStreamSender, encode_kv_transfer
    from repro_torch.core.types import KVCommConfig
    host, dev = _bf16_payload(cuda)
    host = {p: a.to(dtype) for p, a in host.items()}
    dev = {p: a.to(dtype) for p, a in dev.items()}
    select = torch.tensor([True, False, True])
    kvcfg = KVCommConfig()
    assert encode_kv_transfer(kvcfg, dev, select, wire_dtype=wire) == \
        encode_kv_transfer(kvcfg, host, select, wire_dtype=wire)
    frames = [list(KVStreamSender(kvcfg, kv, select, wire_dtype=wire,
                                  chunk_bytes=700).frames())
              for kv in (dev, host)]
    assert frames[0] == frames[1] and len(frames[0]) > 3


@pytest.mark.parametrize("chunk_bytes", [None, 700])
@pytest.mark.parametrize("wire", REMOTE_TIERS)
def test_remote_decode_on_card_is_bit_equal_to_cpu(cuda, wire, chunk_bytes):
    from repro_torch.comm.remote import (LoopbackChannel, recv_shared,
                                         send_shared)
    from repro_torch.core.types import KVCommConfig
    host, _ = _bf16_payload(cuda)
    select = torch.tensor([True, False, True])
    views = []
    for device in ("cpu", cuda):
        ch = LoopbackChannel()
        send_shared(ch, KVCommConfig(), host, select, wire_dtype=wire,
                    chunk_bytes=chunk_bytes)
        views.append(recv_shared(ch, device=device)[0])
    for p in ("k", "v"):
        assert views[1].packed_kv[p].device.type == cuda.type
        assert torch.equal(views[1].packed_kv[p].cpu(),
                           views[0].packed_kv[p])


def test_remote_paged_and_streamed_sends_on_card(cuda):
    """RemoteTransport from card KV: streamed, monolithic and paged views
    bit-equal to each other (bf16 wire of bf16 KV) and to the in-memory
    hand-over; the paged repeat ships no page."""
    from repro_torch.comm import InMemoryTransport
    from repro_torch.comm.remote import RemoteTransport
    from repro_torch.core.types import KVCommConfig
    from repro_torch.store import PageStore
    _, dev = _bf16_payload(cuda, Sc=40)
    kv = {p: torch.cat([a, a[:1]]) for p, a in dev.items()}   # 4 layers
    select = torch.tensor([True, False, True, True])
    kvcfg = KVCommConfig()
    want = InMemoryTransport().send(None, kvcfg, kv, select)
    store = PageStore(page_len=16)
    paged = RemoteTransport("bfloat16", store=store)
    for tr in (RemoteTransport("bfloat16"),
               RemoteTransport("bfloat16", chunk_bytes=None), paged, paged):
        got = tr.send(None, kvcfg, kv, select)
        for p in ("k", "v"):
            assert got.packed_kv[p].device.type == cuda.type
            assert torch.equal(got.packed_kv[p], want.packed_kv[p])
    assert paged.log[0].pages_sent == paged.log[0].pages_total == 9
    assert paged.log[1].pages_sent == 0


# --- a heterogeneous pair on the card against the CPU: the float32 6 -> 10
# pair on one parameter draw per depth, TF32 off

def _hetero_setup(dev):
    import dataclasses
    from repro_torch.comm import Agent, CommSession
    from repro_torch.configs.registry import get_config
    from repro_torch.data.synthetic import SyntheticTask, TaskConfig
    from repro_torch.data.tokenizer import SymbolTokenizer
    from repro_torch.models import transformer as tfm
    tok = SymbolTokenizer(16, 8)
    cfgs = {L: dataclasses.replace(
        get_config("llama3.2-3b-pair"), num_layers=L, d_model=64, d_ff=128,
        num_heads=4, num_kv_heads=2, head_dim=16, vocab_size=tok.vocab_size,
        dtype="float32", tie_embeddings=False) for L in (6, 10)}
    params = {L: tfm.init_params(cfgs[L], L, device="cpu") for L in cfgs}
    batch = SyntheticTask(tok, TaskConfig("retrieval", num_facts=4,
                                          seed=11)).batch(2)

    def to(tree, device):
        if isinstance(tree, dict):
            return {k: to(v, device) for k, v in tree.items()}
        if isinstance(tree, list):
            return [to(v, device) for v in tree]
        return tree.to(device)

    def session(L_s, L_r, device):
        return CommSession(Agent("s", cfgs[L_s], to(params[L_s], device), tok),
                           Agent("r", cfgs[L_r], to(params[L_r], device), tok))
    return session, batch


@pytest.mark.parametrize("policy", ["identity", "depth_proportional",
                                    "score_greedy"])
@pytest.mark.parametrize("depths", [(6, 10), (10, 6)])
def test_hetero_pair_on_card_matches_cpu(cuda, depths, policy):
    from repro_torch.core.types import KVCommConfig
    session, batch = _hetero_setup(cuda)
    cpu, card = session(*depths, "cpu"), session(*depths, cuda)
    kvcfg = KVCommConfig(ratio=0.5, alpha=0.7)
    scores = cpu.calibrate_side("sender", batch["context"][:1],
                                batch["query"][:1])
    a, b = (s.run("hetero_kvcomm", batch, kvcfg=kvcfg, scores=scores,
                  layer_map=policy) for s in (cpu, card))
    np.testing.assert_array_equal(b.preds, a.preds)
    assert (b.wire_bytes, b.flops) == (a.wire_bytes, a.flops)
    for k in ("M", "src_layers", "dst_layers"):
        assert b.extras[k] == a.extras[k]
    shared, _ = card.share_mapped(batch["context"], kvcfg, policy=policy,
                                  src_scores=scores)
    want = cpu.generate(batch["query"], cpu.share_mapped(
        batch["context"], kvcfg, policy=policy, src_scores=scores)[0],
        max_new=4)
    got = np.stack(list(card.stream(batch["query"], shared, max_new=4,
                                    backend="kernel")), axis=1)
    np.testing.assert_array_equal(got, want)


# --- the resilience layer and the KV server on the card: a retried stream
# lands bit-equal to a clean one, a card KVServer answers as a CPU one, and
# the scheduler's degraded admissions give the CPU port's events and tokens

def _tiny_fp32(device):
    import dataclasses
    from repro_torch.configs.registry import get_config
    from repro_torch.data.tokenizer import SymbolTokenizer
    from repro_torch.models import transformer as tfm
    tok = SymbolTokenizer(16, 8)
    cfg = dataclasses.replace(
        get_config("llama3.2-3b-pair"), num_layers=4, d_model=64, d_ff=128,
        num_heads=4, num_kv_heads=2, head_dim=16, vocab_size=tok.vocab_size,
        dtype="float32", tie_embeddings=False)
    params = tfm.init_params(cfg, 0, device="cpu")

    def to(tree):
        if isinstance(tree, dict):
            return {k: to(v) for k, v in tree.items()}
        if isinstance(tree, list):
            return [to(v) for v in tree]
        return tree.to(device)
    return cfg, tok, to(params)


def test_streamed_retry_at_every_frame_on_card(cuda):
    """A truncate at each frame index of a streamed share from card KV,
    each followed by a retry: the K/V received on the card equal a clean
    share's bit for bit (no half-filled pinned buffer, no stale upload)."""
    from repro_torch.comm.remote import (KVStreamSender, LoopbackChannel,
                                         RemoteTransport)
    from repro_torch.comm.resilience import (Fault, FaultSchedule,
                                             FaultyChannel, RetryPolicy)
    from repro_torch.core.types import KVCommConfig
    _, dev = _bf16_payload(cuda, Sc=40)
    kv = {p: torch.cat([a, a[:1]]) for p, a in dev.items()}
    select = torch.tensor([True, False, True, True])
    kvcfg = KVCommConfig()
    want = RemoteTransport("bfloat16", chunk_bytes=700).send(
        None, kvcfg, kv, select)
    n = KVStreamSender(kvcfg, kv, select, wire_dtype="bfloat16",
                       chunk_bytes=700).n_frames
    assert n > 4
    for op in range(n):
        faulty = FaultyChannel(LoopbackChannel(), FaultSchedule(
            [Fault(op, "truncate", frac=0.6)]))
        tr = RemoteTransport("bfloat16", channel=faulty, chunk_bytes=700,
                             policy=RetryPolicy(backoff_s=0.0, jitter=0.0))
        got = tr.send(None, kvcfg, kv, select)
        assert tr.last.attempts == 2
        for p in ("k", "v"):
            assert got.packed_kv[p].device.type == cuda.type
            assert torch.equal(got.packed_kv[p], want.packed_kv[p])


def test_kv_server_on_card_answers_as_on_cpu(cuda):
    from repro_torch.comm import Agent
    from repro_torch.core.protocol import make_selection
    from repro_torch.core.types import KVCommConfig
    from repro_torch.launch.remote_serve import KVClient, KVServer
    from repro_torch.store import PageStore
    cfg, tok, cpu_params = _tiny_fp32("cpu")
    _, _, card_params = _tiny_fp32(cuda)
    kvcfg = KVCommConfig(ratio=0.5, selector="prior_only")
    rng = np.random.default_rng(1)
    ctx = rng.integers(4, cfg.vocab_size, (2, 7)).astype(np.int32)
    qry = rng.integers(4, cfg.vocab_size, (2, 4)).astype(np.int32)
    sender = Agent("s", cfg, cpu_params, tok)
    select = make_selection(cfg, kvcfg)
    answers = {}
    for name, params in (("cpu", cpu_params), ("card", card_params)):
        server = KVServer(Agent("r", cfg, params, tok),
                          store=PageStore(page_len=4))
        server.start()
        client = KVClient.connect(server.host, server.port, timeout_s=20.0,
                                  io_timeout_s=60.0)
        try:
            out = []
            client.share(sender, ctx, kvcfg, select, wire_dtype="float32",
                         chunk_bytes=300)
            out.append(client.generate(qry, max_new=4))
            for _ in range(2):
                _, total, sent = client.share_paged(
                    sender, ctx, kvcfg, select, page_len=4,
                    wire_dtype="float32")
                out.append(client.generate(qry, max_new=4))
            assert sent == 0 and total > 0
        finally:
            client.close()
            server.stop()
        assert server.store.stats().pinned_bytes == 0
        answers[name] = out
    for a, b in zip(answers["cpu"], answers["card"]):
        np.testing.assert_array_equal(a, b)


def test_degraded_admissions_on_card_match_cpu(cuda):
    """One fault script through the scheduler on the card (kernel backend)
    and on the CPU: the same degradation events, bytes and tokens."""
    from repro_torch.comm import Agent, CommSession
    from repro_torch.comm.remote import LoopbackChannel, RemoteTransport
    from repro_torch.comm.resilience import (CircuitBreaker, Fault,
                                             FaultSchedule, FaultyChannel,
                                             Resilience, RetryPolicy,
                                             default_resilience)
    from repro_torch.core.types import KVCommConfig
    from repro_torch.serving.scheduler import (Request, Scheduler,
                                               SchedulerConfig)
    kvcfg = KVCommConfig(ratio=0.5, selector="prior_only")
    out = {}
    for device in ("cpu", cuda):
        cfg, tok, params = _tiny_fp32(device)
        reqs = [Request(rid=i, context=np.random.default_rng(9 + i)
                        .integers(4, cfg.vocab_size, 5 + i).astype(np.int32),
                        query=np.random.default_rng(50 + i).integers(
                            4, cfg.vocab_size, 4).astype(np.int32),
                        max_new=3) for i in range(6)]
        runs = []
        for ladder in ("default", "baseline"):
            faulty = FaultyChannel(LoopbackChannel(), FaultSchedule([
                Fault(1, "truncate"), Fault(3, "disconnect"),
                Fault(4, "disconnect"), Fault(5, "drop"), Fault(6, "drop")]))
            breaker = CircuitBreaker(failure_threshold=2,
                                     reset_timeout_s=1e9)
            res = (default_resilience("float32", breaker=breaker)
                   if ladder == "default" else
                   Resilience(fallbacks=[("baseline", None)],
                              breaker=breaker))
            tr = RemoteTransport("float32", channel=faulty, chunk_bytes=None,
                                 policy=RetryPolicy(max_attempts=2,
                                                    backoff_s=0.0,
                                                    jitter=0.0))
            sess = CommSession(Agent("s", cfg, params, tok),
                               Agent("r", cfg, params, tok), tr,
                               resilience=res)
            comps, _ = Scheduler(sess, kvcfg, config=SchedulerConfig(
                capacity=3, prefix_bucket=8, query_bucket=4,
                decode_backend="kernel")).run(reqs)
            runs.append(([c.tokens.tolist() for c in comps],
                         [None if c.degradation is None else
                          (c.degradation.stage, c.degradation.attempts)
                          for c in comps],
                         [(r.n_bytes, r.attempts) for r in tr.log]))
        out[str(device)] = runs
    assert out["cpu"] == out[str(cuda)]
    assert [e and e[0] for e in out["cpu"][1][1]] == \
        [None, None, "baseline", "baseline", "baseline", "baseline"]


# ---------------------------------------------------------------------------
# state sharing: K4 and K1 at the served shapes, the state codec, the tiny
# SSM pairs
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("T", [2049, 1])
def test_wkv6_at_served_rwkv6_shapes(cuda, T):
    """K4 at rwkv6-1.6b's served shapes (4 rows, 32 heads of 64): the
    prefill of a 2,049-token context and one decode step."""
    from repro_torch.kernels.rwkv_scan import wkv6, wkv6_reference
    B, H, hd = 4, 32, 64
    r, k, v = (_randn(cuda, torch.float32, B, T, H, hd, seed=s)
               for s in (34, 35, 36))
    w = torch.sigmoid(_randn(cuda, torch.float32, B, T, H, hd, seed=37))
    u = _randn(cuda, torch.float32, H, hd, seed=38)
    s0 = 0.1 * _randn(cuda, torch.float32, B, H, hd, hd, seed=39)
    y, s = wkv6(r, k, v, w, u, s0)
    ry, rs = wkv6_reference(r, k, v, w, u, s0)
    torch.cuda.synchronize()
    for out, want in ((y, ry), (s, rs)):
        allow = 1e-4 * want.square().mean().sqrt() + 1e-4 * want.abs()
        assert bool(((out - want).abs() <= allow).all())


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_ragged_decode_at_zamba2_shape(cuda, dtype):
    """K1 at zamba2-2.7b's shared attention: MHA (G 1) at head dim 80, a
    257-position prefix and a short self region."""
    q, k, v, kv_len, pfx = _case(cuda, 4, 281, 257, 32, 32, 80, dtype,
                                 seed=5)
    out = ragged_decode(q, k, v, kv_len, pfx, prefix_len=257)
    want = ragged_decode_reference(q.float(), k.float(), v.float(), kv_len,
                                   pfx, prefix_len=257)
    torch.cuda.synchronize()
    _close(out, want, dtype)


@pytest.mark.parametrize("wire", ["float32", "float16", "bfloat16", "int8",
                                  "int4", "plan:float16,int4,int8"])
def test_state_codec_on_card_is_byte_identical_to_cpu(cuda, wire):
    """roundtrip_states on card tensors: the wire arrays, the counted
    bytes and the received states equal the CPU's bit for bit (the
    device-tensor divisor of F3 holds for state leaves too)."""
    from repro_torch.comm.transport import (encode_wire, roundtrip_states,
                                            state_wire_dtype)
    g = torch.Generator().manual_seed(9)
    host = {"conv": 3 * torch.randn(4, 2, 3, 24, generator=g),
            "ssm": 3 * torch.randn(4, 2, 4, 8, 16, generator=g)}
    host["ssm"][2] = 0.0
    sel = torch.tensor([True, False, True, True])
    card = {key: x.to(cuda) for key, x in host.items()}
    wd = state_wire_dtype(wire)
    for key in host:
        got, n = encode_wire(card[key][sel.to(cuda)], wd)
        want, n_cpu = encode_wire(host[key][sel], wd)
        assert n == n_cpu
        assert [_wire_bytes(a) for a in got] == [_wire_bytes(b)
                                                 for b in want]
    rx, n = roundtrip_states(card, sel, wire)
    rx_cpu, n_cpu = roundtrip_states(host, sel, wire)
    assert n == n_cpu > 0
    for key in host:
        assert rx[key].device.type == "cuda"
        assert torch.equal(rx[key].cpu(), rx_cpu[key])


@pytest.mark.parametrize("arch", ["rwkv6-1.6b", "zamba2-2.7b"])
def test_ssm_pair_on_card_matches_cpu(cuda, arch):
    """The reduced float32 RWKV6 / Zamba2 pair shares its states (and
    KV) through a SerializedTransport("int8") on the card and on the CPU:
    bytes identical, prefill logits within 1e-4 of the largest |logit|,
    and the card's K4 (and K1) launched."""
    import dataclasses
    from repro_torch.comm import Agent, CommSession, SerializedTransport
    from repro_torch.configs.registry import get_config
    from repro_torch.core.types import KVCommConfig
    from repro_torch.data.tokenizer import SymbolTokenizer
    from repro_torch.kernels.rwkv_scan import wkv6
    from repro_torch.models import transformer as tfm
    tok = SymbolTokenizer(16, 8)
    cfg = dataclasses.replace(get_config(arch).reduced(), dtype="float32",
                              vocab_size=tok.vocab_size)
    params = tfm.init_params(cfg, 0, device="cpu")
    rng = np.random.default_rng(1)
    ctx = rng.integers(4, cfg.vocab_size, (2, 9)).astype(np.int32)
    qry = rng.integers(4, cfg.vocab_size, (2, 5)).astype(np.int32)
    kvcfg = KVCommConfig(ratio=0.5, selector="prior_only")
    out = {}
    for dev in ("cpu", cuda):
        p = _to(params, dev)
        sess = CommSession(Agent("s", cfg, p, tok), Agent("r", cfg, p, tok),
                           SerializedTransport("int8"))
        k4, k1 = wkv6.launches, ragged_decode.launches
        shared, _ = sess.share(ctx, kvcfg)
        lg = sess.receiver.prefill(qry, shared, max_new=2).logits
        toks, _ = sess.receiver.generate(qry, shared, max_new=2,
                                         backend="kernel")
        out[str(dev)] = (sess.transport.total_bytes, lg.float().cpu(),
                         toks.cpu(), wkv6.launches - k4,
                         ragged_decode.launches - k1)
    (nb, lg, _, _, _), (nb_c, lg_c, _, k4, k1) = out["cpu"], out[str(cuda)]
    assert nb == nb_c > 0
    assert float((lg_c - lg).abs().max()) <= 1e-4 * float(lg.abs().max())
    if arch == "rwkv6-1.6b":
        # forwards: the share's sender prefill, the prefill, and
        # generate's prefill and two decode steps
        assert k4 == cfg.num_layers * 5 and k1 == 0
    else:
        assert k4 == 0 and k1 == cfg.attn_layer_count * 2


def _to(tree, dev):
    """A copy of a parameter tree on ``dev`` that keeps shared entries
    shared (Zamba2's one attention block)."""
    memo = {}

    def move(x):
        if id(x) in memo:
            return memo[id(x)]
        if isinstance(x, dict):
            out = {k: move(v) for k, v in x.items()}
        elif isinstance(x, list):
            out = [move(v) for v in x]
        else:
            out = x.to(dev)
        memo[id(x)] = out
        return out

    return move(tree)


# --- the recorder (repro_torch.utils.trace) on the card: it adds no host
# wait, and its admit.host_syncs counts every one an admission makes

def _trace_scheduler(dev, transport):
    """A Scheduler on the tiny float32 pair of ``_methods_setup`` over an
    int8 ``SerializedTransport`` or the in-memory hand-over, and its six
    requests."""
    from repro_torch.comm import (CommSession, InMemoryTransport,
                                  SerializedTransport)
    from repro_torch.core.types import KVCommConfig
    from repro_torch.data.synthetic import SyntheticTask, TaskConfig
    from repro_torch.serving.scheduler import (Scheduler, SchedulerConfig,
                                               make_requests)
    _, card, tok, _ = _methods_setup(dev)
    sess = CommSession(card.sender, card.receiver,
                       SerializedTransport("int8") if transport == "int8"
                       else InMemoryTransport())
    reqs = make_requests([SyntheticTask(tok, TaskConfig(
        "retrieval", num_facts=nf, seed=11 + nf)).batch(3) for nf in (4, 8)],
        pad=tok.PAD)
    for i, r in enumerate(reqs):
        r.max_new = (4, 2, 1)[i % 3]
    return Scheduler(sess, KVCommConfig(ratio=0.5, selector="prior_only"),
                     config=SchedulerConfig(capacity=3, prefix_bucket=8,
                                            query_bucket=4)), reqs


def _synchronising(fn):
    """(fn's result, the list of synchronising calls
    ``torch.cuda.set_sync_debug_mode("warn")`` reports while it runs, as
    it grows: a caller can read it inside fn)."""
    import warnings
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn(caught)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    return out, [w for w in caught if "synchroniz" in str(w.message)]


@pytest.mark.parametrize("transport", ["int8", "in_memory"])
def test_recorded_wave_adds_no_host_sync(cuda, transport):
    from repro_torch.utils import trace
    sched, reqs = _trace_scheduler(cuda, transport)
    sched.run(reqs)                                   # warm

    def recorded(_):
        with trace.recording():
            return sched.run(reqs)

    (off, _), syncs_off = _synchronising(lambda _: sched.run(reqs))
    (on, stats), syncs_on = _synchronising(recorded)
    assert len(syncs_on) <= len(syncs_off)
    for a, b in zip(off, on):
        np.testing.assert_array_equal(a.tokens, b.tokens)
    timed = [s for s in stats["trace"]["spans"] if s["stream_ms"] is not None]
    assert {s["name"] for s in timed} >= {
        "scheduler.setup", "scheduler.admit", "sender.prefill",
        "transport.send", "receiver.prefill", "scheduler.step"}
    assert all(s["stream_ms"] >= 0 for s in timed)


@pytest.mark.parametrize("n", [1, 6], ids=["one", "six"])
@pytest.mark.parametrize("transport", ["int8", "in_memory"])
def test_admit_host_syncs_counts_every_admission_wait(cuda, transport, n):
    """admit.host_syncs equals the synchronising calls the sync debug mode
    reports inside admissions (these paths make no explicit wait there):
    the int8 codec's copies to the host and back, nothing in memory."""
    from repro_torch.utils import trace
    sched, reqs = _trace_scheduler(cuda, transport)
    reqs = reqs[:n]
    sched.run(reqs)                                   # warm
    inside = []
    enqueue = sched._enqueue_admission

    def serve(caught):
        def counted(*args):
            k = len(caught)
            out = enqueue(*args)
            inside.extend(w for w in caught[k:]
                          if "synchroniz" in str(w.message))
            return out
        sched._enqueue_admission = counted
        with trace.recording():
            return sched.run(reqs)

    (_, stats), _ = _synchronising(serve)
    counters = stats["trace"]["counters"]
    assert counters["admit.count"] == n
    assert counters["admit.host_syncs"] == len(inside)
    if transport == "int8":       # codes and scales of K and V, both ways
        assert len(inside) == 8 * n
    # the deferred stamp is the transfer's stream time, the span's too
    sends = [s for s in stats["trace"]["spans"]
             if s["name"] == "transport.send"]
    log = sched.session.transport.log[-n:]
    np.testing.assert_allclose([r.latency_s * 1e3 for r in log],
                               [s["stream_ms"] for s in sends], rtol=1e-12)


# --- the sender's prefix-free prefill on the prefill kernel (K2): a bf16
# sender prefill at the served geometries takes K2 in every attention
# layer, its KV and last-position logits within the bf16 tolerance (2e-2 of
# the largest value) of the plain core on the same card, and no farther
# from a float32 plain run than the plain bf16 core is (1.1 x its error
# plus 1e-3 of the largest value)

def _prefill_run(params, cfg, toks):
    """(KV stacked over the attention layers, last-position logits) of a
    sender prefill: ``protocol.sender_prefill``'s forward, logits kept."""
    from repro_torch.core import protocol
    from repro_torch.models import transformer as tfm
    out = tfm.apply_model(params, cfg, toks, mode="cached",
                          cache=tfm.init_cache(cfg, *toks.shape,
                                               device=toks.device),
                          logits_mode="last")
    kv = protocol.extract_kv(cfg, out.cache)
    return torch.cat([kv["k"].flatten(), kv["v"].flatten()]).float(), \
        out.logits.float()


@pytest.mark.parametrize("arch,S,overrides", [
    ("starcoder2-7b", 1537, {}), ("starcoder2-7b", 2561, {}),
    ("internlm2-20b", 1537, {}), ("internlm2-20b", 2561, {}),
    ("gemma3-4b", 2049, {"local_window": 1024}),   # 8/4 x 256, windowed
], ids=["sc-1537", "sc-2561", "il-1537", "il-2561", "gemma3-window"])
def test_sender_prefill_takes_the_prefill_kernel(cuda, monkeypatch, arch, S,
                                                 overrides):
    import dataclasses
    from repro_torch.configs.registry import get_config
    from repro_torch.core import protocol
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.models import attention
    from repro_torch.models import transformer as tfm
    cfg = dataclasses.replace(get_config(arch), num_layers=2,
                              dtype="bfloat16", **overrides)
    L = cfg.attn_layer_count
    if arch == "gemma3-4b":        # both layers local, within the window
        assert [s.window for s in tfm.layer_specs(cfg)] == [1024] * L
    params = tfm.init_params(cfg, 7, device=cuda)
    g = torch.Generator().manual_seed(S)
    toks = torch.randint(0, cfg.vocab_size, (1, S), generator=g).to(cuda)

    before = flash_attention.launches
    protocol.sender_prefill(params, cfg, toks)
    assert flash_attention.launches == before + L
    kernel = _prefill_run(params, cfg, toks)
    assert flash_attention.launches == before + 2 * L
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    exact = _prefill_run(_upcast(params), cfg32, toks)
    with monkeypatch.context() as m:
        m.setattr(attention, "prefill_on_kernel", lambda *a, **k: False)
        plain = _prefill_run(params, cfg, toks)
    assert flash_attention.launches == before + 2 * L
    torch.cuda.synchronize()
    for got, want, ref in zip(kernel, plain, exact):
        top = float(ref.abs().max())
        assert float((got - want).abs().max()) <= 2e-2 * float(
            want.abs().max())
        err_k, err_p = (float((x - ref).abs().max()) for x in (got, want))
        assert err_k <= 1.1 * err_p + 1e-3 * top, (err_k, err_p, top)


def _upcast(tree):
    if isinstance(tree, dict):
        return {k: _upcast(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_upcast(v) for v in tree]
    return tree.float() if tree.is_floating_point() else tree


@pytest.mark.parametrize("pos_mode", ["shift", "zero_unselected"])
def test_receiver_prefill_keeps_the_plain_core(cuda, pos_mode):
    """A bf16 receiver prefill over the sender's prefix launches no K2 in
    any layer, in the packed view (whose unselected layers hold no prefix)
    as in the dense one, so the two views' logits agree within the bf16
    rule in either position mode."""
    import dataclasses
    from repro_torch.configs.registry import get_config
    from repro_torch.core import protocol
    from repro_torch.core.types import KVCommConfig
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.models import transformer as tfm
    cfg = dataclasses.replace(get_config("internlm2-20b"), num_layers=4,
                              dtype="bfloat16")
    params = tfm.init_params(cfg, 11, device=cuda)
    g = torch.Generator().manual_seed(3)
    ctx = torch.randint(0, cfg.vocab_size, (2, 1025), generator=g).to(cuda)
    query = torch.randint(0, cfg.vocab_size, (2, 33), generator=g).to(cuda)
    kv, _ = protocol.sender_prefill(params, cfg, ctx)
    select = torch.tensor([True, False, True, False])
    kvcfg = KVCommConfig(ratio=0.5, pos_mode=pos_mode)
    before = flash_attention.launches
    logits = [protocol.receiver_prefill(params, cfg, query,
                                        build(kvcfg, kv, select),
                                        max_new=4).logits
              for build in (protocol.build_shared, protocol.pack_shared)]
    torch.cuda.synchronize()
    assert flash_attention.launches == before
    dense, packed = logits
    assert float((packed - dense).abs().max()) <= 1e-2 * float(
        dense.abs().max())


# --- K5 the grouped expert kernels against the dense_all loop, at
# mellum2-12b's served shapes: a 4,096-position sender prefill (32,768
# assignments over 64 experts, 128-row tiles) and a 16-row decode step
# (128 assignments, 16-row tiles). The loop rounds each expert's h and
# output to bf16 and accumulates the gated outputs in bf16 over the 64
# experts; the kernel keeps h's products in float32 and sums a token's 8
# gated rows in float32: 2e-2 of the largest output, as the bf16 kernels
# above. Against its plain version (float32 products, the same
# roundings): 2e-2 of the largest output too.

@pytest.mark.parametrize("N", [4096, 16])
def test_grouped_experts_match_the_loop(cuda, N):
    import math
    from repro_torch.kernels.moe_grouped import (grouped_experts,
                                                 grouped_experts_reference)
    from repro_torch.models import layers
    E, k, D, F = 64, 8, 2304, 896
    g = torch.Generator().manual_seed(N)
    p = {"router": (torch.randn(D, E, generator=g) * 2 / math.sqrt(D)).to(
        cuda),
         "w_gate": (torch.randn(E, D, F, generator=g) / math.sqrt(D)).to(
             cuda, torch.bfloat16),
         "w_up": (torch.randn(E, D, F, generator=g) / math.sqrt(D)).to(
             cuda, torch.bfloat16),
         "w_down": (torch.randn(E, F, D, generator=g) / math.sqrt(F)).to(
             cuda, torch.bfloat16)}
    x = torch.randn(1, N, D, generator=g).to(cuda, torch.bfloat16)
    cfg = types.SimpleNamespace(moe_impl="dense_all", num_experts_per_tok=k)
    assert layers.moe_on_kernel(p, x, cfg)
    before = grouped_experts.launches
    got, aux = layers.apply_moe(p, x, cfg)
    assert grouped_experts.launches - before == 2
    want, want_aux = layers.apply_moe_dense_all(p, x, k)
    torch.cuda.synchronize()
    scale = float(want.float().abs().max())
    assert float((got.float() - want.float()).abs().max()) <= 2e-2 * scale
    assert torch.equal(aux, want_aux)
    gates, idx, _ = layers.router_probs(p, x, k)
    plain = grouped_experts_reference(
        x[0], p["w_gate"], p["w_up"], p["w_down"], gates[0], idx[0])
    assert float((got[0].float() - plain.float()).abs().max()) \
        <= 2e-2 * scale


def test_grouped_experts_make_no_host_sync(cuda):
    """K5's dispatch (sort, offsets, tile table), both launches and the
    combine make no synchronising call (``set_sync_debug_mode``)."""
    import math
    from repro_torch.models import layers
    E, k, D, F = 64, 8, 2304, 896
    g = torch.Generator().manual_seed(3)
    p = {"router": (torch.randn(D, E, generator=g) * 2 / math.sqrt(D)).to(
        cuda),
         "w_gate": torch.randn(E, D, F, generator=g).to(cuda, torch.bfloat16)
         / math.sqrt(D),
         "w_up": torch.randn(E, D, F, generator=g).to(cuda, torch.bfloat16)
         / math.sqrt(D),
         "w_down": torch.randn(E, F, D, generator=g).to(cuda, torch.bfloat16)
         / math.sqrt(F)}
    x = torch.randn(16, 1, D, generator=g).to(cuda, torch.bfloat16)
    cfg = types.SimpleNamespace(moe_impl="dense_all", num_experts_per_tok=k)
    layers.apply_moe(p, x, cfg)                       # build the kernels
    # the first switch to the debug mode warns once that it is a
    # prototype, in words that match the helper's filter: absorb it
    _synchronising(lambda caught: None)
    _, syncs = _synchronising(lambda caught: layers.apply_moe(p, x, cfg))
    assert syncs == [], [(w.filename, w.lineno, str(w.message))
                         for w in syncs]


def test_mellum_served_on_the_grouped_path(cuda):
    """mellum2-12b cut to one period (3 windowed layers, then a full one
    under YaRN), bf16, through ``Scheduler.run`` on the kernel backend
    with an int8 wire: every MoE call takes K5 (``moe.loop`` 0), K1 runs
    the full layer alone (a quarter of the one-token calls), and an
    admission makes no more host syncs than the int8 codec's 8."""
    from repro_torch.comm import Agent, CommSession, SerializedTransport
    from repro_torch.configs.registry import get_config
    from repro_torch.core.types import KVCommConfig
    from repro_torch.data.synthetic import SyntheticTask, TaskConfig
    from repro_torch.data.tokenizer import SymbolTokenizer
    from repro_torch.models import transformer as tfm
    from repro_torch.serving.scheduler import (Scheduler, SchedulerConfig,
                                               make_requests)
    from repro_torch.utils import trace
    tok = SymbolTokenizer(16, 8)
    cfg = get_config("mellum2-12b").reduced(
        num_experts=8, num_experts_per_tok=2, vocab_size=tok.vocab_size,
        dtype="bfloat16")
    params = tfm.init_params(cfg, 0, device=cuda)
    sess = CommSession(Agent("s", cfg, params, tok),
                       Agent("r", cfg, params, tok),
                       SerializedTransport("int8"))
    reqs = make_requests([SyntheticTask(tok, TaskConfig(
        "retrieval", num_facts=6, seed=3)).batch(4)], pad=tok.PAD)
    sched = Scheduler(sess, KVCommConfig(ratio=0.5, selector="prior_only"),
                      config=SchedulerConfig(capacity=4, prefix_bucket=8,
                                             query_bucket=4,
                                             decode_backend="kernel"))
    sched.run(reqs)                                   # warm
    with trace.recording():
        _, stats = sched.run(reqs)
    c = stats["trace"]["counters"]
    assert c["moe.loop"] == 0 and c["moe.grouped"] > 0
    assert c["decode.attn_kernel"] == stats["steps"] > 0
    assert c["decode.attn_plain"] == 3 * stats["steps"]
    assert c["admit.host_syncs"] == 8 * c["admit.count"]
