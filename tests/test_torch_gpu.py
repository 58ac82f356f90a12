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
