"""Which self-attention calls run the prefill kernel (``flash_attention``)
in place of the plain core, and what the recorder counts.

``attention.prefill_on_kernel`` is read from the call's inputs alone: a
cached prefill of a sequence from its start that attends only its own
tokens, of bf16 / fp16 CUDA tensors at a geometry the kernel takes, with no
autograd; the receiver's prefill over a prefix keeps the plain core, the
packed view's prefix-less layers too, in either position mode. The CPU has
no
CUDA tensor, so the rule is held here against stand-ins that carry a
tensor's shape, dtype, device flag and grad flag; the kernel branch itself
is driven on the CPU by a rule that takes the stand-in for the real q (the
kernel's wrapper computes its plain version there), against the plain
core. On the CPU every prefill keeps the plain core, which the recorder
counts."""
import dataclasses
from types import SimpleNamespace
from unittest import mock

import numpy as np
import pytest
import torch
from torch.distributed.tensor import DTensor

from _torch_bridge import port_cfg
from repro_torch.core import protocol
from repro_torch.core.types import KVCommConfig
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.models import attention
from repro_torch.models import transformer as tfm
from repro_torch.utils import trace


def _q(B=1, S=64, Hq=8, D=128, dtype=torch.bfloat16, is_cuda=True,
       requires_grad=False, dtensor=False):
    """A stand-in for q: what the rule reads of a tensor."""
    q = (mock.MagicMock(spec=DTensor) if dtensor else SimpleNamespace())
    q.shape, q.dtype, q.is_cuda = (B, S, Hq, D), dtype, is_cuda
    q.requires_grad = requires_grad
    return q


def _k(B=1, S=64, Hkv=4, D=128):
    return SimpleNamespace(shape=(B, S, Hkv, D))


CALL = dict(mode="cached", cache_len=0, pos_shift=0, prefix_len=0,
            shared_prefix_len=0, prefix_lens=None, collect_mass=False,
            ring=False)

KERNEL = {
    "bf16": ({}, {}, {}),
    "fp16": ({"dtype": torch.float16}, {}, {}),
    "g9": ({"Hq": 36}, {"Hkv": 4}, {}),
    "g6": ({"Hq": 48}, {"Hkv": 8}, {}),
    "d256": ({"D": 256}, {"D": 256}, {}),
    "d80": ({"Hq": 32, "D": 80}, {"Hkv": 32, "D": 80}, {}),
    "two_rows": ({"B": 2, "S": 2}, {"B": 2, "S": 2}, {}),
}
PLAIN = {
    "train": ({}, {}, {"mode": "train"}),
    "decode": ({"S": 1}, {"S": 1}, {}),
    "filled_cache": ({}, {}, {"cache_len": 5}),
    "tensor_cache_len": ({}, {}, {"cache_len": torch.tensor(0)}),
    "ragged_cache_len": ({}, {}, {"cache_len": torch.zeros(1, dtype=int)}),
    "tensor_shift": ({}, {}, {"pos_shift": torch.tensor([3])}),
    "past_a_prefix": ({}, {}, {"pos_shift": 7}),
    "prefix_lens": ({}, {}, {"prefix_lens": torch.tensor([4])}),
    "prefix": ({}, {}, {"prefix_len": 8, "shared_prefix_len": 8}),
    # a layer holding no prefix, at shift 0, in a forward over one (the
    # packed view's unselected layers under zero_unselected)
    "forward_prefix": ({}, {}, {"shared_prefix_len": 8}),
    "mass": ({}, {}, {"collect_mass": True}),
    "ring": ({}, {}, {"ring": True}),
    "cpu": ({"is_cuda": False}, {}, {}),
    "dtensor": ({"dtensor": True}, {}, {}),
    "float32": ({"dtype": torch.float32}, {}, {}),
    "d20": ({"D": 20}, {"D": 20}, {}),
    "d512": ({"D": 512}, {"D": 512}, {}),
    "ragged_groups": ({"Hq": 6}, {"Hkv": 4}, {}),
    "autograd": ({"requires_grad": True}, {}, {}),
}


@pytest.mark.parametrize("case", sorted(KERNEL))
def test_rule_takes_the_kernel(case):
    qkw, kkw, call = KERNEL[case]
    assert attention.prefill_on_kernel(_q(**qkw), _k(**kkw),
                                       **{**CALL, **call})


@pytest.mark.parametrize("case", sorted(PLAIN))
def test_rule_keeps_the_plain_core(case):
    qkw, kkw, call = PLAIN[case]
    assert not attention.prefill_on_kernel(_q(**qkw), _k(**kkw),
                                           **{**CALL, **call})


def test_rule_takes_the_kernel_without_autograd():
    """q that requires grad takes the kernel where no graph is recorded."""
    with torch.no_grad():
        assert attention.prefill_on_kernel(_q(requires_grad=True), _k(),
                                           **CALL)


@pytest.fixture(scope="module")
def model(tiny_cfg):
    cfg = port_cfg(tiny_cfg)
    return cfg, tfm.init_params(cfg, 0, device="cpu")


def _context(cfg, S=21, seed=0):
    g = torch.Generator().manual_seed(seed)
    return torch.randint(4, cfg.vocab_size, (2, S), generator=g)


def _counted(fn):
    """fn()'s result and the prefill routing counters it moved (an MoE
    model's calls count under ``moe.*`` beside them)."""
    with trace.recording() as rec:
        out = fn()
    return out, {k: v for k, v in rec.counters.items()
                 if k.startswith("prefill.")}


def test_sender_prefill_on_the_cpu_counts_plain(model):
    cfg, params = model
    (kv, _), counters = _counted(
        lambda: protocol.sender_prefill(params, cfg, _context(cfg)))
    L = cfg.attn_layer_count
    assert counters == {attention.PLAIN_PREFILLS: L}
    assert kv["k"].shape[0] == L


@pytest.mark.parametrize("pos_mode", ["shift", "zero_unselected"])
@pytest.mark.parametrize("card", [False, True], ids=["cpu", "as_on_card"])
@pytest.mark.parametrize("packed", [False, True], ids=["dense", "packed"])
def test_receiver_prefill_over_a_prefix_counts_plain(model, monkeypatch,
                                                     packed, card, pos_mode):
    """The receiver's prefill attends the sender's prefix (on every layer of
    the dense view; on the selected layers of the packed one, whose
    unselected layers hold no prefix and start past it, or at 0 under
    ``zero_unselected``): plain on the CPU and, every layer, on the card
    (so the packed and dense views run one arithmetic)."""
    cfg, params = model
    if card:
        _pretend_card(monkeypatch)
    kv, _ = protocol.sender_prefill(params, cfg, _context(cfg))
    L = cfg.attn_layer_count
    select = torch.tensor([i % 2 == 0 for i in range(L)])
    kvcfg = KVCommConfig(ratio=0.5, pos_mode=pos_mode)
    shared = (protocol.pack_shared if packed else protocol.build_shared)(
        kvcfg, kv, select)
    _, counters = _counted(lambda: protocol.receiver_prefill(
        params, cfg, _context(cfg, S=9, seed=1), shared, max_new=4))
    assert counters == {attention.PLAIN_PREFILLS: L}


def _pretend_card(monkeypatch):
    """Route as the card would: the rule sees a bf16 CUDA q of the call's
    shape (the kernel's wrapper then computes its plain version on the
    CPU, in float32)."""
    rule = attention.prefill_on_kernel

    def on_card(q, k, **kw):
        return rule(_q(*q.shape, requires_grad=q.requires_grad), k, **kw)
    monkeypatch.setattr(attention, "prefill_on_kernel", on_card)


def _prefill(params, cfg, toks):
    out = tfm.apply_model(params, cfg, toks, mode="cached",
                          cache=tfm.init_cache(cfg, *toks.shape,
                                               device="cpu"),
                          logits_mode="last")
    return protocol.extract_kv(cfg, out.cache), out.logits


@pytest.mark.parametrize("arch", ["tiny", "gemma3-4b", "mixtral-8x22b"])
def test_kernel_branch_computes_the_plain_function(model, monkeypatch,
                                                   arch):
    """The kernel branch (positions, causal mask, window, cache write) gives
    the plain core's KV and logits within float32 rounding: the tiny pair,
    reduced gemma3 (local window 8 then a global layer) and reduced mixtral
    (window 8 on every layer) over contexts past the window."""
    from repro_torch.configs.registry import get_config
    cfg, params = model
    if arch != "tiny":
        cfg = dataclasses.replace(get_config(arch).reduced(),
                                  dtype="float32")
        params = tfm.init_params(cfg, 3, device="cpu")
    toks = _context(cfg, S=21, seed=2)
    (kv0, logits0), plain = _counted(lambda: _prefill(params, cfg, toks))
    _pretend_card(monkeypatch)
    launches = flash_attention.launches
    (kv1, logits1), routed = _counted(lambda: _prefill(params, cfg, toks))
    L = cfg.attn_layer_count
    assert plain == {attention.PLAIN_PREFILLS: L}
    assert routed == {attention.KERNEL_PREFILLS: L}
    assert flash_attention.launches == launches        # no card, no launch
    for a, b in [(kv1["k"], kv0["k"]), (kv1["v"], kv0["v"]),
                 (logits1, logits0)]:
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=2e-5,
                                   rtol=2e-5)
