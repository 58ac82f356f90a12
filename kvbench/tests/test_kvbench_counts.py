"""The benchmark's operation and byte counts against hand counts on a
tiny configuration (d 4, 2 query heads over 1 KV head of 2, d_ff 8,
vocabulary 10, 3 layers, gelu)."""
from types import SimpleNamespace

import numpy as np

from kvbench import counts

M = dict(num_layers=3, d_model=4, num_heads=2, num_kv_heads=1, head_dim=2,
         d_ff=8, vocab_size=10)


def test_per_token_and_attention():
    # 2 * (4 * (4 + 4) + 4 * 4 + 2 * 4 * 8)
    assert counts.linear_per_token(M, "gelu") == 224
    assert counts.linear_per_token(M, "swiglu") == 224 + 2 * 4 * 8
    assert counts.attn_ops(M, 7) == 4 * 2 * 2 * 7


def test_one_request_by_stage():
    f = counts.request_flops(M, "gelu", sc=5, sq=3, n=3, sel=[0, 2])
    # sender: layers 0, 1 whole over 5 causal rows (15 attended), layer
    # 2's K and V projections only; no logits
    assert f["sender"] == 2 * (5 * 224 + 16 * 15) + 5 * 32
    # receiver: 3 layers over 3 rows (6 causal), 2 layers x 3 rows x 5
    # prefix positions, one row of logits
    assert f["receiver"] == 3 * (3 * 224 + 16 * 6) + 2 * 16 * 15 + 80
    # two decode steps over 4 and 5 own positions
    assert f["decode"] == (3 * (224 + 64) + 160 + 80) + (
        3 * (224 + 80) + 160 + 80)


def test_window_sums_requests():
    it = SimpleNamespace(context=np.zeros(4), query=np.zeros(3), answer=3)
    one = sum(counts.request_flops(M, "gelu", 5, 3, 3, [0, 2]).values())
    assert counts.window_flops(M, "gelu", [it, it], [0, 2]) == 2 * one


def test_k1_bytes():
    it = SimpleNamespace(context=np.zeros(4), query=np.zeros(3), answer=3)
    # per step: 3 layers x (own positions x 8 + 16) + 2 layers x 5 x 8
    assert counts.k1_bytes(M, [it], [0, 2]) == (3 * 48 + 80) + (3 * 56 + 80)


def test_no_selection_needs_no_sender():
    f = counts.request_flops(M, "gelu", 5, 3, 2, [])
    assert f["sender"] == 0
