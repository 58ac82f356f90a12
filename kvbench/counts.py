"""What the inputs need, in operations and bytes: the benchmark's own
arithmetic, independent of what the program executes.

One KVComm round of a request with a context of ``Sc`` positions (BOS
included), a query of ``Sq`` tokens and ``n`` answer tokens, under a
selection of layers ``sel`` whose deepest is ``dmax``, needs:

  sender   — layers 0 .. dmax-1 whole over Sc positions (causal attention
             over attended positions only), and layer dmax's K and V
             projections; no logits.
  receiver — every layer over the Sq query tokens, attending the Sc
             prefix positions on selected layers only, and the logits of
             the last query position.
  decode   — n - 1 steps of one token, step j attending Sq + j own
             positions plus the prefix on selected layers, and one row of
             logits each.

Live rows only: no bucket padding, no dead slot-table rows. A matrix
product of (m, k) by (k, n) counts 2 m k n operations.
"""
from __future__ import annotations

from typing import Dict, Iterable, Sequence

BYTES_BF16 = 2


def linear_per_token(model: Dict, mlp: str) -> int:
    """Operations of one token through one layer's projections and MLP."""
    d, dff = model["d_model"], model["d_ff"]
    hq, hkv, dh = model["num_heads"], model["num_kv_heads"], model["head_dim"]
    n_mlp = 3 if mlp == "swiglu" else 2
    return 2 * (d * (hq * dh + 2 * hkv * dh) + hq * dh * d + n_mlp * d * dff)


def attn_ops(model: Dict, attended: int) -> int:
    """QK^T and PV of one query row over ``attended`` positions."""
    return 4 * model["num_heads"] * model["head_dim"] * attended


def request_flops(model: Dict, mlp: str, sc: int, sq: int, n: int,
                  sel: Sequence[int]) -> Dict[str, int]:
    """Needed operations of one request, by stage."""
    L, d, V = model["num_layers"], model["d_model"], model["vocab_size"]
    kv_proj = 2 * d * 2 * model["num_kv_heads"] * model["head_dim"]
    lin = linear_per_token(model, mlp)
    m = len(sel)
    dmax = max(sel) if m else -1
    sender = 0
    if m:
        sender = (dmax * (sc * lin + attn_ops(model, sc * (sc + 1) // 2))
                  + sc * kv_proj)
    logits = 2 * d * V
    causal = sq * (sq + 1) // 2
    receiver = (L * (sq * lin + attn_ops(model, causal))
                + m * attn_ops(model, sq * sc) + logits)
    decode = 0
    for j in range(1, n):
        decode += (L * (lin + attn_ops(model, sq + j))
                   + m * attn_ops(model, sc) + logits)
    return {"sender": sender, "receiver": receiver, "decode": decode}


def window_flops(model: Dict, mlp: str, items: Iterable, sel: Sequence[int]
                 ) -> int:
    """Needed operations of every request in ``items`` (each with
    ``context``, ``query`` and ``answer``)."""
    return sum(sum(request_flops(model, mlp, len(it.context) + 1,
                                 len(it.query), it.answer, sel).values())
               for it in items)


def k1_bytes(model: Dict, items: Iterable, sel: Sequence[int],
             itemsize: int = BYTES_BF16) -> int:
    """Bytes the decode attention (K1) needs over every decode step of
    ``items``: each live row reads K and V of its attended positions once,
    and its query row, and writes its output row."""
    L = model["num_layers"]
    hq, hkv, dh = model["num_heads"], model["num_kv_heads"], model["head_dim"]
    m = len(sel)
    kv_row = 2 * hkv * dh * itemsize
    qo = 2 * hq * dh * itemsize
    total = 0
    for it in items:
        sc, sq, n = len(it.context) + 1, len(it.query), it.answer
        for j in range(1, n):
            total += L * ((sq + j) * kv_row + qo) + m * sc * kv_row
    return total
