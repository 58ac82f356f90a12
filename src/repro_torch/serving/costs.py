"""Analytic compute/memory/communication cost model (paper §3.3 / §N).

These closed forms are what Fig. 8 plots (relative FLOPs of KVComm/Skyline
over AC) and what the §Perf napkin math starts from. All counts are per
sample, decoder-layer dominant terms only (embeddings and heads excluded),
matching the paper's notation:

  L  total layers          M   selected layers
  C  context tokens        Q   query tokens
  Tr receiver generated    Ts  sender generated (NLD)
  d  hidden dim
"""
from __future__ import annotations

from repro_torch.configs.base import ModelConfig


def _prefill(n_layers: int, n: int, d: int) -> float:
    return n_layers * (n * d * d + n * n * d)


def _decode(n_layers: int, n_ctx: int, t: int, d: int) -> float:
    # decoding t tokens against a growing context of n_ctx
    return n_layers * (t * d * d + sum(n_ctx + i for i in range(t)) * d)


def flops_skyline(cfg: ModelConfig, C: int, Q: int, Tr: int) -> float:
    L, d = cfg.num_layers, cfg.d_model
    return _prefill(L, C + Q, d) + _decode(L, C + Q, Tr, d)


def flops_baseline(cfg: ModelConfig, Q: int, Tr: int) -> float:
    L, d = cfg.num_layers, cfg.d_model
    return _prefill(L, Q, d) + _decode(L, Q, Tr, d)


def flops_kvcomm(cfg: ModelConfig, C: int, Q: int, Tr: int, M: int) -> float:
    """Sender prefill of C + receiver prefill/decode where only M layers
    attend over the extra C context entries (Eq. in §N)."""
    L, d = cfg.num_layers, cfg.d_model
    sender = _prefill(L, C, d)
    recv_pre = L * Q * d * d + M * (C + Q) * Q * d + (L - M) * Q * Q * d
    recv_dec = (Tr * (L * d * d)
                + M * sum(C + Q + i for i in range(Tr)) * d
                + (L - M) * sum(Q + i for i in range(Tr)) * d)
    return sender + recv_pre + recv_dec


def flops_kvcomm_receiver(cfg: ModelConfig, C: int, Q: int, Tr: int,
                          M: int) -> float:
    """Receiver-side cost only: the sender's prefill of C is amortized (its
    KV exists as a by-product of the sender agent's own operation) — the
    accounting behind the paper's Fig. 8 / §4.6 2.5-6x claim."""
    L, d = cfg.num_layers, cfg.d_model
    recv_pre = L * Q * d * d + M * (C + Q) * Q * d + (L - M) * Q * Q * d
    recv_dec = (Tr * (L * d * d)
                + M * sum(C + Q + i for i in range(Tr)) * d
                + (L - M) * sum(Q + i for i in range(Tr)) * d)
    return recv_pre + recv_dec


def flops_receiver_prefill(cfg: ModelConfig, C: int, Q: int,
                           M: int) -> float:
    """Receiver prefill alone under the packed fast path: all L layers pay
    the dense (d^2) terms, but only the M selected layers attend over the
    C-token prefix — the quantity the fig8 XLA cross-check measures.
    Dense full-sharing prefill is the M == L case."""
    L, d = cfg.num_layers, cfg.d_model
    return L * Q * d * d + M * (C + Q) * Q * d + (L - M) * Q * Q * d


def flops_decode_step(cfg: ModelConfig, C: int, Q: int, t: int,
                      M: int) -> float:
    """One decode step at generated-token index t (packed receiver): the
    per-token cost the jitted donated step pays — selected layers attend
    C + Q + t entries, unselected Q + t."""
    L, d = cfg.num_layers, cfg.d_model
    return L * d * d + (M * (C + Q + t) + (L - M) * (Q + t)) * d


def flops_ac(cfg: ModelConfig, C: int, Q: int, Tr: int) -> float:
    """Sender prefill of C + receiver prefill/decode of Q only (a single
    d-vector crosses; no extra attention cost)."""
    L, d = cfg.num_layers, cfg.d_model
    return _prefill(L, C, d) + flops_baseline(cfg, Q, Tr)


def flops_nld(cfg: ModelConfig, C: int, Q: int, Tr: int, Ts: int,
              sender_cfg: ModelConfig = None) -> float:
    """§N: sender prefill+decode of its message; receiver answers over the
    transmitted text (single information-transfer round).  ``sender_cfg``
    prices the sender side at its own depth/width on heterogeneous pairs
    (default: same model both sides)."""
    scfg = sender_cfg if sender_cfg is not None else cfg
    Ls, ds = scfg.num_layers, scfg.d_model
    L, d = cfg.num_layers, cfg.d_model
    sender = _prefill(Ls, C, ds) + _decode(Ls, C, Ts, ds)
    recv = _prefill(L, Ts + Q, d) + _decode(L, Ts + Q, Tr, d)
    return sender + recv


def kv_bytes(cfg: ModelConfig, C: int, M: int, itemsize: int = 2) -> int:
    return 2 * M * C * cfg.num_kv_heads * cfg.resolved_head_dim * itemsize


def kv_cache_memory(cfg: ModelConfig, C: int, Q: int, Tr: int, M: int,
                    itemsize: int = 2) -> int:
    """Receiver-side KV memory: selected layers hold C+Q+Tr entries, others
    Q+Tr (the paper's 23–73% memory saving vs Skyline). This is exactly the
    buffer footprint the packed selection-specialized cache allocates
    (dense masked sharing allocates the M == L skyline footprint)."""
    per_tok = 2 * cfg.num_kv_heads * cfg.resolved_head_dim * itemsize
    L = cfg.num_layers
    return per_tok * (M * (C + Q + Tr) + (L - M) * (Q + Tr))


def skyline_cache_memory(cfg: ModelConfig, C: int, Q: int, Tr: int,
                         itemsize: int = 2) -> int:
    per_tok = 2 * cfg.num_kv_heads * cfg.resolved_head_dim * itemsize
    return per_tok * cfg.num_layers * (C + Q + Tr)
