"""Transfer records and the analytic wire-byte count."""
from __future__ import annotations

from dataclasses import dataclass

from repro_torch.configs.base import ModelConfig


@dataclass
class TransferRecord:
    kind: str                   # "kv"
    n_bytes: int
    layers: int
    context_len: int
    wire_dtype: str = "model"   # payload dtype ("model" = compute dtype)
    latency_s: float = 0.0      # device-synced wall clock of the transfer
                                # (0.0 until a deferred stamp settles)


def kv_wire_bytes(cfg: ModelConfig, batch: int, context_len: int,
                  num_layers_sent: int, itemsize: int = 2) -> int:
    """Analytic KV wire bytes of a uniform wire (int8 scales excluded)."""
    return (2 * num_layers_sent * batch * context_len
            * cfg.num_kv_heads * cfg.resolved_head_dim * itemsize)
