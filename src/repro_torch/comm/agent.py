"""Agent: one LLM participant (parameters + config + tokenizer) with its
sender and receiver roles. Agents produce and consume ``SharedKV`` views;
the transport decides what crosses and counts the bytes."""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional, Tuple

import numpy as np
import torch

from repro_torch import as_tokens
from repro_torch.configs.base import ModelConfig
from repro_torch.core import protocol
from repro_torch.core.types import SharedKV


@dataclass
class Agent:
    name: str
    cfg: ModelConfig
    params: Any
    tok: Any

    @property
    def device(self) -> torch.device:
        return self.params["embed"].device

    def tokens(self, arr) -> torch.Tensor:
        """Token ids (numpy or tensor) on this agent's device."""
        if isinstance(arr, torch.Tensor):
            return arr.to(self.device)
        return as_tokens(np.asarray(arr), self.device)

    def with_bos(self, arr: np.ndarray) -> np.ndarray:
        """Prepend BOS to every row of a (B, S) token batch."""
        b = np.full((arr.shape[0], 1), self.tok.BOS, np.int32)
        return np.concatenate([b, arr], axis=1)

    # ---- sender role ------------------------------------------------------
    def export_kv(self, context: np.ndarray, *, add_bos: bool = True
                  ) -> Tuple[Any, int]:
        """One forward pass over [BOS? context]; returns (kv, Sc)."""
        ctx = self.with_bos(context) if add_bos else np.asarray(context)
        return (protocol.sender_prefill(self.params, self.cfg,
                                        self.tokens(ctx)), ctx.shape[1])

    # ---- receiver role ----------------------------------------------------
    def prefill(self, tokens, shared: Optional[SharedKV] = None,
                max_new: int = 1, prefix_lens=None):
        return protocol.receiver_prefill(self.params, self.cfg,
                                         self.tokens(tokens), shared,
                                         max_new=max_new,
                                         prefix_lens=prefix_lens)

    def decode_step(self, token, cache, shared: Optional[SharedKV] = None,
                    backend: str = "reference"):
        """One greedy step; returns (next_token (B, 1), logits, cache)."""
        return protocol.decode_step(self.params, self.cfg, token, cache,
                                    shared, backend=backend)

    def ragged_step(self, tokens, cache, shared: Optional[SharedKV],
                    prefix_lens, active, backend: str = "reference"):
        """One continuous-batching iteration over a slot-table cache."""
        return protocol.ragged_decode_step(self.params, self.cfg, tokens,
                                           cache, shared, prefix_lens,
                                           active, backend=backend)

    def generate(self, tokens, shared: Optional[SharedKV] = None,
                 max_new: int = 32, backend: str = "reference"):
        return protocol.generate(self.params, self.cfg, self.tokens(tokens),
                                 shared, max_new=max_new, backend=backend)

    def calibrate(self, query, kv) -> torch.Tensor:
        """Eq. (1): prefill ``query`` with every layer shared; returns the
        normalized per-layer scores (CPU)."""
        return protocol.calibrate(self.params, self.cfg, self.tokens(query),
                                  kv)
