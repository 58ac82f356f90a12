"""Agent: one LLM participant (parameters + config + tokenizer) with its
sender and receiver roles.

  sender side   : ``export_kv`` (one prefill over the context: the KV and
                  the SSM states), ``message``
                  (NLD greedy tokens and CIPHER expected embeddings),
                  ``export_hiddens`` (the AC baselines' payload).
  receiver side : ``prefill`` / ``decode`` / ``decode_step`` /
                  ``generate`` over an optional ``SharedKV`` prefix,
                  ``calibrate`` and ``self_scores`` for Eq. (1) scores.

Agents produce and consume ``SharedKV`` views; the transport decides what
crosses and counts the bytes."""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional, Tuple

import numpy as np
import torch

from repro_torch import as_tokens
from repro_torch.configs.base import ModelConfig
from repro_torch.core import protocol
from repro_torch.core.types import SharedKV
from repro_torch.models import transformer as tfm


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
                  ) -> Tuple[Any, Any, int]:
        """One forward pass over [BOS? context]; returns (kv, states, Sc)
        (kv None for an attention-free model, states None without SSM
        layers)."""
        ctx = self.with_bos(context) if add_bos else np.asarray(context)
        kv, states = protocol.sender_prefill(self.params, self.cfg,
                                             self.tokens(ctx))
        return kv, states, ctx.shape[1]

    @torch.no_grad()
    def message(self, context: np.ndarray, n_tokens: int
                ) -> Tuple[np.ndarray, torch.Tensor]:
        """Continue after [BOS context] for ``n_tokens`` greedy steps on the
        masked-dense path: the tokens (NLD, host numpy (B, n)) and each
        step's expected embedding under the output distribution (CIPHER's
        soft tokens, float32 (B, n, D))."""
        cfg, B = self.cfg, context.shape[0]
        inp = self.tokens(self.with_bos(context))
        cache = tfm.init_cache(cfg, B, inp.shape[1] + n_tokens,
                               device=self.device)
        out = tfm.apply_model(self.params, cfg, inp, mode="cached",
                              cache=cache)
        cache, logits = out.cache, out.logits[:, -1, :]
        embed = self.params["embed"].float()
        toks, embs = [], []
        for i in range(n_tokens):
            nt = torch.argmax(logits, dim=-1)[:, None]
            embs.append(torch.softmax(logits, dim=-1) @ embed)
            toks.append(nt[:, 0])
            if i + 1 < n_tokens:       # the last token needs no logits
                o = tfm.apply_model(self.params, cfg, nt, mode="cached",
                                    cache=cache, logits_mode="last")
                cache, logits = o.cache, o.logits[:, -1, :]
        return torch.stack(toks, 1).cpu().numpy(), torch.stack(embs, 1)

    @torch.no_grad()
    def export_hiddens(self, context: np.ndarray) -> torch.Tensor:
        """The last token's input to every attention layer over [BOS
        context], (L_attn, B, D): the AC baselines' wire payload."""
        return tfm.apply_model(self.params, self.cfg,
                               self.tokens(self.with_bos(context)),
                               mode="train", capture_hidden=True).hiddens

    # ---- receiver role ----------------------------------------------------
    def prefill(self, tokens, shared: Optional[SharedKV] = None,
                max_new: int = 1, extra=None, prefix_lens=None):
        return protocol.receiver_prefill(self.params, self.cfg,
                                         self.tokens(tokens), shared,
                                         max_new=max_new, extra=extra,
                                         prefix_lens=prefix_lens)

    def decode(self, token, cache, shared: Optional[SharedKV] = None):
        """One eager decode step on the masked-dense path; ``token`` is
        (B, 1). Returns the model output (the cache updated in place)."""
        return protocol.receiver_decode(self.params, self.cfg,
                                        self.tokens(token), cache, shared)

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
                 max_new: int = 32, extra=None, backend: str = "reference"):
        return protocol.generate(self.params, self.cfg, self.tokens(tokens),
                                 shared, max_new=max_new, extra=extra,
                                 backend=backend)

    def calibrate(self, query, kv, states=None) -> torch.Tensor:
        """Eq. (1): prefill ``query`` with every layer (and state) shared;
        returns the normalized per-layer scores (CPU)."""
        return protocol.calibrate(self.params, self.cfg, self.tokens(query),
                                  kv, states)

    def self_scores(self, context: np.ndarray, query) -> torch.Tensor:
        """Eq. (1) scores over this model's own layers: calibrate ``query``
        against the agent's own KV (and states) of ``context``."""
        kv, states, _ = self.export_kv(context)
        return self.calibrate(query, kv, states)

    @staticmethod
    def predict_last(logits: torch.Tensor) -> np.ndarray:
        """argmax over the final position (the single-token answer), as
        host numpy."""
        return torch.argmax(logits[:, -1, :], dim=-1).cpu().numpy()
