"""CommSession: a sender/receiver pairing over a transport.

It owns the calibration state (Eq. (1) scores and frozen layer selections,
cached per task key and ``KVCommConfig``), the transport, and batched and
streaming generation on the receiver. Multi-sender mailboxes, the
resilience ladder and heterogeneous pairs are not ported yet.
"""
from __future__ import annotations

from typing import Dict, Iterator, Optional, Tuple

import numpy as np
import torch

from repro_torch.comm.agent import Agent
from repro_torch.comm.transport import InMemoryTransport, Transport
from repro_torch.core import protocol
from repro_torch.core.types import KVCommConfig, SharedKV


class CommSession:
    def __init__(self, sender: Agent, receiver: Agent,
                 transport: Optional[Transport] = None):
        scfg, rcfg = sender.cfg, receiver.cfg
        if scfg.attn_layer_count != rcfg.attn_layer_count:
            raise NotImplementedError("heterogeneous pairs are not ported")
        if (scfg.num_kv_heads, scfg.resolved_head_dim) != \
                (rcfg.num_kv_heads, rcfg.resolved_head_dim):
            raise ValueError("sender/receiver must agree on KV geometry")
        self.sender = sender
        self.receiver = receiver
        self.transport = transport if transport is not None \
            else InMemoryTransport()
        self.cfg = rcfg
        self._score_cache: Dict[Optional[str], torch.Tensor] = {}
        self._sel_cache: Dict[Tuple[Optional[str], KVCommConfig],
                              torch.Tensor] = {}

    # ---- calibration + frozen selections ---------------------------------
    def calibrate(self, context: np.ndarray, query: np.ndarray,
                  key: Optional[str] = None) -> torch.Tensor:
        """Eq. (1) scores from one calibration sample, cached under
        ``key``: the receiver consumes the sender's KV of ``context``."""
        if key is not None and key in self._score_cache:
            return self._score_cache[key]
        kv, _ = self.sender.export_kv(context)
        scores = self.receiver.calibrate(query, kv)
        if key is not None:
            self._score_cache[key] = scores
        return scores

    def selection(self, kvcfg: KVCommConfig,
                  scores: Optional[torch.Tensor] = None,
                  key: Optional[str] = None) -> torch.Tensor:
        """The frozen layer subset for (task key, kvcfg), computed once.
        Explicit ``scores`` recompute and refresh the cache."""
        cache_key = (key, kvcfg)
        if scores is None and key is not None:
            if cache_key in self._sel_cache:
                return self._sel_cache[cache_key]
            scores = self._score_cache.get(key)
        select = protocol.make_selection(self.cfg, kvcfg, scores)
        if key is not None:
            self._sel_cache[cache_key] = select
        return select

    # ---- one communication round -----------------------------------------
    def share(self, context: np.ndarray, kvcfg: KVCommConfig,
              scores: Optional[torch.Tensor] = None,
              key: Optional[str] = None, sync: Optional[bool] = None
              ) -> Tuple[SharedKV, torch.Tensor]:
        """Prefill the context on the sender, select layers, push through
        the transport. Returns (receiver-side SharedKV, select).
        ``sync=False`` keeps the round free of host waits (the transfer's
        stamp is deferred)."""
        select = self.selection(kvcfg, scores=scores, key=key)
        kv, _ = self.sender.export_kv(context)
        shared = self.transport.send(self.cfg, kvcfg, kv, select, sync=sync)
        return shared, select

    # ---- generation -------------------------------------------------------
    def generate(self, query: np.ndarray, shared: Optional[SharedKV] = None,
                 max_new: int = 32) -> np.ndarray:
        """Batched greedy generation on the receiver: (B, max_new)."""
        toks, _ = self.receiver.generate(query, shared, max_new=max_new)
        return toks.cpu().numpy()

    def stream(self, query: np.ndarray, shared: Optional[SharedKV] = None,
               max_new: int = 32,
               backend: str = "reference") -> Iterator[np.ndarray]:
        """Streaming greedy generation: yields one (B,) token per step."""
        if max_new <= 0:
            return
        out = self.receiver.prefill(query, shared, max_new=max_new)
        cache = out.cache
        tok = torch.argmax(out.logits[:, -1, :], dim=-1)[:, None]
        yield tok[:, 0].cpu().numpy()
        for _ in range(max_new - 1):
            tok, _, cache = self.receiver.decode_step(tok, cache, shared,
                                                      backend=backend)
            yield tok[:, 0].cpu().numpy()
