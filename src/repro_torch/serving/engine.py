"""CommEngine: the reference's older facade over the comm stack, kept with
its constructor and ``run`` signature. Every call goes to a
``CommSession``, whose methods are the ``METHODS`` registry; new code
builds the session directly::

    from repro_torch.comm import Agent, CommSession
    session = CommSession(Agent("s", cfg, sender_params, tok),
                          Agent("r", cfg, receiver_params, tok))
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from repro_torch.comm import Agent, CommSession, MethodResult, Transport
from repro_torch.configs.base import ModelConfig
from repro_torch.core.types import KVCommConfig

__all__ = ["CommEngine", "MethodResult"]


class CommEngine:
    """(cfg, sender params, receiver params, tokenizer) in, ``MethodResult``
    out: a thin ``CommSession`` wrapper."""

    def __init__(self, cfg: ModelConfig, sender_params, receiver_params, tok,
                 transport: Optional[Transport] = None):
        self.cfg = cfg
        self.tok = tok
        self.session = CommSession(
            Agent("sender", cfg, sender_params, tok),
            Agent("receiver", cfg, receiver_params, tok), transport)

    @property
    def sender(self):
        return self.session.sender.params

    @property
    def receiver(self):
        return self.session.receiver.params

    @property
    def channel(self) -> Transport:
        """The byte-accounted link (``.log`` / ``.total_bytes``)."""
        return self.session.transport

    def sender_kv(self, context: np.ndarray):
        """Sender prefill over [BOS context]; returns (kv, states, Sc)."""
        return self.session.sender.export_kv(context)

    def calibrate(self, context: np.ndarray, query: np.ndarray
                  ) -> torch.Tensor:
        return self.session.calibrate(context, query)

    def selection_for(self, kvcfg: KVCommConfig,
                      scores: Optional[torch.Tensor]) -> torch.Tensor:
        return self.session.selection(kvcfg, scores=scores)

    def run(self, method: str, batch: Dict[str, np.ndarray],
            kvcfg: Optional[KVCommConfig] = None,
            scores: Optional[torch.Tensor] = None,
            ac_layer: Optional[int] = None, nld_tokens: int = 16,
            max_new: int = 1) -> MethodResult:
        return self.session.run(method, batch, kvcfg=kvcfg, scores=scores,
                                ac_layer=ac_layer, nld_tokens=nld_tokens,
                                max_new=max_new)
