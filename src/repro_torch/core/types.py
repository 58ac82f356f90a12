"""Protocol types: the receiver-side ``SharedKV`` view and the selection
hyperparameters ``KVCommConfig``."""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional, Tuple

import torch


@dataclass
class SharedKV:
    """Everything the receiver needs from the sender.

    dense  — ``kv`` holds {"k","v"} of (L_attn, B, prefix_len, Hkv, Dh):
             every layer's sender KV; ``select`` decides what is used.
    packed — ``packed_kv`` holds {"k","v"} of (M, B, prefix_len, Hkv, Dh):
             only the selected layers' KV (the wire payload), and
             ``layers`` is the tuple of selected layer indices.

    ``select`` is an (L_attn,) bool tensor on the CPU: selections are frozen
    on the host, so building a cache from it never waits on the card.
    """
    kv: Optional[dict] = None
    select: Optional[torch.Tensor] = None
    prefix_len: int = 0
    pos_mode: str = "shift"          # "shift" (paper) | "zero_unselected"
    packed_kv: Optional[dict] = None
    layers: Optional[Tuple[int, ...]] = None
    # sender-side provenance of each packed slot (None = identity, the
    # homogeneous case); decode steps never read it, so meta() drops it
    src_layers: Optional[Tuple[int, ...]] = None

    @property
    def is_packed(self) -> bool:
        return self.layers is not None

    def meta(self) -> "SharedKV":
        """Payload-free view for decode steps: after prefill the KV lives in
        the receiver's cache, so a step needs only the layout."""
        return SharedKV(select=self.select, prefix_len=self.prefix_len,
                        pos_mode=self.pos_mode, layers=self.layers)

    def to_dense(self, num_layers: Optional[int] = None) -> "SharedKV":
        """Scatter the packed payload into a zero-padded dense stack."""
        if not self.is_packed:
            return self
        kv = None
        if self.packed_kv is not None:
            L = num_layers if num_layers is not None else len(self.select)
            kv = {}
            for part in ("k", "v"):
                pk = self.packed_kv[part]
                dense = pk.new_zeros((L,) + tuple(pk.shape[1:]))
                for m, l in enumerate(self.layers):
                    dense[l] = pk[m]
                kv[part] = dense
        return SharedKV(kv=kv, select=self.select, prefix_len=self.prefix_len,
                        pos_mode=self.pos_mode)


@dataclass(frozen=True)
class KVCommConfig:
    """Hyperparameters of the paper's selection strategy (§3.2, §B.2)."""
    ratio: float = 0.5            # M = ceil(ratio * L)
    alpha: float = 1.0            # score mix: alpha*S_a + (1-alpha)*prior
    mu: Optional[float] = None    # Gaussian center; None -> L/2
    sigma: float = 10.0
    selector: str = "kvcomm"      # kvcomm | random | prior_only |
                                  # contiguous | all
    pos_mode: str = "shift"
    layer_from: int = 0           # contiguous-chunk ablation start
    seed: int = 0                 # for the random selector

    def num_selected(self, num_layers: int) -> int:
        """M = ceil(ratio * L), clamped to [1, L]."""
        return min(num_layers, max(1, math.ceil(self.ratio * num_layers)))
