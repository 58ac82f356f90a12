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

    ``states`` is the state-sharing analogue for SSM layers: a dict of
    per-layer state leaves stacked on a leading L_ssm axis (float32), and
    ``state_select`` the (L_ssm,) bool mask (CPU) of the layers whose
    state the receiver starts from.
    """
    kv: Optional[dict] = None
    select: Optional[torch.Tensor] = None
    states: Optional[dict] = None
    state_select: Optional[torch.Tensor] = None
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

    def wire_meta(self) -> dict:
        """The JSON-safe static description a remote receiver rebuilds the
        view from besides the payload (the reference's key order, so a
        frame header built from it is the reference's byte for byte)."""
        return {
            "prefix_len": int(self.prefix_len),
            "pos_mode": self.pos_mode,
            "packed": self.is_packed,
            "layers": None if self.layers is None else list(self.layers),
            "src_layers": (None if self.src_layers is None
                           else list(self.src_layers)),
            "select": (None if self.select is None
                       else [bool(b) for b in self.select.tolist()]),
        }

    @classmethod
    def from_wire(cls, meta: dict, payload: Optional[dict] = None,
                  states=None, state_select=None,
                  num_layers: Optional[int] = None) -> "SharedKV":
        """Rebuild a receiver-side view from ``wire_meta()`` output and the
        decoded (M, B, Sc, Hkv, Dh) payload. The wire always carries the
        packed payload; ``meta["packed"]`` False asks for the dense view,
        scattered here on the receiving side."""
        select = (None if meta["select"] is None
                  else torch.tensor(meta["select"], dtype=torch.bool))
        layers = (None if meta["layers"] is None
                  else tuple(int(i) for i in meta["layers"]))
        src_layers = (None if meta["src_layers"] is None
                      else tuple(int(i) for i in meta["src_layers"]))
        shared = cls(packed_kv=payload, layers=layers, src_layers=src_layers,
                     select=select, states=states, state_select=state_select,
                     prefix_len=int(meta["prefix_len"]),
                     pos_mode=meta["pos_mode"])
        if payload is not None and not meta.get("packed", True):
            return shared.to_dense(num_layers)
        return shared

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
        return SharedKV(kv=kv, select=self.select, states=self.states,
                        state_select=self.state_select,
                        prefix_len=self.prefix_len, pos_mode=self.pos_mode)


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
