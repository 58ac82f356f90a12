"""Layer-mapping policies for heterogeneous sender/receiver pairs.

The paper's protocol assumes both models have the same attention depth
L, so one selection indexes both sides. When the depths differ, a
``LayerMap`` policy turns the sender-side selection (indices into the
sender's own L_attn) into a ``LayerAssignment``: paired ``src`` (sender)
and ``dst`` (receiver) attention-layer indices. Everything downstream is
keyed by ``dst``: the transport gathers ``kv[src]`` in ``dst`` order and
the packed ``SharedKV.layers`` carries ``dst``, so the receiver's packed
cache consumes a mapped view unchanged.

Invariants every policy upholds (checked by ``LayerAssignment``):
  * ``src`` and ``dst`` have equal length P, the mapped-pair count: the
    wire moves exactly P layers, which may be fewer than the sender's M
    when a policy drops layers;
  * ``dst`` is strictly ascending and within [0, L_dst): each receiver
    slot hosts at most one sender layer;
  * ``src`` is ascending: KV from a shallow sender layer never lands below
    KV from a deeper one.

Host-side numpy, as in the reference; ``register_layer_map`` adds a custom
policy under its ``name``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.selection import gaussian_prior, interp_scores


@dataclass(frozen=True)
class LayerAssignment:
    """A sender-layer -> receiver-slot mapping: ``src`` / ``dst`` are
    equal-length tuples of attention-layer indices paired by position,
    ``num_src_layers`` / ``num_dst_layers`` the two depths."""
    src: Tuple[int, ...]
    dst: Tuple[int, ...]
    num_src_layers: int
    num_dst_layers: int

    def __post_init__(self):
        assert len(self.src) == len(self.dst), "src/dst must pair up"
        assert all(0 <= i < self.num_src_layers for i in self.src), \
            f"src indices out of range: {self.src}"
        assert all(0 <= j < self.num_dst_layers for j in self.dst), \
            f"dst indices out of range: {self.dst}"
        assert all(a < b for a, b in zip(self.dst, self.dst[1:])), \
            f"dst must be strictly ascending: {self.dst}"
        assert all(a <= b for a, b in zip(self.src, self.src[1:])), \
            f"src must preserve depth order: {self.src}"

    @property
    def num_pairs(self) -> int:
        return len(self.src)

    def dst_mask(self) -> np.ndarray:
        """(L_dst,) bool: the receiver-side selection of the mapped view."""
        m = np.zeros((self.num_dst_layers,), bool)
        if self.dst:
            m[np.asarray(self.dst)] = True
        return m

    @property
    def is_identity(self) -> bool:
        """Every pair maps a layer onto itself (the homogeneous case)."""
        return self.src == self.dst


class LayerMap:
    """Base policy: subclasses set ``name`` and implement ``assign``, which
    takes the sender's selected layer indices, both depths and optional
    per-side scores over each model's own layers (host vectors)."""
    name: str = ""

    def assign(self, src_layers: Sequence[int], num_src_layers: int,
               num_dst_layers: int,
               src_scores: Optional[np.ndarray] = None,
               dst_scores: Optional[np.ndarray] = None) -> LayerAssignment:
        raise NotImplementedError


LAYER_MAPS: Dict[str, LayerMap] = {}


def register_layer_map(policy: LayerMap) -> LayerMap:
    """Add a policy instance to the registry (the last one of a name
    wins)."""
    if not policy.name:
        raise ValueError("a layer map needs a name")
    LAYER_MAPS[policy.name] = policy
    return policy


def get_layer_map(name: str) -> LayerMap:
    try:
        return LAYER_MAPS[name]
    except KeyError:
        raise ValueError(f"unknown layer map {name!r}; "
                         f"registered: {sorted(LAYER_MAPS)}") from None


class IdentityTruncate(LayerMap):
    """Sender layer i -> receiver slot i; layers at or beyond the
    receiver's depth are dropped. On a same-depth pair it is the identity,
    bit-exact with the unmapped path."""
    name = "identity"

    def assign(self, src_layers, num_src_layers, num_dst_layers,
               src_scores=None, dst_scores=None) -> LayerAssignment:
        kept = tuple(i for i in sorted(src_layers) if i < num_dst_layers)
        return LayerAssignment(src=kept, dst=kept,
                               num_src_layers=num_src_layers,
                               num_dst_layers=num_dst_layers)


class DepthProportional(LayerMap):
    """Sender layer i -> the receiver slot at the same relative depth,
    round(i * (L_dst - 1) / (L_src - 1)) (Python's round: half to even).
    When several sender layers land on one slot the shallowest keeps it."""
    name = "depth_proportional"

    def assign(self, src_layers, num_src_layers, num_dst_layers,
               src_scores=None, dst_scores=None) -> LayerAssignment:
        if num_src_layers > 1:
            scale = (num_dst_layers - 1) / (num_src_layers - 1)
            pos = lambda i: int(round(i * scale))        # noqa: E731
        else:
            pos = lambda i: (num_dst_layers - 1) // 2    # noqa: E731
        src, dst, taken = [], [], set()
        for i in sorted(src_layers):
            j = pos(i)
            if j in taken:
                continue
            src.append(i)
            dst.append(j)
            taken.add(j)
        return LayerAssignment(src=tuple(src), dst=tuple(dst),
                               num_src_layers=num_src_layers,
                               num_dst_layers=num_dst_layers)


class ScoreGreedy(LayerMap):
    """Keep the P = min(M, L_dst) highest-scoring sender layers and host
    them in the P highest-scoring receiver slots, both sides in depth
    order. Sender scores default to the sender's Gaussian depth prior;
    missing receiver scores are the sender's scores resampled onto the
    receiver's depth (``interp_scores``). Ties break shallow-first."""
    name = "score_greedy"

    def assign(self, src_layers, num_src_layers, num_dst_layers,
               src_scores=None, dst_scores=None) -> LayerAssignment:
        src_layers = sorted(src_layers)
        if src_scores is None:
            src_scores = gaussian_prior(num_src_layers).numpy()
        else:
            src_scores = np.asarray(src_scores, np.float64)
        if dst_scores is None:
            dst_scores = interp_scores(src_scores, num_dst_layers).numpy()
        else:
            dst_scores = np.asarray(dst_scores, np.float64)
        P = min(len(src_layers), num_dst_layers)
        by_score = sorted(src_layers, key=lambda i: (-src_scores[i], i))
        src = tuple(sorted(by_score[:P]))
        slots = sorted(range(num_dst_layers),
                       key=lambda j: (-dst_scores[j], j))
        dst = tuple(sorted(slots[:P]))
        return LayerAssignment(src=src, dst=dst,
                               num_src_layers=num_src_layers,
                               num_dst_layers=num_dst_layers)


register_layer_map(IdentityTruncate())
register_layer_map(DepthProportional())
register_layer_map(ScoreGreedy())
