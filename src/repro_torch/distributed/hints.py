"""Activation-sharding hints for the model code (the counterpart of the
reference's ``distributed/hints.py``).

The reference pins activations between layers to ``P(data_axes, 'model',
None)`` (batch over data, sequence over model: Megatron-style sequence
parallelism, pointwise norms stay sequence-local) and the logits to
``P(data_axes, None, 'model')``, which keeps remat-saved residuals sharded
instead of replicated. Here the same layouts are DTensor redistributions.

The hints are a no-op unless a launcher installs the mesh axes with
``set_axes``, and on a plain tensor (no mesh in use) they return the
input unchanged.
"""
from __future__ import annotations

from typing import Optional, Tuple

from torch.distributed.tensor import DTensor

from repro_torch.distributed.sharding import _sanitize, to_placements

_AXES: Optional[Tuple] = None   # (dp_axes, tp_axis)


def set_axes(dp, tp) -> None:
    global _AXES
    _AXES = (dp, tp)


def clear() -> None:
    global _AXES
    _AXES = None


def _constrain(x, spec):
    mesh = x.device_mesh
    pl = to_placements(_sanitize(spec, tuple(x.shape), mesh), mesh)
    return x if tuple(x.placements) == pl else x.redistribute(mesh, pl)


def shard_activations(x):
    """Constrain (B, S, d) activations: batch->data, seq->model."""
    if _AXES is None or not isinstance(x, DTensor) or x.ndim != 3:
        return x
    dp, tp = _AXES
    return _constrain(x, (dp, tp if x.shape[1] > 1 else None, None))


def gather_sequence(x):
    """(B, S, d) activations with the sequence whole again (batch stays
    over data), where a layer starts: the all-gather of Megatron-style
    sequence parallelism. The layer's products then see a batch-sharded
    (B * S, d) view; a sequence-sharded one is a strided shard, which
    DTensor plans by a graph search costing seconds per new op."""
    if _AXES is None or not isinstance(x, DTensor) or x.ndim != 3:
        return x
    dp, _ = _AXES
    return _constrain(x, (dp, None, None))


def shard_logits(x):
    """Constrain (B, S, V) logits: batch->data, vocab->model."""
    if _AXES is None or not isinstance(x, DTensor) or x.ndim != 3:
        return x
    dp, tp = _AXES
    return _constrain(x, (dp, None, tp))
