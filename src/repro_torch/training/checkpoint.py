"""Checkpoints of the port: a tree -> one ``.npz`` plus a ``.meta.json``,
with the reference's keys (a port of ``training/checkpoint.py``).

A key is the tree path joined by ``/``, as the reference's
``jax.tree_util`` paths give it (dict keys, list indices), so a model's
parameters are stored in the reference's stacked layout
(``blocks/0/attn/wq`` with a leading layer axis): ``save`` and ``restore``
take the model's ``cfg`` and cross through ``weights.params_to_jax`` and
``weights.params_from_jax``. Without ``cfg`` any tree of tensors is stored
path by path. bfloat16 arrays are stored as the reference stores them (the
2-byte void dtype ``np.savez`` writes for JAX's bfloat16), the same bits,
so a checkpoint written by either package restores in the other bit for
bit (the reference's own ``restore`` refuses a bfloat16 file, its own
included: ``jnp.asarray`` has no cast from that void dtype).
"""
from __future__ import annotations

import json
import os
from typing import Any, Dict, Iterator, Tuple

import numpy as np
import torch

from repro_torch.training.optimizer import tree_map
from repro_torch.weights import (_is_bf16, _tensor, params_from_jax,
                                 params_to_jax, to_numpy)


def _paths(tree, prefix: Tuple[str, ...] = ()) -> Iterator[Tuple[str, Any]]:
    """(key, leaf) in the reference's flatten order: dict keys sorted,
    lists by index, ``None`` holds no leaf."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _paths(tree[k], prefix + (str(k),))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _paths(v, prefix + (str(i),))
    elif tree is not None:
        yield "/".join(prefix), tree


def _host_tree(tree, cfg):
    return (params_to_jax(tree, cfg) if cfg is not None
            else tree_map(to_numpy, tree))


def _npz(path: str) -> str:
    return path if path.endswith(".npz") else path + ".npz"


def save(path: str, tree: Any, metadata: dict | None = None, *,
         cfg=None) -> None:
    """Write ``tree`` (a model's parameters with its ``cfg``, or any tree
    of tensors) to ``path``.npz and its manifest to ``path``.meta.json."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    flat = dict(_paths(_host_tree(tree, cfg)))
    np.savez(_npz(path), **flat)
    meta = {"keys": sorted(flat), **(metadata or {})}
    with open(_meta_path(path), "w") as f:
        json.dump(meta, f, indent=1)


def _torch_dtype(a: np.ndarray) -> torch.dtype:
    if _is_bf16(a):
        return torch.bfloat16
    return torch.from_numpy(np.zeros(0, a.dtype)).dtype


def restore(path: str, template: Any, *, cfg=None) -> Any:
    """Restore into the structure of ``template`` (shapes must match; each
    array is cast to the template's dtype and placed on its device). With
    ``cfg`` the template is a model's parameters and the result the port's
    per-layer parameters."""
    npz = np.load(_npz(path))
    device = next(iter(_paths(template)))[1].device
    flat: Dict[str, torch.Tensor] = {}
    for key, leaf in _paths(_host_tree(template, cfg)):
        arr = npz[key]
        assert arr.shape == leaf.shape, (key, arr.shape, leaf.shape)
        flat[key] = _tensor(arr, device, _torch_dtype(leaf))
    if cfg is not None:
        return params_from_jax({k: to_numpy(v) for k, v in flat.items()},
                               cfg=cfg, device=device)
    keyed = iter(flat.values())
    return tree_map(lambda _: next(keyed), _sorted(template))


def _sorted(tree):
    """The template with its dict keys in flatten order, so a map over it
    meets the leaves in ``_paths`` order."""
    if isinstance(tree, dict):
        return {k: _sorted(tree[k]) for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_sorted(v) for v in tree)
    return tree


def load_metadata(path: str) -> dict:
    with open(_meta_path(path)) as f:
        return json.load(f)


def _meta_path(path: str) -> str:
    base = path[:-4] if path.endswith(".npz") else path
    return base + ".meta.json"
