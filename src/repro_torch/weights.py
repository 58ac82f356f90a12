"""Bring the reference package's parameters into the port.

``params_from_jax`` takes the reference parameters as numpy arrays, either
the nested tree (``jax.tree.map(np.asarray, params)``) or the flat
``blocks/0/attn/wq`` keys of its checkpoint files, and returns the port's
per-layer dict: each run's leading layer axis is unstacked, runs are
concatenated in layer-plan order.
"""
from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

from repro_torch import resolve_device


def _nest(flat: Mapping[str, Any]) -> Dict[str, Any]:
    """Flat 'a/b/c' keys -> nested dicts; the 'blocks' level becomes a list
    ordered by run index."""
    tree: Dict[str, Any] = {}
    for key, arr in flat.items():
        node = tree
        parts = key.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = arr
    if "blocks" in tree:
        tree["blocks"] = [tree["blocks"][k] for k in
                          sorted(tree["blocks"], key=int)]
    return tree


def _tensor(a, device, dtype) -> torch.Tensor:
    """One array as a tensor of its own dtype (or ``dtype``). numpy has no
    bfloat16: ml_dtypes' bf16 arrays cross through their uint16 bits."""
    a = np.array(a)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    return t.to(device=device, dtype=dtype or t.dtype)


def params_from_jax(tree: Mapping[str, Any], *, device=None,
                    dtype: torch.dtype = None) -> Dict[str, Any]:
    """Reference parameters (nested numpy tree, or flat checkpoint keys) ->
    the port's parameters on ``device``, each in its array's own dtype
    (float32, float16 or bfloat16) unless ``dtype`` is given. The
    default device is the card: without one this raises unless the caller
    passes ``device="cpu"``."""
    device = resolve_device(device)
    if any("/" in k for k in tree):
        tree = _nest(tree)
    conv = lambda a: _tensor(a, device, dtype)                # noqa: E731
    out: Dict[str, Any] = {"embed": conv(tree["embed"]),
                           "final_norm": conv(tree["final_norm"]),
                           "layers": []}
    if "lm_head" in tree:
        out["lm_head"] = conv(tree["lm_head"])
    for run in tree["blocks"]:
        if run is None or "attn" not in run or "mlp" not in run:
            raise NotImplementedError("only dense attention runs are ported")
        n = np.asarray(run["ln1"]).shape[0]
        for i in range(n):
            out["layers"].append({
                "ln1": conv(run["ln1"][i]),
                "ln2": conv(run["ln2"][i]),
                "attn": {k: conv(v[i]) for k, v in run["attn"].items()},
                "mlp": {k: conv(v[i]) for k, v in run["mlp"].items()},
            })
    return out
