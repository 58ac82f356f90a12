"""Bring the reference package's parameters into the port.

``params_from_jax`` takes the reference parameters as numpy arrays, either
the nested tree (``jax.tree.map(np.asarray, params)``) or the flat
``blocks/0/attn/wq`` keys of its checkpoint files, and returns the port's
per-layer dict: each run's leading layer axis is unstacked, runs are
concatenated in layer-plan order. Attention runs (``ln1``, ``ln2``,
``attn`` and ``mlp``, or ``moe``: ``router`` (d, E), ``w_gate`` / ``w_up``
(E, d, f), ``w_down`` (E, f, d)), RWKV6 (``ln1``, ``ln2``, ``rwkv``) and
Mamba2 (``ln``, ``mamba``) runs cross; a Zamba-style
``shared_attn`` run (``None`` in the reference's ``blocks``) becomes
entries that all point at the one top-level ``shared_attn`` dict.
"""
from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

from repro_torch import resolve_device


def _nest(flat: Mapping[str, Any]) -> Dict[str, Any]:
    """Flat 'a/b/c' keys -> nested dicts; the 'blocks' level becomes a list
    ordered by run index, with None for a run that has no arrays (the
    reference's shared-attention runs)."""
    tree: Dict[str, Any] = {}
    for key, arr in flat.items():
        node = tree
        parts = key.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = arr
    if "blocks" in tree:
        runs = tree["blocks"]
        tree["blocks"] = [runs.get(str(i)) for i in
                          range(max(int(k) for k in runs) + 1)]
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


def params_from_jax(tree: Mapping[str, Any], *, cfg=None, device=None,
                    dtype: torch.dtype = None) -> Dict[str, Any]:
    """Reference parameters (nested numpy tree, or flat checkpoint keys) ->
    the port's parameters on ``device``, each in its array's own dtype
    (float32, float16 or bfloat16) unless ``dtype`` is given; a MoE
    router stays in its own dtype (float32, as the reference inits it)
    either way. The
    default device is the card: without one this raises unless the caller
    passes ``device="cpu"``.

    ``cfg`` (the model's ``ModelConfig``) places shared-attention runs by
    the layer plan; without it each ``None`` run of a nested tree is one
    invocation. A flat hybrid checkpoint holds no trace of its trailing
    shared-attention run, so it needs ``cfg``."""
    device = resolve_device(device)
    flat = any("/" in k for k in tree)
    if flat:
        tree = _nest(tree)
    conv = lambda a: _tensor(a, device, dtype)                # noqa: E731
    keep = lambda a: _tensor(a, device, None)                 # noqa: E731
    out: Dict[str, Any] = {"embed": conv(tree["embed"]),
                           "final_norm": conv(tree["final_norm"]),
                           "layers": []}
    if "lm_head" in tree:
        out["lm_head"] = conv(tree["lm_head"])
    blocks = list(tree["blocks"])
    plan = None if cfg is None else cfg.layer_plan()
    if "shared_attn" in tree:
        if flat and plan is None:
            raise ValueError("a flat checkpoint with shared attention needs "
                             "cfg to place its invocations")
        sa = tree["shared_attn"]
        out["shared_attn"] = {
            "ln1": conv(sa["ln1"]), "ln2": conv(sa["ln2"]),
            "attn": {k: conv(v) for k, v in sa["attn"].items()},
            "mlp": {k: conv(v) for k, v in sa["mlp"].items()}}
    if plan is not None:
        blocks += [None] * (len(plan) - len(blocks))
    for ri, run in enumerate(blocks):
        if run is None:
            if "shared_attn" not in out:
                raise ValueError(f"run {ri} holds no parameters and the tree "
                                 "has no shared_attn block")
            count = 1 if plan is None else plan[ri].count
            out["layers"] += [out["shared_attn"]] * count
            continue
        if "rwkv" in run:
            parts, nested = ("ln1", "ln2"), ("rwkv",)
        elif "mamba" in run:
            parts, nested = ("ln",), ("mamba",)
        elif "attn" in run and "xattn" not in run and ("mlp" in run
                                                       or "moe" in run):
            parts = ("ln1", "ln2")
            nested = ("attn", "mlp" if "mlp" in run else "moe")
        else:
            raise NotImplementedError(
                f"run {ri} ({sorted(run)}): only attention (dense or MoE), "
                "RWKV6 and Mamba2 runs are ported")
        n = np.asarray(run[parts[0]]).shape[0]
        for i in range(n):
            layer = {k: conv(run[k][i]) for k in parts}
            for k in nested:
                layer[k] = {name: (keep(v[i]) if (k, name) == ("moe",
                                                             "router")
                                   else conv(v[i]))
                            for name, v in run[k].items()}
            out["layers"].append(layer)
    return out
