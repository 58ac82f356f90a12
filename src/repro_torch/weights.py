"""Carry parameters between the reference package's layout and the port's.

``params_from_jax`` takes the reference parameters as numpy arrays, either
the nested tree (``jax.tree.map(np.asarray, params)``) or the flat
``blocks/0/attn/wq`` keys of its checkpoint files, and returns the port's
per-layer dict: each run's leading layer axis is unstacked, runs are
concatenated in layer-plan order. Attention runs (``ln1``, ``ln2``,
``attn`` and ``mlp``, or ``moe``: ``router`` (d, E), ``w_gate`` / ``w_up``
(E, d, f), ``w_down`` (E, f, d); whisper's decoder layers add ``ln_x`` and
``xattn``), RWKV6 (``ln1``, ``ln2``, ``rwkv``) and Mamba2 (``ln``,
``mamba``) runs cross; a Zamba-style ``shared_attn`` run (``None`` in the
reference's ``blocks``) becomes entries that all point at the one
top-level ``shared_attn`` dict; whisper's ``encoder`` (``blocks`` and
``final_norm``) becomes ``params["encoder"]`` with its own ``layers``.

``params_to_jax`` is the inverse: it restacks each run of the layer plan
(and the encoder's) into the reference's nested tree of numpy arrays, so
the port's checkpoints carry the reference's keys. Every array keeps its
dtype; numpy has no bfloat16, so bfloat16 crosses as the 2-byte void
array the reference's ``np.savez`` writes for it (``|V2``, the same bits).
"""
from __future__ import annotations

from typing import Any, Dict, List, Mapping

import numpy as np
import torch

from repro_torch import resolve_device

# the reference inits a MoE router in float32 whatever the model dtype
_KEEP_DTYPE = {("moe", "router")}


def _nest(flat: Mapping[str, Any]) -> Dict[str, Any]:
    """Flat 'a/b/c' keys -> nested dicts; every 'blocks' level becomes a
    list ordered by run index, with None for a run that has no arrays (the
    reference's shared-attention runs)."""
    tree: Dict[str, Any] = {}
    for key, arr in flat.items():
        node = tree
        parts = key.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = arr
    for node in (tree, tree.get("encoder", {})):
        if "blocks" in node:
            runs = node["blocks"]
            node["blocks"] = [runs.get(str(i)) for i in
                              range(max(int(k) for k in runs) + 1)]
    return tree


def _is_bf16(a: np.ndarray) -> bool:
    """ml_dtypes' bfloat16 (a JAX array's numpy view) or the 2-byte void
    array that ``np.savez`` / ``np.load`` make of it."""
    return a.dtype.name == "bfloat16" or (a.dtype.kind == "V"
                                          and a.dtype.itemsize == 2)


def _tensor(a, device, dtype) -> torch.Tensor:
    """One array as a tensor of its own dtype (or ``dtype``). numpy has no
    bfloat16: those arrays cross through their uint16 bits."""
    a = np.array(a)
    if _is_bf16(a):
        t = torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    return t.to(device=device, dtype=dtype or t.dtype)


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """A tensor as a host numpy array of the same bits: bfloat16 as the
    ``|V2`` void array the reference's checkpoints hold."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16).view("V2")
    return t.numpy()


def _layer(run, i: int, conv, keep, path=()) -> Dict[str, Any]:
    """Layer ``i`` of a stacked run (a nested dict of arrays)."""
    out = {}
    for k, v in run.items():
        if isinstance(v, Mapping):
            out[k] = _layer(v, i, conv, keep, path + (k,))
        else:
            out[k] = (keep if path + (k,) in _KEEP_DTYPE else conv)(v[i])
    return out


def _check_run(ri: int, run) -> None:
    if not ("rwkv" in run or "mamba" in run or (
            "attn" in run and ("mlp" in run or "moe" in run))):
        raise NotImplementedError(
            f"run {ri} ({sorted(run)}): not an attention (dense, MoE or "
            "cross-attention), RWKV6 or Mamba2 run")


def _unstack(runs, conv, keep, plan, shared) -> List[Dict[str, Any]]:
    """Every run's layers in order; a ``None`` run is ``count`` (or one,
    without a plan) invocations of ``shared``."""
    layers: List[Dict[str, Any]] = []
    runs = list(runs)
    if plan is not None:
        runs += [None] * (len(plan) - len(runs))
    for ri, run in enumerate(runs):
        if run is None:
            if shared is None:
                raise ValueError(f"run {ri} holds no parameters and the tree "
                                 "has no shared_attn block")
            layers += [shared] * (1 if plan is None else plan[ri].count)
            continue
        _check_run(ri, run)
        n = np.asarray(next(iter(_leaves(run)))).shape[0]
        layers += [_layer(run, i, conv, keep) for i in range(n)]
    return layers


def _leaves(tree):
    for v in tree.values():
        if isinstance(v, Mapping):
            yield from _leaves(v)
        else:
            yield v


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
                           "final_norm": conv(tree["final_norm"])}
    if "lm_head" in tree:
        out["lm_head"] = conv(tree["lm_head"])
    plan = None if cfg is None else cfg.layer_plan()
    shared = None
    if "shared_attn" in tree:
        if flat and plan is None:
            raise ValueError("a flat checkpoint with shared attention needs "
                             "cfg to place its invocations")
        # one block, not stacked: slice(None) takes each array whole
        shared = out["shared_attn"] = _layer(
            tree["shared_attn"], slice(None), conv, keep)
    out["layers"] = _unstack(tree["blocks"], conv, keep, plan, shared)
    if "encoder" in tree:
        enc = tree["encoder"]
        out["encoder"] = {
            "layers": _unstack(enc["blocks"], conv, keep, None, None),
            "final_norm": conv(enc["final_norm"])}
    return out


def _stack(layers: List[Dict[str, Any]]) -> Dict[str, Any]:
    """Per-layer dicts -> one dict of arrays with a leading layer axis."""
    out = {}
    for k, v in layers[0].items():
        if isinstance(v, Mapping):
            out[k] = _stack([layer[k] for layer in layers])
        else:
            out[k] = np.stack([to_numpy(layer[k]) for layer in layers])
    return out


def _unstacked(d: Mapping[str, Any]) -> Dict[str, Any]:
    return {k: (_unstacked(v) if isinstance(v, Mapping) else to_numpy(v))
            for k, v in d.items()}


def params_to_jax(params: Mapping[str, Any], cfg) -> Dict[str, Any]:
    """The port's parameters (or any tree of its layout, such as its
    gradients or optimizer moments) -> the reference's nested tree of
    numpy arrays: each run of ``cfg.layer_plan()`` stacked on a leading
    layer axis, ``None`` for a shared-attention run with the block once in
    ``shared_attn``, whisper's encoder under ``encoder``."""
    out: Dict[str, Any] = {"embed": to_numpy(params["embed"]),
                           "final_norm": to_numpy(params["final_norm"])}
    if "lm_head" in params:
        out["lm_head"] = to_numpy(params["lm_head"])
    blocks: List[Any] = []
    i = 0
    for spec in cfg.layer_plan():
        if spec.kind == "shared_attn":
            blocks.append(None)
        else:
            blocks.append(_stack(params["layers"][i:i + spec.count]))
        i += spec.count
    if i != len(params["layers"]):
        raise ValueError(f"{cfg.name}: the plan has {i} layers, the "
                         f"parameters {len(params['layers'])}")
    out["blocks"] = blocks
    if "shared_attn" in params:
        out["shared_attn"] = _unstacked(params["shared_attn"])
    if "encoder" in params:
        enc = params["encoder"]
        out["encoder"] = {"blocks": [_stack(enc["layers"])],
                          "final_norm": to_numpy(enc["final_norm"])}
    return out
