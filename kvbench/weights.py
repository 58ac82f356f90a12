"""Random weights for a configuration, made on the device from a seed, in
the port's parameter layout.

The leaves of one parameter set are views into one flat buffer a dtype
(the served one, unless a family's leaf names another), laid out by
their draw scale, so a set takes a few large ``randn`` calls and a few
in-place scalings instead of one draw per leaf: projections scaled by
1 / sqrt(fan in), the embedding by 0.02, the norm gains (the port's norms
multiply by ``1 + w``) by 0.1. The dense family's leaves (``leaves``)
are the port's layout: ``embed``, ``final_norm``, ``lm_head`` and
``layers[i]`` with ``ln1``, ``attn`` {wq, wk, wv, wo}, ``ln2`` and
``mlp`` ({w_up, w_down} for gelu, plus ``w_gate`` for swiglu), each
weight stored (in, out).
"""
from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch

CHUNK = 1 << 30            # elements per randn call
NORM_SCALE = 0.1
EMBED_SCALE = 0.02


def leaves(model: Dict, mlp: str) -> List[Tuple[Tuple, Tuple[int, ...], float]]:
    """(path, shape, scale) of every leaf of one parameter set."""
    d, dff, V = model["d_model"], model["d_ff"], model["vocab_size"]
    hq, hkv, dh = model["num_heads"], model["num_kv_heads"], model["head_dim"]
    proj = 1.0 / math.sqrt(d)
    out = [(("embed",), (V, d), EMBED_SCALE),
           (("final_norm",), (d,), NORM_SCALE),
           (("lm_head",), (d, V), proj)]
    for i in range(model["num_layers"]):
        out += [(("layers", i, "ln1"), (d,), NORM_SCALE),
                (("layers", i, "ln2"), (d,), NORM_SCALE),
                (("layers", i, "attn", "wq"), (d, hq * dh), proj),
                (("layers", i, "attn", "wk"), (d, hkv * dh), proj),
                (("layers", i, "attn", "wv"), (d, hkv * dh), proj),
                (("layers", i, "attn", "wo"), (hq * dh, d),
                 1.0 / math.sqrt(hq * dh)),
                (("layers", i, "mlp", "w_up"), (d, dff), proj),
                (("layers", i, "mlp", "w_down"), (dff, d),
                 1.0 / math.sqrt(dff))]
        if mlp == "swiglu":
            out.append((("layers", i, "mlp", "w_gate"), (d, dff), proj))
    return out


def make_params(spec: List[Tuple], seed: int, device,
                dtype=torch.bfloat16) -> Dict:
    """One parameter set drawn from ``seed`` on ``device``: the leaves of
    ``spec`` ((path, shape, scale), or with a fourth element, the leaf's
    dtype; without it the leaf takes ``dtype``). The leaves of one dtype
    are views into one flat buffer; the served dtype's buffer is drawn
    first, then the others' in the order their dtypes first appear, all
    from one generator. A set whose leaves all take ``dtype`` is drawn as
    one buffer in ``dtype``."""
    device = torch.device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    groups: Dict[torch.dtype, list] = {dtype: []}
    for leaf in spec:
        groups.setdefault(leaf[3] if len(leaf) > 3 else dtype,
                          []).append(leaf[:3])
    views = {}
    for dt, group in groups.items():
        if group:
            views.update(_draw(group, gen, device, dt))
    params: Dict = {}
    for leaf in spec:
        _put(params, leaf[0], views[leaf[0]])
    return params


def _draw(group, gen, device, dtype) -> Dict[Tuple, torch.Tensor]:
    """The leaves of one dtype as views into one flat buffer, laid out by
    scale: a few large ``normal_`` calls and one in-place scaling a
    run of equal scales."""
    spec = sorted(group, key=lambda t: -t[2])              # group scales
    flat = torch.empty(sum(math.prod(s) for _, s, _ in spec), dtype=dtype,
                       device=device)
    for a in range(0, flat.numel(), CHUNK):
        flat[a:a + CHUNK].normal_(generator=gen)
    views = {}
    off, run_start, run_scale = 0, 0, None
    for path, shape, scale in spec:
        if scale != run_scale:
            if run_scale is not None:
                flat[run_start:off].mul_(run_scale)
            run_start, run_scale = off, scale
        n = math.prod(shape)
        views[path] = flat[off:off + n].view(shape)
        off += n
    flat[run_start:off].mul_(run_scale)
    return views


def _put(tree: Dict, path: Tuple, leaf: torch.Tensor) -> None:
    """Place ``leaf`` at ``path`` (str keys name dict entries, int keys
    list entries), making the nodes on the way."""
    node = tree
    for key, nxt in zip(path[:-1], path[1:]):
        empty = [] if isinstance(nxt, int) else {}
        if isinstance(key, int):
            node.extend([None] * (key + 1 - len(node)))
            if node[key] is None:
                node[key] = empty
            node = node[key]
        else:
            node = node.setdefault(key, empty)
    key = path[-1]
    if isinstance(key, int):
        node.extend([None] * (key + 1 - len(node)))
    node[key] = leaf
