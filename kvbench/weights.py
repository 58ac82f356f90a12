"""Random weights for a configuration, made on the device from a seed, in
the port's parameter layout.

The leaves of one parameter set are views into one flat buffer in the
served dtype, laid out by their draw scale, so a set takes a few large
``randn`` calls and a few in-place scalings instead of one draw per leaf:
projections scaled by 1 / sqrt(fan in), the embedding by 0.02, the norm
gains (the port's norms multiply by ``1 + w``) by 0.1. The layout is the
port's: ``embed``, ``final_norm``, ``lm_head`` and ``layers[i]`` with
``ln1``, ``attn`` {wq, wk, wv, wo}, ``ln2`` and ``mlp`` ({w_up, w_down}
for gelu, plus ``w_gate`` for swiglu), each weight stored (in, out).
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


def make_params(model: Dict, mlp: str, seed: int, device,
                dtype=torch.bfloat16) -> Dict:
    """One parameter set drawn from ``seed`` on ``device``."""
    device = torch.device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    spec = sorted(leaves(model, mlp), key=lambda t: -t[2])  # group scales
    flat = torch.empty(sum(math.prod(s) for _, s, _ in spec), dtype=dtype,
                       device=device)
    for a in range(0, flat.numel(), CHUNK):
        flat[a:a + CHUNK].normal_(generator=gen)
    params: Dict = {"layers": [dict(attn={}, mlp={})
                               for _ in range(model["num_layers"])]}
    off, run_start, run_scale = 0, 0, None
    for path, shape, scale in spec:
        if scale != run_scale:
            if run_scale is not None:
                flat[run_start:off].mul_(run_scale)
            run_start, run_scale = off, scale
        n = math.prod(shape)
        leaf = flat[off:off + n].view(shape)
        off += n
        node = params
        for key in path[:-1]:
            node = node[key]
        node[path[-1]] = leaf
    flat[run_start:off].mul_(run_scale)
    return params
