#!/usr/bin/env python3
"""chip_smoke.py's RWKV6 skyline gate under variants of K4 and under the
plain sequential scan, on one card:

    python3 tools/k4_skyline.py tools/variants/k4_skyline.json

rwkv6-1.6b at published widths (bf16, random weights from seed 0), 4
contexts of 2,048 tokens and queries of 16 as chip_smoke.py's state
sharing phase draws them; for each variant (a variant file as
tools/kernel_variants.py reads it) and then with K4 replaced by its plain
version (a variant's fifth element sets wrapper constants, as in
tools/kernel_variants.py), one JSON line of (rel, argmax agreement): the
receiver on every
shared state against the skyline run of [C; Q] at bf16 and at float32,
and each bf16 run against the float32 skyline (the bf16 noise floor)."""
import importlib.util
import json
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))
import chip_smoke as cs  # noqa: E402


def main(argv):
    from repro_torch.configs.registry import get_config
    from repro_torch.core.types import SharedKV
    from repro_torch.kernels import _build
    from repro_torch.kernels import rwkv_scan as rs
    from repro_torch.launch import pairs
    from repro_torch.models import ssm
    from repro_torch.models import transformer as tfm
    if not torch.cuda.is_available():
        print("k4_skyline: no CUDA device", file=sys.stderr)
        return 2
    spec = importlib.util.spec_from_file_location(
        "kv", ROOT / "tools" / "kernel_variants.py")
    kv = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(kv)
    variants = json.loads(Path(argv[1]).read_text())
    libs = kv.build(variants, ROOT / "build" / "variants")
    dev = torch.device("cuda")
    print(cs.smi_line(), flush=True)
    cfg = get_config("rwkv6-1.6b")
    params = tfm.init_params(cfg, 0, device=dev)
    tok = pairs.pair_tokenizer()
    L, B, C, Q = cfg.num_layers, 4, 2048, 16
    rng = np.random.default_rng(0)
    ctx = rng.integers(4, cfg.vocab_size, (B, C)).astype(np.int32)
    qry = rng.integers(4, cfg.vocab_size, (B, Q)).astype(np.int32)
    everything = lambda kv_, states: SharedKV(  # noqa: E731
        states=states, state_select=torch.ones(L, dtype=torch.bool))
    for name, src, edits, check, *settings in variants:
        _build._LIBS["rwkv_scan"] = libs[name][2]
        rs._PLANS.clear()
        launch = kv.variant_launch(edits, src, name)
        saved = {key: getattr(rs, key)
                 for key in ("_launch", *(settings[0] if settings else {}))}
        for key, val in (settings[0] if settings else {}).items():
            setattr(rs, key, val)
        if launch is not None:
            rs._launch = launch
        sky = cs.skyline_gate(cfg, params, tok, ctx, qry, everything)
        for key, val in saved.items():
            setattr(rs, key, val)
        print(json.dumps({"variant": name,
                          **{k: list(v) for k, v in sky.items()}}), flush=True)
    saved = ssm.wkv6
    ssm.wkv6 = rs.wkv6_reference
    sky = cs.skyline_gate(cfg, params, tok, ctx, qry, everything)
    ssm.wkv6 = saved
    print(json.dumps({"variant": "plain_sequential",
                      **{k: list(v) for k, v in sky.items()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
