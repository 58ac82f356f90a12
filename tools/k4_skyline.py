#!/usr/bin/env python3
"""chip_smoke.py's RWKV6 state-sharing gate under variants of K4 and under
the plain sequential scan, on one card:

    python3 tools/k4_skyline.py tools/variants/k4_skyline.json
    python3 tools/k4_skyline.py tools/variants/k4_skyline.json --faults
    python3 tools/k4_skyline.py tools/variants/k4_skyline.json --faults \
        --zamba2

rwkv6-1.6b at published widths (bf16, random weights from seed 0, the
bonus u drawn as chip_smoke.py draws it), 4 contexts of 2,048 tokens and
queries of 16 as chip_smoke.py's state sharing phase draws them; for each
variant (a variant file as tools/kernel_variants.py reads it; a variant's
fifth element sets wrapper constants) and then with K4 replaced by its
plain version, one JSON line per case: the candidate rules' readings of
``chip_smoke.rwkv6_candidates`` and the verdict of chip_smoke.py's gates.
The case is the honest share, and with ``--faults`` also each planted
fault of ``chip_smoke.rwkv6_faults``. ``--zamba2`` then reads zamba2-2.7b's
gate (its 2 x floor rule and the same candidates) on the honest share and
with the middle Mamba2 layer's ``ssm`` or ``conv`` state zeroed."""
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


def rwkv6_lines(name, cfg, params, tok, ctx, qry, share_all, faults):
    if faults:
        gates = cs.rwkv6_fault_gates(cfg, params, tok, ctx, qry, share_all)
    else:
        gates = {"honest": cs.rwkv6_state_gate(cfg, params, tok, ctx, qry,
                                               share_all)}
    for case, g in gates.items():
        print(json.dumps({"variant": name, "case": case, **g["candidates"],
                          "states_by_leaf": g["readings"]["states_bf16"],
                          "refused_by": g["refused_by"]}), flush=True)


def zamba2_lines(dev, tok):
    """zamba2-2.7b's gate as chip_smoke.py's phase reads it (257-position
    contexts, seed 1), honest and with one Mamba2 state zeroed."""
    from repro_torch.configs.registry import get_config
    from repro_torch.core import protocol
    from repro_torch.core.types import KVCommConfig
    from repro_torch.models import transformer as tfm
    cfg = get_config("zamba2-2.7b")
    params = tfm.init_params(cfg, 0, device=dev)
    rng = np.random.default_rng(1)
    ctx = rng.integers(4, cfg.vocab_size, (4, 256)).astype(np.int32)
    qry = rng.integers(4, cfg.vocab_size, (4, 16)).astype(np.int32)
    n_ssm, L = protocol._n_ssm(cfg), cfg.attn_layer_count
    mid = n_ssm // 2

    def share(leaf):
        def run(kv, states, _):
            if leaf is not None:
                states = {k: x.clone() for k, x in states.items()}
                states[leaf][mid] = 0
            return protocol.pack_shared(
                KVCommConfig(), kv, torch.ones(L, dtype=torch.bool), states,
                torch.ones(n_ssm, dtype=torch.bool))
        return run

    for case, leaf in (("honest", None), ("ssm_zeroed", "ssm"),
                       ("conv_zeroed", "conv")):
        r = cs.gate_readings(cs.skyline_runs(cfg, params, tok, ctx, qry,
                                             share(leaf)))
        cand = cs.rwkv6_candidates(r)
        print(json.dumps({"model": "zamba2-2.7b", "case": case,
                          "layer": mid, **cand,
                          "states_by_leaf": r["states_bf16"],
                          "refused_by": [g for g, ok in (
                              ("fp32", cand["fp32_max_rel"]
                               <= cs.FP32_FULL_BOUND),
                              ("two_floor", cand["floor_max"] <= 2))
                              if not ok]}), flush=True)


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
    faults = "--faults" in argv
    spec = importlib.util.spec_from_file_location(
        "kv", ROOT / "tools" / "kernel_variants.py")
    kv = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(kv)
    variants = json.loads(Path(argv[1]).read_text())
    libs = kv.build(variants, ROOT / "build" / "variants")
    dev = torch.device("cuda")
    print(cs.smi_line(), flush=True)
    cfg = get_config("rwkv6-1.6b")
    params = cs.draw_rwkv6_bonus(tfm.init_params(cfg, 0, device=dev))
    tok = pairs.pair_tokenizer()
    L, B, C, Q = cfg.num_layers, 4, 2048, 16
    rng = np.random.default_rng(0)
    ctx = rng.integers(4, cfg.vocab_size, (B, C)).astype(np.int32)
    qry = rng.integers(4, cfg.vocab_size, (B, Q)).astype(np.int32)
    everything = lambda kv_, states, export=None: SharedKV(  # noqa: E731
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
        rwkv6_lines(name, cfg, params, tok, ctx, qry, everything, faults)
        for key, val in saved.items():
            setattr(rs, key, val)
    saved = ssm.wkv6
    ssm.wkv6 = rs.wkv6_reference
    rwkv6_lines("plain_sequential", cfg, params, tok, ctx, qry, everything,
                faults)
    ssm.wkv6 = saved
    if "--zamba2" in argv:
        del params
        torch.cuda.empty_cache()
        zamba2_lines(dev, tok)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
