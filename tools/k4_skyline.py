#!/usr/bin/env python3
"""chip_smoke.py's state-sharing gates under variants of K4 and under the
plain sequential scan (RWKV6), and under Zamba2's honest runs and planted
faults, on one card:

    python3 tools/k4_skyline.py tools/variants/k4_skyline.json
    python3 tools/k4_skyline.py tools/variants/k4_skyline.json --faults
    python3 tools/k4_skyline.py --zamba2

A variant file runs rwkv6-1.6b at published widths (bf16, random weights
from seed 0, the bonus u drawn as chip_smoke.py draws it), 4 contexts of
2,048 tokens and queries of 16 as chip_smoke.py's state sharing phase
draws them; for each variant (a variant file as tools/kernel_variants.py
reads it; a variant's fifth element sets wrapper constants) and then with
K4 replaced by its plain version, one JSON line per case: the candidate
rules' readings of ``chip_smoke.rwkv6_candidates`` and the verdict of
chip_smoke.py's gates. The case is the honest share, and with ``--faults``
also each planted fault of ``chip_smoke.rwkv6_faults``. ``--zamba2`` reads
zamba2-2.7b's gate (``chip_smoke.zamba2_fault_gates``: every candidate of
``chip_smoke.zamba2_candidates`` and the verdict of ZAMBA2_GATES) on the
honest share and under each planted fault of ``chip_smoke.zamba2_faults``,
over four honest runs (``zamba2_lines``)."""
import importlib.util
import json
import sys
import time
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
    """zamba2-2.7b's gate as chip_smoke.py's phase reads it (4 contexts of
    256 tokens and queries of 16): honest and under each planted fault of
    ``chip_smoke.zamba2_faults``, for the contexts of seeds 1 (the
    phase's), 2 and 3, and for seed 1 with the chunked attention core at
    one query row a block (the only block that divides the sender's 257,
    the skyline's 273 and the receiver's 16 rows, so every prefill of the
    gate takes it)."""
    import dataclasses
    from repro_torch.configs.registry import get_config
    from repro_torch.core import protocol
    from repro_torch.core.types import KVCommConfig
    from repro_torch.models import transformer as tfm
    cfg = get_config("zamba2-2.7b")
    params = tfm.init_params(cfg, 0, device=dev)
    n_ssm, L = protocol._n_ssm(cfg), cfg.attn_layer_count
    everything = lambda kv, states, _: protocol.pack_shared(  # noqa: E731
        KVCommConfig(), kv, torch.ones(L, dtype=torch.bool), states,
        torch.ones(n_ssm, dtype=torch.bool))
    chunked = dataclasses.replace(cfg, attn_impl="chunked", attn_block_q=1)
    for seed, c in ((1, cfg), (2, cfg), (3, cfg), (1, chunked)):
        rng = np.random.default_rng(seed)
        ctx = rng.integers(4, cfg.vocab_size, (4, 256)).astype(np.int32)
        qry = rng.integers(4, cfg.vocab_size, (4, 16)).astype(np.int32)
        t0 = time.perf_counter()
        gates = cs.zamba2_fault_gates(c, params, tok, ctx, qry, everything)
        seconds = time.perf_counter() - t0
        for case, g in gates.items():
            print(json.dumps({"model": "zamba2-2.7b", "seed": seed,
                              "attn_impl": c.attn_impl, "case": case,
                              "layer": n_ssm // 2, **g["candidates"],
                              "states_by_leaf": g["readings"]["states_bf16"],
                              "gates": g["gates"],
                              "refused_by": g["refused_by"],
                              "seconds_all_cases": seconds}), flush=True)


def rwkv6_variants(path, dev, tok, faults):
    """RWKV6's lines for each variant of the file at ``path``, then the
    plain sequential scan."""
    from repro_torch.configs.registry import get_config
    from repro_torch.core.types import SharedKV
    from repro_torch.kernels import _build
    from repro_torch.kernels import rwkv_scan as rs
    from repro_torch.models import ssm
    from repro_torch.models import transformer as tfm
    spec = importlib.util.spec_from_file_location(
        "kv", ROOT / "tools" / "kernel_variants.py")
    kv = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(kv)
    variants = json.loads(Path(path).read_text())
    libs = kv.build(variants, ROOT / "build" / "variants")
    cfg = get_config("rwkv6-1.6b")
    params = cs.draw_rwkv6_bonus(tfm.init_params(cfg, 0, device=dev))
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
    del params
    torch.cuda.empty_cache()


def main(argv):
    from repro_torch.launch import pairs
    if not torch.cuda.is_available():
        print("k4_skyline: no CUDA device", file=sys.stderr)
        return 2
    files = [a for a in argv[1:] if not a.startswith("--")]
    dev = torch.device("cuda")
    print(cs.smi_line(), flush=True)
    tok = pairs.pair_tokenizer()
    if files:
        rwkv6_variants(files[0], dev, tok, "--faults" in argv)
    if "--zamba2" in argv:
        zamba2_lines(dev, tok)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
