#!/usr/bin/env python3
"""Time variants of the port's CUDA kernels side by side on one card.

    python3 tools/kernel_variants.py tools/variants/k3.json

    # K1 and K2 against the parent commit's, on one card
    mkdir -p build/parent && git archive HEAD~1 src/repro_torch/kernels/csrc \
        | tar -x -C build/parent
    python3 tools/kernel_variants.py tools/variants/k1_k2_vs_parent.json

A variant file is a JSON list of [name, source, edits, check]: ``source``
names a kernel under src/repro_torch/kernels/csrc (``ragged_decode``,
``flash_attention``, ``flash_decode``, ``rwkv_scan``), ``edits`` either a
list of [old, new] text replacements made in a copy of that source (the
headers copied beside it; a third element names a header to edit
instead) or a directory, relative to the repository,
whose copy of csrc/ is built instead (another version of the kernels, say
the parent commit's, unpacked there), and ``check`` whether the variant
computes the kernel's function (a variant that drops work to time a part
alone does not). Every variant is built with the port's nvcc flags into
build/variants/ (one nvcc each, all at once), then loaded in place of the
kernel's library and run at the full-width chip_smoke.py cases of its
kernel (K1: full_width_serving and long_cache; K2: sender_prefill_2049,
receiver_prefill_mass and gemma3_local_window; K3: long_cache_32k,
gemma3_window_decode and the sharded decode; K4: rwkv6_1_6b_scan), in the
order of the file and then reversed, so that each variant is timed twice
around the others on one card. A
checked variant is held against the plain version as chip_smoke.py holds
the kernel. One JSON line per variant and pass: device ms (the call queued
behind a sleeping kernel), the tolerance ratio and the event ms.
"""
import ctypes
import json
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402


def build(variants, out_dir):
    from repro_torch.kernels import _build
    shutil.rmtree(out_dir, ignore_errors=True)
    jobs = []
    for name, src, edits, check in variants:
        d = out_dir / name
        if isinstance(edits, str):  # another version of csrc/ as it is
            shutil.copytree(ROOT / edits, d)
            edits = []
        else:
            shutil.copytree(_build.CSRC, d)
        for old, new, *where in edits:  # in the source, or a named header
            p = d / (where[0] if where else f"{src}.cu")
            text = p.read_text()
            if old not in text:
                raise ValueError(f"{name}: edit not found: {old[:60]!r}")
            p.write_text(text.replace(old, new))
        p = d / f"{src}.cu"
        so = d / f"{src}.so"
        jobs.append((name, src, check, so, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(so), str(p)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    libs = {}
    for name, src, check, so, proc in jobs:
        out, err = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"{name}: nvcc failed:\n{err}")
        ptxas = [ln.strip() for ln in (out + err).splitlines()
                 if "registers" in ln or "spill" in ln]
        print(json.dumps({"variant": name, "ptxas": ptxas}), flush=True)
        libs[name] = (src, check, ctypes.CDLL(str(so)))
    return libs


def main(argv):
    import numpy as np
    import torch
    from repro_torch.kernels import _build
    from repro_torch.kernels import flash_decode as fd
    from repro_torch.kernels import ragged_decode as rd
    from repro_torch.launch import distributed_decode
    if not torch.cuda.is_available():
        print("kernel_variants: no CUDA device", file=sys.stderr)
        return 2
    variants = json.loads(Path(argv[1]).read_text())
    libs = build(variants, ROOT / "build" / "variants")
    dev = torch.device("cuda")
    print(cs.smi_line(), flush=True)
    scratch = torch.empty(64 * 2 ** 20, dtype=torch.uint8, device=dev)
    flush = lambda: scratch.zero_()          # noqa: E731  (> the 50 MB L2)
    _build.load_all(cs.KERNEL_SOURCES)
    _, full = cs.entry_point_cases(dev)
    cases = {c["name"]: c for c in full}
    # K1 at phase 2's full-width shapes
    for i, (name, B, S, P) in enumerate([("full_width_serving", 4, 2079, 2064),
                                        ("long_cache", 8, 4096, 2048)]):
        x = cs.random_case(dev, torch.bfloat16, B, S, P, 24, 8, 128, i + 2)
        cases[name] = cs.rd_case(name, *x, P)
    by_source = {
        "ragged_decode": ["full_width_serving", "long_cache"],
        "flash_attention": ["sender_prefill_2049", "receiver_prefill_mass",
                            "gemma3_local_window"],
        "flash_decode": ["long_cache_32k", "gemma3_window_decode"],
        "rwkv_scan": ["rwkv6_1_6b_scan"]}
    # the sharded decode of chip_smoke.py's phase 6
    B, Hq, Hkv, D, S = 4, 24, 8, 128, 32768
    lens = torch.as_tensor(np.random.default_rng(0).integers(S // 2, S + 1,
                                                             B),
                           dtype=torch.int32, device=dev)
    q, k, v = (torch.from_numpy(x).to(dev, torch.bfloat16)
               for x in distributed_decode.make_inputs(B, Hq, Hkv, D, S, 0))
    names = [n for n, *_ in variants]
    for name in names + names[::-1]:
        src, check, lib = libs[name]
        _build._LIBS[src] = lib
        fd._CHUNKS.clear()
        rd._CHUNKS.clear()
        res = {"variant": name}
        for cn in by_source[src]:
            case = cases[cn]
            if check:
                r = cs.compare_case(case, flush)
                res[cn] = {"device_ms": r["device_ms"], "ms": r["ms"],
                           "tol_ratio": r["tol_ratio"]}
            else:
                torch.cuda.synchronize()
                res[cn] = {"device_ms": cs.time_ms(case["run"], flush=flush,
                                                   queue_ahead=True)}
        if src == "flash_decode":
            res["sharded_device_ms"] = cs.time_ms(
                lambda: distributed_decode.sharded_decode(q, k, v, lens, 8),
                flush=flush, queue_ahead=True)
        print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
