#!/usr/bin/env python3
"""Time variants of the port's CUDA kernels side by side on one card.

    python3 tools/kernel_variants.py tools/variants/k3.json

    # K1 and K3 against the parent commit's, on one card
    mkdir -p build/parent && git archive HEAD~1 src/repro_torch/kernels \
        | tar -x -C build/parent
    python3 tools/kernel_variants.py tools/variants/k1_redesign_vs_parent.json

A variant file is a JSON list of [name, source, edits, check] or [name,
source, edits, check, settings]: ``source`` names a kernel under
src/repro_torch/kernels/csrc (``ragged_decode``, ``flash_attention``,
``flash_decode``, ``rwkv_scan``), ``edits`` either a list of [old, new]
text replacements made in a copy of that source (the headers copied beside
it; a third element names a header to edit instead) or a directory,
relative to the repository, whose copy of csrc/ is built instead (another
version of the kernels, say the parent commit's, unpacked there; where the
directory above it holds that version's wrapper ``<source>.py``, the
variant runs through that wrapper's ``_launch``, whose C interface its
library has), ``check`` whether the variant computes the kernel's function
(a variant that drops work to time a part alone does not), and
``settings`` module constants of the kernel's wrapper set for the
variant's run (K1's ``PLAN_WAVES``, say). Every variant is built with the
port's nvcc flags into build/variants/ (one nvcc each, all at once), then
loaded in place of the kernel's library and run at the full-width
chip_smoke.py cases of its kernel (K1: full_width_serving, long_cache,
zamba2_shared_attn and the decoder configs' served geometries of
chip_smoke.py's ARCH_K1_CASES in bf16; K2: sender_prefill_2049,
receiver_prefill_mass and gemma3_local_window; K3: long_cache_32k at G 3
and G 9, gemma3_window_decode and the sharded decode; K4: the entry point's
rwkv6_1_6b_scan and one row of 8,192, and chip_smoke.py's state-sharing
rows, the served prefill at T 2049, the receiver's T 16 and a decode
step, then the rwkv6-1.6b
sender's prefill of 4 x 2,049 tokens, host clock, with the variant in its
24 time mixes), in the order of the file and then reversed, so that each
variant is timed twice around the others on one card. A checked variant is
held against the plain version as chip_smoke.py holds the kernel. One JSON
line per variant and pass: device ms (the call queued behind a sleeping
kernel), the tolerance ratio, the event ms, the host's enqueue ms, the
bound and the plain version's device ms;
then one line of the host's enqueue ms of every checked variant at its
kernel's first case, timed in turns.
"""
import ctypes
import importlib.util
import json
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402


def variant_launch(edits, src, name):
    """The ``_launch`` of the wrapper beside a variant's csrc/ directory,
    or None where there is none (or the variant edits this version)."""
    if not isinstance(edits, str):
        return None
    path = (ROOT / edits).parent / f"{src}.py"
    if not path.exists():
        return None
    spec = importlib.util.spec_from_file_location(f"_{name}_{src}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod._launch


def build(variants, out_dir):
    from repro_torch.kernels import _build
    shutil.rmtree(out_dir, ignore_errors=True)
    jobs = []
    for name, src, edits, check, *_ in variants:
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


def host_ms(fn, n=50, reps=15):
    """Host time to enqueue one call of fn() while the card is busy (a
    sleeping kernel queued ahead): the wrapper's and the launch's cost on
    the host alone, the least over ``reps`` runs of n calls (the host is
    shared; other work only adds to it)."""
    import torch
    fn()
    ts = []
    for _ in range(reps):
        torch.cuda.synchronize()
        torch.cuda._sleep(30_000_000)        # ~15 ms: outlasts n enqueues
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        ts.append((time.perf_counter() - t0) * 1e3 / n)
        torch.cuda.synchronize()
    return min(ts)


def rwkv6_sender(dev):
    """chip_smoke.py's rwkv6-1.6b sender (published widths, bf16, random
    weights from seed 0) and its 4 contexts of 2,048 tokens: a call exports
    their states, the prefill of 2,049 positions with K4 in each of its 24
    time mixes."""
    import numpy as np
    from repro_torch.comm import Agent
    from repro_torch.configs.registry import get_config
    from repro_torch.launch import pairs
    from repro_torch.models import transformer as tfm
    cfg = get_config("rwkv6-1.6b")
    params = tfm.init_params(cfg, 0, device=dev)
    sender = Agent("sender", cfg, params, pairs.pair_tokenizer())
    ctx = np.random.default_rng(0).integers(
        4, cfg.vocab_size, (4, 2048)).astype(np.int32)
    return lambda: sender.export_kv(ctx)


def main(argv):
    import numpy as np
    import torch
    from repro_torch.kernels import _build
    from repro_torch.kernels import flash_decode as fd
    from repro_torch.kernels import ragged_decode as rd
    from repro_torch.kernels import rwkv_scan as rs
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
    # K1 at phase 2's full-width shapes (zamba2's MHA at D 80 with its
    # seed there), then at the decoder configs' served geometries as
    # phase_decoder_archs builds them
    k1 = []
    for name, B, S, P, Hq, Hkv, D, seed in [
            ("full_width_serving", 4, 2079, 2064, 24, 8, 128, 2),
            ("long_cache", 8, 4096, 2048, 24, 8, 128, 3),
            ("zamba2_shared_attn", 4, 281, 257, 32, 32, 80, 4)]:
        x = cs.random_case(dev, torch.bfloat16, B, S, P, Hq, Hkv, D, seed)
        cases[name] = cs.rd_case(name, *x, P)
        k1.append(name)
    for name, dt, B, S, P, Hq, Hkv, D in cs.ARCH_K1_CASES:
        if dt != "bfloat16":
            continue
        x = cs.served_case(dev, torch.bfloat16, B, S, P, Hq, Hkv, D,
                           S + Hkv + D,
                           pad=0 if name in cs.ARCH_K1_UNBUCKETED else 15)
        cases[name] = cs.rd_case(name, *x, P)
        k1.append(name)
    # K4 at the state-sharing phase's rows (4 x 32 heads of 64; the
    # entry point holds the scan at T 2048 and the one row of 8,192)
    for name, B, T, seed in [("rwkv6_served_prefill", 4, 2049, 20),
                             ("rwkv6_receiver_prefill", 4, 16, 24),
                             ("rwkv6_served_decode", 4, 1, 21)]:
        cases[name] = cs.wkv_case(dev, name, B, T, 32, 64, seed=seed,
                                  plain_iters=1)
    sender = rwkv6_sender(dev) if any(
        src == "rwkv_scan" for _, src, *_ in variants) else None
    by_source = {
        "ragged_decode": k1,
        "flash_attention": ["sender_prefill_2049", "receiver_prefill_mass",
                            "gemma3_local_window"],
        "flash_decode": ["long_cache_32k", "long_cache_32k_g9",
                         "gemma3_window_decode"],
        "rwkv_scan": ["rwkv6_served_prefill", "rwkv6_receiver_prefill",
                      "rwkv6_served_decode", "rwkv6_long_prefill_8192",
                      "rwkv6_1_6b_scan"]}
    wrappers = {"ragged_decode": rd, "flash_decode": fd, "rwkv_scan": rs}
    # the sharded decode of chip_smoke.py's phase 6
    B, Hq, Hkv, D, S = 4, 24, 8, 128, 32768
    lens = torch.as_tensor(np.random.default_rng(0).integers(S // 2, S + 1,
                                                             B),
                           dtype=torch.int32, device=dev)
    q, k, v = (torch.from_numpy(x).to(dev, torch.bfloat16)
               for x in distributed_decode.make_inputs(B, Hq, Hkv, D, S, 0))
    spec = {n: (variant_launch(edits, src, n), settings[0] if settings
                else {}) for n, src, edits, _, *settings in variants}

    def install(name):
        """Put variant ``name`` in place of its kernel; returns the undo."""
        src, _, lib = libs[name]
        _build._LIBS[src] = lib
        fd._CHUNKS.clear()
        rd._GEOMETRY.clear()
        rd._PLANS.clear()
        rs._PLANS.clear()
        launch, settings = spec[name]
        mod = wrappers.get(src)
        if mod is None:
            return lambda: None
        saved = {key: getattr(mod, key) for key in ("_launch", *settings)}
        for key, val in settings.items():
            setattr(mod, key, val)
        mod._launch = launch or mod._launch
        return lambda: [setattr(mod, key, val) for key, val in saved.items()]

    names = [n for n, *_ in variants]
    for name in names + names[::-1]:
        src, check, _ = libs[name]
        undo = install(name)
        res = {"variant": name}
        for cn in by_source[src]:
            case = cases[cn]
            if check:
                r = cs.compare_case(case, flush)
                res[cn] = {"device_ms": r["device_ms"], "ms": r["ms"],
                           "host_ms": host_ms(case["run"]),
                           "tol_ratio": r["tol_ratio"],
                           "bound_ms": r["bound_ms"],
                           "plain_device_ms": r["plain_device_ms"],
                           "sdpa_device_ms": r["library_device_ms"]}
            else:
                torch.cuda.synchronize()
                res[cn] = {"device_ms": cs.time_ms(case["run"], flush=flush,
                                                   queue_ahead=True)}
        if src == "rwkv_scan" and check:
            res["sender_prefill_ms"] = cs.wall_ms(sender, n=5)
        if src == "flash_decode":
            res["sharded_device_ms"] = cs.time_ms(
                lambda: distributed_decode.sharded_decode(q, k, v, lens, 8),
                flush=flush, queue_ahead=True)
        undo()
        print(json.dumps(res), flush=True)
    # the host's enqueue ms of every checked variant at its kernel's first
    # case, in turns (20 rounds of each), so that the shared host's spread
    # falls on all of them alike
    checked = [n for n in names if libs[n][1]]
    host = {n: [] for n in checked}
    first = {n: cases[by_source[libs[n][0]][0]]["run"] for n in checked}
    for _ in range(20):
        for name in checked:
            undo = install(name)
            host[name].append(host_ms(first[name], n=20, reps=3))
            undo()
    print(json.dumps({"host_interleaved": {
        n: {"case": by_source[libs[n][0]][0],
            "median_ms": statistics.median(ts), "min_ms": min(ts)}
        for n, ts in host.items()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
