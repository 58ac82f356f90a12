#!/usr/bin/env python3
"""Smoke run of the PyTorch port (src/repro_torch) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each printing one JSON line; any failure raises and exits non-zero:

  1. device and build — the card's name and power limit (nvidia-smi), the
     ragged decode kernel built from csrc/ with nvcc, its ptxas report.
  2. kernel vs plain — the CUDA kernel against its plain PyTorch version at
     the tiny test shapes (float32, dead rows, prefix_len 0, odd Skv), the
     full-width serving shape and a long-cache shape (bf16), timed with CUDA
     events beside the plain version, scaled_dot_product_attention (timed
     only, as a yardstick) and the card's bound for the same work.
  3. float32 parity at a small size — the scheduler on the kernel backend
     against serve_serial on the plain backend, token for token (TF32 off).
  4. full-width serving — llama3.2-3b-pair as published, random weights
     from seed 0 shared by sender and receiver: calibrate on one retrieval
     sample, then serve 8 short and 2 long (2,048-token context) requests
     at capacity 4 through InMemoryTransport and SerializedTransport(int8);
     every ragged step must launch the kernel once per layer; one step's
     logits are compared between the kernel and the plain backend.
  5. the kernels line — one JSON object listing every kernel of the path.

The second-to-last line is nvidia-smi's name and power limit; the last line
is {"ok": true, "device": {...}}.
"""
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"
HBM_BYTES_PER_S = 3.35e12                 # H100 SXM
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12, "float16": 989e12}


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {msg}")


def emit(obj):
    print(json.dumps(obj), flush=True)


def smi_line():
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in leaves(v)]
    if isinstance(tree, list):
        return [x for v in tree for x in leaves(v)]
    return [tree]


def time_ms(fn, iters=20, flush=None):
    """Mean device time of fn() over ``iters`` launches (CUDA events
    around each call; ``flush`` runs outside the timed window)."""
    import torch
    for _ in range(3):
        fn()
    total = 0.0
    for _ in range(iters):
        if flush is not None:
            flush()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        total += a.elapsed_time(b)
    return total / iters


# ---------------------------------------------------------------------------
# phase 2 / 5 helper: one kernel-vs-plain case at given tensors
# ---------------------------------------------------------------------------
def kernel_case(name, q, k, v, kv_len, pfx, prefix_len, *, tol, flush):
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.ragged_decode import (ragged_decode,
                                                   ragged_decode_reference)
    launches0 = ragged_decode.launches
    out = ragged_decode(q, k, v, kv_len, pfx, prefix_len=prefix_len)
    ref = ragged_decode_reference(q, k, v, kv_len, pfx,
                                  prefix_len=prefix_len)
    torch.cuda.synchronize()
    err = float((out.float() - ref.float()).abs().max())
    scale = float(ref.float().abs().max())
    rel = err / max(scale, 1e-30)
    B, Hq, D = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    idx = torch.arange(Skv, device=q.device)[None]
    allow = torch.where(idx < prefix_len, idx < pfx[:, None],
                        idx < kv_len[:, None])
    dead = allow.sum(1) == 0
    check(torch.all(out[dead] == 0), f"{name}: dead rows are not zero")
    check(torch.isfinite(out.float()).all(), f"{name}: non-finite output")
    if q.dtype == torch.float32:
        check(err <= tol + tol * scale, f"{name}: max err {err} > {tol}")
    else:
        check(rel <= tol, f"{name}: relative err {rel} > {tol}")
    # the least time the card needs: each attended K/V row read once (plus
    # q, out and the lengths), and 4*D flops per attended (row, q head)
    n_att = int(allow.sum())
    isz = q.element_size()
    nbytes = 2 * n_att * Hkv * D * isz + 2 * q.numel() * isz + 8 * B
    flops = 4 * n_att * Hkv * G * D
    dname = str(q.dtype).replace("torch.", "")
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS[dname]
    ms = time_ms(lambda: ragged_decode(q, k, v, kv_len, pfx,
                                       prefix_len=prefix_len), flush=flush)
    plain_ms = time_ms(lambda: ragged_decode_reference(
        q, k, v, kv_len, pfx, prefix_len=prefix_len), flush=flush)
    # library yardstick (timed only, never used by the port): SDPA with the
    # two-segment mask as attn_mask
    qs = q[:, :, None, :]
    ks, vs = k.transpose(1, 2), v.transpose(1, 2)
    mask = allow[:, None, None, :]
    if tuple(int(x) for x in torch.__version__.split(".")[:2]) >= (2, 5):
        lib = lambda: F.scaled_dot_product_attention(           # noqa: E731
            qs, ks, vs, attn_mask=mask, enable_gqa=True)
    else:
        ke = ks.repeat_interleave(G, dim=1)
        ve = vs.repeat_interleave(G, dim=1)
        lib = lambda: F.scaled_dot_product_attention(           # noqa: E731
            qs, ke, ve, attn_mask=mask)
    library_ms = time_ms(lib, flush=flush)
    ragged_decode.launches = launches0   # comparison launches never count
    return {"case": name, "B": B, "Hq": Hq, "Hkv": Hkv, "D": D, "Skv": Skv,
            "prefix_len": prefix_len, "dtype": dname, "attended": n_att,
            "max_abs_err": err, "rel_err": rel, "tol": tol, "ms": ms,
            "plain_ms": plain_ms, "library_ms": library_ms,
            "bound_ms": max(t_bytes, t_ops) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def random_case(dev, dtype, B, Skv, P, Hq, Hkv, D, seed, n_dead=0):
    import torch
    g = torch.Generator().manual_seed(seed)
    q = torch.randn(B, Hq, D, generator=g).to(dev, dtype)
    k = torch.randn(B, Skv, Hkv, D, generator=g).to(dev, dtype)
    v = torch.randn(B, Skv, Hkv, D, generator=g).to(dev, dtype)
    kv_len = torch.randint(P + 1, Skv + 1, (B,), generator=g)
    pfx = torch.randint(0, P + 1, (B,), generator=g)
    kv_len[:n_dead] = 0
    pfx[:n_dead] = 0
    return q, k, v, kv_len.to(dev, torch.int32), pfx.to(dev, torch.int32)


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------
def phase_build():
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    _build.load("ragged_decode")
    ptxas = [ln.strip() for ln in _build.build_log("ragged_decode")
             .splitlines() if "registers" in ln or "spill" in ln]
    emit({"phase": "build", "kernel": "ragged_decode",
          "seconds": time.perf_counter() - t0, "ptxas": ptxas})


def phase_kernel_vs_plain(dev, flush):
    import torch
    cases = []
    shapes = [
        ("tiny_prefix_free_odd", torch.float32, 4, 37, 0, 4, 2, 16, 2e-5, 1),
        ("tiny_prefix", torch.float32, 4, 24, 8, 4, 2, 16, 2e-5, 2),
        ("full_width_serving", torch.bfloat16, 4, 2079, 2064, 24, 8, 128,
         2e-2, 0),
        ("long_cache", torch.bfloat16, 8, 4096, 2048, 24, 8, 128, 2e-2, 0),
    ]
    for i, (name, dt, B, S, P, Hq, Hkv, D, tol, dead) in enumerate(shapes):
        q, k, v, kl, pf = random_case(dev, dt, B, S, P, Hq, Hkv, D, i, dead)
        cases.append(kernel_case(name, q, k, v, kl, pf, P, tol=tol,
                                 flush=flush))
        emit({"phase": "kernel_vs_plain", **cases[-1]})
    return cases


def tiny_setup(dev, dtype="float32"):
    import dataclasses
    from repro_torch.configs.registry import get_config
    from repro_torch.data.tokenizer import SymbolTokenizer
    from repro_torch.models import transformer as tfm
    tok = SymbolTokenizer(16, 8)
    cfg = dataclasses.replace(
        get_config("llama3.2-3b-pair"), num_layers=4, d_model=64, d_ff=128,
        num_heads=4, num_kv_heads=2, head_dim=16, vocab_size=tok.vocab_size,
        dtype=dtype, tie_embeddings=False)
    return cfg, tok, tfm.init_params(cfg, 0, device=dev)


def phase_fp32_parity(dev):
    import torch
    from repro_torch.comm import Agent, CommSession, InMemoryTransport
    from repro_torch.core.types import KVCommConfig
    from repro_torch.data.synthetic import SyntheticTask, TaskConfig
    from repro_torch.serving.scheduler import (Scheduler, SchedulerConfig,
                                               make_requests, serve_serial)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg, tok, params = tiny_setup(dev)
    sess = CommSession(Agent("s", cfg, params, tok),
                       Agent("r", cfg, params, tok), InMemoryTransport())
    batches = [SyntheticTask(tok, TaskConfig("retrieval", num_facts=nf,
                                             seed=11 + nf)).batch(3)
               for nf in (4, 8)]
    reqs = make_requests(batches, pad=tok.PAD)
    for i, r in enumerate(reqs):
        r.max_new = (4, 2, 1)[i % 3]
    kvcfg = KVCommConfig(ratio=0.5, selector="prior_only")
    ser, _ = serve_serial(sess, reqs, kvcfg, backend="reference")
    got, stats = Scheduler(sess, kvcfg, config=SchedulerConfig(
        capacity=3, prefix_bucket=8, query_bucket=4,
        decode_backend="kernel")).run(reqs)
    same = all(list(a.tokens) == list(b.tokens) for a, b in zip(ser, got))
    check(same and len(ser) == len(got),
          "fp32 scheduler[kernel] differs from serve_serial[reference]")
    emit({"phase": "fp32_parity", "requests": len(reqs),
          "tokens": stats["tokens"], "token_identical": same})


def serving_requests(tok):
    import numpy as np
    from repro_torch.data.synthetic import SyntheticTask, TaskConfig
    from repro_torch.launch.serve import build_requests
    from repro_torch.serving.scheduler import Request
    reqs = build_requests(tok, "retrieval", 8, 8)
    rng = np.random.default_rng(0)
    long_q = SyntheticTask(tok, TaskConfig("retrieval", num_facts=6,
                                           seed=7)).batch(2)
    for j in range(2):
        ctx = rng.integers(tok.entity_base, tok.vocab_size, 2048)
        reqs.append(Request(rid=len(reqs), context=ctx.astype(np.int32),
                            query=long_q["query"][j], max_new=8))
    return reqs


def phase_full_width(dev, smi):
    import numpy as np
    import torch
    from repro_torch.comm import (Agent, CommSession, InMemoryTransport,
                                  SerializedTransport)
    from repro_torch.core import protocol
    from repro_torch.core.types import KVCommConfig
    from repro_torch.data.synthetic import SyntheticTask, TaskConfig
    from repro_torch.kernels.ragged_decode import ragged_decode
    from repro_torch.launch import pairs
    from repro_torch.models import transformer as tfm
    from repro_torch.serving.scheduler import Scheduler, SchedulerConfig
    cfg, tok = pairs.full_width_config(), pairs.pair_tokenizer()
    t0 = time.perf_counter()
    sender, receiver = pairs.random_pair(cfg, 0, device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(t.numel() for t in leaves(sender))
    kvcfg = KVCommConfig(ratio=0.5, alpha=0.7)
    calib = SyntheticTask(tok, TaskConfig("retrieval", num_facts=6,
                                          seed=42)).batch(1)
    sconf = SchedulerConfig(capacity=4, decode_backend="kernel")
    reqs = serving_requests(tok)

    def session(tr):
        s = CommSession(Agent("sender", cfg, sender, tok),
                        Agent("receiver", cfg, receiver, tok), tr)
        s.calibrate(calib["context"], calib["query"], key="retrieval")
        return s

    # warm-up (cuBLAS handles, allocator): two short requests, not counted
    Scheduler(session(InMemoryTransport()), kvcfg, calib_key="retrieval",
              config=sconf).run(reqs[:2])
    torch.cuda.synchronize()

    runs = {}
    ragged_decode.launches = 0          # the main path starts here
    for name, tr in (("inmemory", InMemoryTransport()),
                     ("serialized_int8", SerializedTransport("int8"))):
        sess = session(tr)
        sched = Scheduler(sess, kvcfg, calib_key="retrieval", config=sconf)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        l0 = ragged_decode.launches
        t0 = time.perf_counter()
        comps, stats = sched.run(reqs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = ragged_decode.launches - l0
        check(launches == cfg.num_layers * stats["steps"] > 0,
              f"{name}: {launches} kernel launches for {stats['steps']} "
              f"steps of {cfg.num_layers} layers")
        check(len(comps) == len(reqs)
              and all(len(c.tokens) == 8 for c in comps),
              f"{name}: incomplete completions")
        runs[name] = {"sched": sched, "stats": {
            "transport": name, "requests": len(comps),
            "tokens": stats["tokens"], "steps": stats["steps"],
            "kernel_launches": launches, "wall_s": wall,
            "tokens_per_s": stats["tokens"] / wall,
            "ttft_p50_ms": float(np.median([c.ttft_s for c in comps])) * 1e3,
            "bytes_moved": sess.transport.total_bytes,
            "peak_mem_gb": torch.cuda.max_memory_allocated(dev) / 1e9,
            "occupancy": stats["occupancy"],
            "selected_layers": list(sched.layers), "card": smi}}
        emit({"phase": "full_width_serving", **runs[name]["stats"]})
    main_launches = ragged_decode.launches

    # one ragged step on the same table under both backends
    sched = runs["inmemory"]["sched"]
    st = sched.state
    clone = lambda: {"len": st["table"]["len"].clone(),     # noqa: E731
                     "layers": [{**e, "k": e["k"].clone(),
                                 "v": e["v"].clone()}
                                for e in st["table"]["layers"]]}
    active = torch.ones_like(st["active"])
    logits = {}
    for backend in ("kernel", "reference"):
        _, lg, _ = protocol.ragged_decode_step(
            receiver, cfg, st["cur_tok"], clone(), sched.meta,
            st["prefix_lens"], active, backend=backend)
        logits[backend] = lg.float()
    ragged_decode.launches = main_launches
    ref = logits["reference"]
    rel = float((logits["kernel"] - ref).abs().max() / ref.abs().max())
    agree = float((logits["kernel"].argmax(-1) == ref.argmax(-1))
                  .float().mean())
    check(rel <= 5e-2, f"kernel vs reference step logits: rel {rel} > 5e-2")
    emit({"phase": "full_width_step_logits", "rel_err": rel,
          "bound": 5e-2, "token_agreement": agree,
          "params": n_params, "init_s": init_s})

    # where the time goes: each stage alone (host wall clock around work
    # that ends in a synchronize, median of 3), then a device profile of
    # one more served stream
    def wall_ms(fn):
        ts = []
        for _ in range(4):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            ts.append((time.perf_counter() - t0) * 1e3)
        return float(np.median(ts[1:]))

    agent = Agent("receiver", cfg, receiver, tok)
    short, long_ = reqs[0], reqs[-1]
    kv_long, _ = agent.export_kv(long_.context[None])
    shared = protocol.pack_shared(kvcfg, kv_long, sched.select)
    qry = np.zeros((1, st["query_max"]), np.int32)
    stages = {
        "sender_prefill_short_ms": wall_ms(
            lambda: agent.export_kv(short.context[None])),
        "sender_prefill_2049_ms": wall_ms(
            lambda: agent.export_kv(long_.context[None])),
        "receiver_prefill_ms": wall_ms(lambda: agent.prefill(
            qry, protocol.pad_prefix(shared, st["dst_prefix"]),
            max_new=st["budget"])),
    }
    for backend in ("kernel", "reference"):
        stages[f"ragged_step_{backend}_ms"] = wall_ms(
            lambda: protocol.ragged_decode_step(
                receiver, cfg, st["cur_tok"], clone(), sched.meta,
                st["prefix_lens"], active, backend=backend))
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    prof_sched = Scheduler(session(InMemoryTransport()), kvcfg,
                           calib_key="retrieval", config=sconf)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        prof_sched.run(reqs)
        torch.cuda.synchronize()
        prof_wall = time.perf_counter() - t0
    ragged_decode.launches = main_launches
    # device-side events only (kernels, copies): the aten ops that launch
    # them carry the same time and would count it twice
    by_kernel = sorted(
        ((e.key, e.self_device_time_total / 1e3, e.count)
         for e in prof.key_averages()
         if e.device_type == DeviceType.CUDA
         and e.self_device_time_total > 0), key=lambda x: -x[1])
    device_ms = sum(ms for _, ms, _ in by_kernel)
    emit({"phase": "full_width_breakdown", **stages,
          "profiled_wall_ms": prof_wall * 1e3,
          "device_busy_ms": device_ms,
          "device_idle_share": 1 - device_ms / (prof_wall * 1e3),
          "top_device_ops": [{"op": k[:90], "ms": ms, "calls": n}
                             for k, ms, n in by_kernel[:10]],
          "card": smi})
    return runs, main_launches


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not (SRC / "repro_torch" / "kernels" / "csrc").is_dir():
        print("chip_smoke: run from a checkout of the repository "
              "(src/repro_torch is missing)", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    dev = torch.device("cuda")
    smi = smi_line()
    emit({"phase": "device", "nvidia_smi": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "count": torch.cuda.device_count()})
    phase_build()
    scratch = torch.empty(64 * 2 ** 20, dtype=torch.uint8, device=dev)
    flush = lambda: scratch.zero_()          # noqa: E731  (> the 50 MB L2)
    cases = phase_kernel_vs_plain(dev, flush)
    phase_fp32_parity(dev)
    runs, launches = phase_full_width(dev, smi)

    # the kernel at the main path's own shape: a selected layer of the
    # served table, with that table's per-row lengths
    st = runs["inmemory"]["sched"].state
    layer = next(e for e in st["table"]["layers"] if e["prefix"])
    B = layer["k"].shape[0]
    q = torch.randn(B, 24, 128, device=dev, dtype=layer["k"].dtype)
    main = kernel_case("main_path_selected_layer", q, layer["k"], layer["v"],
                       st["table"]["len"] + 1, st["prefix_lens"],
                       st["dst_prefix"], tol=2e-2, flush=flush)
    emit({"phase": "kernel_at_main_path_shape", **main})
    steps = sum(r["stats"]["steps"] for r in runs.values())
    kernels = {"kernels": [{
        "name": "ragged_decode", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/ragged_decode.cu",
        "replaces": "src/repro/kernels/ragged_decode.py:46",
        "launches": launches, "launches_per_step": launches // max(steps, 1),
        "max_abs_err": max(c["max_abs_err"] for c in cases + [main]),
        "ms": main["ms"], "plain_ms": main["plain_ms"],
        "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
        "library_ms": main["library_ms"], "shape": {
            k: main[k] for k in ("B", "Hq", "Hkv", "D", "Skv",
                                 "prefix_len", "dtype", "attended")}}]}
    emit(kernels)
    print(smi_line(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
