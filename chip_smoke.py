#!/usr/bin/env python3
"""Smoke run of the PyTorch port (src/repro_torch) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each printing one JSON line; any failure raises and exits non-zero:

  1. device and build — the card's name and power limit (nvidia-smi), all
     four kernels built from csrc/ side by side (one nvcc per source),
     each one's ptxas report.
  2. kernel vs plain — the K1 CUDA kernel against its plain PyTorch version
     at the tiny test shapes (float32, dead rows, prefix_len 0, odd Skv),
     the full-width serving shape and a long-cache shape (bf16). Every
     kernel-vs-plain case (here and in phases 4 and 5) is checked element
     by element, |kernel - plain| <= atol * rms(plain) + rtol * |plain|:
     float32 2e-5 (RWKV6 1e-4); bf16 1e-2, one ulp of the output's final
     rounding, against a plain version computed in float32; the float32
     Eq. (1) mass 1e-4 absolute. Each case is then timed with CUDA events
     beside the plain version, scaled_dot_product_attention (timed only,
     as a yardstick) and the card's bound for the same work: around the
     call ("ms", host enqueue included) and around the call queued behind
     a sleeping kernel ("device_ms", the kernels alone).
  3. float32 parity at a small size — the scheduler on the kernel backend
     against serve_serial on the plain backend, token for token (TF32 off).
  4. full-width serving — llama3.2-3b-pair as published, random weights
     from seed 0 shared by sender and receiver: calibrate on one retrieval
     sample, then serve 8 short and 2 long (2,048-token context) requests
     at capacity 4 through InMemoryTransport and SerializedTransport(int8);
     every ragged step must launch the kernel once per layer; one step's
     logits are compared between the kernel and the plain backend.
  4a. wire_codec — on one request's bf16 sender KV at full width, the
     int8 and int4 arrays the codec makes on the card are byte-identical
     to the CPU codec's; the session's WirePlan counts the analytic bytes
     plus its scales.
  4b. paged_serving — 12 requests over 3 contexts (2,049, 9 and 17
     positions with BOS), 4 queries each, 8 tokens at
     capacity 4 on K1, through InMemoryTransport and
     SerializedTransport(int8), each with a PageStore(page_len=16) and
     without: tokens identical, pages sent equal to the distinct page IDs,
     a hit rate of exactly 0.75, bytes equal to the analytic paged count
     plus the scales; then cold and warm ingests and the bucketed gather
     of the 2,049-position context timed alone.
  4c. wire_tiers — the 10 requests of phase 4 through
     SerializedTransport(int4) and the session's WirePlan: bytes equal to
     the analytic count; at one prefill of the long request, the received
     K/V within the reference's ERR_BOUND per slot (int8 slots widened for
     the bf16 payload's roundings), and the logits' max
     error (relative to the in-memory logits') within INT4_OVER_INT8
     times the int8 wire's.
     Phases 4, 4b and 4c are K1's main paths: each sets the counter to 0,
     and must launch the kernel once per layer per ragged step.
  5. the kernel entry point — repro_torch.kernels.ops driven at full
     published widths with the K2/K3/K4 counters at 0 (llama3.2-3b-pair
     prefills with and without the Eq. (1) mass, a gemma3-4b local
     window layer, a 32k decode cache, a windowed decode, the rwkv6-1.6b
     scan), then every case, with tiny ones (dead rows, a window,
     non-causal unaligned lengths, K3 rows no tensor map describes), held
     against its plain version and timed as in phase 2; each K3 case
     names its route (TMA ring or staged rows) and chunk.
  6. sharded decode — launch.distributed_decode.run over the 32k cache in
     8 shards (counter at 0 first): one K3 launch per shard plus the
     monolithic decode, the LSE combine checked against both; then its
     sharded_decode timed beside the monolithic decode.
  7. the kernels line — one JSON object listing every kernel (K1-K4),
     with each one's device ms over SDPA's at its main case.

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


def time_ms(fn, iters=20, flush=None, warmup=3, queue_ahead=False):
    """Mean device time of fn() over ``iters`` launches (CUDA events
    around each call; ``flush`` runs outside the timed window). The window
    also holds the host's time to enqueue fn()'s kernels, which is most of
    a call with microseconds of device work; ``queue_ahead`` keeps the card
    busy (``torch.cuda._sleep``) while the host enqueues, so the window
    holds the kernels alone: one untimed call measures the host's enqueue
    time, and the sleep lasts about twice that (at least ~1 ms)."""
    import torch
    for _ in range(warmup):
        fn()
    cycles = 0
    if queue_ahead:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        enqueue_s = time.perf_counter() - t0
        torch.cuda.synchronize()
        cycles = max(2_000_000, int(enqueue_s * 4e9))   # ~2 GHz clock
    total = 0.0
    for _ in range(iters):
        if flush is not None:
            flush()
        if cycles:
            torch.cuda._sleep(cycles)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        total += a.elapsed_time(b)
    return total / iters


def wall_ms(fn, n=3):
    """Median host wall clock of fn() over n calls after a warm-up call,
    each ending in a synchronize."""
    import numpy as np
    import torch
    ts = []
    for _ in range(n + 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        ts.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(ts[1:]))


# ---------------------------------------------------------------------------
# kernel-vs-plain cases: each a dict of the wrapper's call, its plain version
# and the library yardstick on the same tensors, the bytes and flops its bound
# counts, and a tolerance per output
# ---------------------------------------------------------------------------
# |kernel - plain| <= atol * rms(plain) + rtol * |plain|, element by element.
# The plain versions compute in float32 as the kernels do, so a bf16 output
# may differ by the one ulp of its final rounding (at most 2**-7 of the
# value); the float32 Eq. (1) mass differs only by summation order.
BF16_TOLS = (1e-2, 1e-2)
MASS_TOLS = (1e-4, 0.0)


def sdpa(q, k, v, mask):
    """scaled_dot_product_attention on (B, H, S, D) views with a boolean
    mask: the library yardstick, timed only, never called by the port."""
    import torch
    import torch.nn.functional as F
    if tuple(int(x) for x in torch.__version__.split(".")[:2]) >= (2, 5):
        return F.scaled_dot_product_attention(q, k, v, attn_mask=mask,
                                              enable_gqa=True)
    G = q.shape[1] // k.shape[1]
    return F.scaled_dot_product_attention(
        q, k.repeat_interleave(G, dim=1), v.repeat_interleave(G, dim=1),
        attn_mask=mask)


def tol_ratio(got, want, atol, rtol):
    """The largest |got - want| / (atol * rms(want) + rtol * |want|) over the
    elements (the check passes at <= 1) and the largest |got - want|."""
    if not want.numel():
        return 0.0, 0.0
    a, b = got.double(), want.double()
    diff = (a - b).abs()
    allow = atol * float(b.square().mean().sqrt()) + rtol * b.abs()
    return (float((diff / allow.clamp_min(1e-300)).max()),
            float(diff.max()))


def rd_case(name, q, k, v, kv_len, pfx, prefix_len):
    """A K1 case: the ragged two-segment decode; its dead rows must be
    exact zeros. Its plain version rounds scores and probabilities to the
    input dtype, as the JAX oracle does, so the check runs it on the same
    inputs in float32 (the timing runs it as it is)."""
    import torch
    from repro_torch.kernels.ragged_decode import (ragged_decode,
                                                   ragged_decode_reference)
    B, Hq, D = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    idx = torch.arange(Skv, device=q.device)[None]
    allow = torch.where(idx < prefix_len, idx < pfx[:, None],
                        idx < kv_len[:, None])
    dead = allow.sum(1) == 0
    n_att = int(allow.sum())
    isz = q.element_size()
    ks, vs = k.transpose(1, 2), v.transpose(1, 2)
    return {"name": name, "kernel": "ragged_decode", "counter": ragged_decode,
            "dtype": q.dtype, "tols": [(2e-5, 2e-5) if q.dtype ==
                                       torch.float32 else BF16_TOLS],
            "run": lambda: ragged_decode(q, k, v, kv_len, pfx,
                                         prefix_len=prefix_len),
            "plain": lambda: ragged_decode_reference(q, k, v, kv_len, pfx,
                                                     prefix_len=prefix_len),
            "check_plain": lambda: ragged_decode_reference(
                q.float(), k.float(), v.float(), kv_len, pfx,
                prefix_len=prefix_len).to(q.dtype),
            "library": lambda: sdpa(q[:, :, None, :], ks, vs,
                                    allow[:, None, None, :]),
            "extra_check": lambda out: check(
                bool(torch.all(out[dead] == 0)),
                f"{name}: dead rows are not zero"),
            # each attended K/V row read once, q, out and the lengths
            "nbytes": 2 * n_att * Hkv * D * isz + 2 * q.numel() * isz + 8 * B,
            "flops": 4 * n_att * Hq * D, "plain_iters": 20,
            "shape": {"B": B, "Hq": Hq, "Hkv": Hkv, "D": D, "Skv": Skv,
                      "prefix_len": prefix_len, "attended": n_att}}


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
KERNEL_SOURCES = ("ragged_decode", "flash_attention", "flash_decode",
                  "rwkv_scan")


def phase_build():
    """Build every kernel of the port at once (one nvcc per source)."""
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    _build.load_all(KERNEL_SOURCES)
    seconds = time.perf_counter() - t0
    for name in KERNEL_SOURCES:
        ptxas = [ln.strip() for ln in _build.build_log(name).splitlines()
                 if "registers" in ln or "spill" in ln]
        emit({"phase": "build", "kernel": name, "seconds": seconds,
              "ptxas": ptxas})


def phase_kernel_vs_plain(dev, flush):
    import torch
    cases = []
    shapes = [
        ("tiny_prefix_free_odd", torch.float32, 4, 37, 0, 4, 2, 16, 1),
        ("tiny_prefix", torch.float32, 4, 24, 8, 4, 2, 16, 2),
        ("full_width_serving", torch.bfloat16, 4, 2079, 2064, 24, 8, 128, 0),
        ("long_cache", torch.bfloat16, 8, 4096, 2048, 24, 8, 128, 0),
    ]
    for i, (name, dt, B, S, P, Hq, Hkv, D, dead) in enumerate(shapes):
        q, k, v, kl, pf = random_case(dev, dt, B, S, P, Hq, Hkv, D, i, dead)
        cases.append(compare_case(rd_case(name, q, k, v, kl, pf, P), flush))
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


def full_width_pair(dev):
    """llama3.2-3b-pair at full width, random weights from seed 0 (one
    parameter set serves sender and receiver), and the serving settings
    every full-width phase shares."""
    import torch
    from repro_torch.core.types import KVCommConfig
    from repro_torch.data.synthetic import SyntheticTask, TaskConfig
    from repro_torch.launch import pairs
    cfg, tok = pairs.full_width_config(), pairs.pair_tokenizer()
    t0 = time.perf_counter()
    sender, receiver = pairs.random_pair(cfg, 0, device=dev)
    torch.cuda.synchronize()
    return {"cfg": cfg, "tok": tok, "sender": sender, "receiver": receiver,
            "init_s": time.perf_counter() - t0,
            "kvcfg": KVCommConfig(ratio=0.5, alpha=0.7),
            "calib": SyntheticTask(tok, TaskConfig(
                "retrieval", num_facts=6, seed=42)).batch(1)}


def fw_session(fw, tr):
    """A session over transport ``tr``, calibrated on the one retrieval
    sample (ratio 0.5, alpha 0.7: 14 of 28 layers)."""
    from repro_torch.comm import Agent, CommSession
    s = CommSession(Agent("sender", fw["cfg"], fw["sender"], fw["tok"]),
                    Agent("receiver", fw["cfg"], fw["receiver"], fw["tok"]),
                    tr)
    s.calibrate(fw["calib"]["context"], fw["calib"]["query"],
                key="retrieval")
    return s


def serve_stream(fw, dev, tr, reqs, name):
    """One served stream at capacity 4 on K1; checks that every ragged step
    launched the kernel once per layer and every request completed.
    Returns (session, scheduler, completions, stats)."""
    import numpy as np
    import torch
    from repro_torch.kernels.ragged_decode import ragged_decode
    from repro_torch.serving.scheduler import Scheduler, SchedulerConfig
    cfg = fw["cfg"]
    sess = fw_session(fw, tr)
    sched = Scheduler(sess, fw["kvcfg"], calib_key="retrieval",
                      config=SchedulerConfig(capacity=4,
                                             decode_backend="kernel"))
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
          and all(len(c.tokens) == r.max_new for c, r in zip(comps, reqs)),
          f"{name}: incomplete completions")
    return sess, sched, comps, {
        "transport": name, "requests": len(comps),
        "tokens": stats["tokens"], "steps": stats["steps"],
        "kernel_launches": launches, "wall_s": wall,
        "tokens_per_s": stats["tokens"] / wall,
        "ttft_p50_ms": float(np.median([c.ttft_s for c in comps])) * 1e3,
        "bytes_moved": sess.transport.total_bytes,
        "peak_mem_gb": torch.cuda.max_memory_allocated(dev) / 1e9,
        "occupancy": stats["occupancy"],
        "selected_layers": list(sched.layers)}


def phase_full_width(dev, smi, fw):
    import numpy as np
    import torch
    from repro_torch.comm import Agent, InMemoryTransport, SerializedTransport
    from repro_torch.core import protocol
    from repro_torch.kernels.ragged_decode import ragged_decode
    from repro_torch.serving.scheduler import Scheduler, SchedulerConfig
    cfg, tok, receiver = fw["cfg"], fw["tok"], fw["receiver"]
    n_params = sum(t.numel() for t in leaves(fw["sender"]))
    kvcfg = fw["kvcfg"]
    reqs = serving_requests(tok)

    # warm-up (cuBLAS handles, allocator): two short requests, not counted
    serve_stream(fw, dev, InMemoryTransport(), reqs[:2], "warm-up")
    torch.cuda.synchronize()

    runs = {}
    ragged_decode.launches = 0          # the main path starts here
    for name, tr in (("inmemory", InMemoryTransport()),
                     ("serialized_int8", SerializedTransport("int8"))):
        _, sched, _, stats = serve_stream(fw, dev, tr, reqs, name)
        runs[name] = {"sched": sched, "stats": {**stats, "card": smi}}
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
          "params": n_params, "init_s": fw["init_s"]})

    # where the time goes: each stage alone (host wall clock around work
    # that ends in a synchronize, median of 3), then a device profile of
    # one more served stream
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
    prof_sched = Scheduler(fw_session(fw, InMemoryTransport()), kvcfg,
                           calib_key="retrieval", config=SchedulerConfig(
                               capacity=4, decode_backend="kernel"))
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


# ---------------------------------------------------------------------------
# the wire tiers and the paged store at full width
# ---------------------------------------------------------------------------
# The round-trip bounds of the reference's codec tests
# (tests/test_wire_codec.py:25, ERR_BOUND): a received K/V element lies
# within this fraction of its layer's absmax of the sent one (half a
# quantization step, ~2x headroom: int4 absmax / 14, int8 absmax / 254).
ERR_BOUND = {"float32": 0.0, "float16": 1e-3, "bfloat16": 8e-3,
             "int8": 8e-3, "int4": 0.15}
# Those bounds are for float32 payloads. A bf16 payload adds two roundings:
# x / scale is rounded to bf16 before round-half-even (bf16's spacing is
# 0.5 on [64, 128), so an int8 code may be off by 0.75 of a step) and the
# decoded value is rounded to bf16 (2^-8 of the absmax). An int8 slot of
# the full-width (bf16) payload is held to 0.75 / 127 + 2^-8 ~= 0.0098;
# int4 (worst 0.516 / 7 + 2^-8 ~= 0.078) and float16 (an exact cast) keep
# theirs.
BF16_PAYLOAD_BOUND = {**ERR_BOUND, "int8": 0.75 / 127 + 2 ** -8}
# To first order the receiver's logits move in proportion to the K/V
# error, so a tier whose coarsest slots are int4 may move them at most
# ERR_BOUND["int4"] / ERR_BOUND["int8"] = 18.75 times as far (relative to
# the in-memory logits' largest magnitude) as the int8 wire does on the
# same request.
INT4_OVER_INT8 = ERR_BOUND["int4"] / ERR_BOUND["int8"]


def long_context_kv(fw, sess, reqs):
    """The sender's bf16 KV of the last request of ``reqs`` (the 2,049-
    position one where the phases call it) and its selected payload (14
    layers)."""
    from repro_torch.core.protocol import gather_selected
    select = sess.selection(fw["kvcfg"], key="retrieval")
    kv, _ = sess.sender.export_kv(reqs[-1].context[None])
    return kv, select, gather_selected(kv, select)


def phase_wire_codec(dev, smi, fw):
    """The codec on the card holds the CPU codec's bytes (int8 and int4, k
    and v of one request's bf16 sender KV at full width), and the
    session's WirePlan counts the analytic bytes plus its scales."""
    import torch
    from repro_torch.comm import InMemoryTransport, SerializedTransport
    from repro_torch.comm.transport import encode_wire
    from repro_torch.core.channel import kv_wire_bytes
    cfg = fw["cfg"]
    sess = fw_session(fw, InMemoryTransport())
    reqs = serving_requests(fw["tok"])
    kv, select, payload = long_context_kv(fw, sess, reqs)
    check(payload["k"].dtype == torch.bfloat16,
          "wire_codec: the sender KV is not bf16")
    out = {"phase": "wire_codec", "payload_shape": list(payload["k"].shape)}
    raw = lambda a: a.contiguous().view(torch.uint8)    # noqa: E731
    for wire in ("int8", "int4"):
        ms = wall_ms(lambda: encode_wire(payload["k"], wire))
        for part in ("k", "v"):
            got, n = encode_wire(payload[part], wire)
            want, n_cpu = encode_wire(payload[part].cpu(), wire)
            same = n == n_cpu and all(torch.equal(raw(a), raw(b))
                                      for a, b in zip(got, want))
            check(same, f"wire_codec: {wire} {part} from the card differs "
                  "from the CPU codec")
        out[f"{wire}_bytes_per_part"] = n
        out[f"{wire}_card_encode_ms"] = ms
    plan = sess.wire_plan(fw["kvcfg"], key="retrieval")
    tr = SerializedTransport(plan)
    tr.send(cfg, fw["kvcfg"], kv, select)
    Sc, M = int(kv["k"].shape[2]), len(plan)
    analytic = kv_wire_bytes(cfg, 1, Sc, M, plan=plan) \
        + 2 * 4 * plan.n_scaled()
    check(tr.last.n_bytes == analytic,
          f"wire_codec: plan bytes {tr.last.n_bytes} != {analytic}")
    emit({**out, "byte_identical": True, "plan": plan.spec,
          "plan_bytes": tr.last.n_bytes, "plan_bytes_analytic": analytic,
          "int8_bytes_analytic": kv_wire_bytes(cfg, 1, Sc, M, 1)
          + 2 * 4 * M, "card": smi})
    return plan


def paged_requests(tok):
    """12 requests over 3 contexts (2,048 random tokens, and retrieval
    contexts of 8 and 16 tokens), each asked 4 queries, 8 tokens each. No two contexts share their first 15 tokens, so with BOS no
    page-aligned 16-position span is shared: the analytic hit rate is
    exactly 3/4."""
    import numpy as np
    from repro_torch.launch.serve import build_requests
    from repro_torch.serving.scheduler import Request
    short = build_requests(tok, "retrieval", 8, 8)
    ctxs = [np.random.default_rng(1).integers(
        tok.entity_base, tok.vocab_size, 2048).astype(np.int32),
        short[0].context, short[-1].context]
    for i in range(3):
        for j in range(i):
            check(not np.array_equal(ctxs[i][:15], ctxs[j][:15]),
                  "paged_serving: two contexts share a leading page")
    return [Request(rid=3 * q + c, context=ctxs[c],
                    query=short[(q + 2 * c) % len(short)].query, max_new=8)
            for q in range(4) for c in range(3)]


def phase_paged_serving(dev, smi, fw):
    """The 12-request stream through InMemoryTransport and
    SerializedTransport("int8"), each with a PageStore(page_len=16) and
    without: tokens identical, pages_sent equal to the distinct page IDs,
    a hit rate of exactly 0.75, bytes equal to the analytic paged count
    plus the scales. Then ingests and the gather at the 2,049-token
    context timed alone. Returns the K1 launches of the paged streams."""
    import dataclasses
    import torch
    from repro_torch.comm import InMemoryTransport, SerializedTransport
    from repro_torch.comm.transport import encode_payload
    from repro_torch.core.channel import kv_wire_bytes_paged
    from repro_torch.core.protocol import selected_layer_ids
    from repro_torch.kernels.ragged_decode import ragged_decode
    from repro_torch.store import PageStore
    cfg = fw["cfg"]
    reqs = paged_requests(fw["tok"])
    wires = {"inmemory": (lambda st: InMemoryTransport(store=st), 2, 0),
             "serialized_int8": (lambda st: SerializedTransport(
                 "int8", store=st), 1, 1)}
    results, steps = {}, 0
    ragged_decode.launches = 0                 # this path starts here
    for name, (make, isz, scaled) in wires.items():
        _, _, plain, plain_stats = serve_stream(fw, dev, make(None), reqs,
                                                name)
        store = PageStore(page_len=16)
        sess, sched, comps, stats = serve_stream(fw, dev, make(store), reqs,
                                                 name + "_paged")
        steps += plain_stats["steps"] + stats["steps"]
        same = all(list(a.tokens) == list(b.tokens)
                   for a, b in zip(plain, comps))
        check(same, f"paged_serving[{name}]: tokens differ from unpaged")
        summary = sess.dedup_summary()
        M = len(sched.layers)
        distinct = len(set(store.resident_ids()))
        expect_pages = M * sum(-(-(len(c) + 1) // 16) for c in
                               {r.context.tobytes(): r.context
                                for r in reqs}.values())
        pstats = dataclasses.asdict(store.stats())
        check(pstats["evictions"] == 0 and distinct == expect_pages
              == summary["pages_sent"],
              f"paged_serving[{name}]: {summary['pages_sent']} pages sent, "
              f"{distinct} distinct IDs, {expect_pages} expected")
        check(summary["hit_rate"] == 0.75,
              f"paged_serving[{name}]: hit rate {summary['hit_rate']}")
        analytic = kv_wire_bytes_paged(
            cfg, 1, 2049, M, page_len=16, pages_sent=summary["pages_sent"],
            itemsize=isz) + len(reqs) * 2 * 4 * M * scaled
        check(summary["bytes"] == analytic,
              f"paged_serving[{name}]: {summary['bytes']} B != {analytic}")
        results[name] = {"unpaged": plain_stats, "paged": stats,
                         "dedup": summary, "pool": pstats,
                         "analytic_bytes": analytic}
        emit({"phase": "paged_serving", "transport": name,
              "token_identical": same, **summary,
              "analytic_bytes": analytic,
              "unpaged_bytes": plain_stats["bytes_moved"],
              "tokens_per_s": {"paged": stats["tokens_per_s"],
                               "unpaged": plain_stats["tokens_per_s"]},
              "ttft_p50_ms": {"paged": stats["ttft_p50_ms"],
                              "unpaged": plain_stats["ttft_p50_ms"]},
              "peak_mem_gb": {"paged": stats["peak_mem_gb"],
                              "unpaged": plain_stats["peak_mem_gb"]},
              "kernel_launches": {"paged": stats["kernel_launches"],
                                  "unpaged": plain_stats["kernel_launches"]},
              "pool": pstats, "card": smi})
    launches = ragged_decode.launches
    check(launches == cfg.num_layers * steps, "paged_serving: K1 launches")

    # host cost of the store at the 2,049-token context, alone
    sess = fw_session(fw, InMemoryTransport())
    kv, select, payload = long_context_kv(fw, sess, [reqs[0]])
    check(payload["k"].shape[2] == 2049, "paged_serving: not the long one")
    layers = selected_layer_ids(select)
    for wd in ("bfloat16", "int8"):
        store = PageStore(page_len=16)
        kw = dict(layers=layers, select=select, wire_dtype=wd)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        table, novel, nbytes = store.ingest(payload, **kw)
        cold_ms = (time.perf_counter() - t0) * 1e3
        warm = []

        def warm_ingest():
            t, n, _ = store.ingest(payload, **kw)
            check(not n, "paged_serving: a warm ingest inserted pages")
            warm.append(t)
        warm_ms = wall_ms(warm_ingest)
        encode_ms = wall_ms(lambda: encode_payload(payload, wd).wait())
        gather_ms = wall_ms(lambda: store.gather_prefix(table, 2064,
                                                        device=dev))
        for t in [table] + warm:
            store.release(t)
        emit({"phase": "paged_store_host_cost", "wire_dtype": wd,
              "pages": table.num_pages, "novel_pages": len(novel),
              "novel_bytes": nbytes, "cold_ingest_ms": cold_ms,
              "warm_ingest_ms": warm_ms,
              "encode_and_copy_ms": encode_ms,
              "gather_prefix_2064_ms": gather_ms,
              "pool": dataclasses.asdict(store.stats()), "card": smi})
    return launches, steps


def phase_wire_tiers(dev, smi, fw, plan):
    """The 10 requests of full_width_serving through
    SerializedTransport("int4") and through the session's WirePlan: bytes
    equal to the analytic count plus the scales; then at one full-width
    prefill of the 2,049-token request, the received K/V held to
    BF16_PAYLOAD_BOUND and the logits to INT4_OVER_INT8 times the int8 wire's error. Returns
    the K1 launches and steps of the streams."""
    import torch
    from repro_torch.comm import (InMemoryTransport, SerializedTransport,
                                  WirePlan)
    from repro_torch.core.channel import kv_wire_bytes
    from repro_torch.kernels.ragged_decode import ragged_decode
    cfg, kvcfg = fw["cfg"], fw["kvcfg"]
    reqs = serving_requests(fw["tok"])
    M = len(plan)
    tiers = {"int4": WirePlan(("int4",) * M), "plan": plan}
    ragged_decode.launches = 0                 # this path starts here
    steps, out = 0, {}
    for name, wplan in tiers.items():
        wire = "int4" if name == "int4" else plan
        sess, _, _, stats = serve_stream(fw, dev, SerializedTransport(wire),
                                         reqs, name)
        steps += stats["steps"]
        analytic = sum(kv_wire_bytes(cfg, 1, len(r.context) + 1, M,
                                     plan=wplan) + 2 * 4 * wplan.n_scaled()
                       for r in reqs)
        check(stats["bytes_moved"] == analytic,
              f"wire_tiers[{name}]: {stats['bytes_moved']} B != {analytic}")
        out[name] = {**stats, "analytic_bytes": analytic}
    launches = ragged_decode.launches
    check(launches == cfg.num_layers * steps, "wire_tiers: K1 launches")
    # one prefill at the long request: each tier's received K/V within
    # BF16_PAYLOAD_BOUND of the sent K/V per slot, and its logits within
    # INT4_OVER_INT8 times the int8 wire's distance from the in-memory ones
    sess = fw_session(fw, InMemoryTransport())
    kv, select, sent = long_context_kv(fw, sess, reqs)
    qry = reqs[-1].query[None]
    logits, kv_ratio = {}, {}
    for name, wire in (("inmemory", None), ("int8", "int8"),
                       ("int4", "int4"), ("plan", plan)):
        tr = InMemoryTransport() if wire is None \
            else SerializedTransport(wire)
        shared = tr.send(cfg, kvcfg, kv, select)
        logits[name] = sess.receiver.prefill(
            qry, shared, max_new=1).logits[0, -1].float()
        if name in tiers:
            slot_dt = plan.dtypes if name == "plan" else (wire,) * len(plan)
            bound = torch.tensor([BF16_PAYLOAD_BOUND[d] for d in slot_dt],
                                 device=dev)
            for p in ("k", "v"):
                ref_p = sent[p].float()
                err = (shared.packed_kv[p].float() - ref_p).abs() \
                    .amax(dim=(1, 2, 3, 4))
                allow = bound * ref_p.abs().amax(dim=(1, 2, 3, 4))
                ratio = float((err / allow).max())
                kv_ratio[name] = max(kv_ratio.get(name, 0.0), ratio)
                check(ratio <= 1.0, f"wire_tiers[{name}]: received {p} "
                      f"reaches {ratio:.3g}x its round-trip bound")
        del shared
    ref = logits["inmemory"]
    rel = {name: float((lg - ref).abs().max() / ref.abs().max())
           for name, lg in logits.items() if name != "inmemory"}
    for name in tiers:
        bound = INT4_OVER_INT8 * rel["int8"]
        check(rel[name] <= bound, f"wire_tiers[{name}]: logits rel err "
              f"{rel[name]} > {INT4_OVER_INT8} x int8's {rel['int8']}")
        emit({"phase": "wire_tiers", "wire": out[name]["transport"]
              if name == "int4" else plan.spec,
              **{k: v for k, v in out[name].items() if k != "transport"},
              "kv_err_over_bound": kv_ratio[name],
              "logits_rel_err": rel[name], "int8_logits_rel_err":
              rel["int8"], "logits_bound": bound, "card": smi})
    del logits, kv
    torch.cuda.empty_cache()
    return launches, steps


# ---------------------------------------------------------------------------
# the kernel entry point (repro_torch.kernels.ops: K2, K3, K4) and the
# sequence-sharded decode
# ---------------------------------------------------------------------------
def fa_case(dev, name, dtype, B, Sq, Sc, Hq, Hkv, D, *, causal=True,
            window=None, mass=False, seed):
    """A K2 case: inputs, the ops call, its plain version, the SDPA
    yardstick, and the bytes and flops its bound counts."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.kernels.flash_attention import (
        attention_mask, flash_attention, flash_attention_reference)
    g = torch.Generator().manual_seed(seed)
    q, k, v = (torch.randn(*s, generator=g).to(dev, dtype)
               for s in ((B, Sq, Hq, D), (B, Sc + Sq, Hkv, D),
                         (B, Sc + Sq, Hkv, D)))
    kw = dict(context_len=Sc, q_offset=Sc, causal=causal, window=window,
              collect_mass=mass)
    allow = attention_mask(Sq, Sc + Sq, context_len=Sc, q_offset=Sc,
                           causal=causal, window=window, device=dev)
    n_att = int(allow.sum()) * B * Hq
    isz = q.element_size()
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    tols = ([(2e-5, 2e-5)] * 2 if dtype == torch.float32
            else [BF16_TOLS, MASS_TOLS])
    return {"name": name, "kernel": "flash_attention", "counter":
            flash_attention, "dtype": dtype, "tols": tols,
            "run": lambda: ops.flash_attention(q, k, v, **kw),
            "plain": lambda: flash_attention_reference(q, k, v, **kw),
            "library": lambda: sdpa(qt, kt, vt, allow),
            "nbytes": (2 * q.numel() + k.numel() + v.numel()) * isz
            + (4 * B if mass else 0),
            "flops": 4 * D * n_att, "plain_iters": 5,
            "shape": {"B": B, "Sq": Sq, "Skv": Sc + Sq, "context_len": Sc,
                      "Hq": Hq, "Hkv": Hkv, "D": D, "causal": causal,
                      "window": window, "collect_mass": mass,
                      "attended_pairs": n_att}}


def fd_case(dev, name, dtype, B, S, Hq, Hkv, D, kv_len, *, window=None,
            seed):
    """A K3 case (normalised decode) in the same form as ``fa_case``."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.kernels.flash_decode import (
        chunk_positions, decode_mask, flash_decode, flash_decode_reference,
        uses_tma)
    g = torch.Generator().manual_seed(seed)
    q = torch.randn(B, Hq, D, generator=g).to(dev, dtype)
    k = torch.randn(B, S, Hkv, D, generator=g).to(dev, dtype)
    v = torch.randn(B, S, Hkv, D, generator=g).to(dev, dtype)
    lens = torch.as_tensor(kv_len, dtype=torch.int32).to(dev)
    allow = decode_mask(S, lens, window)
    n_att = int(allow.sum())
    isz = q.element_size()
    qs, kt, vt = q[:, :, None], k.transpose(1, 2), v.transpose(1, 2)
    return {"name": name, "kernel": "flash_decode", "counter": flash_decode,
            "dtype": dtype, "tols": [(2e-5, 2e-5) if dtype == torch.float32
                                     else BF16_TOLS],
            "run": lambda: ops.decode_attention(q, k, v, lens, window=window),
            "plain": lambda: flash_decode_reference(q, k, v, lens,
                                                    window=window),
            "library": lambda: sdpa(qs, kt, vt, allow[:, None, None]),
            "nbytes": 2 * n_att * Hkv * D * isz + 2 * q.numel() * isz + 4 * B,
            "flops": 4 * n_att * Hq * D, "plain_iters": 10,
            "shape": {"B": B, "S": S, "Hq": Hq, "Hkv": Hkv, "D": D,
                      "window": window, "attended": n_att,
                      # how the kernel reads K/V: a TMA ring, or rows staged
                      # by plain loads where a tensor map cannot describe them
                      "route": "tma" if uses_tma(k, v) else "staged",
                      "chunk": chunk_positions(D, dtype)}}


def wkv_case(dev, name, B, T, H, hd, *, seed, plain_iters=2):
    """A K4 case; no single PyTorch call computes the scan (library null)."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.kernels.rwkv_scan import wkv6, wkv6_reference
    g = torch.Generator().manual_seed(seed)
    r, k, v = (torch.randn(B, T, H, hd, generator=g).to(dev)
               for _ in range(3))
    w = torch.sigmoid(torch.randn(B, T, H, hd, generator=g)).to(dev)
    u = torch.randn(H, hd, generator=g).to(dev)
    s0 = (0.1 * torch.randn(B, H, hd, hd, generator=g)).to(dev)
    n = B * T * H * hd
    return {"name": name, "kernel": "wkv6", "counter": wkv6,
            "dtype": torch.float32, "tols": [(1e-4, 1e-4)] * 2,
            "run": lambda: ops.wkv6_scan(r, k, v, w, u, s0),
            "plain": lambda: wkv6_reference(r, k, v, w, u, s0),
            "library": None,
            # r, k, v, w read and y written once; u; the state in and out
            "nbytes": 4 * (5 * n + H * hd + 2 * B * H * hd * hd),
            # y_j = sum_i r_i S_ij + v_j sum_i r_i u_i k_i and
            # S_ij = w_i S_ij + k_i v_j: 5 flops per (token, head, key,
            # value), and 5 per (token, head, value) for the u term
            "flops": 5 * n * hd + 5 * n, "plain_iters": plain_iters,
            "shape": {"B": B, "T": T, "H": H, "hd": hd}}


def entry_point_cases(dev):
    """Tiny cases (float32 dead rows, a window, non-causal unaligned
    lengths; bf16 K3 rows staged in the kernel) and cases at the published
    widths of llama3.2-3b, gemma3-4b and rwkv6-1.6b."""
    import numpy as np
    import torch
    f32, bf16 = torch.float32, torch.bfloat16
    rng = np.random.default_rng(0)
    tiny = [
        fa_case(dev, "fa_tiny_context_mass", f32, 2, 24, 16, 4, 2, 32,
                mass=True, seed=1),
        fa_case(dev, "fa_tiny_noncausal_unaligned", f32, 1, 12, 0, 2, 2,
                16, causal=False, seed=2),
        fa_case(dev, "fa_tiny_window", f32, 1, 70, 0, 2, 1, 16, window=9,
                seed=3),
        fd_case(dev, "fd_tiny_dead_rows", f32, 3, 40, 4, 2, 16, [0, 17, 40],
                seed=4),
        fd_case(dev, "fd_tiny_window", f32, 2, 300, 8, 2, 64, [300, 123],
                window=50, seed=5),
        # 24-byte rows: no tensor map describes them, staged in the kernel
        fd_case(dev, "fd_tiny_staged_rows", bf16, 3, 700, 6, 2, 12,
                [700, 0, 333], window=500, seed=13),
        wkv_case(dev, "wkv_tiny", 2, 40, 3, 16, seed=6,
                 plain_iters=5),
    ]
    full = [
        # llama3.2-3b-pair: a sender prefill of 2,049 tokens
        fa_case(dev, "sender_prefill_2049", bf16, 1, 2049, 0, 24, 8, 128,
                seed=7),
        # the receiver's bucketed prefill over a 2,049-token context
        fa_case(dev, "receiver_prefill_mass", bf16, 4, 32, 2049, 24, 8, 128,
                mass=True, seed=8),
        # gemma3-4b local layer: sliding window 1024
        fa_case(dev, "gemma3_local_window", bf16, 1, 4096, 0, 8, 4, 256,
                window=1024, seed=9),
        # llama3.2-3b widths over a 32k cache, ragged lengths
        fd_case(dev, "long_cache_32k", bf16, 4, 32768, 24, 8, 128,
                rng.integers(16384, 32769, 4), seed=10),
        # gemma3-4b local layer decode: window 1024 over an 8k cache
        fd_case(dev, "gemma3_window_decode", bf16, 4, 8192, 8, 4, 256,
                rng.integers(1024, 8193, 4), window=1024, seed=11),
        # rwkv6-1.6b: 32 heads of 64, 2,048 tokens
        wkv_case(dev, "rwkv6_1_6b_scan", 4, 2048, 32, 64, seed=12),
    ]
    return tiny, full


def _pieces(x):
    return [p for p in (x if isinstance(x, tuple) else (x,))
            if p is not None]


def compare_case(case, flush):
    """The kernel against its plain version on the same inputs, element by
    element at the case's tolerance for each output, then timed beside it,
    the library call and the bound. The launches made here are taken back
    off the counter."""
    import torch
    counter = case["counter"]
    launches0 = counter.launches
    got = _pieces(case["run"]())
    want = _pieces(case.get("check_plain", case["plain"])())
    torch.cuda.synchronize()
    name = case["name"]
    check(len(got) == len(want) <= len(case["tols"]), f"{name}: output count")
    err, rel, ratio = 0.0, 0.0, 0.0
    for a, b, (atol, rtol) in zip(got, want, case["tols"]):
        check(a.shape == b.shape, f"{name}: shape {a.shape} vs {b.shape}")
        check(bool(torch.isfinite(a.float()).all()),
              f"{name}: non-finite output")
        r, e = tol_ratio(a, b, atol, rtol)
        check(r <= 1.0, f"{name}: |kernel - plain| reaches {r:.3g}x its "
              f"bound {atol} * rms + {rtol} * |plain| (max abs err {e:.3g})")
        s = float(b.float().abs().max()) if b.numel() else 0.0
        err, rel = max(err, e), max(rel, e / max(s, 1e-30))
        ratio = max(ratio, r)
    if "extra_check" in case:
        case["extra_check"](got[0])
    dname = str(case["dtype"]).replace("torch.", "")
    t_bytes = case["nbytes"] / HBM_BYTES_PER_S
    t_ops = case["flops"] / PEAK_FLOPS[dname]
    ms = time_ms(case["run"], flush=flush)
    plain_ms = time_ms(case["plain"], iters=case["plain_iters"],
                       flush=flush, warmup=1)
    library_ms = (time_ms(case["library"], flush=flush)
                  if case["library"] is not None else None)
    dev_ms = {k: time_ms(case[k], iters=case["plain_iters"] if k == "plain"
                         else 20, flush=flush, warmup=0, queue_ahead=True)
              if case[k] is not None else None
              for k in ("run", "plain", "library")}
    counter.launches = launches0
    return {"case": name, "kernel": case["kernel"], "dtype": dname,
            **case["shape"], "max_abs_err": err, "rel_err": rel,
            "tols": case["tols"][:len(got)], "tol_ratio": ratio, "ms": ms,
            "plain_ms": plain_ms, "library_ms": library_ms,
            # the host's share of "ms": enqueueing the launch (tensor maps,
            # scratch, ctypes) beside the kernels' device time
            "enqueue_ms": ms - dev_ms["run"],
            "bound_ms": max(t_bytes, t_ops) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "device_ms": dev_ms["run"], "plain_device_ms": dev_ms["plain"],
            "library_device_ms": dev_ms["library"]}


def phase_entry_point(dev, flush, smi):
    """Drive ops.flash_attention / decode_attention / wkv6_scan at the full
    published widths with the counters at 0 (the slice's main path), then
    hold every case against its plain version and time it."""
    import torch
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.flash_decode import flash_decode
    from repro_torch.kernels.rwkv_scan import wkv6
    tiny, full = entry_point_cases(dev)
    counters = (flash_attention, flash_decode, wkv6)
    torch.cuda.synchronize()
    for c in counters:
        c.launches = 0                      # the main path starts here
    t0 = time.perf_counter()
    outs = [case["run"]() for case in full]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {c.__name__: c.launches for c in counters}
    for case, out in zip(full, outs):
        for p in _pieces(out):
            check(bool(torch.isfinite(p.float()).all()),
                  f"{case['name']}: non-finite output on the main path")
    want = {"flash_attention": 3, "flash_decode": 2, "wkv6": 1}
    check(launches == want, f"entry point launches {launches} != {want}")
    del outs
    emit({"phase": "entry_point_main_path", "cases": [c["name"]
                                                      for c in full],
          "launches": launches, "wall_s": wall, "card": smi})
    results = []
    for case in tiny + full:
        results.append(compare_case(case, flush))
        emit({"phase": "entry_point_kernel_vs_plain", **results[-1]})
    return launches, results


def phase_sharded_decode(dev, smi, flush, B=4, Hq=24, Hkv=8, D=128,
                         S=32768, n=8):
    """launch.distributed_decode.run at full width: the long_cache_32k
    geometry split into 8 shards of 4,096, one K3 partials launch per shard
    plus one for the monolithic decode, combined with the LSE rule; then
    the device time of its sharded_decode (partials and combine, one
    device) beside the monolithic one."""
    import numpy as np
    import torch
    from repro_torch.kernels import ops
    from repro_torch.kernels.flash_decode import (flash_decode,
                                                  flash_decode_reference)
    from repro_torch.launch import distributed_decode
    kv_len = np.random.default_rng(0).integers(S // 2, S + 1, B)
    torch.cuda.synchronize()
    flash_decode.launches = 0                # this path starts here
    t0 = time.perf_counter()
    res = distributed_decode.run(B, Hq, Hkv, D, S, n, "bfloat16",
                                 device=dev, seed=0, kv_len=kv_len)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = flash_decode.launches
    check(launches == n + 1, f"sharded decode: {launches} K3 launches, "
          f"expected {n} shards + 1")
    comb = res["combined"]
    check(comb.shape == (B, Hq, D) and bool(torch.isfinite(comb).all()),
          "sharded decode: bad combined output")
    # the float32 combine against the bf16 monolithic decode and the plain
    # decode on the same bf16 inputs: one bf16 rounding apart
    q, k, v = (torch.from_numpy(x).to(dev, torch.bfloat16)
               for x in distributed_decode.make_inputs(B, Hq, Hkv, D, S, 0))
    lens = torch.as_tensor(kv_len, dtype=torch.int32, device=dev)
    plain = flash_decode_reference(q, k, v, lens)
    ratios = {}
    for other, ref in (("monolithic", res["full"]), ("plain", plain)):
        ratios[other], _ = tol_ratio(comb, ref.float(), *BF16_TOLS)
        check(ratios[other] <= 1.0, f"sharded decode vs {other}: "
              f"{ratios[other]:.3g}x the bound {BF16_TOLS}")
    rel = res["max_abs_err"] / max(res["scale"], 1e-30)
    sharded = lambda: distributed_decode.sharded_decode(    # noqa: E731
        q, k, v, lens, n)
    monolithic = lambda: ops.decode_attention(q, k, v, lens)  # noqa: E731
    times = {"sharded_ms": time_ms(sharded, flush=flush),
             "monolithic_ms": time_ms(monolithic, flush=flush),
             "sharded_device_ms": time_ms(sharded, flush=flush,
                                          queue_ahead=True),
             "monolithic_device_ms": time_ms(monolithic, flush=flush,
                                             queue_ahead=True)}
    flash_decode.launches = launches
    out = {"phase": "sharded_decode", "B": B, "Hq": Hq, "Hkv": Hkv, "D": D,
           "S_total": S, "shards": n, "kv_len": [int(x) for x in kv_len],
           "launches": launches, "combine_vs_monolithic_rel": rel,
           "tol_ratio_vs_monolithic": ratios["monolithic"],
           "tol_ratio_vs_plain": ratios["plain"], "tols": BF16_TOLS,
           "partial_bytes_per_shard": res["partial_bytes_per_shard"],
           "kv_bytes_per_shard": res["kv_bytes_per_shard"],
           **times, "wall_s_with_input_generation": wall, "card": smi}
    emit(out)
    return out


def kernel_entry(results, name, source, replaces, launches, main_case):
    main = next(r for r in results if r["case"] == main_case)
    mine = [r for r in results if r["kernel"] == name]
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches,
            "max_abs_err": max(r["max_abs_err"] for r in mine),
            "ms": main["ms"], "plain_ms": main["plain_ms"],
            "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
            "library_ms": main["library_ms"], "main_case": main_case,
            "device_ms": main["device_ms"],
            "enqueue_ms": main["enqueue_ms"],
            "library_device_ms": main["library_device_ms"],
            # the kernel's device time over SDPA's for the same function
            "device_ms_over_sdpa": (
                main["device_ms"] / main["library_device_ms"]
                if main["library_device_ms"] else None),
            "tol_ratio": max(r["tol_ratio"] for r in mine),
            "shape": {k: v for k, v in main.items() if k not in (
                "case", "kernel", "max_abs_err", "rel_err", "tols",
                "tol_ratio", "ms", "plain_ms", "library_ms", "bound_ms",
                "bound_by", "device_ms", "plain_device_ms",
                "library_device_ms", "enqueue_ms")}}


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
    fw = full_width_pair(dev)
    runs, launches = phase_full_width(dev, smi, fw)

    # the kernel at the main path's own shape: a selected layer of the
    # served table, with that table's per-row lengths
    st = runs["inmemory"]["sched"].state
    layer = next(e for e in st["table"]["layers"] if e["prefix"])
    B = layer["k"].shape[0]
    q = torch.randn(B, 24, 128, device=dev, dtype=layer["k"].dtype)
    main = compare_case(rd_case(
        "main_path_selected_layer", q, layer["k"], layer["v"],
        st["table"]["len"] + 1, st["prefix_lens"], st["dst_prefix"]), flush)
    emit({"phase": "kernel_at_main_path_shape", **main})
    steps = sum(r["stats"]["steps"] for r in runs.values())
    del runs, st, layer, q
    torch.cuda.empty_cache()
    plan = phase_wire_codec(dev, smi, fw)
    paged_launches, paged_steps = phase_paged_serving(dev, smi, fw)
    tier_launches, tier_steps = phase_wire_tiers(dev, smi, fw, plan)
    k1_paths = {"full_width_serving": launches,
                "paged_serving": paged_launches,
                "wire_tiers": tier_launches}
    launches = sum(k1_paths.values())
    steps += paged_steps + tier_steps
    del fw
    torch.cuda.empty_cache()
    ep_launches, ep_results = phase_entry_point(dev, flush, smi)
    sharded = phase_sharded_decode(dev, smi, flush)
    results = cases + [main] + ep_results
    kernels = {"kernels": [
        {**kernel_entry(results, "ragged_decode",
                        "src/repro_torch/kernels/csrc/ragged_decode.cu",
                        "src/repro/kernels/ragged_decode.py:46", launches,
                        "main_path_selected_layer"),
         "launches_per_step": launches // max(steps, 1),
         "launches_by_path": k1_paths},
        kernel_entry(results, "flash_attention",
                     "src/repro_torch/kernels/csrc/flash_attention.cu",
                     "src/repro/kernels/flash_attention.py:31",
                     ep_launches["flash_attention"], "sender_prefill_2049"),
        kernel_entry(results, "flash_decode",
                     "src/repro_torch/kernels/csrc/flash_decode.cu",
                     "src/repro/kernels/flash_decode.py:32",
                     ep_launches["flash_decode"] + sharded["launches"],
                     "long_cache_32k"),
        kernel_entry(results, "wkv6",
                     "src/repro_torch/kernels/csrc/rwkv_scan.cu",
                     "src/repro/kernels/rwkv_scan.py:25",
                     ep_launches["wkv6"], "rwkv6_1_6b_scan")]}
    emit(kernels)
    print(smi_line(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
