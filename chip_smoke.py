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
  4d. comm_methods — every registered comparison method (hetero_kvcomm
     included: on this same-depth pair its map is the identity) through
     CommSession.run: first float32 tiny_cfg on the card against
     the CPU (predictions, bytes and FLOPs identical; CIPHER's soft
     embeddings and AC's hiddens within 2e-5), then llama3.2-3b-pair at
     full width on 4 retrieval samples, one line per method (latency,
     bytes, FLOPs, M, peak memory) with each method's bytes at its
     analytic count, random's selection the threefry draw, a two-sender
     mailbox equal to the dense combine_senders view (K/V bit for bit,
     logits within the bf16 rule) and full_kv within 5e-2 of skyline.
     The methods launch none of K1, K3 and K4, and K2 only whole
     prefix-free bf16 prefills, one launch a layer (routed_prefills).
  4e. hetero_pair — llama3.2-3b-pair (28 layers, seed 0) against the same
     widths at 42 layers (seed 1): hetero_kvcomm both ways for each LayerMap
     policy, in memory, at an int8 wire and over a bf16 RemoteTransport,
     bytes at assignment_bytes, packed vs dense logits within the bf16
     rule, identity at 28 -> 28 bit-equal to kvcomm, a float32 6 -> 10 tiny
     pair card vs CPU; then 8 tokens streamed through the 28 -> 42 mapped
     prefix on K1 (7 x 42 launches) with the first step's logits within
     5e-2 of the plain backend; before the stream, no kernel but K2 for
     whole prefix-free bf16 prefills (routed_prefills).
  4f. remote_serving — the 10 requests of phase 4 through RemoteTransport
     over a LoopbackChannel (bf16 streamed and monolithic, int8 streamed)
     beside in-memory and SerializedTransport(int8), and the 12 requests of
     4b through a bf16 RemoteTransport with a PageStore(page_len=16) and
     without: tokens identical, int8 bytes identical, received K/V
     bit-equal to the in-memory hand-over, 1,848 pages at a hit rate of
     0.75; one 2,049-position transfer's record (bytes, frame bytes,
     serialize / channel / deserialize ms, median of 3), and frames from
     the card's tensors byte-identical to the CPU's at every tier.
     Phases 4e (the stream) and 4f are K1 paths too.
  4g. resilient_serving — the 10 requests of phase 4 through a bf16
     RemoteTransport over a FaultyChannel(LoopbackChannel()) under
     RetryPolicy(max_attempts=3, seed=0), scripted from a clean run's
     frame counts: rid 1 recovers on its second attempt, rid 4 exhausts
     and lands on the serialized rung, rids 7 and 8 exhaust in a row and
     open the breaker (threshold 2), rid 9 is quarantined. Under
     default_resilience the events are those, and every row is
     token-identical to this call's in-memory stream; under a text-only
     ladder the degraded rows are text only, each within the bf16 rule
     (5e-2 of the largest logit) of its serial text-only answer at every
     step, and the rows beside them unchanged. The same script at float32
     on tiny_cfg gives the CPU port's events, bytes and tokens. Per-request
     bytes, the channel's bytes against the clean frames (retry overhead),
     tokens/s and TTFT p50 beside the clean remote stream.
  4h. fabric_serving — three KVServer replicas on 127.0.0.1 serving the
     one receiver Agent, each with a PageStore(page_len=16), behind a
     Router (bf16): the 12 requests of 4b answer as receiver.generate on
     the same paged exchange in process; under affinity 1,848 pages cross
     (each context's once) at a hit rate of exactly 0.75, round-robin's
     beside it; ms per routed request and the probe round trip. Then
     context 0's replica is killed after its second request (one hop, a
     cold share to another replica, tokens unchanged), restarted, and all
     three are partitioned (the local ladder answers as in memory). Then a
     SchedulerPool over the retrieval and multihop keys (selections that
     differ): tokens equal each key's own Scheduler.
  4i. remote_serve_two_process — `python -m repro_torch.launch.remote_serve
     server --config full --seed 0` in a second process (started before
     4g, so it loads meanwhile; its probe logits equal this process's),
     reached over TCP by a KVClient: a streamed bf16 share of the
     2,049-position request, then generate; a paged share twice (the
     second ships no page); answers equal to the in-process ones; the
     server exits 0 on shutdown.
     Phases 4g and the pool of 4h are K1 paths (28 launches per step).
  4j. state_sharing — rwkv6-1.6b and zamba2-2.7b as published, bf16,
     random weights from seed 0 for both roles (each model freed before the
     next). RWKV6: 4 requests of a 2,049-token context and 16 new tokens,
     prior_only at ratio 0.5, in memory, Serialized bf16 / int8 and a
     streamed bf16 RemoteTransport (the bonus u drawn from seed 1:
     init_params leaves it 0); every state shared equals the skyline over
     [C; Q] under RWKV6_GATES: within 1e-3 at float32 (the weights
     upcast), and at bf16 a mean next-token KL divergence under 5e-4 and
     every layer's handed-over states within 0.25 (relative Frobenius) of
     the float32 sender's; five planted faults of the hand-off (a layer's
     wkv state zeroed or transposed, the states one context token short,
     the receiver's streamed steps without the bonus, a layer's shift
     states zeroed) each refused by some gate at twice its bound or more
     (state_sharing_rwkv6_faults); none shared is further off; bytes at
     the analytic count; remote tokens = Serialized bf16 tokens; K4
     launched exactly 24 times per forward call; K4 against its plain
     version at the served T 2049 (the chunked kernel), the receiver's T
     16 and T 1 (the streaming kernel).
     Zamba2: 4 requests of a 257-token context and 8 new tokens,
     kvcomm calibrated on one sample (ratio 0.5, alpha 0.7), in memory,
     Serialized int8, a PageStore(page_len=16), bf16 remote and
     Serialized; every layer's KV and state shared equals the skyline
     within 1e-3 at float32, and at bf16 lies no further from the float32
     skyline than twice the bf16 skyline does (on an H100 at 700 W the
     two bf16 runs of its 63 layers came out 0.034 apart, past the F5
     rule, both ~0.10 from float32); bytes (KV + states) at the analytic count; paged tokens
     = unpaged; decode on K1 (G 1, D 80), 9 launches per step, its logits
     within the full-width step rule (5e-2) of the plain backend's,
     teacher-forced. Each model also runs its reduced float32 pair card vs
     CPU through Serialized int8 (bytes equal, logits within 1e-4, tokens
     under the top-2 margin rule with K1 / K4 on the card against the
     plain versions on the CPU). Stage ms, tokens/s, state bytes per tier,
     K4 device ms at T 2049, T 16 and T 1, the Mamba2 scan's ms per
     layer. These
     are K4's served path and a K1 path.
  4k. decoder_archs — K1 against its plain version at the decoder configs'
     geometries (G 2 at D 256, MHA at D 128, G 9, G 4 at D 160, G 6, G 8;
     bf16 at the served tables, float32 small), then each config as
     published, bf16, random weights from seed 0 for both roles, one model
     resident at a time: gemma3-4b, olmoe-1b-7b, starcoder2-7b,
     pixtral-12b, internlm2-20b, and mixtral-8x22b and qwen1.5-110b at
     their published widths cut to 4 layers. Each: kvcomm calibrated on
     one sample (ratio 0.5, alpha 0.7), 4 requests (2,049-position
     contexts for gemma3 and olmoe, 1,025 for the rest) and 8 new tokens
     on the scheduler with K1 (gemma3 and olmoe in memory and through
     Serialized int8), K1 exactly once per full-attention layer per step
     (5 / 16 / 32 / 40 / 48 / 0 / 4: windowed layers decode masked-dense,
     as in the reference), 8 greedy steps on K1 teacher-forced against
     the plain backend within 5e-2 of the largest logit, sender and
     receiver prefill ms, tokens/s, TTFT p50 and peak memory. gemma3 at
     float32: all layers shared = the skyline over [C; Q] (1e-3), the
     ring cache = the full cache over a 1,100-token prefill and 8 steps
     past the 1,024 window (1e-3), the chunked core = the plain one on a
     2,048-token prefill, logits and Eq. (1) masses (1e-4). olmoe: the
     float32 skyline on dense_all; dropping = the dense_all loop over
     experts at capacity E / k = 8 (float32 1e-4, bf16 3e-2 of the
     largest value), K5 (the bf16 dense_all call's path on the card) =
     the loop at bf16 within 3e-2, the drop count at 1.25, the loop's,
     K5's and dropping's MoE layer ms. olmoe's and mixtral's bf16 MoE
     calls run K5 throughout the phase (the kernels line's K5 launches). pixtral: a forward with
     256 seeded patch embeddings beside a text-only one. mixtral: the
     4,096 window bites on a 4,100-token context, ring = full cache at
     bf16 within 5e-2. These are K1 paths.
  4l. moe_grouped — K5 (kernels/moe_grouped.py, Triton) at mellum2-12b's
     served shapes: a 4,096-position sender prefill's 32,768 assignments
     and a 16-row decode step's 128, over 64 experts of width 896 at
     d 2,304, two launches a call; each against its plain version (2e-2:
     h and each gated row are rounded to bf16 before the final sum, in
     both), timed beside the dense_all loop it replaces ("plain") and
     torch._grouped_mm over the same sorted rows ("library"), the bound
     counting the experts the routing touched. Then K1 at G 8 over
     mellum2-12b's full layers: 16 rows, 32 / 4 heads of 128, a 7,952
     prefix bucket.
  5. the kernel entry point — repro_torch.kernels.ops driven at full
     published widths with the K2/K3/K4 counters at 0 (llama3.2-3b-pair
     prefills with and without the Eq. (1) mass, a gemma3-4b local
     window layer, the served sender prefills of the benchmark's largest
     contexts: starcoder2-7b's 36 / 4 heads at 3,968 positions and
     internlm2-20b's 48 / 8 at 2,560, a 32k decode cache, a windowed
     decode, the rwkv6-1.6b scan at 4 rows of 2,048 and at one row of
     8,192, the single-row prefill of long_500k's context cut to 8,192
     steps, where 32 heads take the plan's time segments), then every
     case, with tiny ones (dead rows, a window, non-causal unaligned
     lengths, K3 rows no tensor map describes), held against its plain
     version and timed as in phase 2; each K3 case names its route (TMA
     ring or staged rows) and chunk.
  6. sharded decode — launch.distributed_decode.run over the 32k cache in
     8 shards (counter at 0 first): one K3 launch per shard plus the
     monolithic decode, the LSE combine checked against both; then its
     sharded_decode timed beside the monolithic decode.
  6a. training (phase_training) — the float32 pair card vs CPU, full-width
     steps, whisper, the quick-trained pair on K1.
  6b. distributed — llama3.2-3b-pair at full width on a one-rank NCCL
     host mesh: 4 train steps with the state sharded by param_shardings
     against the unsharded steps (losses within 1e-4 relative; remat on
     and off; ms a step and peak GB of each), then the prefill, a decode
     step and the KVComm receiver prefill with its Eq. (1) masses against
     the unsharded port (5e-2 of the largest); meanwhile a subprocess
     runs the production meshes' dry run (qwen1.5-110b train_4k,
     mixtral-8x22b decode_32k on 2x16x16, rwkv6-1.6b long_500k,
     whisper-medium train_4k, gemma3-4b prefill_32k --kvcomm): status
     ok, FLOPs and collective bytes > 0, one line each. No kernel
     launches across the phase but K2 in the unsharded port's two bf16
     prefills, one a layer each (56).
  7. the kernels line — one JSON object listing every kernel (K1-K5),
     with each one's device ms over SDPA's at its main case; K1's launches
     by path (full-width, paged, wire tiers, remote serving, resilient
     serving, the scheduler pool, the hetero stream, state sharing, the
     decoder configs) and its times at the decoder configs' geometries;
     K2's by path (each serving phase's routed prefills, counted from 0
     before the first, the entry point, distributed), its main case a
     served sender prefill;
     K4's (state sharing, entry point) and each K4 case with its plan
     (kernel, time segments); K5's by path (counted from 0 before the
     first serving phase: the decoder configs' bf16 MoE calls and the
     moe_grouped phase) and its cases.

The second-to-last line is nvidia-smi's name and power limit; the last line
is {"ok": true, "device": {...}}.
"""
import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"
HBM_BYTES_PER_S = 3.35e12                 # H100 SXM
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12, "float16": 989e12}


CHILDREN = []                             # processes this script started


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
    from repro_torch.kernels.ragged_decode import (geometry, plan,
                                                   ragged_decode,
                                                   ragged_decode_reference)
    B, Hq, D = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    # the kernel's route and split plan at this shape
    nsplit, chunk = plan(B, Hkv, Hq // Hkv, D, Skv, q.dtype, q.device)
    geom = geometry(Hq // Hkv, D, q.dtype, q.device)
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
                      "prefix_len": prefix_len, "attended": n_att,
                      "route": ("tensor_cores" if geom.tensor_cores
                                else "cuda_cores"),
                      "resident": geom.resident, "nsplit": nsplit,
                      "chunk": chunk}}


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
        # zamba2-2.7b's shared attention: MHA (G 1) at head dim 80 over a
        # 257-position prefix and its decode steps
        ("zamba2_shared_attn", torch.bfloat16, 4, 281, 257, 32, 32, 80, 0),
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


def fw_session(fw, tr, resilience=None):
    """A session over transport ``tr``, calibrated on the one retrieval
    sample (ratio 0.5, alpha 0.7: 14 of 28 layers)."""
    from repro_torch.comm import Agent, CommSession
    s = CommSession(Agent("sender", fw["cfg"], fw["sender"], fw["tok"]),
                    Agent("receiver", fw["cfg"], fw["receiver"], fw["tok"]),
                    tr, resilience=resilience)
    s.calibrate(fw["calib"]["context"], fw["calib"]["query"],
                key="retrieval")
    return s


def serve_stream(fw, dev, tr, reqs, name, resilience=None):
    """One served stream at capacity 4 on K1; checks that every ragged step
    launched the kernel once per layer and every request completed.
    Returns (session, scheduler, completions, stats)."""
    import numpy as np
    import torch
    from repro_torch.kernels.ragged_decode import ragged_decode
    from repro_torch.serving.scheduler import Scheduler, SchedulerConfig
    cfg = fw["cfg"]
    sess = fw_session(fw, tr, resilience)
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
    kv_long, _, _ = agent.export_kv(long_.context[None])
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
    kv, _, _ = sess.sender.export_kv(reqs[-1].context[None])
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
# the paper's comparison methods (repro_torch.comm.methods)
# ---------------------------------------------------------------------------
def to_device(tree, dev, memo=None):
    """A copy of a tree of tensors on ``dev``; an entry that appears twice
    (Zamba2's one shared attention block) stays one object."""
    memo = {} if memo is None else memo
    if id(tree) in memo:
        return memo[id(tree)]
    if isinstance(tree, dict):
        out = {k: to_device(v, dev, memo) for k, v in tree.items()}
    elif isinstance(tree, list):
        out = [to_device(v, dev, memo) for v in tree]
    else:
        out = tree.to(dev)
    memo[id(tree)] = out
    return out


def param_count(params) -> int:
    """Parameters of a tree, each tensor counted once however often the
    tree refers to it."""
    return sum(x.numel() for x in {id(x): x for x in leaves(params)}
               .values())


def kernel_launches():
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.flash_decode import flash_decode
    from repro_torch.kernels.ragged_decode import ragged_decode
    from repro_torch.kernels.rwkv_scan import wkv6
    return [f.launches for f in (ragged_decode, flash_attention,
                                 flash_decode, wkv6)]


def routed_prefills(before, where: str, layers: int) -> int:
    """K2's launches since the ``kernel_launches()`` reading ``before``,
    after checking that K1, K3 and K4 launched nothing and K2 only whole
    forwards of ``layers`` attention layers (a divisor of every depth in
    play): the routing rule (``models.attention.prefill_on_kernel``) sends
    each layer of a prefix-free bf16 / fp16 prefill on the card to it, one
    launch a layer, and nothing else."""
    moved = [a - b for a, b in zip(kernel_launches(), before)]
    check(moved[0] == moved[2] == moved[3] == 0 and moved[1] % layers == 0,
          f"{where}: K1-K4 launched {moved}; K2 only whole prefills of "
          f"{layers} layers were expected")
    return moved[1]


def phase_comm_methods(dev, smi, fw):
    """Every registered method through CommSession.run (hetero_kvcomm on
    this same-depth pair maps depth-proportionally, which is the identity).
    (a) float32 tiny_cfg, one CPU-seeded parameter set on the card and on
    the CPU: predictions, wire bytes and FLOPs identical; CIPHER's soft
    embeddings and AC's hiddens within float32 2e-5 (tol_ratio). (b)
    llama3.2-3b-pair at full width on a batch of 4 retrieval samples
    (nld_tokens 16, ratio 0.5, alpha 0.7, the one-sample calibration's
    scores): latency (median of 3 after a warm-up), bytes, FLOPs, M and
    peak memory per method, each method's bytes against its analytic count,
    random's selection against the threefry draw, a two-sender mailbox
    against the dense combine_senders view, and full_kv against skyline.
    The methods launch none of K1, K3 and K4 (as the reference's reach no
    Pallas kernel), and K2 only for the prefills the routing rule sends to
    it (``routed_prefills``: whole full-width bf16 forwards that attend no
    prefix)."""
    import numpy as np
    import torch
    from repro_torch.comm import (METHODS, Agent, CommSession,
                                  InMemoryTransport)
    from repro_torch.core.channel import combine_senders, kv_wire_bytes
    from repro_torch.core.selection import random_scores, topk_mask
    from repro_torch.core.types import KVCommConfig, SharedKV
    from repro_torch.data.synthetic import SyntheticTask, TaskConfig
    names = sorted(METHODS)
    launches0 = kernel_launches()
    t0 = time.perf_counter()

    # (a) float32, the card against the CPU
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg, tok, params = tiny_setup("cpu")
    sess = {d: CommSession(Agent("s", cfg, p, tok), Agent("r", cfg, p, tok))
            for d, p in (("cpu", params), ("cuda", to_device(params, dev)))}
    batch = SyntheticTask(tok, TaskConfig("retrieval", num_facts=4,
                                          seed=3)).batch(4)
    kvcfg = KVCommConfig(ratio=0.5, alpha=0.7)
    scores = sess["cpu"].calibrate(batch["context"][:1], batch["query"][:1])
    for m in names:
        a, b = (sess[d].run(m, batch, kvcfg=kvcfg, scores=scores,
                            nld_tokens=4) for d in ("cpu", "cuda"))
        check(np.array_equal(a.preds, b.preds),
              f"comm_methods[{m}]: card predictions {b.preds} != CPU "
              f"{a.preds}")
        check((a.wire_bytes, a.flops, a.extras.get("M"))
              == (b.wire_bytes, b.flops, b.extras.get("M")),
              f"comm_methods[{m}]: bytes/flops/M differ card vs CPU")
    pieces = {}
    for name, fn in (("soft_embeds", lambda s: s.sender.message(
            batch["context"], 4)[1]),
            ("hiddens", lambda s: s.sender.export_hiddens(batch["context"]))):
        want, got = fn(sess["cpu"]), fn(sess["cuda"]).cpu()
        pieces[name], _ = tol_ratio(got, want, 2e-5, 2e-5)
        check(pieces[name] <= 1.0, f"comm_methods: {name} card vs CPU "
              f"reach {pieces[name]:.3g}x the float32 bound")
    emit({"phase": "comm_methods_fp32", "methods": names,
          "preds_bytes_flops_identical": True,
          **{f"{k}_tol_ratio": v for k, v in pieces.items()}})

    # (b) full width
    cfg, tok, kvcfg = fw["cfg"], fw["tok"], fw["kvcfg"]
    L = cfg.attn_layer_count
    task = SyntheticTask(tok, TaskConfig("retrieval", num_facts=4, seed=42))
    batch = task.batch(4)
    B, Sc = batch["context"].shape
    sess = fw_session(fw, InMemoryTransport())
    scores = sess.calibrate(fw["calib"]["context"], fw["calib"]["query"],
                            key="retrieval")
    want_bytes = {"baseline": 0, "skyline": 0, "nld": 16 * B * 2,
                  "cipher": 16 * B * cfg.d_model * 2,
                  **{f"ac_{m}": B * cfg.d_model * 2
                     for m in ("replace", "mean", "sum")}}
    rows = {}
    for m in names:
        run = lambda: sess.run(m, batch, kvcfg=kvcfg,       # noqa: E731
                               scores=scores, nld_tokens=16)
        run()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        res = [run() for _ in range(3)]
        r = res[-1]
        M = r.extras.get("M")
        want = want_bytes[m] if M is None else kv_wire_bytes(
            cfg, B, Sc + 1, M, itemsize=getattr(torch, cfg.dtype).itemsize)
        check(r.wire_bytes == want,
              f"comm_methods[{m}]: {r.wire_bytes} B != {want}")
        if m == "random":
            draw = topk_mask(random_scores(kvcfg.seed, L),
                             kvcfg.num_selected(L)).numpy()
            check(np.array_equal(r.extras["select"], draw),
                  "comm_methods[random]: selection is not the threefry "
                  "draw")
        rows[m] = {"latency_s": float(np.median([x.latency_s for x in res])),
                   "wire_bytes": r.wire_bytes, "flops": r.flops, "M": M,
                   "peak_mem_gb": torch.cuda.max_memory_allocated(dev) / 1e9}
        emit({"phase": "comm_methods", "method": m, **rows[m],
              "preds": r.preds.tolist(), "card": smi})

    # two senders through the mailbox: the packed view against the dense
    # combine_senders view of the same sends
    select = sess.selection(kvcfg, scores=scores)
    idx = torch.nonzero(select).flatten().tolist()
    ctxs = [batch["context"], SyntheticTask(tok, TaskConfig(
        "retrieval", num_facts=6, seed=43)).batch(B)["context"]]
    for i, c in enumerate(ctxs):
        sess.attach_sender(sess.sender, name=f"s{i}").send(c, kvcfg,
                                                           select=select)
    packed = sess.combined(clear=True)
    dense = combine_senders([
        SharedKV(kv=kv, select=select, prefix_len=p, pos_mode=kvcfg.pos_mode)
        for kv, _, p in (sess.sender.export_kv(c) for c in ctxs)])
    for p in ("k", "v"):
        check(torch.equal(packed.packed_kv[p], dense.kv[p][idx]),
              f"comm_methods mailbox: packed {p} != the dense view's "
              "selected slots")
    qry = batch["query"]
    lp, ld = (sess.receiver.prefill(qry, v, max_new=1).logits[:, -1].float()
              for v in (packed, dense))
    mailbox_ratio, mailbox_err = tol_ratio(lp, ld, *BF16_TOLS)
    check(mailbox_ratio <= 1.0, f"comm_methods mailbox: packed vs dense "
          f"logits reach {mailbox_ratio:.3g}x the bf16 bound")

    # full_kv with one parameter set on both sides is skyline: the receiver
    # reads the sender's KV of [BOS context] as its own
    full, _ = sess.share(batch["context"],
                         KVCommConfig(ratio=1.0, alpha=0.7, selector="all"))
    lf = sess.receiver.prefill(qry, full, max_new=1).logits[:, -1].float()
    ls = sess.receiver.prefill(
        np.concatenate([sess.receiver.with_bos(batch["context"]), qry], 1),
        None, max_new=1).logits[:, -1].float()
    full_rel = float((lf - ls).abs().max() / ls.abs().max())
    check(full_rel <= 5e-2, f"comm_methods: full_kv vs skyline logits rel "
          f"err {full_rel} > 5e-2")
    k2_launches = routed_prefills(launches0, "comm_methods",
                                  fw["cfg"].attn_layer_count)
    check(k2_launches > 0, "comm_methods: no full-width prefill took K2")
    emit({"phase": "comm_methods_checks", "batch": B, "context_len": Sc + 1,
          "mailbox_prefix_len": packed.prefix_len,
          "mailbox_logits_tol_ratio": mailbox_ratio,
          "mailbox_logits_max_abs_err": mailbox_err,
          "full_kv_vs_skyline_rel_err": full_rel, "bound": 5e-2,
          "k2_launches": k2_launches,
          "phase_wall_s": time.perf_counter() - t0,
          "card": smi})
    del sess, packed, dense, full
    torch.cuda.empty_cache()
    return rows


# ---------------------------------------------------------------------------
# heterogeneous pairs (LayerMap policies, hetero_kvcomm) at full width
# ---------------------------------------------------------------------------
HETERO_POLICIES = ("identity", "depth_proportional", "score_greedy")


def clone_cache(cache):
    """A deep copy of a decode cache (tensors cloned, structure kept)."""
    import torch
    if isinstance(cache, dict):
        return {k: clone_cache(v) for k, v in cache.items()}
    if isinstance(cache, list):
        return [clone_cache(v) for v in cache]
    return cache.clone() if isinstance(cache, torch.Tensor) else cache


def hetero_fp32_parity(dev):
    """The float32 tiny 6 -> 10 pair, one parameter draw per depth on the
    CPU and its copy on the card: hetero_kvcomm's predictions, bytes and
    assignments identical for every policy, both directions."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch.comm import Agent, CommSession
    from repro_torch.core.types import KVCommConfig
    from repro_torch.data.synthetic import SyntheticTask, TaskConfig
    from repro_torch.models import transformer as tfm
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg4, tok, _ = tiny_setup("cpu")
    cfgs = {L: dataclasses.replace(cfg4, num_layers=L) for L in (6, 10)}
    params = {L: tfm.init_params(cfgs[L], L, device="cpu") for L in cfgs}
    batch = SyntheticTask(tok, TaskConfig("retrieval", num_facts=4,
                                          seed=11)).batch(4)
    kvcfg = KVCommConfig(ratio=0.5, alpha=0.7)
    rows = 0
    for L_s, L_r in ((6, 10), (10, 6)):
        sess = {d: CommSession(
            Agent("s", cfgs[L_s], to_device(params[L_s], d), tok),
            Agent("r", cfgs[L_r], to_device(params[L_r], d), tok))
            for d in ("cpu", dev)}
        scores = sess["cpu"].calibrate_side("sender", batch["context"][:1],
                                            batch["query"][:1])
        for policy in HETERO_POLICIES:
            a, b = (s.run("hetero_kvcomm", batch, kvcfg=kvcfg,
                          scores=scores, layer_map=policy)
                    for s in sess.values())
            check(np.array_equal(a.preds, b.preds)
                  and (a.wire_bytes, a.extras["src_layers"],
                       a.extras["dst_layers"])
                  == (b.wire_bytes, b.extras["src_layers"],
                      b.extras["dst_layers"]),
                  f"hetero_pair fp32 {L_s}->{L_r} {policy}: card differs "
                  "from the CPU")
            rows += 1
    return rows


def phase_hetero_pair(dev, smi, fw):
    """llama3.2-3b-pair (28 layers, seed 0) paired with the same widths at
    42 layers (seed 1, the 12:8 ratio of deep_receiver_config): every
    LayerMap policy through CommSession.run("hetero_kvcomm") both ways, in
    memory, at an int8 wire and over a bf16 RemoteTransport on a loopback,
    on the comparison methods' batch (4 retrieval samples, 9 positions with
    BOS) with scores from calibrate_side("sender"). Gates: bytes at
    assignment_bytes (2,064,384 for 28 -> 42 depth_proportional in
    memory), packed and dense mapped logits within the bf16 rule, identity
    at 28 -> 28 bit-equal to kvcomm, the float32 tiny pair card vs CPU, no
    kernel launched but K2 for whole prefills the routing rule sends to it
    (``routed_prefills``, of 28 or 42 layers); then 8 tokens streamed
    through the 28 -> 42 mapped prefix on K1 (7 x 42 launches, counter at
    0 first), the first step's logits against the plain backend within
    5e-2. Returns the stream's K1 launches."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch.comm import (Agent, CommSession, InMemoryTransport,
                                  RemoteTransport, SerializedTransport)
    from repro_torch.comm.transport import assignment_bytes
    from repro_torch.core.layermap import LayerAssignment
    from repro_torch.data.synthetic import SyntheticTask, TaskConfig
    from repro_torch.kernels.ragged_decode import ragged_decode
    from repro_torch.models import transformer as tfm
    t_phase = time.perf_counter()
    cfg, tok, kvcfg = fw["cfg"], fw["tok"], fw["kvcfg"]
    deep = dataclasses.replace(cfg, num_layers=42)
    t0 = time.perf_counter()
    deep_params = tfm.init_params(deep, 1, device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    models = {28: (cfg, fw["sender"]), 42: (deep, deep_params)}
    batch = SyntheticTask(tok, TaskConfig("retrieval", num_facts=4,
                                          seed=42)).batch(4)
    B, Sc = batch["context"].shape[0], batch["context"].shape[1] + 1
    launches0 = kernel_launches()

    def session(L_s, L_r, tr):
        return CommSession(Agent("sender", *models[L_s], tok),
                           Agent("receiver", *models[L_r], tok), tr)

    wires = {"inmemory": (InMemoryTransport, None, 0),
             "serialized_int8": (lambda: SerializedTransport("int8"), 1, 1),
             "remote_bf16": (lambda: RemoteTransport("bfloat16"), 2, 0)}
    rows = []
    for L_s, L_r in ((28, 42), (42, 28)):
        probe = session(L_s, L_r, None)
        scores = probe.calibrate_side("sender", fw["calib"]["context"],
                                      fw["calib"]["query"])
        kv_s, _, _ = probe.sender.export_kv(batch["context"])
        for policy in HETERO_POLICIES:
            row = {"direction": f"{L_s}->{L_r}", "policy": policy}
            for name, (make, isz, scaled) in wires.items():
                sess = session(L_s, L_r, make())
                run = lambda: sess.run(                     # noqa: E731
                    "hetero_kvcomm", batch, kvcfg=kvcfg, scores=scores,
                    layer_map=policy)
                run()
                res = [run() for _ in range(3)]
                r = res[-1]
                P = r.extras["M"]
                asg = LayerAssignment(r.extras["src_layers"],
                                      r.extras["dst_layers"], L_s, L_r)
                want = assignment_bytes(kv_s, asg, itemsize=isz) \
                    + 2 * 4 * P * scaled
                check(r.wire_bytes == want,
                      f"hetero_pair {row['direction']} {policy} {name}: "
                      f"{r.wire_bytes} B != {want}")
                if (L_s, L_r, policy, name) == (28, 42, "depth_proportional",
                                                "inmemory"):
                    check(P == 14 and r.wire_bytes == 2064384,
                          f"hetero_pair 28->42 depth_proportional: P {P}, "
                          f"{r.wire_bytes} B (want 14, 2,064,384)")
                row[name] = {"bytes": r.wire_bytes, "P": P,
                             "latency_ms": float(np.median(
                                 [x.latency_s for x in res])) * 1e3,
                             "preds": r.preds.tolist()}
                if name == "remote_bf16":
                    rec = sess.transport.last
                    row[name].update(frame_bytes=rec.frame_bytes,
                                     serialize_ms=rec.serialize_s * 1e3,
                                     channel_ms=rec.channel_s * 1e3,
                                     deserialize_ms=rec.deserialize_s * 1e3)
            row["src_layers"] = list(r.extras["src_layers"])
            row["dst_layers"] = list(r.extras["dst_layers"])
            # packed and dense mapped views: the same logits (bf16 rule)
            lg = []
            for packed in (True, False):
                sess = session(L_s, L_r, InMemoryTransport(packed=packed))
                shared, _ = sess.share_mapped(batch["context"], kvcfg,
                                              policy=policy,
                                              src_scores=scores)
                lg.append(sess.receiver.prefill(
                    batch["query"], shared, max_new=1).logits[:, -1].float())
            row["packed_vs_dense_tol_ratio"], _ = tol_ratio(lg[0], lg[1],
                                                            *BF16_TOLS)
            check(row["packed_vs_dense_tol_ratio"] <= 1.0,
                  f"hetero_pair {row['direction']} {policy}: packed vs "
                  "dense logits beyond the bf16 rule")
            rows.append(row)
            emit({"phase": "hetero_pair", **row, "card": smi})

    # identity on the 28 -> 28 pair is kvcomm, bit for bit
    sess = fw_session(fw, InMemoryTransport())
    same = fw_session(fw, InMemoryTransport())
    scores = sess.calibrate(fw["calib"]["context"], fw["calib"]["query"])
    a = sess.run("kvcomm", batch, kvcfg=kvcfg, scores=scores)
    b = same.run("hetero_kvcomm", batch, kvcfg=kvcfg, scores=scores,
                 layer_map="identity")
    sa, _ = sess.share(batch["context"], kvcfg, scores=scores)
    sb, asg = same.share_mapped(batch["context"], kvcfg, policy="identity",
                                src_scores=scores)
    la = sess.receiver.prefill(batch["query"], sa, max_new=1).logits
    lb = same.receiver.prefill(batch["query"], sb, max_new=1).logits
    check(asg.is_identity and torch.equal(la, lb)
          and np.array_equal(a.preds, b.preds)
          and a.wire_bytes == b.wire_bytes,
          "hetero_pair: identity at 28->28 differs from kvcomm")
    fp32_rows = hetero_fp32_parity(dev)
    k2_launches = routed_prefills(launches0, "hetero_pair",
                                  math.gcd(28, 42))
    check(k2_launches > 0, "hetero_pair: no bf16 sender prefill took K2")

    # 8 tokens through the 28 -> 42 mapped prefix on K1
    sess = session(28, 42, InMemoryTransport())
    scores = sess.calibrate_side("sender", fw["calib"]["context"],
                                 fw["calib"]["query"])
    shared, asg = sess.share_mapped(batch["context"], kvcfg,
                                    policy="depth_proportional",
                                    src_scores=scores)
    qry = batch["query"]
    out = sess.receiver.prefill(qry, shared, max_new=8)
    tok0 = torch.argmax(out.logits[:, -1, :], dim=-1)[:, None]
    step = {}
    for backend in ("kernel", "reference"):
        _, lg, _ = sess.receiver.decode_step(tok0, clone_cache(out.cache),
                                             shared, backend=backend)
        step[backend] = lg.float()
    rel = float((step["kernel"] - step["reference"]).abs().max()
                / step["reference"].abs().max())
    check(rel <= 5e-2, f"hetero_pair stream: kernel vs reference step "
          f"logits rel {rel} > 5e-2")
    torch.cuda.synchronize()
    ragged_decode.launches = 0                 # this path starts here
    t0 = time.perf_counter()
    toks = np.stack(list(sess.stream(qry, shared, max_new=8,
                                     backend="kernel")), axis=1)
    torch.cuda.synchronize()
    stream_s = time.perf_counter() - t0
    launches = ragged_decode.launches
    check(launches == 7 * 42, f"hetero_pair stream: {launches} K1 "
          "launches, expected 7 x 42")
    check(toks.shape == (B, 8), "hetero_pair stream: token shape")
    emit({"phase": "hetero_pair_checks", "deep_layers": 42,
          "deep_params": sum(t.numel() for t in leaves(deep_params)),
          "deep_init_s": init_s, "batch": B, "context_len": Sc,
          "identity_bit_equal_kvcomm": True, "k2_launches": k2_launches,
          "fp32_card_vs_cpu_rows": fp32_rows,
          "stream_tokens": toks.tolist(), "stream_s": stream_s,
          "stream_k1_launches": launches,
          "stream_step_logits_rel_err": rel, "bound": 5e-2,
          "assignment_28_42_depth_proportional": [list(asg.src),
                                                  list(asg.dst)],
          "phase_wall_s": time.perf_counter() - t_phase, "card": smi})
    del models, deep_params, sess, shared, out, probe, kv_s
    torch.cuda.empty_cache()
    return launches


# ---------------------------------------------------------------------------
# serving over the remote wire (RemoteTransport on a LoopbackChannel)
# ---------------------------------------------------------------------------
def phase_remote_serving(dev, smi, fw, plan):
    """The 10 requests of full_width_serving through RemoteTransport over a
    LoopbackChannel: a bf16 wire streamed and monolithic, int8 streamed,
    beside the in-memory and SerializedTransport("int8") streams of this
    call; then the 12 paged_serving requests through a bf16
    RemoteTransport with a PageStore(page_len=16) and without. Gates:
    bf16 tokens identical to in-memory and the received K/V bit-equal to
    the in-memory hand-over (streamed and monolithic alike); int8 tokens
    and bytes identical to SerializedTransport's; paged: 1,848 pages sent,
    a hit rate of exactly 0.75, tokens identical to unpaged; frames built
    from the card's tensors byte-identical to frames built on the CPU at
    every tier; K1 at 28 launches per step (counter at 0 first). Returns
    (K1 launches, steps)."""
    import numpy as np
    import torch
    from repro_torch.comm import (InMemoryTransport, RemoteTransport,
                                  SerializedTransport)
    from repro_torch.comm.remote import encode_kv_transfer
    from repro_torch.kernels.ragged_decode import ragged_decode
    from repro_torch.store import PageStore
    t_phase = time.perf_counter()
    cfg, kvcfg = fw["cfg"], fw["kvcfg"]
    reqs = serving_requests(fw["tok"])
    streams = {
        "inmemory": InMemoryTransport,
        "remote_bf16_streamed": lambda: RemoteTransport("bfloat16"),
        "remote_bf16_monolithic": lambda: RemoteTransport(
            "bfloat16", chunk_bytes=None),
        "serialized_int8": lambda: SerializedTransport("int8"),
        "remote_int8_streamed": lambda: RemoteTransport("int8")}
    ragged_decode.launches = 0                 # this path starts here
    steps, out = 0, {}
    for name, make in streams.items():
        sess, _, comps, stats = serve_stream(fw, dev, make(), reqs, name)
        steps += stats["steps"]
        recs = [r for r in sess.transport.log if r.kind == "kv"]
        out[name] = {"tokens": [c.tokens.tolist() for c in comps],
                     "bytes": [r.n_bytes for r in recs], "stats": stats,
                     "frame_bytes": sum(r.frame_bytes for r in recs)}
    for name, base in (("remote_bf16_streamed", "inmemory"),
                       ("remote_bf16_monolithic", "inmemory"),
                       ("remote_int8_streamed", "serialized_int8")):
        check(out[name]["tokens"] == out[base]["tokens"],
              f"remote_serving[{name}]: tokens differ from {base}")
    check(out["remote_int8_streamed"]["bytes"]
          == out["serialized_int8"]["bytes"],
          "remote_serving: int8 bytes differ from SerializedTransport's")
    preqs = paged_requests(fw["tok"])
    store = PageStore(page_len=16)
    paged = {}
    for name, tr in (("remote_bf16_unpaged", RemoteTransport("bfloat16")),
                     ("remote_bf16_paged", RemoteTransport("bfloat16",
                                                           store=store))):
        sess, sched, comps, stats = serve_stream(fw, dev, tr, preqs, name)
        steps += stats["steps"]
        paged[name] = {"tokens": [c.tokens.tolist() for c in comps],
                       "stats": stats, "dedup": sess.dedup_summary(),
                       "M": len(sched.layers)}
    launches = ragged_decode.launches
    check(launches == cfg.num_layers * steps, "remote_serving: K1 launches")
    summary = paged["remote_bf16_paged"]["dedup"]
    check(paged["remote_bf16_paged"]["tokens"]
          == paged["remote_bf16_unpaged"]["tokens"],
          "remote_serving[paged]: tokens differ from unpaged")
    check(summary["pages_sent"] == 1848 and summary["hit_rate"] == 0.75,
          f"remote_serving[paged]: {summary['pages_sent']} pages sent, hit "
          f"rate {summary['hit_rate']} (want 1,848 and 0.75)")
    for name, o in out.items():
        st = o["stats"]
        emit({"phase": "remote_serving", "transport": name,
              "tokens_per_s": st["tokens_per_s"],
              "ttft_p50_ms": st["ttft_p50_ms"], "steps": st["steps"],
              "kernel_launches": st["kernel_launches"],
              "bytes_moved": st["bytes_moved"],
              "frame_bytes": o["frame_bytes"],
              "peak_mem_gb": st["peak_mem_gb"], "card": smi})
    for name, o in paged.items():
        st = o["stats"]
        emit({"phase": "remote_serving", "transport": name,
              "requests": len(preqs), "tokens_per_s": st["tokens_per_s"],
              "ttft_p50_ms": st["ttft_p50_ms"], "steps": st["steps"],
              "kernel_launches": st["kernel_launches"],
              "bytes_moved": st["bytes_moved"], **o["dedup"],
              "card": smi})

    # one transfer of the 2,049-position request alone: the remote views
    # against the in-memory hand-over, the record's breakdown (median of
    # 3), and the frames from the card against the frames from the CPU
    sess = fw_session(fw, InMemoryTransport())
    kv, select, _ = long_context_kv(fw, sess, reqs)
    want = InMemoryTransport().send(cfg, kvcfg, kv, select)
    views, transfer = {}, {}
    for name, make in (
            ("bf16_streamed", lambda: RemoteTransport("bfloat16")),
            ("bf16_monolithic", lambda: RemoteTransport(
                "bfloat16", chunk_bytes=None)),
            ("int8_streamed", lambda: RemoteTransport("int8")),
            ("int8_monolithic", lambda: RemoteTransport(
                "int8", chunk_bytes=None))):
        tr = make()
        views[name] = tr.send(cfg, kvcfg, kv, select)
        for _ in range(2):
            tr.send(cfg, kvcfg, kv, select)
        med = lambda f: float(np.median(                    # noqa: E731
            [getattr(r, f) for r in tr.log]))
        transfer[name] = {
            "n_bytes": tr.last.n_bytes, "frame_bytes": tr.last.frame_bytes,
            **{f"{f}_ms": med(f) * 1e3 for f in (
                "serialize_s", "channel_s", "deserialize_s", "latency_s")}}
    for p in ("k", "v"):
        for name in ("bf16_streamed", "bf16_monolithic"):
            check(torch.equal(views[name].packed_kv[p], want.packed_kv[p]),
                  f"remote_serving: {name} {p} != the in-memory hand-over")
        check(torch.equal(views["int8_streamed"].packed_kv[p],
                          views["int8_monolithic"].packed_kv[p]),
              f"remote_serving: int8 streamed {p} != monolithic")
    del views, want
    host_kv = {p: kv[p].cpu() for p in ("k", "v")}
    tiers = ("float32", "float16", "bfloat16", "int8", "int4", plan)
    frame_ms = {}
    for wire in tiers:
        t0 = time.perf_counter()
        a = encode_kv_transfer(kvcfg, kv, select, wire_dtype=wire)
        frame_ms[wire if isinstance(wire, str) else "plan"] = \
            (time.perf_counter() - t0) * 1e3
        b = encode_kv_transfer(kvcfg, host_kv, select, wire_dtype=wire)
        check(a == b, f"remote_serving: {wire} frame from the card differs "
              "from the CPU's")
        del a, b
    emit({"phase": "remote_transfer", "context_len": int(kv["k"].shape[2]),
          "selected_layers": int(select.sum()), **transfer,
          "card_frames_byte_identical_to_cpu": [
              t if isinstance(t, str) else t.spec for t in tiers],
          "card_frame_encode_ms": frame_ms,
          "phase_wall_s": time.perf_counter() - t_phase, "card": smi})
    del kv, host_kv, sess
    torch.cuda.empty_cache()
    return launches, steps


# ---------------------------------------------------------------------------
# the resilience ladder, the serving fabric and the KV server in a second
# process
# ---------------------------------------------------------------------------
# The fault script of resilient_serving, by request id (admission order):
# rid 1 recovers on its second attempt (its first chunk truncated), rid 4
# exhausts three attempts and lands on the serialized rung, rids 7 and 8
# exhaust in a row and open the breaker (threshold 2), so rid 9 is
# quarantined and goes straight down the ladder.
RESILIENT_PLAN = {1: "recover", 4: "exhaust", 7: "exhaust", 8: "exhaust",
                  9: "quarantine"}
RESILIENT_EVENTS = [("serialized", 3, 4), ("serialized", 3, 7),
                    ("serialized", 3, 8), ("serialized", 1, 9)]
RETRY_ATTEMPTS = 3
# an exhausted share's attempts: two that break the channel (the retry
# resets it) and a last one that leaves it whole (a corrupt frame fails
# its checksum), so the next request starts on a healthy channel
EXHAUST_KINDS = ("disconnect", "drop", "corrupt")


def stream_frames():
    """A loopback that records whether each frame written is a stream's
    begin frame: the frame counts of a clean run's shares, in order."""
    from repro_torch.comm import LoopbackChannel

    class Tape(LoopbackChannel):
        def __init__(self):
            super().__init__()
            self.begins = []

        def write(self, data):
            self.begins.append(b'"kind": "kv_stream_begin"' in data[22:60])
            super().write(data)

        def counts(self):
            idx = [i for i, b in enumerate(self.begins) if b]
            return [b - a for a, b in zip(idx, idx[1:] + [len(self.begins)])]
    return Tape()


def fault_script(counts, plan):
    """The faults that make ``plan`` happen to shares of ``counts`` frames
    each: a retried attempt writes again from the stream's begin frame."""
    from repro_torch.comm.resilience import Fault
    faults, op = [], 0
    for rid, n in enumerate(counts):
        how = plan.get(rid)
        if how == "recover":
            faults.append(Fault(op + 1, "truncate", frac=0.5))
            op += 2 + n
        elif how == "exhaust":
            for a in range(RETRY_ATTEMPTS):
                faults.append(Fault(op, EXHAUST_KINDS[a], frac=0.5))
                op += 1
        elif how != "quarantine":
            op += n
    return faults


def resilient_transport(wire, counts, chunk_bytes):
    """A RemoteTransport over a FaultyChannel(LoopbackChannel()) that
    fires the plan's faults, under RetryPolicy(3 attempts, seed 0)."""
    from repro_torch.comm import (FaultSchedule, FaultyChannel,
                                  LoopbackChannel, RemoteTransport,
                                  RetryPolicy)
    faulty = FaultyChannel(LoopbackChannel(), FaultSchedule(
        fault_script(counts, RESILIENT_PLAN)))
    return faulty, RemoteTransport(
        wire, channel=faulty, chunk_bytes=chunk_bytes,
        policy=RetryPolicy(max_attempts=RETRY_ATTEMPTS, seed=0))


def ladders(wire):
    """The two ladders of resilient_serving: remote -> serialized ->
    text only, and text only alone; each breaker opens after two
    consecutive failures and stays open for the run."""
    from repro_torch.comm import (CircuitBreaker, Resilience,
                                  default_resilience)
    return {"default": default_resilience(wire, breaker=CircuitBreaker(
                failure_threshold=2, reset_timeout_s=1e9)),
            "baseline": Resilience(fallbacks=[("baseline", None)],
                                   breaker=CircuitBreaker(
                                       failure_threshold=2,
                                       reset_timeout_s=1e9))}


def degradation_rows(sess, comps):
    events = [(e.stage, e.attempts, e.rid) for e in sess.degradations]
    return events, {c.rid: c.degradation.stage for c in comps
                    if c.degradation is not None}


def teacher_forced(agent, query, tokens):
    """The serial text-only path fed the scheduler row's tokens: at each
    step, how far the row's token's logit falls below the largest (over
    the largest |logit|), and whether it is the argmax (all argmax: the
    row equals serve_serial's text-only answer)."""
    import torch
    out = agent.prefill(query[None], None, max_new=len(tokens))
    logits, cache = out.logits[:, -1].float(), out.cache
    worst, same = 0.0, True
    for i, t in enumerate(tokens):
        worst = max(worst, float((logits.max() - logits[0, t])
                                 / logits.abs().max()))
        same = same and int(logits.argmax()) == t
        if i + 1 < len(tokens):
            tok = torch.tensor([[t]], device=agent.device)
            _, logits, cache = agent.decode_step(tok, cache, None)
            logits = logits.float()
    return worst, same


def resilient_tiny(device, chunk_bytes=256):
    """The script of resilient_serving at float32 on tiny_cfg (kernel
    backend): events, per-request bytes and tokens of both ladders."""
    import torch
    from repro_torch.comm import (Agent, CommSession, FaultyChannel,
                                  RemoteTransport)
    from repro_torch.core.types import KVCommConfig
    from repro_torch.launch.serve import build_requests
    from repro_torch.serving.scheduler import Scheduler, SchedulerConfig
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg, tok, params = tiny_setup("cpu")
    params = to_device(params, device)
    reqs = build_requests(tok, "retrieval", 10, 4)
    kvcfg = KVCommConfig(ratio=0.5, selector="prior_only")
    sched_cfg = SchedulerConfig(capacity=3, prefix_bucket=8, query_bucket=4,
                                decode_backend="kernel")

    def session(tr, res=None):
        return CommSession(Agent("s", cfg, params, tok),
                           Agent("r", cfg, params, tok), tr, resilience=res)
    tape = stream_frames()
    Scheduler(session(RemoteTransport(
        "float32", channel=FaultyChannel(tape), chunk_bytes=chunk_bytes)),
        kvcfg, config=sched_cfg).run(reqs)
    out = {}
    for name, res in ladders("float32").items():
        faulty, tr = resilient_transport("float32", tape.counts(),
                                         chunk_bytes)
        sess = session(tr, res)
        comps, _ = Scheduler(sess, kvcfg, config=sched_cfg).run(reqs)
        out[name] = {"tokens": [c.tokens.tolist() for c in comps],
                     "events": degradation_rows(sess, comps)[0],
                     "bytes": [r.n_bytes for r in tr.log],
                     "writes": faulty.writes}
    return out


def phase_resilient_serving(dev, smi, fw):
    """The 10 requests of full_width_serving through a bf16 RemoteTransport
    over a FaultyChannel(LoopbackChannel()) under RetryPolicy(3 attempts,
    seed 0), with the session's default ladder (remote -> serialized ->
    text only) and then a text-only ladder, both under a breaker that
    opens after two consecutive failures. The fault script comes from a
    clean run's frame counts (RESILIENT_PLAN). Gates: the events (stage,
    attempts, rid) as the plan implies; recovered and serialized rows
    token-identical to this call's in-memory stream; text-only rows within
    the bf16 rule of their serial text-only answer at every step (teacher
    forced) and the rows beside them unchanged; the same script at
    float32 on tiny_cfg gives the CPU port's events, bytes and tokens; K1
    at 28 launches per step. Returns (K1 launches, steps)."""
    import numpy as np
    from repro_torch.comm import (FaultyChannel, InMemoryTransport,
                                  RemoteTransport)
    from repro_torch.comm.remote import DEFAULT_CHUNK_BYTES
    from repro_torch.kernels.ragged_decode import ragged_decode
    t_phase = time.perf_counter()
    cfg = fw["cfg"]
    reqs = serving_requests(fw["tok"])
    ragged_decode.launches = 0                 # this path starts here
    steps, runs = 0, {}
    _, _, comps, stats = serve_stream(fw, dev, InMemoryTransport(), reqs,
                                      "inmemory")
    steps += stats["steps"]
    runs["inmemory"] = {"tokens": [c.tokens.tolist() for c in comps],
                        "stats": stats}
    tape = stream_frames()
    sess, _, comps, stats = serve_stream(
        fw, dev, RemoteTransport("bfloat16", channel=FaultyChannel(tape)),
        reqs, "remote_bf16_clean")
    steps += stats["steps"]
    counts = tape.counts()
    check(len(counts) == len(reqs), f"resilient_serving: {len(counts)} "
          f"streams for {len(reqs)} requests")
    clean_bytes = sum(r.frame_bytes for r in sess.transport.log)
    runs["remote_clean"] = {"tokens": [c.tokens.tolist() for c in comps],
                            "stats": stats, "frame_bytes": clean_bytes,
                            "bytes": [r.n_bytes for r in sess.transport.log]}
    check(runs["remote_clean"]["tokens"] == runs["inmemory"]["tokens"],
          "resilient_serving: the clean remote stream differs from "
          "in-memory")
    want = runs["inmemory"]["tokens"]
    for name, res in ladders("bfloat16").items():
        faulty, tr = resilient_transport("bfloat16", counts,
                                         DEFAULT_CHUNK_BYTES)
        sess, _, comps, stats = serve_stream(fw, dev, tr, reqs,
                                             f"resilient_{name}", res)
        steps += stats["steps"]
        events, degraded = degradation_rows(sess, comps)
        expect = [(name if name == "baseline" else stage, a, r)
                  for stage, a, r in RESILIENT_EVENTS]
        check(events == expect,
              f"resilient_serving[{name}]: events {events}")
        check(sess.degradations[-1].reason.startswith("CircuitOpenError"),
              f"resilient_serving[{name}]: rid 9 was not quarantined")
        attempts = [r.attempts for r in tr.log]
        check(attempts[1] == 2 and tr.log[1].degradation is None,
              f"resilient_serving[{name}]: rid 1 took {attempts[1]} "
              "attempts")
        tokens = [c.tokens.tolist() for c in comps]
        # the frames of the attempts that landed, and those of the ones
        # that failed (everything else the channel took)
        landed = sum(r.frame_bytes for r in tr.log if r.degradation is None)
        run = {"tokens": tokens, "stats": stats, "events": events,
               "attempts": attempts, "bytes": [r.n_bytes for r in tr.log],
               "writes": faulty.writes,
               "bytes_written": faulty.bytes_written,
               "landed_frame_bytes": landed,
               "retry_overhead": faulty.bytes_written / landed - 1,
               "resets": faulty.resets}
        if name == "default":
            check(tokens == want, "resilient_serving: recovered or "
                  "serialized rows differ from the in-memory stream")
        else:
            for rid, row in enumerate(tokens):
                if rid not in degraded:
                    check(row == want[rid], f"resilient_serving: row {rid} "
                          "beside a text-only row changed")
            text_only = {}
            for rid in sorted(degraded):
                worst, same = teacher_forced(sess.receiver,
                                             reqs[rid].query, tokens[rid])
                check(worst <= 5e-2, f"resilient_serving: text-only row "
                      f"{rid} is {worst} below the serial argmax")
                text_only[rid] = {"worst_rel_shortfall": worst,
                                  "token_identical_to_serial": same}
            run["text_only"] = text_only
        runs[name] = run
    launches = ragged_decode.launches
    check(launches == cfg.num_layers * steps,
          f"resilient_serving: {launches} K1 launches for {steps} steps")

    # the same script at float32 on tiny_cfg: the card against the CPU
    t0 = time.perf_counter()
    tiny = {d: resilient_tiny(d) for d in ("cpu", dev)}
    check(tiny["cpu"] == tiny[dev], "resilient_serving: tiny fp32 card run "
          "differs from the CPU port's")
    check(tiny["cpu"]["default"]["events"] == RESILIENT_EVENTS,
          f"resilient_serving: tiny events {tiny['cpu']['default']}")
    tiny_s = time.perf_counter() - t0
    ragged_decode.launches = launches

    for name in ("inmemory", "remote_clean", "default", "baseline"):
        st = runs[name]["stats"]
        row = {"phase": "resilient_serving", "run": name,
               "tokens_per_s": st["tokens_per_s"],
               "ttft_p50_ms": st["ttft_p50_ms"], "steps": st["steps"],
               "kernel_launches": st["kernel_launches"],
               "bytes_moved": st["bytes_moved"], "card": smi}
        if name in ("default", "baseline"):
            r = runs[name]
            row.update(events=r["events"], attempts=r["attempts"],
                       per_request_bytes=r["bytes"],
                       clean_per_request_bytes=runs["remote_clean"]["bytes"],
                       channel_writes=r["writes"],
                       channel_bytes_written=r["bytes_written"],
                       landed_frame_bytes=r["landed_frame_bytes"],
                       clean_frame_bytes=runs["remote_clean"]["frame_bytes"],
                       retry_overhead=r["retry_overhead"],
                       resets=r["resets"], text_only=r.get("text_only"))
        emit(row)
    emit({"phase": "resilient_serving_checks",
          "frames_per_share": counts, "plan": RESILIENT_PLAN,
          "tiny_fp32_card_equals_cpu": True,
          "tiny_events": tiny["cpu"]["default"]["events"],
          "tiny_s": tiny_s, "k1_launches": launches, "steps": steps,
          "phase_wall_s": time.perf_counter() - t_phase, "card": smi})
    return launches, steps


def build_fleet(agent, n=3):
    """n KVServer replicas of ``agent`` on 127.0.0.1, each with its own
    PageStore(page_len=16), started, behind a ReplicaSet and a harness
    whose restarts bring a replica back cold."""
    from repro_torch.launch.remote_serve import KVServer
    from repro_torch.serving.fabric import FleetHarness, Replica, ReplicaSet
    from repro_torch.store import PageStore

    def make(rid, port=0):
        return KVServer(agent, port=port, store=PageStore(page_len=16))
    servers = {f"r{i}": make(f"r{i}") for i in range(n)}
    replicas = ReplicaSet([Replica(rid, s.host, s.port, connect_timeout_s=0.25,
                                   io_timeout_s=300.0)
                           for rid, s in servers.items()])
    harness = FleetHarness(replicas, servers, make)
    harness.start()
    return replicas, harness


def phase_fabric_serving(dev, smi, fw):
    """Three KVServer replicas in this process (one receiver Agent on the
    card), a Router (bf16 wire, page_len 16) over the 12 paged_serving
    requests: tokens equal to receiver.generate on the same paged exchange
    in process; under affinity each context's pages cross once (1,848)
    and the hit rate is exactly 0.75; round-robin's beside it. Then a
    FleetSchedule on context 0: its holder killed after its second
    request (one hop, a cold share to the next replica, tokens unchanged),
    restarted, and all three partitioned (the local ladder answers as the
    in-memory stream). Then a SchedulerPool over the retrieval and
    multihop keys against each key's own Scheduler, K1 at 28 per step.
    Returns (K1 launches of the pool, its steps)."""
    import numpy as np
    import torch
    from repro_torch.comm import Agent, InMemoryTransport, RemoteTransport
    from repro_torch.data.synthetic import SyntheticTask, TaskConfig
    from repro_torch.kernels.ragged_decode import ragged_decode
    from repro_torch.launch.serve import build_requests
    from repro_torch.serving.fabric import (FleetEvent, FleetSchedule,
                                            Router, RouterConfig,
                                            SchedulerPool)
    from repro_torch.serving.scheduler import Scheduler, SchedulerConfig
    from repro_torch.store import PageStore
    t_phase = time.perf_counter()
    cfg, tok, kvcfg = fw["cfg"], fw["tok"], fw["kvcfg"]
    reqs = paged_requests(tok)
    receiver = Agent("receiver", cfg, fw["receiver"], tok)
    sender = Agent("sender", cfg, fw["sender"], tok)

    # the in-process answers: the same paged exchange, then generate
    ref = fw_session(fw, RemoteTransport("bfloat16",
                                         store=PageStore(page_len=16)))
    mem = fw_session(fw, InMemoryTransport())
    want, want_mem = {}, {}
    for r in reqs:
        shared, _ = ref.share(r.context[None], kvcfg, key="retrieval")
        want[r.rid] = receiver.generate(r.query[None], shared,
                                        max_new=r.max_new)[0][0].tolist()
        if r.rid in (0, 9):
            shared, _ = mem.share(r.context[None], kvcfg, key="retrieval")
            want_mem[r.rid] = receiver.generate(
                r.query[None], shared, max_new=r.max_new)[0][0].tolist()
    ref.transport.release_table()
    out = {}
    for policy in ("affinity", "round_robin"):
        replicas, harness = build_fleet(receiver)
        router = Router(sender, kvcfg, replicas, config=RouterConfig(
            wire_dtype="bfloat16", page_len=16, policy=policy),
            fallback=mem)
        try:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            comps, metrics = router.run(reqs, calib_key="retrieval")
            wall = time.perf_counter() - t0
            probe_ms = []
            for _ in range(5):
                t1 = time.perf_counter()
                replicas["r0"].probe()
                probe_ms.append((time.perf_counter() - t1) * 1e3)
        finally:
            router.close()
            harness.stop()
        for srv in harness.servers.values():
            check(srv.store.stats().pinned_bytes == 0,
                  "fabric_serving: a pin outlived its connection")
        check([c.tokens.tolist() for c in comps] ==
              [want[r.rid] for r in reqs],
              f"fabric_serving[{policy}]: tokens differ from in-process")
        check(metrics["failovers"] == 0 and metrics["local"] == 0,
              f"fabric_serving[{policy}]: {metrics}")
        out[policy] = {"metrics": metrics, "wall_s": wall,
                       "ms_per_request": wall / len(reqs) * 1e3,
                       "probe_rtt_ms": float(np.median(probe_ms)),
                       "routes": [(r.rid, r.replica_id, r.pages_sent)
                                  for r in router.routes]}
    aff = out["affinity"]["metrics"]
    M = int(mem.selection(kvcfg, key="retrieval").sum())
    distinct = M * sum(-(-(len(c) + 1) // 16) for c in
                       {r.context.tobytes(): r.context for r in reqs}.values())
    check(aff["pages_sent"] == distinct and aff["page_hit_rate"] == 0.75,
          f"fabric_serving[affinity]: {aff['pages_sent']} pages sent, hit "
          f"rate {aff['page_hit_rate']} (want {distinct} and 0.75)")

    # the fleet schedule on context 0 (rids 0, 3, 6, 9), after one
    # request of context 1 (rid 1) has made the fleet's first exchange, so
    # context 0's first cold share is timed like the failover's
    c0 = [r for r in reqs if r.rid % 3 == 0]
    replicas, harness = build_fleet(receiver)
    router = Router(sender, kvcfg, replicas, config=RouterConfig(
        wire_dtype="bfloat16", page_len=16), fallback=mem)
    times = []
    try:
        first = router.submit(reqs[1], calib_key="retrieval")
        check(first.tokens.tolist() == want[1],
              "fabric_serving[failover]: the first request's tokens")
        t0 = time.perf_counter()
        comps = [router.submit(c0[0], calib_key="retrieval")]
        times.append(time.perf_counter() - t0)
        holder = router.routes[1].replica_id
        others = [rid for rid in replicas.ids() if rid != holder]
        harness.schedule = FleetSchedule(
            [FleetEvent(1, "kill", holder), FleetEvent(2, "restart", holder)]
            + [FleetEvent(2, "partition", rid) for rid in replicas.ids()])
        for i, r in enumerate(c0[1:]):
            harness.before(i)
            t0 = time.perf_counter()
            comps.append(router.submit(r, calib_key="retrieval"))
            times.append(time.perf_counter() - t0)
        fleet_metrics = router.metrics()
    finally:
        router.close()
        harness.stop()
    routes = router.routes[1:]
    # what one dial of a dead port costs at the replicas' 0.25 s deadline
    import socket
    from repro_torch.comm.remote import RemoteProtocolError, SocketChannel
    probe = socket.socket()
    probe.bind(("127.0.0.1", 0))
    dead_port = probe.getsockname()[1]
    probe.close()
    t0 = time.perf_counter()
    try:
        SocketChannel.connect("127.0.0.1", dead_port, timeout_s=0.25)
        check(False, "fabric_serving: a dead port accepted a dial")
    except RemoteProtocolError:
        dead_dial_ms = (time.perf_counter() - t0) * 1e3
    check([c.tokens.tolist() for c in comps[:3]] == [want[r.rid]
                                                     for r in c0[:3]],
          "fabric_serving[failover]: tokens changed")
    check(routes[2].hops == 1 and routes[2].replica_id in others
          and routes[2].pages_sent == routes[2].pages_total > 0
          and routes[1].pages_sent == 0,
          f"fabric_serving[failover]: routes {routes}")
    check(comps[2].degradation is not None
          and comps[2].degradation.from_stage == f"replica:{holder}",
          "fabric_serving[failover]: the hop left no event")
    check(routes[3].replica_id is None
          and comps[3].degradation.stage == "local"
          and comps[3].tokens.tolist() == want_mem[9],
          "fabric_serving[partition]: the local ladder did not answer as "
          "the in-memory stream")
    check(len(harness.schedule.fired) == 5, "fabric_serving: events fired")

    # the SchedulerPool: one slot table per calibration key
    sess = fw_session(fw, InMemoryTransport())
    for seed in range(42, 47):
        mh = SyntheticTask(tok, TaskConfig("multihop", num_facts=6,
                                           seed=seed)).batch(1)
        sess.calibrate(mh["context"], mh["query"], key=f"multihop{seed}")
        if not torch.equal(sess.selection(kvcfg, key="retrieval"),
                           sess.selection(kvcfg, key=f"multihop{seed}")):
            break
    mkey = f"multihop{seed}"
    check(not torch.equal(sess.selection(kvcfg, key="retrieval"),
                          sess.selection(kvcfg, key=mkey)),
          "fabric_serving: the two keys select the same layers")
    by_key = {"retrieval": build_requests(tok, "retrieval", 6, 8),
              mkey: build_requests(tok, "multihop", 6, 8)}
    for i, r in enumerate(by_key[mkey]):
        r.rid = 100 + i
    sc = SchedulerConfig(capacity=4, decode_backend="kernel")
    pool = SchedulerPool(sess, kvcfg, config=sc)
    for key, rs in by_key.items():
        for r in rs:
            pool.submit(r, calib_key=key)
    torch.cuda.synchronize()
    ragged_decode.launches = 0                 # this path starts here
    t0 = time.perf_counter()
    pcomps, pmetrics = pool.run()
    torch.cuda.synchronize()
    pool_wall = time.perf_counter() - t0
    launches = ragged_decode.launches
    pool_steps = sum(m["steps"] for m in pmetrics["per_key"].values())
    check(launches == cfg.num_layers * pool_steps > 0,
          f"fabric_serving[pool]: {launches} K1 launches for {pool_steps} "
          "steps")
    got = {c.rid: c.tokens.tolist() for c in pcomps}
    for key, rs in by_key.items():
        own, _ = Scheduler(sess, kvcfg, calib_key=key, config=sc).run(rs)
        check(all(got[c.rid] == c.tokens.tolist() for c in own),
              f"fabric_serving[pool]: key {key} differs from its own "
              "Scheduler")
    ragged_decode.launches = launches
    for policy, o in out.items():
        emit({"phase": "fabric_serving", "policy": policy,
              "requests": len(reqs), **o["metrics"],
              "ms_per_routed_request": o["ms_per_request"],
              "probe_rtt_ms": o["probe_rtt_ms"], "routes": o["routes"],
              "card": smi})
    emit({"phase": "fabric_failover", "holder": holder,
          "paged_answers_equal_in_memory": all(
              want_mem[r] == want[r] for r in want_mem),
          "routes": [(r.rid, r.replica_id, r.hops, r.pages_sent,
                      r.pages_total) for r in routes],
          "events": [(c.degradation.from_stage, c.degradation.stage)
                     for c in comps if c.degradation is not None],
          "ms": [t * 1e3 for t in times],
          "failover_extra_ms": (times[2] - times[0]) * 1e3,
          "dead_dial_ms": dead_dial_ms,
          "metrics": fleet_metrics, "card": smi})
    emit({"phase": "scheduler_pool", "keys": list(by_key),
          "selected": {k: [int(i) for i in torch.nonzero(
              sess.selection(kvcfg, key=k)).flatten()] for k in by_key},
          "requests": len(pcomps), "tokens": pmetrics["tokens"],
          "steps": pool_steps, "kernel_launches": launches,
          "tokens_per_s": pmetrics["tokens"] / pool_wall,
          "phase_wall_s": time.perf_counter() - t_phase, "card": smi})
    return launches, pool_steps


def start_remote_server(pool_mb=1024):
    """``python -m repro_torch.launch.remote_serve server`` at full width on
    the card (seed 0) in a second process. Returns the process; its
    stdout's first lines are PROBE and PORT."""
    import os
    env = dict(os.environ, PYTHONPATH=str(SRC) + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    proc = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.remote_serve", "server",
         "--port", "0", "--device", "cuda", "--config", "full", "--seed",
         "0", "--pool-mb", str(pool_mb), "--timeout", "600"],
        cwd=str(ROOT), env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    CHILDREN.append(proc)
    return proc


def read_line(proc, prefix, timeout_s=300.0):
    """The rest of the server's next output line that starts with
    ``prefix``, other lines skipped (read with a deadline: a thread does
    the blocking reads)."""
    import threading
    box, seen = [], []

    def reader():
        for line in proc.stdout:
            if line.startswith(prefix):
                box.append(line)
                return
            seen.append(line)
    th = threading.Thread(target=reader, daemon=True)
    th.start()
    th.join(timeout_s)
    check(bool(box), f"remote_serve server: no {prefix!r} line within "
          f"{timeout_s}s (exit {proc.poll()}): {''.join(seen)[-2000:]}")
    return box[0][len(prefix):].strip()


def phase_remote_serve_two_process(dev, smi, fw, proc):
    """The KV server in a second process at full width (same seed, same
    card: its probe logits equal this process's), reached over TCP by a
    KVClient here: a streamed bf16 share of the 2,049-position request
    then generate, and a paged share twice (the second ships no page),
    each answered as receiver.generate answers in process; the server
    exits 0 on shutdown."""
    import numpy as np
    import torch
    from repro_torch.comm import Agent, InMemoryTransport, RemoteTransport
    from repro_torch.comm.remote import DEFAULT_CHUNK_BYTES
    from repro_torch.launch.remote_serve import KVClient, probe_logits
    from repro_torch.store import PageStore
    t_phase = time.perf_counter()
    cfg, tok, kvcfg = fw["cfg"], fw["tok"], fw["kvcfg"]
    receiver = Agent("receiver", cfg, fw["receiver"], tok)
    sender = Agent("sender", cfg, fw["sender"], tok)
    theirs = json.loads(read_line(proc, "PROBE "))
    port = int(read_line(proc, "PORT "))
    mine = probe_logits(receiver)
    diff = max(abs(a - b) for a, b in zip(mine, theirs))
    check(diff <= 1e-2 * max(abs(x) for x in mine[:-1]),
          f"remote_serve: the server's probe logits differ by {diff}")
    req = serving_requests(tok)[-1]
    want = {}
    for name, tr in (("inmemory", InMemoryTransport()),
                     ("streamed", RemoteTransport("bfloat16")),
                     ("paged", RemoteTransport(
                         "bfloat16", store=PageStore(page_len=16)))):
        sess = fw_session(fw, tr)
        shared, select = sess.share(req.context[None], kvcfg,
                                    key="retrieval")
        want[name] = receiver.generate(req.query[None], shared,
                                       max_new=req.max_new)[0].cpu().numpy()
    client = KVClient.connect("127.0.0.1", port, timeout_s=120.0,
                              io_timeout_s=300.0)
    ms = {}
    try:
        t0 = time.perf_counter()
        n_streamed = client.share(sender, req.context[None], kvcfg, select,
                                  wire_dtype="bfloat16",
                                  chunk_bytes=DEFAULT_CHUNK_BYTES)
        ms["share_streamed"] = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        got = [client.generate(req.query[None], max_new=req.max_new)]
        ms["generate"] = (time.perf_counter() - t0) * 1e3
        paged = []
        for i in range(2):
            t0 = time.perf_counter()
            paged.append(client.share_paged(
                sender, req.context[None], kvcfg, select, page_len=16,
                wire_dtype="bfloat16"))
            ms[f"share_paged_{i}"] = (time.perf_counter() - t0) * 1e3
            got.append(client.generate(req.query[None],
                                       max_new=req.max_new))
        health = client.probe()
    finally:
        client.close()
    try:
        out, _ = proc.communicate(timeout=120)
    except subprocess.TimeoutExpired:
        proc.kill()
        out, _ = proc.communicate()
    check(proc.returncode == 0, f"remote_serve server exited "
          f"{proc.returncode}: {out[-2000:]}")
    for g, name in zip(got, ("streamed", "paged", "paged")):
        check(np.array_equal(g, want[name]), f"remote_serve: the {name} "
              "remote answer differs from the in-process one")
    check(paged[0][2] == paged[0][1] > 0 and paged[1][2] == 0,
          f"remote_serve: paged shares shipped {paged}")
    emit({"phase": "remote_serve_two_process", "context_len":
          int(req.context.shape[0]) + 1, "probe_max_abs_diff": diff,
          "probe_identical": mine == theirs,
          "streamed_payload_bytes": n_streamed,
          "paged": [{"payload_bytes": n, "pages_total": t, "pages_sent": s}
                    for n, t, s in paged], **{f"{k}_ms": v
                                              for k, v in ms.items()},
          "server_answered": health["answered"],
          "in_process_exchanges_equal_in_memory": all(
              np.array_equal(w, want["inmemory"]) for w in want.values()),
          "server_stdout_tail": out.strip().splitlines()[-2:],
          "phase_wall_s": time.perf_counter() - t_phase, "card": smi})


# ---------------------------------------------------------------------------
# the kernel entry point (repro_torch.kernels.ops: K2, K3, K4) and the
# sequence-sharded decode
# ---------------------------------------------------------------------------
# ---------------------------------------------------------------------------
# state sharing: rwkv6-1.6b (K4 in every time mix) and zamba2-2.7b (Mamba2
# plus shared attention, K1 on its decode) at their published widths
# ---------------------------------------------------------------------------
# olmoe's dropping MoE at capacity E/k against dense_all, one bf16 layer:
# within 3e-2 of the largest |output|
MOE_DROP_BF16_BOUND = 3e-2
# float32 card against CPU: logits within 1e-4 of the largest |logit|, and
# tokens equal wherever the CPU's top-2 margin is at least MARGIN
FP32_BOUND, MARGIN = 1e-4, 1e-3
# float32 at full width (24-54 layers, another summation order): ten times
# the tiny pair's bound
FP32_FULL_BOUND = 1e-3
# a full-width bf16 decode step, kernel against the plain backend (PERF.md
# section 2: the step rule of the full-width serving phase)
STEP_BOUND = 5e-2
# RWKV6's state-sharing gate (rwkv6_state_gate; ROADMAP F9): the float32
# skyline, and at bf16 the mean KL divergence of the receiver's next-token
# distributions from the bf16 skyline's and every layer's handed-over
# states within a relative Frobenius error of the float32 sender's. On an
# H100 at 700 W (PERF.md section 6, PR 25) seven correct K4 variants read KL
# 3.1e-5 to 1.2e-4 and states 0.096 to 0.098; five planted faults KL 2.3e-3
# or more, and states 1.0 or more where the fault is in the hand-off
RWKV6_KL_BOUND, RWKV6_STATE_BOUND = 5e-4, 0.25
RWKV6_GATES = (("fp32_max_rel", FP32_FULL_BOUND), ("kl", RWKV6_KL_BOUND),
               ("states", RWKV6_STATE_BOUND))
# Zamba2's state-sharing gate (zamba2_state_gate; ROADMAP F10): the float32
# skyline; at bf16 the receiver's distance from the float32 skyline within
# twice the bf16 skyline's (floor_max), the mean KL divergence from the
# bf16 skyline, and every Mamba2 layer's handed-over states (ssm and conv:
# their honest readings lie under 2x apart) against a float32 sender's.
# On an H100 at 700 W (PERF.md section 6, PR 26) four honest runs read KL
# 5.2e-4 to 5.4e-4 and states 0.165 to 0.170; four planted faults KL
# 2.5e-3 or more, and states 1.0 or more where the fault is in a state
ZAMBA2_KL_BOUND, ZAMBA2_STATE_BOUND = 1.15e-3, 0.4
ZAMBA2_GATES = (("fp32_max_rel", FP32_FULL_BOUND), ("floor_max", 2.0),
                ("kl", ZAMBA2_KL_BOUND), ("states", ZAMBA2_STATE_BOUND))
_BITS = {"float32": 32, "bfloat16": 16, "float16": 16, "int8": 8, "int4": 4}


def state_wire_bytes(states, state_select, wire):
    """Analytic wire bytes of the selected layers of every state leaf at a
    uniform wire: the values at the wire's width, plus one float32 scale
    per layer and leaf for int8 / int4."""
    m = int(state_select.sum())
    scale = 4 * m if wire in ("int8", "int4") else 0
    return sum(m * x[0].numel() * _BITS[wire] // 8 + scale
               for x in states.values())


def rel_and_agree(got, want):
    """(max |got - want| / max |want|, argmax agreement share)."""
    got, want = got.float(), want.float()
    rel = float((got - want).abs().max() / want.abs().max())
    agree = float((got.argmax(-1) == want.argmax(-1)).float().mean())
    return rel, agree


def skyline_runs(cfg, params, tok, ctx, qry, share_all):
    """The receiver given every layer's KV and every state against the
    skyline run of [C; Q], at the model's bf16 and at float32 (the same
    weights upcast, TF32 off). ``share_all(kv, states, export)`` makes the
    receiver's SharedKV from the sender's export of ``ctx``; ``export(
    tokens)`` exports other tokens from the same agent, as (kv, states).
    Returns, per dtype, the receiver's logits ``got`` and the skyline's
    ``sky`` (float32, (B, Q, V)), the sender's exported ``states`` and the
    states handed over, ``shared``."""
    return skyline_cases(cfg, params, tok, ctx, qry, {None: share_all})[None]


def skyline_cases(cfg, params, tok, ctx, qry, shares):
    """``skyline_runs`` for each callback of ``shares`` ({case:
    share_all}): the sender's export of ``ctx`` and the skyline once per
    dtype, the receiver once per case. Returns {case: runs}."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch.comm import Agent
    from repro_torch.models import transformer as tfm
    torch.backends.cuda.matmul.allow_tf32 = False
    runs = {case: {} for case in shares}
    for dt in ("bfloat16", "float32"):
        c = dataclasses.replace(cfg, dtype=dt)
        p = params if dt == cfg.dtype else to_device(params, torch.float32)
        agent = Agent("receiver", c, p, tok)
        kv, states, Sc = agent.export_kv(ctx)
        sky = tfm.apply_model(p, c, agent.tokens(np.concatenate(
            [agent.with_bos(ctx), qry], 1))).logits[:, Sc:].float().clone()
        for case, share_all in shares.items():
            shared = share_all(kv, states, lambda t: agent.export_kv(t)[:2])
            got = agent.prefill(qry, shared, max_new=0).logits.float()
            runs[case][dt] = {"got": got, "sky": sky, "states": states,
                              "shared": shared.states}
            del shared
        del p, agent, kv
    torch.cuda.empty_cache()
    return runs


def skyline_gate(cfg, params, tok, ctx, qry, share_all):
    """``skyline_runs``' logits as (rel, argmax agreement) for: bf16
    shared vs bf16 skyline, float32 shared vs float32 skyline, and each
    bf16 run against the float32 skyline (the bf16 noise floor)."""
    runs = skyline_runs(cfg, params, tok, ctx, qry, share_all)
    b16, f32 = runs["bfloat16"], runs["float32"]
    return {"bf16": rel_and_agree(b16["got"], b16["sky"]),
            "fp32": rel_and_agree(f32["got"], f32["sky"]),
            "bf16_skyline_vs_fp32": rel_and_agree(b16["sky"], f32["sky"]),
            "bf16_shared_vs_fp32": rel_and_agree(b16["got"], f32["sky"])}


def logit_readings(got, want):
    """Statistics of logits ``got`` against ``want`` (float32, (B, Q, V)):
    the largest error over the largest |logit| (``max_rel``, the F5
    rule's), argmax agreement, the RMS error over the RMS logit
    (``rms_rel``), the median over query positions of each position's
    largest error over its largest |logit| (``med_pos``), and the mean
    over positions of KL(softmax(want) || softmax(got)) (``kl``)."""
    d = (got - want).abs()
    lw, lg = want.log_softmax(-1), got.log_softmax(-1)
    return {
        "max_rel": float(d.max() / want.abs().max()),
        "agree": float((got.argmax(-1) == want.argmax(-1)).float().mean()),
        "rms_rel": float(d.square().mean().sqrt()
                         / want.square().mean().sqrt()),
        "med_pos": float((d.amax(-1) / want.abs().amax(-1)).median()),
        "kl": float((lw.exp() * (lw - lg)).sum(-1).mean()),
    }


def state_readings(got, want):
    """The handed-over states ``got`` against ``want`` (a float32
    sender's), leaf by leaf: the largest over layers of the relative
    Frobenius error, and the layer where it is largest."""
    out = {}
    for key, w in want.items():
        w = w.float().flatten(1)
        rel = ((got[key].float().flatten(1) - w).norm(dim=1)
               / w.norm(dim=1).clamp_min(1e-30))
        out[key] = [float(rel.max()), int(rel.argmax())]
    return out


def rwkv6_candidates(r):
    """The candidate bf16 rules' readings from ``rwkv6_state_gate``'s
    readings ``r`` (ROADMAP F9; PERF.md section 6, PR 25): the F5 rule's
    largest error against the bf16 skyline (``f5_max_rel``, with its
    argmax agreement); (i) bf16 shared against the float32 skyline over
    the bf16 skyline's own distance from it (``floor_max``, ``floor_rms``);
    (ii) statistics against the bf16 skyline that the chaotic tail moves
    less (``med_pos``, ``rms_rel``, ``kl``); (iii) the handed-over states
    against the float32 sender's (``states``: the largest relative
    Frobenius error of any layer and leaf); and the float32 gate."""
    b16, floor, shared = (r["bf16"], r["bf16_skyline_vs_fp32"],
                          r["bf16_shared_vs_fp32"])
    return {
        "f5_max_rel": b16["max_rel"], "f5_agree": b16["agree"],
        "floor_max": shared["max_rel"] / floor["max_rel"],
        "floor_rms": shared["rms_rel"] / floor["rms_rel"],
        "med_pos": b16["med_pos"], "rms_rel": b16["rms_rel"],
        "kl": b16["kl"],
        "states": max(v[0] for v in r["states_bf16"].values()),
        "fp32_max_rel": r["fp32"]["max_rel"],
    }


def state_gate(r, cand, gates):
    """The verdict of ``gates`` ((name, bound), ...) on the candidate
    readings ``cand`` of readings ``r``: {"readings", "candidates",
    "gates": {name: [reading, bound]}, "ok", "refused_by"}; ok when every
    gate holds."""
    gates = {name: [cand[name], bound] for name, bound in gates}
    refused = [name for name, (x, bound) in gates.items() if not x <= bound]
    return {"readings": r, "candidates": cand, "gates": gates,
            "ok": not refused, "refused_by": refused}


def rwkv6_state_gate(cfg, params, tok, ctx, qry, share_all):
    """RWKV6's state-sharing gate: ``skyline_runs`` read by
    ``gate_readings`` and ``rwkv6_candidates``, under RWKV6_GATES
    (``state_gate``)."""
    r = gate_readings(skyline_runs(cfg, params, tok, ctx, qry, share_all))
    return state_gate(r, rwkv6_candidates(r), RWKV6_GATES)


def gate_readings(runs):
    """``skyline_runs``' output as readings: the logits of the receiver
    against the skyline at each dtype and of each bf16 run against the
    float32 skyline (``logit_readings``), and the states handed over at
    each dtype against the float32 sender's (``state_readings``)."""
    b16, f32 = runs["bfloat16"], runs["float32"]
    return {"bf16": logit_readings(b16["got"], b16["sky"]),
            "fp32": logit_readings(f32["got"], f32["sky"]),
            "bf16_skyline_vs_fp32": logit_readings(b16["sky"], f32["sky"]),
            "bf16_shared_vs_fp32": logit_readings(b16["got"], f32["sky"]),
            "states_bf16": state_readings(b16["shared"], f32["states"]),
            "states_fp32": state_readings(f32["shared"], f32["states"])}


def draw_rwkv6_bonus(params, seed=1):
    """Every RWKV6 layer's bonus u drawn uniform in [0, 1) from ``seed``,
    in place. ``init_params`` leaves u at 0 as the reference does, and a
    zero bonus hides from every gate whether the receiver adds it."""
    import torch
    g = torch.Generator().manual_seed(seed)
    for lp in params["layers"]:
        if "rwkv" in lp:
            u = lp["rwkv"]["u"]
            lp["rwkv"]["u"] = torch.rand(u.shape, generator=g).to(u)
    return params


def rwkv6_faults(cfg, ctx, share_all):
    """The planted faults of the state hand-off (ROADMAP F9), each a pair
    (share_all, substitute for ``ssm.wkv6`` or None) for
    ``rwkv6_state_gate``; none of them is a switch in the port. f1: the
    middle layer's (12 of 24) wkv state zeroed; f2: that state transposed
    in its (hd, hd) axes; f3: the states after C - 1 context tokens handed
    over as those after C; f4: the receiver's streamed calls (T <= 16,
    K4's streaming kernel) run without the bonus u; f5: the middle
    layer's token-shift states (tm_x, cm_x) zeroed."""
    import torch
    from repro_torch.kernels.rwkv_scan import STREAM_MAX_T
    mid = cfg.num_layers // 2

    def on_states(fault):
        def share(kv, states, export):
            states = {key: x.clone() for key, x in states.items()}
            fault(states)
            return share_all(kv, states, export)
        return share

    def transpose(st):
        st["wkv"][mid] = st["wkv"][mid].transpose(-1, -2).clone()

    def shift_zeroed(st):
        st["tm_x"][mid] = 0
        st["cm_x"][mid] = 0

    def off_by_one(kv, states, export):
        return share_all(kv, export(ctx[:, :-1])[1], export)

    def without_bonus(wkv):
        def run(r, k, v, w, u, state):
            if r.shape[1] <= STREAM_MAX_T:
                u = torch.zeros_like(u)
            return wkv(r, k, v, w, u, state)
        return run

    return {
        "f1_wkv_zeroed": (on_states(lambda st: st["wkv"][mid].zero_()),
                          None),
        "f2_wkv_transposed": (on_states(transpose), None),
        "f3_context_off_by_one": (off_by_one, None),
        "f4_stream_without_bonus": (share_all, without_bonus),
        "f5_shift_zeroed": (on_states(shift_zeroed), None),
    }


def rwkv6_fault_gates(cfg, params, tok, ctx, qry, share_all):
    """``rwkv6_state_gate`` on the honest share, then under each planted
    fault of ``rwkv6_faults`` (a substitute scan in place of ``ssm.wkv6``
    for that run only)."""
    from repro_torch.models import ssm
    out = {"honest": rwkv6_state_gate(cfg, params, tok, ctx, qry,
                                      share_all)}
    for name, (share, scan) in rwkv6_faults(cfg, ctx, share_all).items():
        saved = ssm.wkv6
        if scan is not None:
            ssm.wkv6 = scan(saved)
        try:
            out[name] = rwkv6_state_gate(cfg, params, tok, ctx, qry, share)
        finally:
            ssm.wkv6 = saved
    return out


def zamba2_candidates(r):
    """``rwkv6_candidates``, the mean KL of bf16 shared from the float32
    skyline over the bf16 skyline's (``floor_kl``), and each Mamba2 leaf's
    largest handed-over state error (``states_ssm``, ``states_conv``)."""
    floor_kl = (r["bf16_shared_vs_fp32"]["kl"]
                / max(r["bf16_skyline_vs_fp32"]["kl"], 1e-30))
    return {**rwkv6_candidates(r), "floor_kl": floor_kl,
            **{f"states_{key}": v[0] for key, v in r["states_bf16"].items()}}


def zamba2_state_gate(runs):
    """Zamba2's state-sharing gate (ROADMAP F10): ``skyline_runs``' output
    read by ``gate_readings`` and ``zamba2_candidates``, under
    ZAMBA2_GATES (``state_gate``)."""
    r = gate_readings(runs)
    return state_gate(r, zamba2_candidates(r), ZAMBA2_GATES)


def zamba2_faults(cfg, ctx, share_all):
    """The planted faults of Zamba2's hand-off (ROADMAP F10), each a
    share_all for ``skyline_runs``; none of them is a switch in the
    port. On the middle Mamba2 layer (27 of 54): z1 its ``ssm`` state
    zeroed, z2 its ``conv`` state zeroed; z3 the states after C - 1
    context tokens handed over with the KV of C; z4 the KV of the middle
    shared-attention invocation (the 5th of 9) zeroed, every state
    intact."""
    from repro_torch.core import protocol
    mid, mid_attn = protocol._n_ssm(cfg) // 2, cfg.attn_layer_count // 2

    def state_zeroed(leaf):
        def share(kv, states, export):
            states = {key: x.clone() for key, x in states.items()}
            states[leaf][mid] = 0
            return share_all(kv, states, export)
        return share

    def off_by_one(kv, states, export):
        return share_all(kv, export(ctx[:, :-1])[1], export)

    def kv_zeroed(kv, states, export):
        kv = {key: x.clone() for key, x in kv.items()}
        for x in kv.values():
            x[mid_attn] = 0
        return share_all(kv, states, export)

    return {"z1_ssm_zeroed": state_zeroed("ssm"),
            "z2_conv_zeroed": state_zeroed("conv"),
            "z3_context_off_by_one": off_by_one,
            "z4_attn_kv_zeroed": kv_zeroed}


def zamba2_fault_gates(cfg, params, tok, ctx, qry, share_all):
    """``zamba2_state_gate`` on the honest share and under each planted
    fault of ``zamba2_faults``; the sender's export and the skyline are
    computed once per dtype (``skyline_cases``)."""
    shares = {"honest": share_all, **zamba2_faults(cfg, ctx, share_all)}
    return {case: zamba2_state_gate(runs) for case, runs in skyline_cases(
        cfg, params, tok, ctx, qry, shares).items()}


def greedy(agent, qry, shared, n, backend, force=None):
    """Greedy tokens and each step's last-position logits: the prefill,
    then n - 1 decode steps, teacher-forced on ``force`` (B, n) when given.
    Returns (tokens (B, n), [logits (B, V) float32 on the CPU])."""
    import torch
    out = agent.prefill(qry, shared, max_new=n)
    cache, lg = out.cache, out.logits[:, -1].float()
    toks, logits = [], []
    for i in range(n):
        tok = lg.argmax(-1)
        toks.append(tok.cpu())
        logits.append(lg.cpu())
        if i + 1 < n:
            feed = tok if force is None else force[:, i].to(tok.device)
            _, lg, cache = agent.decode_step(feed[:, None], cache, shared,
                                             backend=backend)
            lg = lg.float()
    return torch.stack(toks, 1), logits


def margin_rule(want_toks, want_logits, got_toks):
    """Tokens equal at every step of a row until the reference's top-2
    margin first falls below MARGIN there (a near tie may rightly flip,
    and the rows part after it). Returns the steps compared."""
    import torch
    live = torch.ones(want_toks.shape[0], dtype=torch.bool)
    compared = 0
    for i, lg in enumerate(want_logits):
        top2 = lg.topk(2, -1).values
        live &= (top2[:, 0] - top2[:, 1]) >= MARGIN
        check(bool((want_toks[live, i] == got_toks[live, i]).all()),
              f"tokens differ at step {i} where the margin is >= {MARGIN}")
        compared += int(live.sum())
    return compared


def ssm_tiny_parity(dev, arch):
    """The reduced float32 pair (one parameter draw on the CPU, its copy
    on the card) through share, prefill and 4 greedy steps on the kernel
    backend: bytes equal, prefill logits within FP32_BOUND, tokens under
    the margin rule."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch.comm import Agent, CommSession, SerializedTransport
    from repro_torch.configs.registry import get_config
    from repro_torch.core.types import KVCommConfig
    from repro_torch.data.tokenizer import SymbolTokenizer
    from repro_torch.models import transformer as tfm
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    tok = SymbolTokenizer(16, 8)
    cfg = dataclasses.replace(get_config(arch).reduced(), dtype="float32",
                              vocab_size=tok.vocab_size)
    params = tfm.init_params(cfg, 3, device="cpu")
    rng = np.random.default_rng(5)
    ctx = rng.integers(4, cfg.vocab_size, (4, 12)).astype(np.int32)
    qry = rng.integers(4, cfg.vocab_size, (4, 5)).astype(np.int32)
    out = {}
    for d in ("cpu", dev):
        p = to_device(params, d)
        sess = CommSession(Agent("s", cfg, p, tok), Agent("r", cfg, p, tok),
                           SerializedTransport("int8"))
        shared, _ = sess.share(ctx, KVCommConfig(ratio=0.5,
                                                 selector="prior_only"))
        toks, logits = greedy(sess.receiver, qry, shared, 4, "kernel")
        out[str(d)] = (sess.transport.total_bytes, toks, logits)
    (nb, toks, logits), (nb_c, toks_c, logits_c) = out["cpu"], out[str(dev)]
    rel = float((logits_c[0] - logits[0]).abs().max()
                / logits[0].abs().max())
    check(nb == nb_c and rel <= FP32_BOUND,
          f"{arch} tiny fp32: bytes {nb_c} vs {nb}, logits rel {rel}")
    compared = margin_rule(toks, logits, toks_c)
    return {"logits_rel": rel, "bound": FP32_BOUND,
            "tokens_compared": compared, "bytes": nb}


def ss_run(sess, ctx, qry, kvcfg, n, backend, scores=None):
    """One served round: share, then generate n tokens. Returns (shared,
    select, tokens, share seconds, generate seconds)."""
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    shared, select = sess.share(ctx, kvcfg, scores=scores)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    toks, _ = sess.receiver.generate(qry, shared, max_new=n,
                                     backend=backend)
    torch.cuda.synchronize()
    return shared, select, toks.cpu(), t1 - t0, time.perf_counter() - t1


def ss_line(model, name, tr, state_bytes, n_req, n_new, share_s, gen_s,
            stages, smi, **extra):
    rec = tr.last
    return {"phase": "state_sharing", "model": model, "transport": name,
            "requests": n_req, "new_tokens": n_new,
            "bytes": rec.n_bytes, "state_bytes": state_bytes,
            "share_ms": share_s * 1e3, "transfer_ms": rec.latency_s * 1e3,
            "serialize_ms": rec.serialize_s * 1e3,
            "channel_ms": rec.channel_s * 1e3,
            "deserialize_ms": rec.deserialize_s * 1e3,
            "generate_ms": gen_s * 1e3,
            "tokens_per_s": n_req * n_new / gen_s, **stages, **extra,
            "card": smi}


def phase_rwkv6_state_sharing(dev, smi, flush, tok):
    """rwkv6-1.6b as published (24 layers, d 2048, 32 heads of 64), bf16,
    random weights from seed 0 for both roles (the bonus u from seed 1,
    ``draw_rwkv6_bonus``), the state-sharing gate and its planted faults
    (``rwkv6_fault_gates``), then 4 requests of a 2,049-token
    context (K4 at T 2049) and 16 new tokens, prior_only at ratio 0.5,
    through in-memory, Serialized bf16 / int8 and a streamed bf16
    RemoteTransport; K4 launched 24 times per forward call."""
    import numpy as np
    import torch
    from repro_torch.comm import (Agent, CommSession, InMemoryTransport,
                                  RemoteTransport, SerializedTransport)
    from repro_torch.comm.transport import payload_bytes
    from repro_torch.configs.registry import get_config
    from repro_torch.core.types import KVCommConfig, SharedKV
    from repro_torch.kernels.rwkv_scan import wkv6
    from repro_torch.models import transformer as tfm
    t_phase = time.perf_counter()
    tiny = ssm_tiny_parity(dev, "rwkv6-1.6b")
    cfg = get_config("rwkv6-1.6b")
    t0 = time.perf_counter()
    params = draw_rwkv6_bonus(tfm.init_params(cfg, 0, device=dev))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    L, B, C, Q, N = cfg.num_layers, 4, 2048, 16, 16
    rng = np.random.default_rng(0)
    ctx = rng.integers(4, cfg.vocab_size, (B, C)).astype(np.int32)
    qry = rng.integers(4, cfg.vocab_size, (B, Q)).astype(np.int32)
    sender = Agent("sender", cfg, params, tok)
    receiver = Agent("receiver", cfg, params, tok)
    kvcfg = KVCommConfig(ratio=0.5, selector="prior_only")
    ss_run(CommSession(sender, receiver), ctx[:, :32], qry, kvcfg, 2,
           "kernel")                           # warm-up, not counted

    # every state shared equals the skyline over [C; Q] under every gate of
    # RWKV6_GATES, and each planted fault of the hand-off is refused by
    # some gate at twice its bound or more; none shared is further off
    everything = lambda kv, states, export=None: SharedKV(  # noqa: E731
        states=states, state_select=torch.ones(L, dtype=torch.bool))
    t0 = time.perf_counter()
    gates = rwkv6_fault_gates(cfg, params, tok, ctx, qry, everything)
    honest = gates.pop("honest")
    check(honest["ok"], f"rwkv6: all states shared refused by "
          f"{honest['refused_by']}: {honest['gates']}")
    faults = {}
    for name, g in gates.items():
        margin = max(x / bound for x, bound in g["gates"].values())
        check(margin >= 2, f"rwkv6: fault {name} under twice every gate's "
              f"bound: {g['gates']}")
        faults[name] = {"gates": g["gates"], "refused_by": g["refused_by"],
                        "reading_over_bound": margin}
    emit({"phase": "state_sharing_rwkv6_faults", "honest": honest["gates"],
          "faults": faults, "seconds": time.perf_counter() - t0,
          "card": smi})
    sky = honest["readings"]
    rel = sky["bf16"]["max_rel"]
    kv, states, Sc = sender.export_kv(ctx)
    check(kv is None and Sc == C + 1, "rwkv6: the sender exports states")
    got = receiver.prefill(qry, everything(None, states), max_new=0).logits
    nothing = SharedKV(states=states, state_select=torch.zeros(
        L, dtype=torch.bool))
    rel_none, _ = rel_and_agree(receiver.prefill(qry, nothing,
                                                 max_new=0).logits, got)
    check(rel_none > 2 * rel, f"rwkv6: no state shared is as close to all "
          f"shared ({rel_none}) as the skyline is ({rel})")
    del got

    # the main path: K4's counter at 0, then every transport's round
    torch.cuda.synchronize()
    wkv6.launches = 0
    runs = {}
    for name, tr, wire in (
            ("inmemory", InMemoryTransport(), None),
            ("serialized_bf16", SerializedTransport("bfloat16"), "bfloat16"),
            ("serialized_int8", SerializedTransport("int8"), "int8"),
            ("remote_bf16_stream", RemoteTransport("bfloat16"),
             "bfloat16")):
        sess = CommSession(sender, receiver, tr)
        l0 = wkv6.launches
        shared, _, toks, share_s, gen_s = ss_run(sess, ctx, qry, kvcfg, N,
                                                 "kernel")
        forwards = 1 + 1 + N       # sender prefill, prefill, N steps
        check(wkv6.launches - l0 == L * forwards,
              f"rwkv6 {name}: {wkv6.launches - l0} K4 launches for "
              f"{forwards} forward calls of {L} layers")
        ss = shared.state_select
        want = (payload_bytes(None, None, states, ss) if wire is None
                else state_wire_bytes(states, ss, wire))
        check(tr.last.n_bytes == want, f"rwkv6 {name}: {tr.last.n_bytes} "
              f"bytes, analytic {want}")
        check(bool(torch.isfinite(shared.states["wkv"]).all()),
              f"rwkv6 {name}: non-finite received state")
        runs[name] = (tr, toks, share_s, gen_s, int(ss.sum()), shared)
    launches = wkv6.launches
    check(torch.equal(runs["remote_bf16_stream"][1],
                      runs["serialized_bf16"][1]),
          "rwkv6: remote bf16 tokens differ from Serialized bf16")

    # each stage alone, and K4 at the served shapes (off the counter)
    shared = runs["inmemory"][5]
    cache = receiver.prefill(qry, shared, max_new=N).cache
    tok1 = torch.zeros((B, 1), dtype=torch.long, device=dev)
    stages = {
        "sender_prefill_ms": wall_ms(lambda: sender.export_kv(ctx)),
        "receiver_prefill_ms": wall_ms(
            lambda: receiver.prefill(qry, shared, max_new=N)),
        "decode_step_ms": wall_ms(
            lambda: receiver.decode_step(tok1, cache, shared)),
    }
    wkv6.launches = launches
    cases = [compare_case(wkv_case(dev, "rwkv6_served_prefill", B, C + 1,
                                   32, 64, seed=20), flush),
             # the receiver's prefill of Q steps: the streaming kernel's
             # steps staged together, the state carried step to step
             compare_case(wkv_case(dev, "rwkv6_receiver_prefill", B, Q, 32,
                                   64, seed=24, plain_iters=5), flush),
             compare_case(wkv_case(dev, "rwkv6_served_decode", B, 1, 32, 64,
                                   seed=21, plain_iters=20), flush)]
    for c in cases:
        emit({"phase": "state_sharing_kernel_vs_plain", **c, "card": smi})
    for name, (tr, toks, share_s, gen_s, m, _) in runs.items():
        emit(ss_line("rwkv6-1.6b", name, tr, tr.last.n_bytes, B, N, share_s,
                     gen_s, stages, smi, states_selected=m,
                     k4_launches_per_forward=L))
    out = {"phase": "state_sharing_rwkv6", "params": param_count(params),
           "init_s": init_s, "context": Sc, "skyline": sky,
           "no_state_vs_all_rel": rel_none,
           "gates": honest["gates"], "k4_launches": launches,
           "k4_device_ms_T2049": cases[0]["device_ms"],
           "k4_device_ms_T16": cases[1]["device_ms"],
           "k4_device_ms_T1": cases[2]["device_ms"],
           "state_bytes_per_row_fp32": sum(
               x[:, :1].numel() * 4 for x in states.values()),
           "tiny_fp32_card_vs_cpu": tiny,
           "seconds": time.perf_counter() - t_phase, "card": smi}
    emit(out)
    del params, sender, receiver, runs, states, shared, cache
    torch.cuda.empty_cache()
    return launches, cases


def phase_zamba2_state_sharing(dev, smi, flush, tok):
    """zamba2-2.7b as published (54 Mamba2 layers, d 2560, one shared
    attention block invoked 9 times, 32/32 heads of 80), bf16, random
    weights from seed 0 for both roles: the state-sharing gate and its
    planted faults (``zamba2_fault_gates``), then 4 requests of a
    257-token context and 8 new tokens, kvcomm calibrated on one sample
    (ratio 0.5, alpha 0.7), through in-memory, Serialized int8, a
    PageStore(page_len=16) and bf16 remote / Serialized; K1 launched 9
    times per decode step."""
    import numpy as np
    import torch
    from repro_torch.comm import (Agent, CommSession, InMemoryTransport,
                                  RemoteTransport, SerializedTransport)
    from repro_torch.comm.transport import payload_bytes
    from repro_torch.configs.registry import get_config
    from repro_torch.core import protocol
    from repro_torch.core.channel import kv_wire_bytes_paged
    from repro_torch.core.types import KVCommConfig
    from repro_torch.kernels.ragged_decode import ragged_decode
    from repro_torch.models import ssm
    from repro_torch.models import transformer as tfm
    from repro_torch.store import PageStore
    t_phase = time.perf_counter()
    tiny = ssm_tiny_parity(dev, "zamba2-2.7b")
    cfg = get_config("zamba2-2.7b")
    t0 = time.perf_counter()
    params = tfm.init_params(cfg, 0, device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    L_attn, B, C, Q, N = cfg.attn_layer_count, 4, 256, 16, 8
    rng = np.random.default_rng(1)
    ctx = rng.integers(4, cfg.vocab_size, (B, C)).astype(np.int32)
    qry = rng.integers(4, cfg.vocab_size, (B, Q)).astype(np.int32)
    sender = Agent("sender", cfg, params, tok)
    receiver = Agent("receiver", cfg, params, tok)
    kvcfg = KVCommConfig(ratio=0.5, alpha=0.7)
    calib = CommSession(sender, receiver)
    ss_run(calib, ctx[:, :16], qry, KVCommConfig(ratio=0.5,
                                                 selector="prior_only"),
           2, "kernel")                        # warm-up, not counted
    t0 = time.perf_counter()
    scores = calib.calibrate(ctx[:1], qry[:1])
    calib_s = time.perf_counter() - t0

    # every layer's KV and every state shared equals the skyline under
    # every gate of ZAMBA2_GATES, and each planted fault of the hand-off is
    # refused at float32 and by a bf16 gate, each at twice its bound
    n_ssm = protocol._n_ssm(cfg)
    everything = lambda kv, states, _: protocol.pack_shared(  # noqa: E731
        KVCommConfig(), kv, torch.ones(L_attn, dtype=torch.bool), states,
        torch.ones(n_ssm, dtype=torch.bool))
    t0 = time.perf_counter()
    gates = zamba2_fault_gates(cfg, params, tok, ctx, qry, everything)
    honest = gates.pop("honest")
    check(honest["ok"], f"zamba2: all shared refused by "
          f"{honest['refused_by']}: {honest['gates']}")
    faults = {}
    for name, g in gates.items():
        over = {n: x / bound for n, (x, bound) in g["gates"].items()}
        bf16 = max(v for n, v in over.items() if n != "fp32_max_rel")
        check(over["fp32_max_rel"] >= 2 and bf16 >= 2,
              f"zamba2: fault {name} under twice the float32 bound or "
              f"every bf16 gate's: {g['gates']}")
        faults[name] = {"gates": g["gates"], "refused_by": g["refused_by"],
                        "fp32_over_bound": over["fp32_max_rel"],
                        "bf16_over_bound": bf16}
    emit({"phase": "state_sharing_zamba2_faults", "honest": honest["gates"],
          "faults": faults, "seconds": time.perf_counter() - t0,
          "card": smi})
    kv, states, Sc = sender.export_kv(ctx)

    # the main path: K1's counter at 0, then every transport's round on
    # the kernel backend
    torch.cuda.synchronize()
    ragged_decode.launches = 0
    runs = {}
    for name, tr in (
            ("inmemory", InMemoryTransport()),
            ("serialized_int8", SerializedTransport("int8")),
            ("paged_inmemory", InMemoryTransport(
                store=PageStore(page_len=16))),
            ("remote_bf16_stream", RemoteTransport("bfloat16")),
            ("serialized_bf16", SerializedTransport("bfloat16"))):
        sess = CommSession(sender, receiver, tr)
        l0 = ragged_decode.launches
        shared, select, toks, share_s, gen_s = ss_run(
            sess, ctx, qry, kvcfg, N, "kernel", scores=scores)
        check(ragged_decode.launches - l0 == L_attn * N,
              f"zamba2 {name}: {ragged_decode.launches - l0} K1 launches "
              f"for {N} steps of {L_attn} attention invocations")
        ss, M = shared.state_select, int(select.sum())
        want = {
            "inmemory": payload_bytes(kv, select, states, ss),
            "serialized_int8": payload_bytes(kv, select, itemsize=1)
            + 2 * 4 * M + state_wire_bytes(states, ss, "int8"),
            "paged_inmemory": kv_wire_bytes_paged(
                cfg, B, Sc, M, page_len=16, itemsize=2)
            + payload_bytes(None, None, states, ss),
        }.get(name, payload_bytes(kv, select, itemsize=2)
              + state_wire_bytes(states, ss, "bfloat16"))
        check(tr.last.n_bytes == want, f"zamba2 {name}: {tr.last.n_bytes} "
              f"bytes, analytic {want}")
        state_b = (payload_bytes(None, None, states, ss)
                   if "inmemory" in name else state_wire_bytes(
                       states, ss, "int8" if "int8" in name else "bfloat16"))
        runs[name] = (tr, toks, share_s, gen_s, M, int(ss.sum()), shared,
                      state_b)
    launches = ragged_decode.launches
    check(torch.equal(runs["paged_inmemory"][1], runs["inmemory"][1]),
          "zamba2: paged tokens differ from unpaged")
    check(torch.equal(runs["remote_bf16_stream"][1],
                      runs["serialized_bf16"][1]),
          "zamba2: remote bf16 tokens differ from Serialized bf16")

    # K1 against the plain backend, teacher-forced on the plain tokens
    shared = runs["inmemory"][6]
    ref_toks, ref_logits = greedy(receiver, qry, shared, N, "reference")
    _, k_logits = greedy(receiver, qry, shared, N, "kernel", force=ref_toks)
    step_rel, step_agree = rel_and_agree(torch.stack(k_logits),
                                         torch.stack(ref_logits))
    check(step_rel <= STEP_BOUND, f"zamba2: kernel vs reference decode "
          f"rel {step_rel} (argmax agreement {step_agree})")

    # each stage alone, and the Mamba2 scan of one layer
    cache = receiver.prefill(qry, shared, max_new=N).cache
    tok1 = torch.zeros((B, 1), dtype=torch.long, device=dev)
    layer = next(lp for lp in params["layers"] if "mamba" in lp)["mamba"]
    x = torch.randn(B, Sc, cfg.d_model, device=dev, dtype=torch.bfloat16)
    st = {k: v[0] for k, v in states.items()}
    stages = {
        "sender_prefill_ms": wall_ms(lambda: sender.export_kv(ctx)),
        "receiver_prefill_ms": wall_ms(
            lambda: receiver.prefill(qry, shared, max_new=N)),
        "decode_step_ms": wall_ms(lambda: receiver.decode_step(
            tok1, clone_cache(cache), shared, backend="kernel")),
        "mamba_scan_ms_per_layer_S257": wall_ms(
            lambda: ssm.apply_mamba(layer, cfg, x, st)),
        "mamba_scan_ms_per_layer_S1": wall_ms(
            lambda: ssm.apply_mamba(layer, cfg, x[:, :1], st)),
    }
    ragged_decode.launches = launches
    for name, (tr, toks, share_s, gen_s, M, m, _, sb) in runs.items():
        emit(ss_line("zamba2-2.7b", name, tr, sb, B, N, share_s, gen_s,
                     stages, smi, kv_layers_selected=M, states_selected=m,
                     k1_launches_per_step=L_attn))
    out = {"phase": "state_sharing_zamba2", "params": param_count(params),
           "init_s": init_s, "calibrate_s": calib_s, "context": Sc,
           "selected_layers": protocol.selected_layer_ids(
               runs["inmemory"][6].select),
           "skyline": honest["readings"], "gates": honest["gates"],
           "kernel_vs_reference_rel": step_rel,
           "kernel_vs_reference_argmax_agree": step_agree,
           "step_bound": STEP_BOUND, "k1_launches": launches,
           "state_bytes_per_row_fp32": sum(
               x[:, :1].numel() * 4 for x in states.values()),
           "tiny_fp32_card_vs_cpu": tiny,
           "seconds": time.perf_counter() - t_phase, "card": smi}
    emit(out)
    steps = N * len(runs)
    del params, sender, receiver, runs, states, shared, cache, kv, x
    torch.cuda.empty_cache()
    return launches, steps


# ---------------------------------------------------------------------------
# decoder_archs: the decoder-only attention configs at published widths,
# one model resident at a time (random weights from seed 0 shared by sender
# and receiver), each through calibration, a share, the receiver prefill
# and the scheduler on K1
# ---------------------------------------------------------------------------
# K1 launches per decode step: one per full-attention layer (windowed
# layers decode masked-dense, as in the reference); mixtral and qwen1.5 at
# their cut depth
ARCH_K1_PER_STEP = {"gemma3-4b": 5, "olmoe-1b-7b": 16, "starcoder2-7b": 32,
                    "pixtral-12b": 40, "internlm2-20b": 48,
                    "qwen1.5-110b": 4, "mixtral-8x22b": 0,
                    "whisper-medium": 24}
# published widths, depth cut to fit one 80 GB card at bf16 (mixtral ~141 B
# and qwen1.5 ~111 B parameters in full)
ARCH_DEPTH = {"mixtral-8x22b": 4, "qwen1.5-110b": 4}
# K1 at the served geometries of these models: (name, dtype, B, Skv,
# prefix bucket, Hq, Hkv, D). bf16 at the stream's table: 2,049-position
# contexts in a 2,064 bucket (1,025 in 1,040), then the 16-position query
# and 8 new tokens, every row 4 steps in (served_case); the G 8 yardstick
# is starcoder2's rows with 32 query heads, G 9's 16-row tile beside it.
# float32 at a small size with random lengths and a dead row.
ARCH_K1_CASES = [
    ("gemma3_global_g2_d256", "bfloat16", 4, 2088, 2064, 8, 4, 256),
    ("olmoe_mha_d128", "bfloat16", 4, 2088, 2064, 16, 16, 128),
    ("starcoder2_g9", "bfloat16", 4, 1064, 1040, 36, 4, 128),
    ("g8_yardstick_for_g9", "bfloat16", 4, 1064, 1040, 32, 4, 128),
    ("pixtral_g4_d160", "bfloat16", 4, 1064, 1040, 32, 8, 160),
    ("internlm2_g6", "bfloat16", 4, 1064, 1040, 48, 8, 128),
    ("qwen1_5_g8", "bfloat16", 4, 1064, 1040, 64, 8, 128),
    ("gemma3_global_g2_d256_fp32", "float32", 2, 300, 256, 8, 4, 256),
    ("olmoe_mha_d128_fp32", "float32", 2, 300, 256, 16, 16, 128),
    ("starcoder2_g9_fp32", "float32", 2, 300, 256, 36, 4, 128),
    ("pixtral_g4_d160_fp32", "float32", 2, 300, 256, 32, 8, 160),
    ("internlm2_g6_fp32", "float32", 2, 300, 256, 48, 8, 128),
    ("qwen1_5_g8_fp32", "float32", 2, 300, 256, 64, 8, 128),
    # whisper-medium's decoder self-attention: MHA at D 64 over its
    # packed selected layer (384 context positions, no bucket: the audio
    # model is served by decode_step, not the slot table) and the
    # 16-position query with 8 decode steps
    ("whisper_mha_d64", "bfloat16", 4, 408, 384, 16, 16, 64),
    ("whisper_mha_d64_fp32", "float32", 2, 300, 256, 16, 16, 64),
]
ARCH_B, ARCH_Q, ARCH_NEW = 4, 16, 8
# cases whose prefix is not bucketed (whisper's decode_step cache)
ARCH_K1_UNBUCKETED = {"whisper_mha_d64"}


def served_case(dev, dtype, B, Skv, P, Hq, Hkv, D, seed, n_dead=0, pad=15):
    """K1's inputs at a served slot table: every row's real prefix fills
    the bucket to P - pad (a context bucketed by 16; pad 0 for whisper's
    unbucketed cache) and its self region is the 16-position query and 4
    decode steps. Only the q draw depends on Hq (a G 8 and a G 9 case of
    one Skv read the same rows)."""
    import torch
    g = torch.Generator().manual_seed(seed)
    k = torch.randn(B, Skv, Hkv, D, generator=g).to(dev, dtype)
    v = torch.randn(B, Skv, Hkv, D, generator=g).to(dev, dtype)
    q = torch.randn(B, Hq, D, generator=g).to(dev, dtype)
    full = lambda n: torch.full((B,), n, dtype=torch.int32,   # noqa: E731
                                device=dev)
    kv_len, pfx = full(P + ARCH_Q + 4), full(P - pad)
    return q, k, v, kv_len, pfx


def arch_model(dev, name):
    """The config (depth cut where ARCH_DEPTH says) and its random bf16
    parameters from seed 0 on the card."""
    import dataclasses
    import torch
    from repro_torch.configs.registry import get_config
    from repro_torch.models import transformer as tfm
    cfg = get_config(name)
    if name in ARCH_DEPTH:
        cfg = dataclasses.replace(cfg, num_layers=ARCH_DEPTH[name])
    n_full = sum(1 for s in tfm.layer_specs(cfg) if s.window is None)
    check(n_full == ARCH_K1_PER_STEP[name],
          f"{name}: {n_full} full-attention layers, expected "
          f"{ARCH_K1_PER_STEP[name]}")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params = tfm.init_params(cfg, 0, device=dev)
    torch.cuda.synchronize()
    return cfg, params, time.perf_counter() - t0


def arch_stream(sess, cfg, ctx, qry, transports):
    """The calibrated session's requests (one per row of ctx / qry, 8 new
    tokens each) served at capacity 4 on K1 through each transport; every
    ragged step launches K1 once per full-attention layer."""
    import numpy as np
    import torch
    from repro_torch.kernels.ragged_decode import ragged_decode
    from repro_torch.serving.scheduler import (Request, Scheduler,
                                               SchedulerConfig)
    reqs = [Request(rid=i, context=ctx[i], query=qry[i], max_new=ARCH_NEW)
            for i in range(len(ctx))]
    per_step = ARCH_K1_PER_STEP[cfg.name]
    rows, launches, steps = {}, 0, 0
    for name, tr in transports:
        sess.transport = tr
        sched = Scheduler(sess, arch_kvcfg(), calib_key="arch",
                          config=SchedulerConfig(capacity=4,
                                                 decode_backend="kernel"))
        torch.cuda.synchronize()
        l0 = ragged_decode.launches
        t0 = time.perf_counter()
        comps, stats = sched.run(reqs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        n = ragged_decode.launches - l0
        check(stats["steps"] > 0 and n == per_step * stats["steps"],
              f"{cfg.name} {name}: {n} K1 launches for {stats['steps']} "
              f"steps of {per_step} full-attention layers")
        check(len(comps) == len(reqs) and all(
            len(c.tokens) == ARCH_NEW for c in comps),
            f"{cfg.name} {name}: incomplete completions")
        launches += n
        steps += stats["steps"]
        rows[name] = {
            "tokens": stats["tokens"], "steps": stats["steps"],
            "k1_launches": n, "k1_launches_per_step": per_step,
            "tokens_per_s": stats["tokens"] / wall,
            "ttft_p50_ms": float(np.median([c.ttft_s for c in comps])) * 1e3,
            "bytes_moved": tr.total_bytes,
            "selected_layers": list(sched.layers)}
    return rows, launches, steps


def arch_kvcfg():
    from repro_torch.core.types import KVCommConfig
    return KVCommConfig(ratio=0.5, alpha=0.7)


def arch_ring_vs_full(cfg, params, ids, n_steps):
    """The plain cached path (no prefix) over ids[:, :S] then n_steps
    tokens of ids one at a time, with the full cache and with the ring
    (cfg.ring_cache): (max |ring - full| / max |full| over the steps'
    last-position logits, each layer's ring buffer length)."""
    import dataclasses
    import torch
    from repro_torch.models import transformer as tfm
    B, S = ids.shape[0], ids.shape[1] - n_steps
    out = {}
    for ring in (False, True):
        c = dataclasses.replace(cfg, ring_cache=ring)
        cache = tfm.init_cache(c, B, S + n_steps, device=ids.device)
        o = tfm.apply_model(params, c, ids[:, :S], mode="cached",
                            cache=cache, logits_mode="last")
        lg = [o.logits[:, -1].float()]
        for i in range(n_steps):
            o = tfm.apply_model(params, c, ids[:, S + i:S + i + 1],
                                mode="cached", cache=o.cache)
            lg.append(o.logits[:, -1].float())
        out[ring] = (torch.stack(lg), [e["k"].shape[1]
                                       for e in cache["layers"]])
        del cache, o
    rel, _ = rel_and_agree(out[True][0], out[False][0])
    return rel, out[True][1]


def gemma3_gates(dev, cfg, params, tok, ctx, qry):
    """float32 (the weights upcast, TF32 off): every layer shared equals
    the skyline over [C; Q] within FP32_FULL_BOUND (the local windows see
    only the prefix's tail); the ring cache equals the full cache over a
    1,100-token prefill and 8 steps past the 1,024 window; the chunked
    core (query blocks of 256) equals the plain one on a 2,048-token
    prefill over a shared 257-position prefix, logits and Eq. (1)
    masses within 1e-4."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch.comm import Agent
    from repro_torch.core import protocol
    from repro_torch.core.types import KVCommConfig
    from repro_torch.models import transformer as tfm
    L = cfg.attn_layer_count
    everything = lambda kv, states, _: protocol.pack_shared(  # noqa: E731
        KVCommConfig(), kv, torch.ones(L, dtype=torch.bool))
    sky = skyline_gate(cfg, params, tok, ctx[:1], qry[:1], everything)
    check(sky["fp32"][0] <= FP32_FULL_BOUND,
          f"gemma3: float32 all shared vs skyline {sky['fp32']}")
    c32 = dataclasses.replace(cfg, dtype="float32")
    p32 = to_device(params, torch.float32)
    rng = np.random.default_rng(7)
    ids = torch.as_tensor(rng.integers(4, cfg.vocab_size, (1, 1108)),
                          device=dev)
    ring_rel, bufs = arch_ring_vs_full(c32, p32, ids, 8)
    check(ring_rel <= FP32_FULL_BOUND,
          f"gemma3: ring vs full cache rel {ring_rel}")
    local = [b for b, s in zip(bufs, tfm.layer_specs(cfg)) if s.window]
    check(set(local) == {cfg.local_window} and max(bufs) == 1108,
          f"gemma3: ring buffers {sorted(set(bufs))}")
    agent = Agent("receiver", c32, p32, tok)
    kv, _, _ = agent.export_kv(ctx[:1, :256])
    shared = everything(kv, None, None)
    q = agent.tokens(rng.integers(4, cfg.vocab_size, (1, 2048)))
    res = {}
    for impl in ("xla", "chunked"):
        out = protocol.receiver_prefill(
            p32, dataclasses.replace(c32, attn_impl=impl), q, shared,
            max_new=0, collect_mass=True)
        res[impl] = (out.logits, out.masses.float())
        del out
    chunk_rel, _ = rel_and_agree(res["chunked"][0], res["xla"][0])
    mass_rel = float((res["chunked"][1] - res["xla"][1]).abs().max()
                     / res["xla"][1].abs().max())
    check(chunk_rel <= 1e-4 and mass_rel <= 1e-4,
          f"gemma3: chunked vs xla logits {chunk_rel}, masses {mass_rel}")
    del p32, agent, kv, shared, res
    torch.cuda.empty_cache()
    return {"skyline": sky, "fp32_bound": FP32_FULL_BOUND,
            "ring_vs_full_rel_fp32": ring_rel,
            "ring_buffer_positions": sorted(set(bufs)),
            "chunked_vs_xla_logits_rel": chunk_rel,
            "chunked_vs_xla_mass_rel": mass_rel, "chunked_bound": 1e-4}


def olmoe_gates(dev, cfg, params, tok, ctx, qry):
    """The float32 skyline (dense_all); dropping against the dense_all
    loop over experts (``apply_moe_dense_all``) on one layer's experts at
    capacity E / k (nothing drops): float32 within 1e-4 and bf16 within
    MOE_DROP_BF16_BOUND of the largest value; the grouped path (K5, which
    the bf16 dense_all call takes on the card) against the same loop at
    bf16 within the same bound; the drop count at the default 1.25; the
    loop's, K5's and dropping's MoE layer ms at the stream's prefill
    (4 x 2,049 tokens) and decode (4 x 1)."""
    import dataclasses
    import torch
    from repro_torch.core import protocol
    from repro_torch.core.types import KVCommConfig
    from repro_torch.models import layers
    L = cfg.attn_layer_count
    everything = lambda kv, states, _: protocol.pack_shared(  # noqa: E731
        KVCommConfig(), kv, torch.ones(L, dtype=torch.bool))
    sky = skyline_gate(cfg, params, tok, ctx[:1], qry[:1], everything)
    check(sky["fp32"][0] <= FP32_FULL_BOUND,
          f"olmoe: float32 all shared vs skyline {sky['fp32']}")
    E, k = cfg.num_experts, cfg.num_experts_per_tok
    full = dataclasses.replace(cfg, moe_impl="dropping",
                               moe_capacity_factor=E / k)
    drop = dataclasses.replace(cfg, moe_impl="dropping")
    p = params["layers"][0]["moe"]
    g = torch.Generator(device=dev).manual_seed(3)
    x = torch.randn((ARCH_B, ctx.shape[1] + 1, cfg.d_model), generator=g,
                    device=dev).to(torch.bfloat16)
    rels = {}
    for dt in (torch.float32, torch.bfloat16):
        pd = {n: (w if n == "router" else w.to(dt)) for n, w in p.items()}
        xd = x.to(dt)
        check(layers.moe_dropped(pd, xd, full) == 0,
              f"olmoe: capacity E/k drops at {dt}")
        want, _ = layers.apply_moe_dense_all(pd, xd, k)
        got, _ = layers.apply_moe(pd, xd, full)
        rels[str(dt).replace("torch.", "")], _ = rel_and_agree(got, want)
        if dt == torch.bfloat16:
            check(layers.moe_on_kernel(pd, xd, cfg),
                  "olmoe: the bf16 dense_all call does not take K5")
            grouped, _ = layers.apply_moe(pd, xd, cfg)
            grouped_rel, _ = rel_and_agree(grouped, want)
            del grouped
        del pd, xd, want, got
    check(rels["float32"] <= 1e-4
          and rels["bfloat16"] <= MOE_DROP_BF16_BOUND,
          f"olmoe: dropping at capacity E/k vs dense_all {rels}")
    check(grouped_rel <= MOE_DROP_BF16_BOUND,
          f"olmoe: K5 vs the dense_all loop at bf16 {grouped_rel}")
    dropped = layers.moe_dropped(p, x, drop)
    loop = lambda p, x, c: layers.apply_moe_dense_all(  # noqa: E731
        p, x, c.num_experts_per_tok)
    ms = {}
    for impl, fn, c in (("dense_all", loop, cfg),
                        ("grouped", layers.apply_moe, cfg),
                        ("dropping", layers.apply_moe, drop)):
        ms[f"moe_{impl}_prefill_ms"] = wall_ms(lambda: fn(p, x, c))
        ms[f"moe_{impl}_decode_ms"] = wall_ms(lambda: fn(p, x[:, :1], c))
    del x
    torch.cuda.empty_cache()
    return {"skyline": sky, "fp32_bound": FP32_FULL_BOUND,
            "dropping_vs_dense_all_rel_at_capacity_E_over_k": rels,
            "grouped_vs_dense_all_rel_bf16": grouped_rel,
            "moe_bound": MOE_DROP_BF16_BOUND,
            "dropped_assignments_at_1_25": dropped,
            "assignments": ARCH_B * (ctx.shape[1] + 1) * k, **ms}


def pixtral_gates(dev, cfg, params, tok, ctx, qry):
    """One forward with 256 seeded patch embeddings in the first 256
    positions beside the text-only one: finite logits of the same shape,
    moved by the patches at every position (causal attention carries
    them forward)."""
    import torch
    from repro_torch.models import transformer as tfm
    ids = torch.as_tensor(ctx[:1, :512], dtype=torch.long, device=dev)
    g = torch.Generator(device=dev).manual_seed(4)
    pe = torch.randn((1, cfg.num_patches, cfg.d_model), generator=g,
                     device=dev).to(torch.bfloat16)
    text = tfm.apply_model(params, cfg, ids).logits
    img = tfm.apply_model(params, cfg, ids, extra={"patches": pe}).logits
    check(img.shape == text.shape == (1, 512, cfg.vocab_size)
          and bool(torch.isfinite(img).all()),
          "pixtral: bad logits with patches")
    moved = (img - text).abs().amax(-1)[0]
    check(bool((moved > 0).all()), "pixtral: patches left a position "
          "unchanged")
    return {"patches": cfg.num_patches,
            "patch_vs_text_rel": rel_and_agree(img, text)[0],
            "last_position_moved": float(moved[-1])}


def mixtral_gates(dev, cfg, params, tok, ctx, qry):
    """The 4,096 window bites: one 4,100-token context at B 1 on the plain
    cached path, 8 decode steps, the ring cache against the full cache at
    bf16 within the full-width step rule."""
    import numpy as np
    import torch
    rng = np.random.default_rng(8)
    ids = torch.as_tensor(rng.integers(4, cfg.vocab_size, (1, 4108)),
                          device=dev)
    rel, bufs = arch_ring_vs_full(cfg, params, ids, 8)
    check(rel <= STEP_BOUND and set(bufs) == {cfg.sliding_window},
          f"mixtral: ring vs full cache rel {rel}, buffers {set(bufs)}")
    return {"ring_vs_full_rel_bf16": rel, "step_bound": STEP_BOUND,
            "ring_buffer_positions": sorted(set(bufs)),
            "ring_context": 4100}


# model, context tokens per request (before BOS), transports, extra gates
ARCH_PLAN = [
    ("gemma3-4b", 2048, ("inmemory", "serialized_int8"), gemma3_gates),
    ("olmoe-1b-7b", 2048, ("inmemory", "serialized_int8"), olmoe_gates),
    ("starcoder2-7b", 1024, ("inmemory",), None),
    ("pixtral-12b", 1024, ("inmemory",), pixtral_gates),
    ("internlm2-20b", 1024, ("inmemory",), None),
    ("mixtral-8x22b", 1024, ("inmemory",), mixtral_gates),
    ("qwen1.5-110b", 1024, ("inmemory",), None),
]


def k1_vs_plain_steps(agent, qry, shared):
    """ARCH_NEW greedy steps of ``agent`` on K1, teacher-forced on the
    plain backend's tokens: (rel, argmax agreement over every step, each
    step's rel); TF32 off."""
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    ref_toks, ref_logits = greedy(agent, qry, shared, ARCH_NEW, "reference")
    _, k_logits = greedy(agent, qry, shared, ARCH_NEW, "kernel",
                         force=ref_toks)
    rel, agree = rel_and_agree(torch.stack(k_logits), torch.stack(ref_logits))
    return rel, agree, [rel_and_agree(a, b)[0]
                        for a, b in zip(k_logits, ref_logits)]


def arch_run(dev, smi, tok, name, C, transports, gates):
    """One model: calibration on one sample, the served stream(s) on K1,
    a share and 8 greedy steps on K1 teacher-forced against the plain
    backend (within STEP_BOUND; a MoE model's within FP32_FULL_BOUND on
    its weights upcast), stage times, the model's own gates. Returns (K1
    launches, steps, the emitted row)."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch.configs.registry import get_config
    from repro_torch.comm import (Agent, CommSession, InMemoryTransport,
                                  SerializedTransport)
    t0 = time.perf_counter()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    cfg, params, init_s = arch_model(dev, name)
    rng = np.random.default_rng(11)
    ctx = rng.integers(4, cfg.vocab_size, (ARCH_B, C)).astype(np.int32)
    qry = rng.integers(4, cfg.vocab_size, (ARCH_B, ARCH_Q)).astype(np.int32)
    sender = Agent("sender", cfg, params, tok)
    receiver = Agent("receiver", cfg, params, tok)
    sess = CommSession(sender, receiver)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    sess.calibrate(ctx[:1], qry[:1], key="arch")
    torch.cuda.synchronize()
    calib_s = time.perf_counter() - t1
    make = {"inmemory": InMemoryTransport,
            "serialized_int8": lambda: SerializedTransport("int8")}
    rows, launches, steps = arch_stream(
        sess, cfg, ctx, qry, [(n, make[n]()) for n in transports])
    sess.transport = InMemoryTransport()
    shared, select = sess.share(ctx, arch_kvcfg(), key="arch")
    steps_bf16 = k1_vs_plain_steps(receiver, qry, shared)
    if cfg.num_experts and ARCH_K1_PER_STEP[name]:
        # top-k routing is discontinuous: K1's float32 softmax against
        # the plain path's bf16 probabilities flips near-tied experts and
        # the rows part, so the gate runs on the weights upcast (ungated
        # at bf16, reported)
        steps_fp32 = k1_vs_plain_steps(Agent(
            "receiver", dataclasses.replace(cfg, dtype="float32"),
            to_device(params, torch.float32), tok), qry, shared)
        step_rel, step_agree, bound = (*steps_fp32[:2], FP32_FULL_BOUND)
    else:
        steps_fp32 = None
        step_rel, step_agree, bound = (*steps_bf16[:2], STEP_BOUND)
    check(step_rel <= bound, f"{name}: kernel vs reference decode rel "
          f"{step_rel} > {bound} (argmax agreement {step_agree})")
    stages = {
        "sender_prefill_ms": wall_ms(lambda: sender.export_kv(ctx)),
        "receiver_prefill_ms": wall_ms(
            lambda: receiver.prefill(qry, shared, max_new=ARCH_NEW))}
    extra = gates(dev, cfg, params, tok, ctx, qry) if gates else {}
    torch.cuda.synchronize()
    row = {"phase": "decoder_archs", "model": name,
           "layers": cfg.num_layers, "params": param_count(params),
           "reduced": ({"num_layers": ARCH_DEPTH[name],
                        "published_layers": get_config(name).num_layers}
                       if name in ARCH_DEPTH else None),
           "requests": ARCH_B, "context": C + 1, "query": ARCH_Q,
           "new_tokens": ARCH_NEW, "init_s": init_s, "calibrate_s": calib_s,
           "selected_layers": [int(i) for i in
                               np.flatnonzero(select.cpu().numpy())],
           "streams": rows, **stages,
           "kernel_vs_reference_rel": step_rel,
           "kernel_vs_reference_argmax_agree": step_agree,
           "kernel_vs_reference_bound": bound,
           "kernel_vs_reference_bf16": steps_bf16,
           "kernel_vs_reference_fp32": steps_fp32, **extra,
           "peak_mem_gb": torch.cuda.max_memory_allocated(dev) / 1e9,
           "seconds": time.perf_counter() - t0, "card": smi}
    emit(row)
    return launches, steps, row


# whisper-medium: a 384-token context, a 16-token query and 8 new tokens
# (408 of its 448 text positions, arXiv:2212.04356), frames of its 1,500
# encoder positions
WHISPER_C = 384


def whisper_greedy(params, cfg, qry, shared, frames, n, backend, force=None):
    """``greedy`` for whisper: the prefill reads the frames (each layer
    keeps its cross KV), the n - 1 decode steps reuse it."""
    import torch
    from repro_torch.core import protocol
    out = protocol.receiver_prefill(params, cfg, qry, shared, max_new=n,
                                    extra={"frames": frames})
    cache, lg = out.cache, out.logits[:, -1].float()
    toks, logits = [], []
    for i in range(n):
        tok = lg.argmax(-1)
        toks.append(tok.cpu())
        logits.append(lg.cpu())
        if i + 1 < n:
            feed = tok if force is None else force[:, i].to(tok.device)
            _, lg, cache = protocol.decode_step(params, cfg, feed[:, None],
                                                cache, shared,
                                                backend=backend)
            lg = lg.float()
    return torch.stack(toks, 1), logits


def whisper_run(dev, smi, tok):
    """whisper-medium as published (bf16, seed 0 for both roles, seeded
    frames): sender_prefill over the frames, calibrate on one sample,
    kvcomm 0.5 / 0.7, then per transport (in memory, Serialized int8) the
    share, the receiver prefill and 7 decode steps with K1 exactly 24
    times a step (every decoder layer; cross-attention stays on the plain
    core), bytes at the analytic count of the self-attention KV; 8 steps
    on K1 teacher-forced against the plain backend within STEP_BOUND; the
    scheduler refusing the model; a float32 gate, every layer shared with
    the same frames on both sides against the train-mode forward over
    [C; Q] within FP32_FULL_BOUND. Returns (K1 launches, steps, row)."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch.comm import (Agent, CommSession, InMemoryTransport,
                                  SerializedTransport)
    from repro_torch.configs.registry import get_config
    from repro_torch.core import protocol
    from repro_torch.core.channel import kv_wire_bytes
    from repro_torch.core.types import KVCommConfig
    from repro_torch.kernels.ragged_decode import ragged_decode
    from repro_torch.models import transformer as tfm
    from repro_torch.serving.scheduler import Scheduler
    name = "whisper-medium"
    t0 = time.perf_counter()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    cfg = get_config(name)
    params = tfm.init_params(cfg, 0, device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = param_count(params)
    L, Hkv, Dh = cfg.attn_layer_count, cfg.num_kv_heads, cfg.resolved_head_dim
    B, C, Q, NEW = ARCH_B, WHISPER_C, ARCH_Q, ARCH_NEW
    rng = np.random.default_rng(12)
    ctx = torch.as_tensor(rng.integers(4, cfg.vocab_size, (B, C)),
                          device=dev)
    qry = torch.as_tensor(rng.integers(4, cfg.vocab_size, (B, Q)),
                          device=dev)
    g = torch.Generator(device=dev).manual_seed(5)
    frames = torch.randn((B, cfg.encoder_seq, cfg.d_model), generator=g,
                         device=dev).to(torch.bfloat16)
    extra = {"frames": frames}
    kv, _ = protocol.sender_prefill(params, cfg, ctx, extra=extra)
    check(set(kv) == {"k", "v"} and tuple(kv["k"].shape) == (L, B, C, Hkv,
                                                             Dh),
          f"whisper: sender KV {[tuple(x.shape) for x in kv.values()]}")
    scores = protocol.calibrate(params, cfg, qry[:1],
                                {p: x[:, :1] for p, x in kv.items()},
                                extra={"frames": frames[:1]})
    kvcfg = arch_kvcfg()
    select = protocol.make_selection(cfg, kvcfg, scores)
    M = int(select.sum())
    per_step = ARCH_K1_PER_STEP[name]
    streams, launches, steps = {}, 0, 0
    for tname, tr, isz, scales in (
            ("inmemory", InMemoryTransport(), 2, 0),
            ("serialized_int8", SerializedTransport("int8"), 1, 2 * 4 * M)):
        torch.cuda.synchronize()
        l0 = ragged_decode.launches
        t1 = time.perf_counter()
        shared = tr.send(cfg, kvcfg, kv, select)
        toks, _ = whisper_greedy(params, cfg, qry, shared, frames, NEW,
                                 "kernel")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t1
        n = ragged_decode.launches - l0
        check(n == per_step * (NEW - 1),
              f"whisper {tname}: {n} K1 launches for {NEW - 1} steps of "
              f"{per_step} layers")
        analytic = kv_wire_bytes(cfg, B, C, M, isz) + scales
        check(tr.total_bytes == analytic,
              f"whisper {tname}: {tr.total_bytes} B != {analytic}")
        launches += n
        steps += NEW - 1
        streams[tname] = {"bytes_moved": tr.total_bytes,
                          "bytes_analytic": analytic, "k1_launches": n,
                          "k1_launches_per_step": per_step,
                          "tokens": B * NEW, "tokens_per_s": B * NEW / wall,
                          "share_prefill_decode_s": wall}
    shared = InMemoryTransport().send(cfg, kvcfg, kv, select)
    torch.backends.cuda.matmul.allow_tf32 = False
    ref_toks, ref_logits = whisper_greedy(params, cfg, qry, shared, frames,
                                          NEW, "reference")
    _, k_logits = whisper_greedy(params, cfg, qry, shared, frames, NEW,
                                 "kernel", force=ref_toks)
    step_rel, step_agree = rel_and_agree(torch.stack(k_logits),
                                         torch.stack(ref_logits))
    check(step_rel <= STEP_BOUND, f"whisper: kernel vs reference decode rel "
          f"{step_rel} > {STEP_BOUND} (argmax agreement {step_agree})")
    stages = {
        "encoder_ms": wall_ms(lambda: tfm._encoder_forward(params, cfg,
                                                           frames)),
        "sender_prefill_ms": wall_ms(lambda: protocol.sender_prefill(
            params, cfg, ctx, extra=extra)),
        "receiver_prefill_ms": wall_ms(lambda: protocol.receiver_prefill(
            params, cfg, qry, shared, max_new=NEW, extra=extra))}
    sess = CommSession(Agent("sender", cfg, params, tok),
                       Agent("receiver", cfg, params, tok))
    refusal = None
    try:
        Scheduler(sess, kvcfg)
    except ValueError as e:
        refusal = str(e)
    check(refusal is not None, "whisper: the scheduler took an audio model")
    peak = torch.cuda.max_memory_allocated(dev) / 1e9
    # float32: every layer shared, the same frames both sides, = skyline
    c32 = dataclasses.replace(cfg, dtype="float32")
    p32 = to_device(params, torch.float32)
    x32 = {"frames": frames[:1].float()}
    kv32, _ = protocol.sender_prefill(p32, c32, ctx[:1], extra=x32)
    got = protocol.receiver_prefill(
        p32, c32, qry[:1], protocol.build_shared(
            KVCommConfig(), kv32, torch.ones(L, dtype=torch.bool)),
        max_new=0, extra=x32).logits
    with torch.no_grad():
        sky = tfm.apply_model(p32, c32, torch.cat([ctx[:1], qry[:1]], 1),
                              extra=x32).logits[:, C:]
    sky_rel, sky_agree = rel_and_agree(got, sky)
    check(sky_rel <= FP32_FULL_BOUND,
          f"whisper: float32 all shared vs skyline {sky_rel}")
    del p32, kv32, got, sky, kv, shared, params, frames
    torch.cuda.empty_cache()
    row = {"phase": "decoder_archs", "model": name,
           "layers": cfg.num_layers, "encoder_layers": cfg.encoder_layers,
           "encoder_seq": cfg.encoder_seq,
           "params": n_params, "reduced": None, "requests": B,
           "context": C,
           "query": Q, "new_tokens": NEW, "init_s": init_s,
           "selected_layers": [int(i) for i in
                               np.flatnonzero(select.cpu().numpy())],
           "streams": streams, **stages,
           "kernel_vs_reference_rel": step_rel,
           "kernel_vs_reference_argmax_agree": step_agree,
           "kernel_vs_reference_bound": STEP_BOUND,
           "scheduler_refusal": refusal,
           "skyline_fp32": [sky_rel, sky_agree],
           "fp32_bound": FP32_FULL_BOUND, "peak_mem_gb": peak,
           "seconds": time.perf_counter() - t0, "card": smi}
    emit(row)
    return launches, steps, row


def phase_decoder_archs(dev, smi, flush, tok):
    """K1 against its plain version at the new geometries, then every
    model of ARCH_PLAN in turn (each freed before the next). Returns (K1
    launches on the served streams, their steps, the K1 cases)."""
    import gc
    import torch
    t_phase = time.perf_counter()
    cases = []
    for cname, dt, B, S, P, Hq, Hkv, D in ARCH_K1_CASES:
        # the seed follows the rows' geometry, not Hq: the G 8 yardstick
        # reads starcoder2's rows
        args = (dev, getattr(torch, dt), B, S, P, Hq, Hkv, D, S + Hkv + D)
        if dt != "bfloat16":
            q, k, v, kl, pf = random_case(*args, n_dead=1)
        else:
            q, k, v, kl, pf = served_case(
                *args, pad=0 if cname in ARCH_K1_UNBUCKETED else 15)
        cases.append(compare_case(rd_case(cname, q, k, v, kl, pf, P),
                                  flush))
        emit({"phase": "decoder_archs_kernel_vs_plain", **cases[-1],
              "card": smi})
        del q, k, v
    launches, steps, per_model = 0, 0, {}
    for name, C, transports, gates in ARCH_PLAN:
        n, s, row = arch_run(dev, smi, tok, name, C, transports, gates)
        launches += n
        steps += s
        per_model[name] = n
        gc.collect()                   # the model's last references
        torch.cuda.empty_cache()
    n, s, _ = whisper_run(dev, smi, tok)
    launches += n
    steps += s
    per_model["whisper-medium"] = n
    gc.collect()
    torch.cuda.empty_cache()
    emit({"phase": "decoder_archs_checks", "k1_launches": launches,
          "k1_launches_by_model": per_model,
          "k1_launches_per_step": ARCH_K1_PER_STEP, "steps": steps,
          "seconds": time.perf_counter() - t_phase, "card": smi})
    return launches, steps, cases


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
            seed, partials=False):
    """A K3 case in the same form as ``fa_case``: the normalised decode, or
    with ``partials`` the float32 (o, m, l) the sharded decode combines (no
    single PyTorch call computes those: library null; every row attends
    something, so m holds no -1e30 that would swamp its rms)."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.kernels.flash_decode import (
        chunk_positions, decode_mask, decode_partial_reference, flash_decode,
        flash_decode_reference, uses_tma)
    g = torch.Generator().manual_seed(seed)
    q = torch.randn(B, Hq, D, generator=g).to(dev, dtype)
    k = torch.randn(B, S, Hkv, D, generator=g).to(dev, dtype)
    v = torch.randn(B, S, Hkv, D, generator=g).to(dev, dtype)
    lens = torch.as_tensor(kv_len, dtype=torch.int32).to(dev)
    allow = decode_mask(S, lens, window)
    n_att = int(allow.sum())
    isz = q.element_size()
    qs, kt, vt = q[:, :, None], k.transpose(1, 2), v.transpose(1, 2)
    if partials:
        check(bool((allow.sum(1) > 0).all()), f"{name}: a dead row")
        return {"name": name, "kernel": "flash_decode",
                "counter": flash_decode, "dtype": dtype,
                "tols": [(2e-5, 2e-5)] * 3,
                "run": lambda: ops.decode_attention_partials(
                    q, k, v, lens, window=window),
                "plain": lambda: decode_partial_reference(q, k, v, lens,
                                                          window=window),
                "library": None,
                # K/V rows once, q; float32 o (B, Hq, D), m and l (B, Hq)
                "nbytes": (2 * n_att * Hkv * D * isz + q.numel() * isz
                           + 4 * q.numel() + 8 * B * Hq + 4 * B),
                "flops": 4 * n_att * Hq * D, "plain_iters": 10,
                "shape": {"B": B, "S": S, "Hq": Hq, "Hkv": Hkv, "D": D,
                          "G": Hq // Hkv, "window": window,
                          "partials": True, "attended": n_att,
                          "route": "tma" if uses_tma(k, v) else "staged",
                          "chunk": chunk_positions(D, dtype)}}
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
                      "G": Hq // Hkv, "window": window, "partials": False,
                      "attended": n_att,
                      # how the kernel reads K/V: a TMA ring, or rows staged
                      # by plain loads where a tensor map cannot describe them
                      "route": "tma" if uses_tma(k, v) else "staged",
                      "chunk": chunk_positions(D, dtype)}}


def wkv_case(dev, name, B, T, H, hd, *, seed, plain_iters=2):
    """A K4 case; no single PyTorch call computes the scan (library null)."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.kernels.rwkv_scan import plan, wkv6, wkv6_reference
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
            "shape": {"B": B, "T": T, "H": H, "hd": hd,
                      # the wrapper's plan: which kernel, time segments
                      "plan": list(plan(B, T, H, hd, r.device))}}


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
    # F7: groups of more than 8 query heads per KV head: one 16-row tile
    # up to G 16 in bf16, head groups of at most 8 in float32 (G 9 -> 5 +
    # 4, G 16 -> 8 + 8), normalised and partials, with a window and
    # without, on the TMA ring and on staged rows (24-byte rows no tensor
    # map describes)
    wide_rng = np.random.default_rng(1)    # rng keeps the full cases' draws
    lens = lambda S, B: wide_rng.integers(1, S + 1, B)     # noqa: E731
    wide = [
        fd_case(dev, "fd_g9", bf16, 4, 4096, 36, 4, 128, lens(4096, 4),
                seed=14),
        fd_case(dev, "fd_g9_window_partials", bf16, 4, 4096, 36, 4, 128,
                lens(4096, 4), window=1024, seed=15, partials=True),
        fd_case(dev, "fd_g16_partials", bf16, 2, 3000, 32, 2, 64,
                lens(3000, 2), seed=16, partials=True),
        fd_case(dev, "fd_g16_window", bf16, 2, 3000, 32, 2, 64,
                lens(3000, 2), window=700, seed=17),
        fd_case(dev, "fd_g9_fp32_window", f32, 3, 2000, 18, 2, 128,
                [2000, 0, 1234], window=333, seed=18),
        fd_case(dev, "fd_g16_fp32_partials", f32, 2, 1500, 16, 1, 64,
                [1500, 701], seed=19, partials=True),
        fd_case(dev, "fd_g9_staged_rows", bf16, 3, 700, 18, 2, 12,
                [700, 0, 333], window=500, seed=20),
        fd_case(dev, "fd_g16_fp32_staged_partials", f32, 2, 500, 32, 2, 6,
                [500, 77], seed=21, partials=True),
    ]
    for case, route in zip(wide, ("tma",) * 6 + ("staged",) * 2):
        check(case["shape"]["route"] == route,
              f"{case['name']}: read by {case['shape']['route']}, "
              f"expected {route}")
    tiny += wide
    lc_lens = rng.integers(16384, 32769, 4)
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
        # the served sender prefills at the benchmark's longest contexts:
        # starcoder2-7b's G 9 (36 / 4 heads, each KV head's 9 rows packed
        # across the 64-row tiles) and internlm2-20b's G 6 (48 / 8)
        fa_case(dev, "starcoder2_sender_prefill_3968", bf16, 1, 3968, 0, 36,
                4, 128, seed=24),
        fa_case(dev, "internlm2_sender_prefill_2560", bf16, 1, 2560, 0, 48,
                8, 128, seed=25),
        # llama3.2-3b widths over a 32k cache, ragged lengths
        fd_case(dev, "long_cache_32k", bf16, 4, 32768, 24, 8, 128, lc_lens,
                seed=10),
        # starcoder2-7b's G 9 (36 / 4 heads of 128) over the same lengths:
        # one 16-row tile per KV head
        fd_case(dev, "long_cache_32k_g9", bf16, 4, 32768, 36, 4, 128,
                lc_lens, seed=22),
        # gemma3-4b local layer decode: window 1024 over an 8k cache
        fd_case(dev, "gemma3_window_decode", bf16, 4, 8192, 8, 4, 256,
                rng.integers(1024, 8193, 4), window=1024, seed=11),
        # rwkv6-1.6b: 32 heads of 64, 2,048 tokens
        wkv_case(dev, "rwkv6_1_6b_scan", 4, 2048, 32, 64, seed=12),
        # rwkv6-1.6b long_500k's single-row prefill, cut to 8,192 steps:
        # 32 heads fill a quarter of the SMs, so the plan cuts each head's
        # steps into time segments
        wkv_case(dev, "rwkv6_long_prefill_8192", 1, 8192, 32, 64, seed=23,
                 plain_iters=1),
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


MOE_CASES = [
    # mellum2-12b's expert layer: 64 experts of width 896 at d 2304, top 8;
    # a 4,096-position sender prefill's 32,768 assignments, and a 16-row
    # decode step's 128
    ("mellum2_prefill_4096x8", 4096),
    ("mellum2_decode_16", 16),
]
MOE_E, MOE_K, MOE_D, MOE_F = 64, 8, 2304, 896
MOE_TOLS = (2e-2, 2e-2)


def moe_case(dev, name, N, seed):
    """A K5 case in ``fa_case``'s form: routed tokens of mellum2-12b's
    expert layer (the router at the benchmark's scale, 2 / sqrt(d)), the
    kernel, its plain version (checked in float32 products), the dense_all
    loop it replaces (timed as "plain") and ``torch._grouped_mm`` over the
    same sorted rows as the yardstick; the bound counts the experts the
    routing touched, read once, and x and the output."""
    import math
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.moe_grouped import (
        block_m, grouped_experts, grouped_experts_reference)
    from repro_torch.models.layers import (combine_weights, expert_sum,
                                           router_probs)
    g = torch.Generator().manual_seed(seed)
    E, k, D, Fd = MOE_E, MOE_K, MOE_D, MOE_F
    p = {"router": (torch.randn(D, E, generator=g) * 2 / math.sqrt(D)).to(
        dev),
         "w_gate": (torch.randn(E, D, Fd, generator=g) / math.sqrt(D)).to(
             dev, torch.bfloat16),
         "w_up": (torch.randn(E, D, Fd, generator=g) / math.sqrt(D)).to(
             dev, torch.bfloat16),
         "w_down": (torch.randn(E, Fd, D, generator=g) / math.sqrt(Fd)).to(
             dev, torch.bfloat16)}
    x = torch.randn(N, D, generator=g).to(dev, torch.bfloat16)
    gates, idx, _ = router_probs(p, x, k)
    comb = combine_weights(gates, idx, p)
    touched = int((torch.bincount(idx.reshape(-1), minlength=E) > 0).sum())
    args = (x, p["w_gate"], p["w_up"], p["w_down"], gates, idx)

    def grouped_mm():
        order = torch.sort(idx.reshape(-1), stable=True).indices
        ends = torch.searchsorted(idx.reshape(-1)[order],
                                  torch.arange(E, device=dev), right=True)
        offs = ends.to(torch.int32)
        xs = x[order // k]
        h = F.silu(torch._grouped_mm(xs, p["w_gate"], offs=offs)) \
            * torch._grouped_mm(xs, p["w_up"], offs=offs)
        y = torch._grouped_mm(h, p["w_down"], offs=offs)
        out = torch.empty_like(y)
        out[order] = y * gates.reshape(-1)[order, None]
        return out.view(N, k, D).sum(1, dtype=torch.float32).to(x.dtype)

    library, library_error = None, None
    try:                     # the yardstick, where this PyTorch has it
        grouped_mm()
        library = grouped_mm
    except (AttributeError, RuntimeError) as e:
        library_error = str(e)[:200]
    return {"name": name, "kernel": "moe_grouped",
            "counter": grouped_experts, "dtype": torch.bfloat16,
            # h and each gated expert row are rounded to bf16 before the
            # final sum's rounding, in both versions: a one-ulp difference
            # in any of the three reaches the output, so two ulps
            "tols": [MOE_TOLS],
            "run": lambda: grouped_experts(*args),
            "plain": lambda: expert_sum(p, x, comb),
            "check_plain": lambda: grouped_experts_reference(
                *args, bm=block_m(N * k, E)),
            "library": library,
            "nbytes": touched * 3 * D * Fd * 2 + 2 * N * D * 2,
            "flops": 6 * N * k * D * Fd, "plain_iters": 3,
            "shape": {"N": N, "E": E, "k": k, "D": D, "F": Fd,
                      "assignments": N * k, "experts_touched": touched,
                      "block_m": block_m(N * k, E),
                      "library_error": library_error}}


def phase_moe_grouped(dev, flush, smi):
    """K5 at mellum2-12b's served shapes against its plain version and
    timed beside the dense_all loop and torch._grouped_mm; then K1 at G 8
    over mellum2-12b's full layers (32 / 4 heads of 128, 16 rows over a
    7,952-position prefix bucket)."""
    import torch
    from repro_torch.kernels.moe_grouped import grouped_experts
    results = []
    for i, (name, N) in enumerate(MOE_CASES):
        case = moe_case(dev, name, N, seed=40 + i)
        before = grouped_experts.launches
        case["run"]()
        torch.cuda.synchronize()
        made = grouped_experts.launches - before
        check(made == 2, f"{name}: {made} launches, expected 2")
        results.append(compare_case(case, flush))
        emit({"phase": "moe_grouped_kernel_vs_plain", "card": smi,
              **results[-1]})
    case = rd_case("mellum2_full_layer_g8", *served_case(
        dev, torch.bfloat16, 16, 8039, 7952, 32, 4, 128, seed=42),
        prefix_len=7952)
    results.append(compare_case(case, flush))
    emit({"phase": "mellum2_k1_g8", "card": smi, **results[-1]})
    return results


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
    want = {"flash_attention": 5, "flash_decode": 3, "wkv6": 2}
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


# ---------------------------------------------------------------------------
# training: autograd through the train-mode forward (the plain attention
# core, as the reference's train mode runs the XLA core: no kernel), AdamW
# with float32 moments, the quick-trained pair
# ---------------------------------------------------------------------------
TRAIN_PARITY_STEPS, TRAIN_FW_STEPS, QUICK_STEPS = 20, 4, 1200


def train_losses(cfg, params, batches, device):
    """The losses of one make_train_step step per batch from ``params`` on
    ``device`` (the parameters are updated in place)."""
    from repro_torch.training.optimizer import OptimizerConfig, init_opt_state
    from repro_torch.training.train_loop import (TrainState, make_train_step,
                                                 to_batch)
    step = make_train_step(cfg, OptimizerConfig(
        lr=2e-3, total_steps=len(batches), warmup_steps=2))
    state = TrainState(params, init_opt_state(params))
    out = []
    for b in batches:
        state, m = step(state, to_batch(b, device))
        out.append(float(m["loss"]))
    return out


def probe_params(params):
    """Copies of a few parameters, to show a step moved them."""
    return [params["final_norm"].clone(),
            params["layers"][0]["attn"]["wq"].clone(),
            params["layers"][-1]["ln2"].clone()]


def moved(before, params):
    import torch
    return any(not torch.equal(a, b)
               for a, b in zip(before, probe_params(params)))


def fw_train_steps(dev, cfg, batches):
    """make_train_step steps of ``cfg`` at its published width (bf16
    parameters, float32 moments) on the given host batches: each step's
    wall ms, the losses, tokens/s, peak GB; gated finite, moved, counted."""
    import numpy as np
    import torch
    from repro_torch.training.optimizer import OptimizerConfig, leaves
    from repro_torch.training.train_loop import (init_train_state,
                                                 make_train_step, to_batch)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    state = init_train_state(cfg, 0, device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = param_count(state.params)
    before = probe_params(state.params)
    step = make_train_step(cfg, OptimizerConfig(
        lr=3e-4, total_steps=len(batches), warmup_steps=1))
    ms, losses = [], []
    for b in batches:
        b = to_batch(b, dev)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        state, m = step(state, b)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t1) * 1e3)
        losses.append(float(m["loss"]))
    check(all(np.isfinite(losses)), f"{cfg.name}: losses {losses}")
    check(moved(before, state.params), f"{cfg.name}: parameters unchanged")
    check(state.opt.step == len(batches), f"{cfg.name}: opt.step "
          f"{state.opt.step}")
    check(all(x.dtype == torch.float32 for x in leaves(state.opt.m)),
          f"{cfg.name}: moments not float32")
    tokens = int(np.prod(batches[0]["tokens"].shape))
    steady = float(np.median(ms[1:] if len(ms) > 1 else ms))
    out = {"model": cfg.name, "params": n_params, "dtype": cfg.dtype,
           "batch": list(batches[0]["tokens"].shape), "steps": len(ms),
           "losses": losses, "step_ms": ms, "steady_step_ms": steady,
           "trained_tokens_per_s": tokens / steady * 1e3, "init_s": init_s,
           "peak_mem_gb": torch.cuda.max_memory_allocated(dev) / 1e9}
    del state, step, before
    return out


def phase_training(dev, smi, tok):
    """(1) The 8-layer float32 pair: TRAIN_PARITY_STEPS steps on the card
    against the same steps on the CPU, from the same weights and batches
    (TF32 off), losses within 1e-4 relative. (2) llama3.2-3b-pair at
    published width, bf16 parameters and float32 moments: 4 steps at B 4,
    S 128 on the byte corpus. (3) whisper-medium: one step at B 2 with
    seeded frames. (4) pairs._quick_train on the card (QUICK_STEPS steps,
    batch 64, the reference's recipe): the mean loss of the last 100 steps
    below the first 100's, then the retrieval task through the Scheduler
    on K1 at kvcomm 0.5 with the trained weights (token-identical to
    serve_serial on the plain backend, at float32) and with random ones;
    accuracy is recorded, not gated. Returns the K1 launches of the
    trained pair's scheduler run."""
    import gc
    import numpy as np
    import torch
    from repro_torch.comm import Agent, CommSession, InMemoryTransport
    from repro_torch.configs.registry import get_config
    from repro_torch.core.types import KVCommConfig
    from repro_torch.data.pipeline import (mixed_lm_iter,
                                           synthetic_byte_corpus,
                                           token_stream_iter)
    from repro_torch.data.synthetic import SyntheticTask, TaskConfig
    from repro_torch.kernels.ragged_decode import ragged_decode
    from repro_torch.launch import pairs
    from repro_torch.launch.serve import build_requests
    from repro_torch.models import transformer as tfm
    from repro_torch.serving.scheduler import (Scheduler, SchedulerConfig,
                                               accuracy, serve_serial)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()

    # (1) card against CPU
    pc, ptok = pairs.pair_config(), pairs.pair_tokenizer()
    it = mixed_lm_iter(pairs.task_suite(ptok), 16, seed=0)
    batches = [next(it) for _ in range(TRAIN_PARITY_STEPS)]
    cpu_params = tfm.init_params(pc, 0, device="cpu")
    card_params = to_device(tfm.init_params(pc, 0, device="cpu"), dev)
    t0 = time.perf_counter()
    cpu_losses = train_losses(pc, cpu_params, batches, "cpu")
    cpu_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    card_losses = train_losses(pc, card_params, batches, dev)
    card_s = time.perf_counter() - t0
    rel = max(abs(a - b) / abs(b) for a, b in zip(card_losses, cpu_losses))
    check(rel <= 1e-4, f"training: card vs CPU losses rel {rel}")
    check(card_losses[-1] < card_losses[0], "training: the tiny pair's "
          f"loss did not fall ({card_losses[0]} -> {card_losses[-1]})")
    emit({"phase": "training_card_vs_cpu", "model": "pair_config (8 "
          "layers, float32)", "steps": TRAIN_PARITY_STEPS, "batch": 16,
          "card_losses": card_losses, "cpu_losses": cpu_losses,
          "max_rel": rel, "bound": 1e-4, "card_s": card_s, "cpu_s": cpu_s,
          "card": smi})
    del cpu_params, card_params

    # (2) llama3.2-3b-pair at published width
    fw = pairs.full_width_config()
    corpus = synthetic_byte_corpus() % fw.vocab_size
    it = token_stream_iter(corpus, 4, 128)
    row = fw_train_steps(dev, fw, [next(it) for _ in range(TRAIN_FW_STEPS)])
    emit({"phase": "training_full_width", **row, "card": smi})
    gc.collect()
    torch.cuda.empty_cache()

    # (3) whisper-medium, one step with seeded frames
    wc = get_config("whisper-medium")
    b = next(token_stream_iter(synthetic_byte_corpus() % wc.vocab_size, 2,
                               64))
    b["frames"] = np.random.default_rng(6).standard_normal(
        (2, wc.encoder_seq, wc.d_model)).astype(np.float32)
    row = fw_train_steps(dev, wc, [b])
    emit({"phase": "training_whisper", **row, "card": smi})
    gc.collect()
    torch.cuda.empty_cache()

    # (4) the quick-trained pair
    losses = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    trained = pairs._quick_train(
        pc, ptok, steps=QUICK_STEPS, device=dev, log_every=1,
        log_fn=lambda line: losses.append(float(line.split()[3])),
        ckpt_dir=str(ROOT / "build" / "ckpt"))
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    first, last = float(np.mean(losses[:100])), float(np.mean(losses[-100:]))
    check(len(losses) == QUICK_STEPS and last < first,
          f"quick-train: loss {first} -> {last}")
    reqs = build_requests(ptok, "retrieval", 32, 4)
    kvcfg = KVCommConfig(ratio=0.5, alpha=0.7)
    calib = SyntheticTask(ptok, TaskConfig("retrieval", num_facts=6,
                                           seed=42)).batch(1)
    acc, k1 = {}, 0
    for label, p in (("trained", trained),
                     ("random", tfm.init_params(pc, 0, device=dev))):
        sess = CommSession(Agent("sender", pc, p, ptok),
                           Agent("receiver", pc, p, ptok),
                           InMemoryTransport())
        sess.calibrate(calib["context"], calib["query"], key="retrieval")
        l0 = ragged_decode.launches
        comps, stats = Scheduler(sess, kvcfg, calib_key="retrieval",
                                 config=SchedulerConfig(
                                     capacity=8, decode_backend="kernel")
                                 ).run(reqs)
        check(ragged_decode.launches - l0 == pc.num_layers * stats["steps"],
              f"quick-train {label}: K1 launches")
        acc[label] = accuracy(comps, reqs)
        if label == "trained":
            k1 = ragged_decode.launches - l0
            ser, _ = serve_serial(sess, reqs, kvcfg, calib_key="retrieval",
                                  backend="reference")
            same = all(list(a.tokens) == list(b.tokens)
                       for a, b in zip(ser, comps))
            check(same and len(ser) == len(comps), "quick-trained pair: "
                  "scheduler[kernel] differs from serve_serial[reference]")
    emit({"phase": "training_quick_trained_pair", "steps": QUICK_STEPS,
          "batch": 64, "train_s": train_s,
          "step_ms": train_s / QUICK_STEPS * 1e3,
          "loss_first_100": first, "loss_last_100": last,
          "requests": len(reqs), "accuracy_trained": acc["trained"],
          "accuracy_random": acc["random"],
          "scheduler_token_identical_to_serve_serial": True,
          "k1_launches": k1, "seconds": time.perf_counter() - t_phase,
          "card": smi})
    del trained
    gc.collect()
    torch.cuda.empty_cache()
    return k1


# ---------------------------------------------------------------------------
# distributed: the model and trainer on DTensors over a one-rank NCCL host
# mesh at full width, and the production meshes' dry run in a subprocess
# ---------------------------------------------------------------------------
DIST_TRAIN_STEPS = 4
DRYRUN_COMBOS = [("qwen1.5-110b", "train_4k", False, False),
                 ("mixtral-8x22b", "decode_32k", True, False),
                 ("rwkv6-1.6b", "long_500k", False, False),
                 ("whisper-medium", "train_4k", False, False),
                 ("gemma3-4b", "prefill_32k", False, True)]
DRYRUN_CODE = r"""
import json, sys
sys.path.insert(0, sys.argv[1])
from repro_torch.launch import dryrun
for arch, shape, multi_pod, kvcomm in json.loads(sys.argv[2]):
    rec = dryrun.run_one(arch, shape, multi_pod, kvcomm=kvcomm)
    print("DRYRUN " + json.dumps(rec), flush=True)
"""


def start_dryrun():
    """The five production-mesh dry-run combos in a second process (a
    fake process group cannot share a process with NCCL), on the CPU: it
    sees no card."""
    import os
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.Popen(
        [sys.executable, "-c", DRYRUN_CODE, str(SRC),
         json.dumps(DRYRUN_COMBOS)], cwd=str(ROOT), env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    CHILDREN.append(proc)
    return proc


def dist_train_run(dev, cfg, batches, mesh):
    """DIST_TRAIN_STEPS make_train_step steps of ``cfg`` from seed 0 on
    the given host batches, the state sharded by ``param_shardings`` over
    ``mesh`` (unsharded without one): losses, wall ms a step, peak GB."""
    import gc
    import torch
    from repro_torch.configs.base import InputShape
    from repro_torch.distributed import hints
    from repro_torch.distributed import sharding as shd
    from repro_torch.launch.mesh import mesh_axes
    from repro_torch.launch.train import scalar
    from repro_torch.models import transformer as tfm
    from repro_torch.training.optimizer import OptimizerConfig, \
        init_opt_state
    from repro_torch.training.train_loop import (TrainState,
                                                 make_train_step, to_batch)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    params = tfm.init_params(cfg, 0, device=dev)
    B, S = batches[0]["tokens"].shape
    shape = InputShape("train", S, B, "train")
    if mesh is not None:
        params = shd.distribute(params, mesh,
                                shd.param_shardings(cfg, mesh, params))
        hints.set_axes(*mesh_axes(mesh))
    state = TrainState(params, init_opt_state(params))
    step = make_train_step(cfg, OptimizerConfig(
        lr=3e-4, total_steps=len(batches), warmup_steps=1))
    ms, losses = [], []
    try:
        for b in batches:
            b = to_batch(b, dev)
            if mesh is not None:
                b = shd.distribute(b, mesh, shd.input_shardings(
                    cfg, mesh, shape, b))
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, m = step(state, b)
            losses.append(scalar(m["loss"]))
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
    finally:
        hints.clear()
    peak = torch.cuda.max_memory_allocated(dev) / 1e9
    del state, params, step
    gc.collect()
    torch.cuda.empty_cache()
    return {"losses": losses, "step_ms": ms,
            "steady_step_ms": float(sorted(ms[1:])[len(ms[1:]) // 2]),
            "peak_gb": peak}


def phase_distributed(dev, smi):
    """(a) llama3.2-3b-pair at full width (bf16 parameters, float32
    moments), DIST_TRAIN_STEPS steps at B 4 x S 128 from seed 0, its state
    sharded by param_shardings over a one-rank NCCL host mesh, against the
    unsharded steps: losses within 1e-4 relative (predicted bit-equal: on
    a (1, 1) mesh every DTensor op runs the local op), with the config's
    remat (on) and with remat off; ms a step and peak GB of each. (b) On
    that mesh the prefill (B 4 x S 256), one decode step over its cache
    and the KVComm receiver prefill with the Eq. (1) masses
    (make_kvcomm_prefill_fn: a 512-position sender prefix, 14 of 28
    layers selected, B 4 x S 64): logits and masses within 5e-2 of the
    largest of the unsharded port's. (c) The production meshes' dry run
    of five combos in a subprocess: status ok, FLOPs > 0, collective
    bytes > 0. No kernel launches across the phase but K2 in the
    unsharded port's two bf16 prefills (one a layer each,
    ``routed_prefills``): the sharded path, like the reference's, runs the
    plain attention and scans."""
    import dataclasses
    import numpy as np
    import torch
    import torch.distributed as dist
    from repro_torch.configs.base import InputShape
    from repro_torch.data.pipeline import synthetic_byte_corpus, \
        token_stream_iter
    from repro_torch.distributed import hints
    from repro_torch.distributed import sharding as shd
    from repro_torch.launch import pairs, specs
    from repro_torch.launch.mesh import make_host_mesh, mesh_axes
    from repro_torch.models import transformer as tfm
    t_phase = time.perf_counter()
    dry = start_dryrun()
    launches0 = kernel_launches()
    mesh = make_host_mesh("cuda")
    fw = pairs.full_width_config()
    corpus = synthetic_byte_corpus() % fw.vocab_size
    it = token_stream_iter(corpus, 4, 128)
    batches = [next(it) for _ in range(DIST_TRAIN_STEPS)]

    # (a) train steps, sharded against unsharded, remat on and off
    train = {}
    for remat in (True, False):
        cfg = dataclasses.replace(fw, remat=remat)
        un = dist_train_run(dev, cfg, batches, None)
        sh = dist_train_run(dev, cfg, batches, mesh)
        rel = max(abs(a - b) / abs(b) for a, b in zip(sh["losses"],
                                                      un["losses"]))
        check(all(np.isfinite(sh["losses"])) and rel <= 1e-4,
              f"distributed train (remat {remat}): losses {sh['losses']} "
              f"vs {un['losses']}")
        train[f"remat_{remat}"] = {"unsharded": un, "sharded": sh,
                                   "max_rel": rel,
                                   "bit_equal": sh["losses"] == un["losses"]}
        emit({"phase": "distributed_train", "model": fw.name,
              "remat": remat, "batch": [4, 128], "mesh": {"data": 1,
                                                          "model": 1},
              "unsharded": un, "sharded": sh, "max_rel": rel,
              "bound": 1e-4, "card": smi})

    # (b) serving-shaped steps on the mesh against the unsharded port
    params = tfm.init_params(fw, 0, device=dev)
    sparams = shd.distribute(params, mesh,
                             shd.param_shardings(fw, mesh, params))
    rng = np.random.default_rng(7)
    pre_shape = InputShape("prefill", 256, 4, "prefill")
    prefill, _ = specs.make_step_fn(fw, pre_shape)
    decode, _ = specs.make_step_fn(fw, InputShape("decode", 256, 4,
                                                  "decode"))
    kv_shape = InputShape("kvcomm", 64, 4, "prefill")
    kvfn, kv_args = specs.make_kvcomm_prefill_fn(fw, kv_shape,
                                                 context_len=512)
    toks = torch.from_numpy(rng.integers(0, fw.vocab_size, (4, 256))).to(dev)
    ktoks = toks[:, :64].clone()
    kv = {n: torch.from_numpy(rng.standard_normal(
        tuple(kv_args[2][n].shape)).astype(np.float32)).to(
        dev, torch.bfloat16) for n in ("k", "v")}
    select = kv_args[3]

    def serve_steps(p, m):
        batch, kbatch, kvs = {"tokens": toks}, {"tokens": ktoks}, kv
        if m is not None:
            batch = shd.distribute(batch, m, shd.input_shardings(
                fw, m, pre_shape, batch))
            kbatch = shd.distribute(kbatch, m, shd.input_shardings(
                fw, m, kv_shape, kbatch))
            kvs = shd.distribute(kv, m, shd.cache_shardings(
                fw, m, kv_shape, kv))
            hints.set_axes(*mesh_axes(m))
        try:
            with torch.no_grad():
                t0 = time.perf_counter()
                logits, cache = prefill(p, batch)
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                dlogits, _ = decode(p, batch["tokens"][:, -1:], cache)
                torch.cuda.synchronize()
                t2 = time.perf_counter()
                klogits, masses, _ = kvfn(p, kbatch, kvs, select)
                torch.cuda.synchronize()
                t3 = time.perf_counter()
        finally:
            hints.clear()
        full = lambda x: (x.full_tensor() if hasattr(x, "full_tensor")  # noqa
                          else x).float().cpu()
        return ([full(x) for x in (logits, dlogits, klogits, masses)],
                {"prefill_ms": (t1 - t0) * 1e3, "decode_ms": (t2 - t1) * 1e3,
                 "kvcomm_prefill_ms": (t3 - t2) * 1e3})

    serve_steps(params, None)                       # warm-up
    want, t_un = serve_steps(params, None)
    got, t_sh = serve_steps(sparams, mesh)
    errs = {}
    for name, a, b in zip(("prefill", "decode", "kvcomm_prefill",
                           "masses"), got, want):
        check(a.shape == b.shape and bool(torch.isfinite(a).all()),
              f"distributed {name}: shape {tuple(a.shape)} vs "
              f"{tuple(b.shape)}")
        errs[name] = float((a - b).abs().max() / b.abs().max())
        check(errs[name] <= 5e-2, f"distributed {name}: {errs[name]}")
    emit({"phase": "distributed_serving_steps", "model": fw.name,
          "prefill": [4, 256], "kvcomm": {"batch": [4, 64], "context": 512,
                                         "selected": int(select.sum())},
          "max_err_over_largest": errs, "bound": 5e-2,
          "masses": got[3].tolist(), "unsharded_ms": t_un,
          "sharded_ms": t_sh, "card": smi})
    del params, sparams, kv
    dist.destroy_process_group()

    # (c) the dry run
    out, err = dry.communicate(timeout=900)
    check(dry.returncode == 0, f"dry run exited {dry.returncode}: "
          f"{err[-2000:]}")
    recs = [json.loads(ln[7:]) for ln in out.splitlines()
            if ln.startswith("DRYRUN ")]
    check(len(recs) == len(DRYRUN_COMBOS), f"dry run: {len(recs)} records")
    for rec in recs:
        rec.pop("traceback", None)
        emit({"phase": "distributed_dryrun", **rec})
        check(rec["status"] == "ok" and rec["flops"] > 0
              and rec["collectives"]["total"] > 0,
              f"dry run {rec['arch']} {rec['shape']}: {rec.get('error')}")
    k2_launches = routed_prefills(launches0, "distributed", fw.num_layers)
    check(k2_launches == 2 * fw.num_layers, f"distributed: {k2_launches} "
          f"K2 launches, expected the unsharded prefills' 2 x "
          f"{fw.num_layers}")
    emit({"phase": "distributed", "k2_launches": k2_launches,
          "train": {k: {"max_rel": v["max_rel"], "bit_equal": v["bit_equal"]}
                    for k, v in train.items()},
          "seconds": time.perf_counter() - t_phase, "card": smi})


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
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.moe_grouped import grouped_experts
    k2_paths, k2_seen = {}, 0
    k5_paths, k5_seen = {}, 0

    def served_path(name):
        """K2's and K5's launches since the last reading, under ``name``:
        the prefills the routing rule sent to K2, and the bf16 dense_all
        MoE calls that took K5, in the phases between."""
        nonlocal k2_seen, k5_seen
        k2_paths[name] = flash_attention.launches - k2_seen
        k2_seen = flash_attention.launches
        k5_paths[name] = grouped_experts.launches - k5_seen
        k5_seen = grouped_experts.launches

    fw = full_width_pair(dev)
    torch.cuda.synchronize()
    flash_attention.launches = 0            # K2's served launches from here
    grouped_experts.launches = 0            # and K5's
    runs, launches = phase_full_width(dev, smi, fw)
    served_path("full_width_serving")

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
    served_path("wire_codec")
    paged_launches, paged_steps = phase_paged_serving(dev, smi, fw)
    served_path("paged_serving")
    tier_launches, tier_steps = phase_wire_tiers(dev, smi, fw, plan)
    served_path("wire_tiers")
    phase_comm_methods(dev, smi, fw)
    served_path("comm_methods")
    hetero_launches = phase_hetero_pair(dev, smi, fw)
    served_path("hetero_pair")
    remote_launches, remote_steps = phase_remote_serving(dev, smi, fw, plan)
    served_path("remote_serving")
    # the second process starts now and loads while the next phases run
    server = start_remote_server()
    res_launches, res_steps = phase_resilient_serving(dev, smi, fw)
    served_path("resilient_serving")
    pool_launches, pool_steps = phase_fabric_serving(dev, smi, fw)
    served_path("scheduler_pool")
    phase_remote_serve_two_process(dev, smi, fw, server)
    served_path("remote_serve_two_process")
    k1_paths = {"full_width_serving": launches,
                "paged_serving": paged_launches,
                "wire_tiers": tier_launches,
                "remote_serving": remote_launches,
                "resilient_serving": res_launches,
                "scheduler_pool": pool_launches,
                "hetero_stream": hetero_launches}
    launches = sum(k1_paths.values())
    steps += (paged_steps + tier_steps + remote_steps + res_steps
              + pool_steps)
    del fw
    torch.cuda.empty_cache()
    from repro_torch.launch import pairs
    k4_state, k4_cases = phase_rwkv6_state_sharing(dev, smi, flush,
                                                   pairs.pair_tokenizer())
    served_path("rwkv6_state_sharing")
    k1_state, state_steps = phase_zamba2_state_sharing(
        dev, smi, flush, pairs.pair_tokenizer())
    served_path("zamba2_state_sharing")
    k1_paths["state_sharing"] = k1_state
    launches += k1_state
    k1_arch, arch_steps, arch_cases = phase_decoder_archs(
        dev, smi, flush, pairs.pair_tokenizer())
    k1_paths["decoder_archs"] = k1_arch
    launches += k1_arch
    served_path("decoder_archs")
    moe_results = phase_moe_grouped(dev, flush, smi)
    served_path("moe_grouped")
    ep_launches, ep_results = phase_entry_point(dev, flush, smi)
    k2_paths["entry_point"] = ep_launches["flash_attention"]
    k2_seen = flash_attention.launches       # the entry point reset it
    sharded = phase_sharded_decode(dev, smi, flush)
    # starcoder2-7b's G 9 over the same sharded cache (F7)
    sharded_g9 = phase_sharded_decode(dev, smi, flush, Hq=36, Hkv=4)
    k1_train = phase_training(dev, smi, pairs.pair_tokenizer())
    k1_paths["quick_trained_pair"] = k1_train
    launches += k1_train
    served_path("training")
    phase_distributed(dev, smi)
    served_path("distributed")
    results = (cases + [main] + ep_results + k4_cases + arch_cases
               + moe_results)
    kernels = {"kernels": [
        {**kernel_entry(results, "ragged_decode",
                        "src/repro_torch/kernels/csrc/ragged_decode.cu",
                        "src/repro/kernels/ragged_decode.py:46", launches,
                        "main_path_selected_layer"),
         # the 28-layer served paths' launches per ragged step; the
         # hetero stream decodes at the 42-layer receiver's depth, Zamba2
         # at its 9 shared-attention invocations, each decoder config at
         # its full-attention layers
         "launches_per_step": (launches - hetero_launches - k1_state
                               - k1_arch - k1_train) // max(steps, 1),
         "hetero_stream_launches_per_step": hetero_launches // 7,
         "state_sharing_launches_per_step": k1_state // state_steps,
         "decoder_archs_launches_per_step": ARCH_K1_PER_STEP,
         "decoder_archs_steps": arch_steps,
         "new_geometries": {c["case"]: {
             k: c[k] for k in ("dtype", "B", "Hq", "Hkv", "D", "Skv",
                               "route", "nsplit", "chunk",
                               "device_ms", "bound_ms", "library_device_ms",
                               "ms", "plain_ms", "library_ms",
                               "max_abs_err", "tol_ratio")}
             for c in arch_cases},
         "launches_by_path": k1_paths},
        {**kernel_entry(results, "flash_attention",
                        "src/repro_torch/kernels/csrc/flash_attention.cu",
                        "src/repro/kernels/flash_attention.py:31",
                        sum(k2_paths.values()),
                        "starcoder2_sender_prefill_3968"),
         # the served sender prefills (the routing rule's), beside the
         # entry point's cases
         "launches_by_path": k2_paths,
         "cases": {c["case"]: {
             k: c[k] for k in ("B", "Sq", "Skv", "Hq", "Hkv", "D", "window",
                               "device_ms", "bound_ms", "library_device_ms",
                               "ms", "plain_ms", "library_ms",
                               "max_abs_err", "tol_ratio")}
             for c in ep_results if c["kernel"] == "flash_attention"
             and c["dtype"] == "bfloat16"}},
        {**kernel_entry(results, "flash_decode",
                        "src/repro_torch/kernels/csrc/flash_decode.cu",
                        "src/repro/kernels/flash_decode.py:32",
                        ep_launches["flash_decode"] + sharded["launches"]
                        + sharded_g9["launches"], "long_cache_32k"),
         # F7: groups of more than 8 query heads
         "wide_groups": {c["case"]: {
             k: c[k] for k in ("dtype", "B", "S", "Hq", "Hkv", "D", "G",
                               "window", "partials", "route", "device_ms",
                               "bound_ms", "library_device_ms", "ms",
                               "plain_ms", "library_ms", "max_abs_err",
                               "tol_ratio")}
             for c in ep_results
             if c["kernel"] == "flash_decode" and c["G"] > 8},
         "launches_by_path": {"entry_point": ep_launches["flash_decode"],
                              "sharded_decode_g3": sharded["launches"],
                              "sharded_decode_g9": sharded_g9["launches"]}},
        {**kernel_entry(results, "wkv6",
                        "src/repro_torch/kernels/csrc/rwkv_scan.cu",
                        "src/repro/kernels/rwkv_scan.py:25",
                        ep_launches["wkv6"] + k4_state,
                        "rwkv6_served_prefill"),
         # RWKV6's 24 time mixes per forward call (prefills and decode
         # steps) and the entry point's one scan
         "launches_by_path": {"state_sharing": k4_state,
                              "entry_point": ep_launches["wkv6"]},
         "cases": {c["case"]: {
             k: c[k] for k in ("B", "T", "H", "hd", "plan", "device_ms",
                               "bound_ms", "ms", "plain_ms", "max_abs_err",
                               "tol_ratio")}
             for c in results if c["kernel"] == "wkv6"}},
        {**kernel_entry(results, "moe_grouped",
                        "src/repro_torch/kernels/moe_grouped.py",
                        "none (the dense_all loop of models/layers.py)",
                        sum(k5_paths.values()), "mellum2_prefill_4096x8"),
         # mellum2-12b's served shapes; "plain" is the dense_all loop it
         # replaces, "library" torch._grouped_mm over the same sorted rows
         "route": "triton",
         # every launch, counted from 0 before the first serving phase:
         # the decoder configs' bf16 MoE calls (olmoe, mixtral) and the
         # moe_grouped phase's cases
         "launches_by_path": k5_paths,
         "cases": {c["case"]: {
             k: c[k] for k in ("N", "assignments", "experts_touched",
                               "block_m", "device_ms", "bound_ms",
                               "bound_by", "library_device_ms", "ms",
                               "plain_ms", "plain_device_ms", "library_ms",
                               "max_abs_err", "tol_ratio")}
             for c in moe_results if c["kernel"] == "moe_grouped"},
         "k1_mellum2_full_layer_g8": next(
             {k: c[k] for k in ("device_ms", "bound_ms", "ms", "plain_ms",
                                "library_device_ms", "tol_ratio")}
             for c in moe_results if c["kernel"] == "ragged_decode")}]}
    emit(kernels)
    print(smi_line(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


def run() -> int:
    """``main``, then stop every process it started, however it ended."""
    try:
        return main()
    finally:
        for proc in CHILDREN:
            if proc.poll() is None:
                proc.kill()
                proc.wait()


if __name__ == "__main__":
    sys.exit(run())
