// RWKV6 WKV recurrence with the state kept on chip, for sm_90a.
//
// Replaces the Pallas kernel src/repro/kernels/rwkv_scan.py (_wkv_kernel,
// whose fori_loop takes one step per token). Per (batch row, head), with the
// state S (key x value, HD x HD):
//     y_t = r_t . (S + diag(u) k_t v_t^T)        (a vector over value columns)
//     S  <- diag(w_t) S + k_t v_t^T
//
// Bound: device memory sees one read of r, k, v, w and one write of y per
// token, plus the state in and out (at B 4, T 2049, 32 heads of 64: 340 MB,
// 0.1015 ms at 3.35 TB/s; one decode step, T 1: 4.4 MB, 0.0013 ms). The
// sequential scan does 5 float32 flops per (token, head, key, value), 80 us
// at 67 TFLOP/s on the CUDA cores, but its steps are serial in t: one step
// per token at B*H*HD*HD / 16 threads is bound by issue and latency. So a
// prefill takes the chunked form and its matrix products go to the tensor
// cores; a decode streams the state.
//
// wkv6_chunk_kernel (T above the wrapper's STREAM_MAX_T). Per chunk of
// C = 16 NS steps (rows past T padded with r = k = v = 0, w = 1), with S the
// state entering it and P(a, b) the product of w over steps a..b-1:
//     y_t   = (r_t P(0, t)) S + sum_{s <= t} A_ts v_s
//     S_out = diag(P(0, C)) S + sum_s (k_s P(s + 1, C)) v_s^T
// with A_ts = sum_i r_ti k_si P(s + 1, t)_i (s < t), A_tt = sum_i r_ti u_i k_ti.
//  * Decays as products taken outward from a sub-chunk boundary (16 steps):
//    Rq_t = r_t P(beta, t) and Kq_s = k_s P(s + 1, end) within a sub-chunk,
//    the sub-chunk totals, their prefix and suffix products. Every factor
//    is in [0, 1]: no quotient, no difference of log-decays (whose rounding
//    costs ulp(|log P|) of the exponent, beyond 1e-4 once log P reaches the
//    thousands), and w = 0 is an exact 0 as in the reference. For s, t in
//    sub-chunks j < i, A_ts is a product over keys of Rq_t (times the
//    totals between) and Kq_s: a 16 x 16 tensor-core tile per pair. The
//    diagonal 16 x 16 blocks carry k_s forward step by step on the CUDA
//    cores: a lane per (s pair, key quarter), bound by shared-memory reads
//    (every r_t and w_t value goes to the 8 lanes of its quarter).
//  * Tensor cores in 3xTF32 (mma_tf32.cuh: mma.sync m16n8k8, operands split
//    into a TF32 hi, rounded to nearest, and the float32 residual as lo;
//    hi*hi + hi*lo + lo*hi in float32): the pair tiles of A, the rows
//    against the state, A V and the update S^T += V^T (Kq P) all run there,
//    each within ~2^-21 of float32. Each product runs its three passes over
//    all of a warp's tiles at once, so no mma waits on the one before it.
//  * The state lives in registers as accumulator fragments of S^T (value x
//    key), 8 warps over 16-column value tiles and key groups (the groups'
//    partial y summed in shared memory). A fragment of S^T is the B operand
//    of y = Rq S with the key index permuted (mma_tf32.cuh), so the state
//    never leaves registers.
//  * A chunk in three steps between barriers: (1) the products of w, Rq, Kq
//    and a copy of v with padded rows (fragment loads free of bank
//    conflicts); (2) the diagonal blocks, the pair tiles, y = Rc S and
//    U = V^T Kc, odd and even warps in opposite order; (3) y += A V,
//    S = P(0, C) S + U, y out, beside the next chunk's step (1) (V and the
//    totals in two buffers).
//  * Inputs: r, k, w and v of a chunk arrive as four TMA boxes (tma.cuh,
//    maps cached per buffer) into a 2-stage ring, the next chunk in flight
//    behind the current one's products; inputs a map cannot describe (a base
//    or stride off 16 bytes) are staged by plain loads into the same ring.
//  * Grid (1, H, B * nseg). A block takes a head (C 64 at HD <= 64, 32 at
//    128; one block an SM). Where that leaves SMs idle, wkv6_plan in the
//    wrapper cuts each head's steps into nseg time segments of whole chunks:
//    pass 0 runs the state update alone for each segment from a zero start
//    (segment 0 from s0) and leaves its end state and decay; pass 1 starts
//    segment k from S_k = P_{k-1} S_{k-1} + E_{k-1} and runs it whole.
//  * The steps past a call's last whole chunk run after its chunks, in the
//    same block, by stream_steps (below) from the state the chunks leave. A
//    call over [C; Q] and a call over Q from C's state then compute Q's rows
//    by the same per-step arithmetic, bit for bit, as the sequential scan
//    did (the skyline gates of state sharing compare exactly those two).
//
// wkv6_stream_kernel (T up to STREAM_MAX_T: decode steps, short prefills).
// A block per (b, h); a thread holds a float4 of value columns for HD / 8
// keys, neighbouring lanes on neighbouring columns, so the state is read
// once, coalesced, and written once. Every step's inputs are copied into
// shared memory by cp.async, all in flight at once, while the state loads;
// one barrier, then the steps run from registers, and y is summed over the
// key groups of a warp by shuffles: no ring, no chunk.
#include "common.cuh"
#include "mma_tf32.cuh"
#include "tma.cuh"

namespace {

using kern::FragA3;
using kern::FragB3;
using kern::frag_a;
using kern::frag_b;
using kern::mbar_arrive;
using kern::mbar_expect_tx;
using kern::mbar_init;
using kern::mbar_wait;
using kern::mma3_pass;
using kern::smem_u32;
using kern::tma_load;

constexpr int kWholeNS = 4;  // sub-chunks a chunk at HD <= 64
constexpr int kWideNS = 2;   // at HD 128
constexpr int kBufs = 2;     // chunks in the ring: one in flight
constexpr int kWarps = 8;    // warps a block: two a scheduler
constexpr int kStreamKeyGroups = 8;  // streaming kernel: lanes of a column
constexpr int kMaxSmem = 232448;  // shared memory a block may have

struct Args {
  const float* r;
  const float* k;
  const float* v;
  const float* w;
  const float* u;   // (H, HD) contiguous
  const float* s0;  // (B, H, HD, HD) contiguous, 16-byte aligned
  float* y;         // (B, T, H, HD) contiguous, 16-byte aligned
  float* sfin;      // (B, H, HD, HD) contiguous, 16-byte aligned
  int B, T, H, aligned;  // T: the steps this launch runs
  int yT;                 // rows of y a batch row (the call's T)
  long long sb[4], st[4], sh[4];  // strides of r, k, v, w (head dim is 1)
  // time segments of a head (chunked kernel): nseg of seg_len steps (a
  // multiple of the chunk); pass 0 leaves each segment's end state from a
  // zero start (segment 0: from s0) in seg_state (B*H*nseg, HD, HD) and
  // its decay P(start, end) in seg_decay (B*H*nseg, HD); pass 1 starts each
  // segment from the states of those before it and writes y
  int nseg, seg_len;
  float* seg_state;
  float* seg_decay;
  // the chunked kernel: steps T .. T + tail - 1 streamed after its chunks
  int tail;
  int vec;  // every row of r, k, v, w starts on 16 bytes
};

__device__ __forceinline__ float2 ld2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ void st2(float* p, float x, float y) {
  *reinterpret_cast<float2*>(p) = make_float2(x, y);
}
// n values from shared memory at p: float4 loads where n is a multiple of 4
template <int N>
__device__ __forceinline__ void lds(const float* p, float* out) {
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int i = 0; i < N; i += 4) kern::split4(ld4(p + i), out + i);
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) out[i] = p[i];
  }
}

// ---------------------------------------------------------------------------
// the state-streaming steps (wkv6_stream_kernel, and the chunked kernel's
// steps past its last whole chunk)
// ---------------------------------------------------------------------------
template <int HD>
struct Stream {
  static constexpr int KG = kStreamKeyGroups < HD ? kStreamKeyGroups : HD;
  static constexpr int KPT = HD / KG;   // keys a thread
  static constexpr int LC = 32 / KG;    // float4 column groups a warp
  static constexpr int CG = HD / 4;     // float4 column groups
  static constexpr int NW = (CG + LC - 1) / LC;
  static constexpr int NT = 32 * NW;
  static constexpr int ROW = 4 * HD;    // a step's r, k, w, v in shared memory
};

// Steps t0 .. t0 + n - 1 of head (b, h)'s r, k, w and v into sin as
// [t][r, k, w, v][HD], by thread tid of nt: every copy a cp.async issued
// before any lands (16 bytes where every row starts on 16 bytes, else 4),
// committed as one group.
template <int HD>
__device__ __forceinline__ void stage_steps(const Args& a, int b, int h,
                                            int t0, int n, float* sin,
                                            int tid, int nt) {
  constexpr int ROW = Stream<HD>::ROW;
  const float* src[4] = {a.r, a.k, a.w, a.v};
  const int sx[4] = {0, 1, 3, 2};  // index of r, k, w, v in a.sb/st/sh
#pragma unroll
  for (int x = 0; x < 4; ++x) {
    const long long st = a.st[sx[x]];
    const float* base = src[x] + b * a.sb[sx[x]] + t0 * st + h * a.sh[sx[x]];
    float* out = sin + x * HD;
    if (a.vec) {
      for (int idx = tid; idx < n * (HD / 4); idx += nt) {
        const int t = idx / (HD / 4);
        const int c = 4 * (idx % (HD / 4));
        kern::cp_async16(out + t * ROW + c, base + t * st + c);
      }
    } else {
      for (int idx = tid; idx < n * HD; idx += nt) {
        const int t = idx / HD;
        const int c = idx % HD;
        kern::cp_async4(out + t * ROW + c, base + t * st + c);
      }
    }
  }
  kern::cp_async_commit();
}

// Steps t0 .. t0 + n - 1 of head (b, h) from its state at s_in (HD x HD,
// key-major; device or shared memory), their inputs staged in sin by
// stage_steps: y rows out, the state to a.sfin.
// Thread tid holds a float4 of value columns for HD / KG keys,
// neighbouring lanes on neighbouring columns, so the state is read once,
// coalesced, and written once; y is summed over the key groups of a warp by
// shuffles. Every thread of the block calls it (threads past Stream::NT
// hold nothing); `ready` is the block's wait for sin, after this thread's
// state is in flight.
template <int HD, typename Ready>
__device__ __forceinline__ void stream_steps(const Args& a, int b, int h,
                                             int t0, int n,
                                             const float* s_in,
                                             const float* sin, int tid,
                                             Ready ready) {
  using St = Stream<HD>;
  constexpr int KPT = St::KPT;
  const int lane = tid % 32;
  const int kg = lane / St::LC;
  const int cg = (tid / 32) * St::LC + lane % St::LC;
  const bool live = cg < St::CG;   // HD 8: half the lanes hold nothing
  const int col = live ? 4 * cg : 0;
  const int key0 = kg * KPT;
  const long long bh = static_cast<long long>(b) * a.H + h;
  float S[KPT][4];
  float uu[KPT];
#pragma unroll
  for (int i = 0; i < KPT; ++i) {
    const int key = key0 + i;
    uu[i] = a.u[h * HD + key];
    kern::split4(ld4(s_in + key * HD + col), S[i]);
  }
  ready();
  if ((tid / 32) * St::LC >= St::CG) return;  // a warp that holds nothing

  // the steps depend on each other only through S's one FMA a step, so
  // four at a time let one step's loads, sums and shuffles overlap the next
#pragma unroll 4
  for (int t = 0; t < n; ++t) {
    const float* in = sin + t * St::ROW;
    float rr[KPT], kk[KPT], ww[KPT], vv[4];
    lds<KPT>(in + key0, rr);
    lds<KPT>(in + HD + key0, kk);
    lds<KPT>(in + 2 * HD + key0, ww);
    kern::split4(ld4(in + 3 * HD + col), vv);
    float ruk = 0.f;  // this thread's keys' share of sum_i r_i u_i k_i
#pragma unroll
    for (int i = 0; i < KPT; ++i) ruk = fmaf(rr[i] * uu[i], kk[i], ruk);
    float y[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      float x = 0.f;
#pragma unroll
      for (int i = 0; i < KPT; ++i) x = fmaf(rr[i], S[i][c], x);
      y[c] = fmaf(vv[c], ruk, x);
    }
#pragma unroll
    for (int o = St::LC; o < 32; o *= 2)
#pragma unroll
      for (int c = 0; c < 4; ++c) y[c] += __shfl_xor_sync(0xffffffffu, y[c], o);
#pragma unroll
    for (int i = 0; i < KPT; ++i)
#pragma unroll
      for (int c = 0; c < 4; ++c)
        S[i][c] = fmaf(ww[i], S[i][c], kk[i] * vv[c]);
    if (kg == 0 && live)
      *reinterpret_cast<float4*>(
          a.y + ((static_cast<long long>(b) * a.yT + t0 + t) * a.H + h) * HD +
          col) = make_float4(y[0], y[1], y[2], y[3]);
  }
  if (live) {
#pragma unroll
    for (int i = 0; i < KPT; ++i)
      *reinterpret_cast<float4*>(a.sfin + (bh * HD + key0 + i) * HD + col) =
          make_float4(S[i][0], S[i][1], S[i][2], S[i][3]);
  }
}

// ---------------------------------------------------------------------------
// the chunked kernel
// ---------------------------------------------------------------------------
// Shape of the chunked kernel for HD keys (and value columns), NS
// sub-chunks a chunk and NW warps; shared memory in floats.
template <int HD, int NS, int NW>
struct Chunk {
  static constexpr int C = 16 * NS;   // steps a chunk
  static constexpr int NT = 32 * NW;
  static constexpr int VW = HD < 16 ? 16 : HD;  // columns as 16-wide tiles
  static constexpr int VT = VW / 16;            // value tiles
  static constexpr int KW = NW / VT < HD / 8 ? NW / VT : HD / 8;  // key groups
  static constexpr int KH = HD / KW;  // keys of one warp's state
  static constexpr int SW = VT * KW;  // warps that hold the state
  static constexpr int PR = HD + 8;   // rows of Rq, Kq (float2 fragments)
  static constexpr int PV = VW + 8;   // rows of V
  static constexpr int PA = C + 4;    // rows of A
  static constexpr int STAGE = 4 * C * HD;  // r, k, w, v of a chunk
  // rows of the partial y (KW > 1): padded where that still fits the stage
  static constexpr int PY = KW * C * (VW + 8) <= STAGE ? VW + 8 : VW;
  // the diagonal blocks' key slices (a warp per (sub-chunk, slice), at
  // least 4 keys a lane); slices past the first leave partials in Ad
  static constexpr int KS0 = NW / NS < 1 ? 1 : NW / NS;
  static constexpr int KS = KS0 < HD / 8 ? KS0 : HD / 8;
  // the partial y take the chunk's stage once it is read, where they fit
  static constexpr int RED = KW > 1 ? KW * C * PY : 0;
  static constexpr bool kRedInStage = RED <= STAGE;
  static constexpr int oRq = kBufs * STAGE;
  static constexpr int oKq = oRq + C * PR;
  static constexpr int oV = oKq + C * PR;
  static constexpr int oA = oV + 2 * C * PV;  // V: two chunks' copies
  static constexpr int oT = oA + C * PA;  // sub-chunk totals [2][NS][HD]
  static constexpr int oU = oT + 2 * NS * HD;
  static constexpr int oAd = oU + HD;       // [KS - 1][NS][16][16]
  static constexpr int oRed = oAd + (KS - 1) * NS * 256;
  static constexpr int kFloats = oRed + (kRedInStage ? 0 : RED);
  // + the ring's barriers and the slack to align the base to 128 bytes
  static constexpr int kSmem = kFloats * 4 + 8 * kBufs + 128;
  static_assert(KW >= 1 && HD % KW == 0 && KH % 8 == 0, "key groups");
  static_assert(SW <= NW, "state warps");
  static_assert(kSmem <= kMaxSmem, "shared memory");
  // the streamed steps past the last chunk: inputs in stage 0, state in 1
  static_assert(kBufs >= 2 && HD * HD <= STAGE, "streamed steps");
};

// STATE_PASS: pass 0 of the time segments (the state update alone); else
// pass 1, the whole chunked form.
template <int HD, int NS, int NW, bool STATE_PASS>
__global__ void __launch_bounds__(32 * NW, 1)
    wkv6_chunk_kernel(const Args a, const __grid_constant__ CUtensorMap mr,
                      const __grid_constant__ CUtensorMap mk,
                      const __grid_constant__ CUtensorMap mv,
                      const __grid_constant__ CUtensorMap mw) {
  using K = Chunk<HD, NS, NW>;
  constexpr int C = K::C, NT = K::NT, PR = K::PR, PV = K::PV, PA = K::PA;
  constexpr int VT = K::VT, KW = K::KW, KH = K::KH, NKT = KH / 8;
  constexpr int NP = NS * (NS - 1) / 2;  // sub-chunk pairs
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  float* smem =
      reinterpret_cast<float*>(smem_raw + (((raw + 127) & ~127u) - raw));
  float* Rq = smem + K::oRq;
  float* Kq = smem + K::oKq;
  float* const VpB = smem + K::oV;
  float* Am = smem + K::oA;
  float* const TgB = smem + K::oT;
  float* us = smem + K::oU;
  float* Ad = smem + K::oAd;
  const uint32_t bar0 = smem_u32(smem + K::kFloats);
  auto full = [&](int st) { return bar0 + 8 * st; };
  auto stage = [&](int st) { return smem + st * K::STAGE; };

  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  const int g = lane / 4;  // fragment row group
  const int q = lane % 4;  // fragment column pair
  const int h = blockIdx.y;
  const int b = blockIdx.z / a.nseg;
  const int seg = blockIdx.z % a.nseg;
  constexpr bool state_pass = STATE_PASS;
  // pass 0 leaves the last segment to pass 1, which ends in sfin
  if (state_pass && seg == a.nseg - 1) return;
  const long long bh = static_cast<long long>(b) * a.H + h;
  const int T = a.T;
  const int tb = seg * a.seg_len;                 // this block's steps
  const int te = min(T, tb + a.seg_len);
  const int nch = (te - tb + C - 1) / C;
  const bool tma = a.aligned != 0;

  if (tid == 0) {
    for (int st = 0; st < kBufs; ++st) mbar_init(full(st), tma ? 1 : NT);
    kern::mbar_init_fence();
  }
  for (int i = tid; i < HD; i += NT) us[i] = a.u[h * HD + i];
  __syncthreads();

  // chunk c into stage st: r, k, w and v as [C][HD], rows past T
  // zero; four TMA boxes from one thread, or plain loads by every thread
  auto load_chunk = [&](int st, int c) {
    float* dst = stage(st);
    const int t0 = tb + c * C;
    if (tma) {
      if (tid == 0) {
        const uint32_t d = smem_u32(dst);
        mbar_expect_tx(full(st), K::STAGE * 4);
        tma_load(d, &mr, 0, h, t0, b, full(st));
        tma_load(d + C * HD * 4, &mk, 0, h, t0, b, full(st));
        tma_load(d + 2 * C * HD * 4, &mw, 0, h, t0, b, full(st));
        tma_load(d + 3 * C * HD * 4, &mv, 0, h, t0, b, full(st));
      }
    } else {
      const float* src[4] = {a.r, a.k, a.w, a.v};
      const int sx[4] = {0, 1, 3, 2};  // index of r, k, w, v in a.sb/st/sh
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        const float* base = src[x] + b * a.sb[sx[x]] + h * a.sh[sx[x]];
        float* out = dst + x * C * HD;
        for (int idx = tid; idx < C * HD; idx += NT) {
          const int t = idx / HD;
          const int cc = idx % HD;
          out[idx] = t0 + t < T ? base[(t0 + t) * a.st[sx[x]] + cc] : 0.f;
        }
      }
      mbar_arrive(full(st));
    }
  };

  // the state: S^T fragments (value v0 + g (+8), key key0 + 8 nt + 2q (+1))
  const bool holds = warp < K::SW;
  const int v0 = (warp % VT) * 16;
  const int kw = warp / VT;
  const int key0 = kw * KH;
  float S[NKT][4];
#pragma unroll
  for (int nt = 0; nt < NKT; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int val = v0 + g + (e >> 1) * 8;
      const int key = key0 + 8 * nt + 2 * q + (e & 1);
      float x = 0.f;
      if (holds && val < HD) {
        const long long at = static_cast<long long>(key) * HD + val;
        if (seg == 0) {
          x = a.s0[bh * HD * HD + at];
        } else if (!state_pass) {
          // S entering segment seg: segment 0's end state (pass 0 ran it
          // from s0), then each later one's decay and zero-start end state
          const long long sg = bh * a.nseg;
          x = a.seg_state[sg * HD * HD + at];
          for (int j = 1; j < seg; ++j)
            x = fmaf(a.seg_decay[(sg + j) * HD + key], x,
                     a.seg_state[(sg + j) * HD * HD + at]);
        }
      }
      S[nt][e] = x;
    }
  float Dacc[NKT][2];  // this segment's decay P(tb, te) of the warp's keys
#pragma unroll
  for (int nt = 0; nt < NKT; ++nt) Dacc[nt][0] = Dacc[nt][1] = 1.f;

  // 1. chunk c's products of w outward from the sub-chunk boundaries, a
  // thread per (key, sub-chunk, direction): forward Rq_t = r_t P(beta, t)
  // and the sub-chunk's total, backward Kq_s = k_s P(s + 1, end); and v into
  // its padded rows (columns past HD zero). V and the totals alternate
  // between two buffers, so chunk c + 1's run while chunk c's A V reads c's.
  auto prep = [&](int c) {
    const int st = c % kBufs;
    const int n = min(C, te - tb - c * C);
    mbar_wait(full(st), (c / kBufs) & 1);
    const float* sr = stage(st);
    const float* sk = sr + C * HD;
    const float* sw = sk + C * HD;
    const float* sv = sw + C * HD;
    float* Tg = TgB + (c & 1) * NS * HD;
    float* Vp = VpB + (c & 1) * C * PV;
    for (int p = tid; p < NS * HD; p += NT) {
      const int key = p % HD;
      const int gs = p / HD;
      float f = 1.f, fb = 1.f;  // the two chains side by side
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        const int t = gs * 16 + i;
        const int tk = gs * 16 + 15 - i;
        Rq[t * PR + key] = sr[t * HD + key] * f;
        Kq[tk * PR + key] = sk[tk * HD + key] * fb;
        f *= t < n ? sw[t * HD + key] : 1.f;
        fb *= tk < n ? sw[tk * HD + key] : 1.f;
      }
      Tg[gs * HD + key] = f;
    }
    for (int idx = tid; idx < C * K::VW; idx += NT) {
      const int t = idx / K::VW;
      const int col = idx % K::VW;
      Vp[t * PV + col] = col < HD ? sv[t * HD + col] : 0.f;
    }
  };

  for (int c = 0; c < kBufs && c < nch; ++c) load_chunk(c, c);
  if (nch > 0) prep(0);
  __syncthreads();  // Rq, Kq, V and the totals of chunk 0 are in

  for (int c = 0; c < nch; ++c) {
    const int st = c % kBufs;
    const int t0 = tb + c * C;
    const int n = min(C, te - t0);
    const float* sr = stage(st);
    const float* sk = sr + C * HD;
    const float* sw = sk + C * HD;
    const float* Tg = TgB + (c & 1) * NS * HD;
    const float* Vp = VpB + (c & 1) * C * PV;

    // 2. Three independent parts, each warp its share of each: the diagonal
    // blocks (CUDA cores, bound by shared-memory reads), the sub-chunk pair
    // tiles of A and, for the warps that hold the state, y = Rc S and
    // U = V^T Kc (tensor cores). Odd warps take them in the other order, so
    // that the two warps of a scheduler overlap the two kinds of work.
    float yacc[NS][2][4] = {};
    float U[NKT][4] = {};

    // 2a. the diagonal blocks: a warp per (sub-chunk, key slice); lane
    // (s pair, key quarter) carries k_s of its two s forward through the
    // sub-chunk, A_ts = r_t . k_s P(s + 1, t), summed over the quarters by two
    // shuffles (each r_t and w_t read feeds both s); the bonus
    // sum_i r_si u_i k_si on the diagonal, zeros above it. Slice 0 writes A,
    // the others their partials to Ad.
    auto diagonal = [&]() {
      for (int unit = warp; unit < NS * K::KS; unit += NW) {
        constexpr int KPQ = HD / K::KS / 4;  // keys a lane
        const int gs = unit % NS;
        const int sl = unit / NS;
        const int s0 = 2 * (lane / 4);
        const int kb = sl * (HD / K::KS) + (lane % 4) * KPQ;
        const float* rg = sr + gs * 16 * HD + kb;
        const float* wg = sw + gs * 16 * HD + kb;
        float kp[2][KPQ], bonus[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float rs[KPQ], uj[KPQ];
          lds<KPQ>(sk + (gs * 16 + s0 + e) * HD + kb, kp[e]);
          lds<KPQ>(rg + (s0 + e) * HD, rs);
          lds<KPQ>(us + kb, uj);
          float x = 0.f;
#pragma unroll
          for (int i = 0; i < KPQ; ++i) x = fmaf(rs[i] * uj[i], kp[e][i], x);
          x += __shfl_xor_sync(0xffffffffu, x, 1);
          bonus[e] = x + __shfl_xor_sync(0xffffffffu, x, 2);
        }
        float* out = sl == 0 ? Am + gs * 16 * PA + gs * 16
                             : Ad + ((sl - 1) * NS + gs) * 256;
        const int pitch = sl == 0 ? PA : 16;
#pragma unroll 4
        for (int t = 0; t < 16; ++t) {
          float rt[KPQ], wt[KPQ];
          lds<KPQ>(rg + t * HD, rt);
          lds<KPQ>(wg + t * HD, wt);
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int s = s0 + e;
            float x0 = 0.f, x1 = 0.f;
#pragma unroll
            for (int i = 0; i < KPQ; i += 2) {
              x0 = fmaf(rt[i], kp[e][i], x0);
              x1 = fmaf(rt[i + 1], kp[e][i + 1], x1);
            }
            float x = x0 + x1;
            x += __shfl_xor_sync(0xffffffffu, x, 1);
            x += __shfl_xor_sync(0xffffffffu, x, 2);
            if (lane % 4 == 0)
              out[t * pitch + s] = t > s ? x : (t == s ? bonus[e] : 0.f);
            if (t > s) {
#pragma unroll
              for (int i = 0; i < KPQ; ++i) kp[e][i] *= wt[i];
            }
          }
        }
      }
    };

    // 2b. A_ts for s, t in sub-chunks j < i: (Rq_i x the totals between)
    // Kq_j^T over HD keys (k permuted: q -> keys 2q, 2q + 1), a warp per
    // pair, its two 16 x 8 tiles in lockstep
    auto pairs = [&]() {
      if constexpr (NS > 1) {
        for (int pr = warp; pr < NP; pr += NW) {
          int i = 1, j = pr;
          while (j >= i) {
            j -= i;
            ++i;
          }
          float d[2][4] = {};
#pragma unroll 2
          for (int ks = 0; ks < HD / 8; ++ks) {
            const int kk = 8 * ks + 2 * q;
            float2 gap = make_float2(1.f, 1.f);
            for (int m = j + 1; m < i; ++m) {
              const float2 t2 = ld2(Tg + m * HD + kk);
              gap.x *= t2.x;
              gap.y *= t2.y;
            }
            const float2 ra = ld2(Rq + (16 * i + g) * PR + kk);
            const float2 rb = ld2(Rq + (16 * i + g + 8) * PR + kk);
            const FragA3 A = frag_a(ra.x * gap.x, rb.x * gap.x, ra.y * gap.y,
                                    rb.y * gap.y);
            FragB3 Bk[2];
#pragma unroll
            for (int nt = 0; nt < 2; ++nt) {
              const float2 kv = ld2(Kq + (16 * j + 8 * nt + g) * PR + kk);
              Bk[nt] = frag_b(kv.x, kv.y);
            }
#pragma unroll
            for (int ps = 0; ps < 3; ++ps)
#pragma unroll
              for (int nt = 0; nt < 2; ++nt) mma3_pass(ps, d[nt], A, Bk[nt]);
          }
#pragma unroll
          for (int nt = 0; nt < 2; ++nt) {
            float* out = Am + (16 * i + g) * PA + 16 * j + 8 * nt + 2 * q;
            st2(out, d[nt][0], d[nt][1]);
            st2(out + 8 * PA, d[nt][2], d[nt][3]);
          }
        }
      }
    };

    // 2c. y = (Rq P(0, beta)) S over the warp's keys and U = V^T (Kq P(end, C))
    // (M values, N keys, K time); P(0, beta) and P(end, C) are products of
    // the totals, taken here; each product's three passes over all of the
    // warp's tiles at once
    auto state_products = [&]() {
      if (!holds) return;
#pragma unroll
      for (int ks = 0; ks < (state_pass ? 0 : NKT); ++ks) {  // pass 0: no y
        // this S^T tile as B of y = Rc S: vals v0 + g (n-tile 0), + 8 (1)
        const FragB3 Bs[2] = {frag_b(S[ks][0], S[ks][1]),
                              frag_b(S[ks][2], S[ks][3])};
        const int kk = key0 + 8 * ks + 2 * q;
        FragA3 A[NS];
        float2 pre = make_float2(1.f, 1.f);
#pragma unroll
        for (int i = 0; i < NS; ++i) {
          const float2 ra = ld2(Rq + (16 * i + g) * PR + kk);
          const float2 rb = ld2(Rq + (16 * i + g + 8) * PR + kk);
          A[i] = frag_a(ra.x * pre.x, rb.x * pre.x, ra.y * pre.y, rb.y * pre.y);
          const float2 t2 = ld2(Tg + i * HD + kk);
          pre.x *= t2.x;
          pre.y *= t2.y;
        }
#pragma unroll
        for (int ps = 0; ps < 3; ++ps)
#pragma unroll
          for (int i = 0; i < NS; ++i)
#pragma unroll
            for (int nt = 0; nt < 2; ++nt)
              mma3_pass(ps, yacc[i][nt], A[i], Bs[nt]);
      }
      // P(end, C) of the warp's keys key0 + 8 nt + g, per sub-chunk
      float suf[NS][NKT];
#pragma unroll
      for (int nt = 0; nt < NKT; ++nt) {
        float run = 1.f;
#pragma unroll
        for (int gs = NS - 1; gs >= 0; --gs) {
          suf[gs][nt] = run;
          run *= Tg[gs * HD + key0 + 8 * nt + g];
        }
      }
      constexpr int NG = NKT < 8 ? NKT : 8;
#pragma unroll
      for (int ks = 0; ks < C / 8; ++ks) {
        const float* vr = Vp + (8 * ks + q) * PV + v0 + g;
        const FragA3 A = frag_a(vr[0], vr[8], vr[4 * PV], vr[4 * PV + 8]);
#pragma unroll
        for (int n0 = 0; n0 < NKT; n0 += NG) {
          FragB3 Bk[NG];
#pragma unroll
          for (int x = 0; x < NG; ++x) {
            const float f = suf[ks / 2][n0 + x];
            const float* kr = Kq + (8 * ks + q) * PR + key0 + 8 * (n0 + x) + g;
            Bk[x] = frag_b(kr[0] * f, kr[4 * PR] * f);
          }
#pragma unroll
          for (int ps = 0; ps < 3; ++ps)
#pragma unroll
            for (int x = 0; x < NG; ++x)
              mma3_pass(ps, U[n0 + x], A, Bk[x]);
        }
      }
    };

#pragma unroll 1
    for (int part = 0; part < 2; ++part) {
      if ((part == 0) == (warp % 2 == 0))
        state_products();
      else if (!state_pass)
        diagonal();
    }
    if (!state_pass) pairs();
    __syncthreads();  // A is whole (its diagonal blocks' partials in Ad)

    // 3. y += A V (the diagonal blocks' slice partials added into the A
    // fragments), S = P(0, C) S + U, then y out. Sub-chunk i's A V (2 i + 2
    // k-steps) goes to key group (i ^ i / 2) % KW: at KW 2 and NS 4 that is
    // {0, 3} and {1, 2}, 10 k-steps each.
    auto av_owner = [](int i) { return (i ^ (i >> 1)) % KW; };
    if (holds) {
#pragma unroll 1
      for (int ks = 0; ks < (state_pass ? 0 : 2 * NS); ++ks) {
        FragB3 Bv[2];
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
          const float* vr = Vp + (8 * ks + q) * PV + v0 + 8 * nt + g;
          Bv[nt] = frag_b(vr[0], vr[4 * PV]);
        }
        FragA3 A[NS];
#pragma unroll
        for (int i = 0; i < NS; ++i)
          if (2 * i + 1 >= ks && av_owner(i) == kw) {
            const float* ar = Am + (16 * i + g) * PA + 8 * ks + q;
            float x[4] = {ar[0], ar[8 * PA], ar[4], ar[8 * PA + 4]};
            if constexpr (K::KS > 1) {
              if (ks / 2 == i) {  // a diagonal block: add the other slices
                const int cc = 8 * ks + q - 16 * i;
#pragma unroll
                for (int sl = 1; sl < K::KS; ++sl) {
                  const float* ad = Ad + ((sl - 1) * NS + i) * 256 + g * 16 + cc;
                  x[0] += ad[0];
                  x[1] += ad[128];
                  x[2] += ad[4];
                  x[3] += ad[132];
                }
              }
            }
            A[i] = frag_a(x[0], x[1], x[2], x[3]);
          }
#pragma unroll
        for (int ps = 0; ps < 3; ++ps)
#pragma unroll
          for (int i = 0; i < NS; ++i)
            if (2 * i + 1 >= ks && av_owner(i) == kw)
#pragma unroll
              for (int nt = 0; nt < 2; ++nt)
                mma3_pass(ps, yacc[i][nt], A[i], Bv[nt]);
      }
#pragma unroll
      for (int nt = 0; nt < NKT; ++nt) {
        const int kk = key0 + 8 * nt + 2 * q;
        float2 dd = make_float2(1.f, 1.f);
#pragma unroll
        for (int gs = 0; gs < NS; ++gs) {
          const float2 t2 = ld2(Tg + gs * HD + kk);
          dd.x *= t2.x;
          dd.y *= t2.y;
        }
        S[nt][0] = fmaf(S[nt][0], dd.x, U[nt][0]);
        S[nt][1] = fmaf(S[nt][1], dd.y, U[nt][1]);
        S[nt][2] = fmaf(S[nt][2], dd.x, U[nt][2]);
        S[nt][3] = fmaf(S[nt][3], dd.y, U[nt][3]);
        Dacc[nt][0] *= dd.x;
        Dacc[nt][1] *= dd.y;
      }
      float* red = K::kRedInStage ? stage(st) : smem + K::oRed;
#pragma unroll
      for (int i = 0; i < NS; ++i)
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
          const int col = v0 + 8 * nt + 2 * q;
#pragma unroll
          for (int hf = 0; hf < 2; ++hf) {
            const int t = 16 * i + g + 8 * hf;
            if constexpr (state_pass) continue;  // pass 0: no y
            if constexpr (KW == 1) {
              if (t < n && col < HD)
                st2(a.y + ((static_cast<long long>(b) * a.yT + t0 + t) * a.H +
                           h) * HD + col,
                    yacc[i][nt][2 * hf], yacc[i][nt][2 * hf + 1]);
            } else {
              st2(red + (kw * C + t) * K::PY + col, yacc[i][nt][2 * hf],
                  yacc[i][nt][2 * hf + 1]);
            }
          }
        }
    }
    // the next chunk's prep (CUDA cores, shared memory) beside this one's
    // A V (tensor cores) in the other warps
    if (c + 1 < nch) prep(c + 1);
    if (KW > 1 && !state_pass) {  // y = the key groups' partials summed
      __syncthreads();
      const float* red = K::kRedInStage ? stage(st) : smem + K::oRed;
      for (int idx = tid; idx < n * (HD / 2); idx += NT) {
        const int t = idx / (HD / 2);
        const int col = 2 * (idx % (HD / 2));
        float2 acc = ld2(red + t * K::PY + col);
#pragma unroll
        for (int kg = 1; kg < KW; ++kg) {
          const float2 x = ld2(red + (kg * C + t) * K::PY + col);
          acc.x += x.x;
          acc.y += x.y;
        }
        st2(a.y + ((static_cast<long long>(b) * a.yT + t0 + t) * a.H + h) *
                      HD + col,
            acc.x, acc.y);
      }
    }
    __syncthreads();  // the stage and A are free, the next chunk's prep is in
    if (c + kBufs < nch) load_chunk(st, c + kBufs);
  }

  // the steps past the last whole chunk: their inputs copied into the
  // ring's first stage (free: every chunk is read; tail < C steps fit one
  // stage) while the state goes out
  const bool tail = !state_pass && a.tail > 0 && seg == a.nseg - 1;
  if (tail) stage_steps<HD>(a, b, h, T, a.tail, stage(0), tid, NT);
  // the state out: pass 0's segment end states and decays; pass 1's last
  // segment ends the head, or leaves the state in the ring's second stage
  // for the streamed steps
  float* out = state_pass ? a.seg_state + (bh * a.nseg + seg) * HD * HD
               : seg != a.nseg - 1 ? nullptr
               : tail              ? stage(1)
                                   : a.sfin + bh * HD * HD;
  if (holds && out != nullptr) {
#pragma unroll
    for (int nt = 0; nt < NKT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int val = v0 + g + (e >> 1) * 8;
        const int key = key0 + 8 * nt + 2 * q + (e & 1);
        if (val < HD) out[key * HD + val] = S[nt][e];
      }
    if (state_pass && v0 == 0 && g == 0) {
      float* dout = a.seg_decay + (bh * a.nseg + seg) * HD;
#pragma unroll
      for (int nt = 0; nt < NKT; ++nt) {
        dout[key0 + 8 * nt + 2 * q] = Dacc[nt][0];
        dout[key0 + 8 * nt + 2 * q + 1] = Dacc[nt][1];
      }
    }
  }
  if (tail) {  // streamed from that state as wkv6_stream_kernel does
    __syncthreads();  // the state is whole
    stream_steps<HD>(a, b, h, T, a.tail, stage(1), stage(0), tid, [] {
      kern::cp_async_wait<0>();
      __syncthreads();
    });
  }
}

// ---------------------------------------------------------------------------
// the state-streaming kernel: a block a (b, h), every step staged at once
// ---------------------------------------------------------------------------
template <int HD>
__global__ void __launch_bounds__(Stream<HD>::NT)
    wkv6_stream_kernel(const Args a) {
  extern __shared__ float4 smem4[];
  float* sin = reinterpret_cast<float*>(smem4);  // [T][r, k, w, v][HD]
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  stage_steps<HD>(a, b, h, 0, a.T, sin, threadIdx.x, Stream<HD>::NT);
  stream_steps<HD>(a, b, h, 0, a.T,
                   a.s0 + (static_cast<long long>(b) * a.H + h) * HD * HD,
                   sin, threadIdx.x, [] {
    kern::cp_async_wait<0>();
    __syncthreads();
  });
}

// ---------------------------------------------------------------------------
// host
// ---------------------------------------------------------------------------
// Raise the dynamic shared-memory limit of `fn` to `smem` once per device
// (`ready` marks the devices done).
template <typename F>
cudaError_t allow_smem(F fn, int smem, unsigned* ready) {
  if (smem <= 48 * 1024) return cudaSuccess;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess || (dev < 32 && (*ready >> dev & 1u))) return err;
  err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  if (err == cudaSuccess && dev < 32) *ready |= 1u << dev;
  return err;
}

template <int HD>
cudaError_t launch_chunk(Args a, cudaStream_t s) {
  constexpr int NS = HD <= 64 ? kWholeNS : kWideNS;
  constexpr int NW = kWarps > HD / 16 ? kWarps : HD / 16;  // a value tile a warp
  using K = Chunk<HD, NS, NW>;
  static unsigned ready = 0, ready0 = 0;
  cudaError_t err =
      allow_smem(wkv6_chunk_kernel<HD, NS, NW, false>, K::kSmem, &ready);
  if (err != cudaSuccess) return err;
  CUtensorMap m[4] = {};
  const void* src[4] = {a.r, a.k, a.v, a.w};
  bool ok = a.T > 0;
  for (int x = 0; x < 4 && ok; ++x)
    ok = kern::cached_map(&m[x], src[x], 0, a.B, a.T, a.H, HD, a.sb[x],
                          a.st[x], a.sh[x], HD, K::C, false);
  a.aligned = ok ? 1 : 0;
  // time segments of whole chunks (at most the nseg asked for): pass 0 for
  // their states, then pass 1
  a.seg_len = ((a.T + a.nseg - 1) / a.nseg + K::C - 1) / K::C * K::C;
  if (a.seg_len == 0) a.seg_len = K::C;
  a.nseg = a.T > 0 ? (a.T + a.seg_len - 1) / a.seg_len : 1;
  const dim3 grid(1, a.H, a.B * a.nseg);
  if (a.nseg > 1) {
    err = allow_smem(wkv6_chunk_kernel<HD, NS, NW, true>, K::kSmem, &ready0);
    if (err != cudaSuccess) return err;
    wkv6_chunk_kernel<HD, NS, NW, true><<<grid, K::NT, K::kSmem, s>>>(
        a, m[0], m[1], m[2], m[3]);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  wkv6_chunk_kernel<HD, NS, NW, false><<<grid, K::NT, K::kSmem, s>>>(
      a, m[0], m[1], m[2], m[3]);
  return cudaGetLastError();
}

template <int HD>
cudaError_t launch_stream(const Args& a, cudaStream_t s) {
  static unsigned ready = 0;
  const long long smem = static_cast<long long>(a.T) * Stream<HD>::ROW * 4;
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  cudaError_t err = smem > 48 * 1024
                        ? allow_smem(wkv6_stream_kernel<HD>, kMaxSmem, &ready)
                        : cudaSuccess;
  if (err != cudaSuccess) return err;
  wkv6_stream_kernel<HD><<<dim3(a.H, a.B), Stream<HD>::NT,
                           static_cast<int>(smem), s>>>(a);
  return cudaGetLastError();
}

}  // namespace

// float32 only. r, k, v, w are (B, T, H, hd) with a contiguous head dim and
// the (b, t, h) strides, in elements, in `strides` (a host array of 12:
// r's three, then k's, v's and w's); u (H, hd), state, y and sfin are
// contiguous, state, y and sfin 16-byte aligned. hd is one of 8, 16, 32, 64,
// 128. `chunked` picks the chunked kernel over the streaming one, with each
// head's steps in up to `nseg` time segments of whole chunks (nseg > 1:
// seg_state and seg_decay hold B * H * nseg * hd * hd and B * H * nseg * hd
// floats).
// Returns cudaGetLastError() of the launch (0 on success).
extern "C" int wkv6_launch(const float* r, const float* k, const float* v,
                           const float* w, const float* u, const float* s0,
                           float* y, float* sfin, int B, int T, int H, int hd,
                           const long long* strides, int chunked, int nseg,
                           float* seg_state, float* seg_decay, void* stream) {
  if (B < 1 || T < 0 || H < 1 || B > 65535 || H > 65535 ||
      reinterpret_cast<uintptr_t>(y) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(s0) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(sfin) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (chunked && (nseg < 1 || B * nseg > 65535 ||
                  nseg > 1 && (seg_state == nullptr || seg_decay == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  Args a{r, k, v, w, u, s0, y, sfin, B, T, H, 0, T, {}, {}, {},
         nseg, 0, seg_state, seg_decay, 0, 1};
  const float* src[4] = {r, k, v, w};
  for (int x = 0; x < 4; ++x) {
    a.sb[x] = strides[3 * x];
    a.st[x] = strides[3 * x + 1];
    a.sh[x] = strides[3 * x + 2];
    if (reinterpret_cast<uintptr_t>(src[x]) % 16 != 0 || a.sb[x] % 4 != 0 ||
        a.st[x] % 4 != 0 || a.sh[x] % 4 != 0)
      a.vec = 0;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  auto streamed = [&](const Args& x) {
    switch (hd) {
      case 8: return launch_stream<8>(x, s);
      case 16: return launch_stream<16>(x, s);
      case 32: return launch_stream<32>(x, s);
      case 64: return launch_stream<64>(x, s);
      case 128: return launch_stream<128>(x, s);
    }
    return cudaErrorInvalidValue;
  };
  // The chunked kernel takes the whole chunks and streams the steps past
  // the last one from the state they leave, as the streaming kernel does
  // (stream_steps in both). So a
  // call's last steps, and a later call that continues from its state, run
  // the same per-step arithmetic: [C; Q] in one call and C, then Q from C's
  // state, give the same y for Q, bit for bit, as the plain scan does.
  const int C = 16 * (hd <= 64 ? kWholeNS : kWideNS);
  if (!chunked || T < C) return static_cast<int>(streamed(a));
  a.tail = T % C;
  a.T = T - a.tail;
  switch (hd) {
    case 8: err = launch_chunk<8>(a, s); break;
    case 16: err = launch_chunk<16>(a, s); break;
    case 32: err = launch_chunk<32>(a, s); break;
    case 64: err = launch_chunk<64>(a, s); break;
    case 128: err = launch_chunk<128>(a, s); break;
  }
  return static_cast<int>(err);
}
