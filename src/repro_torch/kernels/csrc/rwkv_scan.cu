// RWKV6 WKV recurrence with the state kept on chip, for sm_90a.
//
// Replaces the Pallas kernel src/repro/kernels/rwkv_scan.py (_wkv_kernel).
// Per (batch row, head), with the state S (key x value, HD x HD):
//     y_t = r_t . (S + diag(u) k_t v_t^T)        (a vector over value columns)
//     S  <- diag(w_t) S + k_t v_t^T
//
// Bound: device memory sees one read of r, k, v, w and one write of y per
// token (at B 4, T 2048, 32 heads of 64: 336 MB, 101 us at 3.35 TB/s), and
// 5 float32 flops per (token, head, key, value) (80 us at 67 TFLOP/s). The
// recurrence is serial in t, so what the kernel fights is the issue rate
// and the latency of each step, with enough blocks to fill 132 SMs.
// Design:
//  * Value columns split across blocks. Column j of S and y_t[j] depend
//    only on v's column j, so (b, h) splits into HD / JB blocks of JB = 32
//    columns (HD at HD <= 32); the grid is (HD / JB, H, B), the column
//    blocks of a head adjacent, so their repeated reads of r, k and w come
//    from L2 and device memory sees about one. At B*H = 128 and HD 64 that
//    is 256 blocks of 128 threads, two per SM.
//  * Register tiles. A thread holds a 4-key x 4-column tile of S (keys
//    4*kg.., columns 4*cg..); per step it reads r, k and w of its keys and
//    v of its columns as four float4 from shared memory, so each value read
//    feeds four columns or four keys: 16 FMAs of y, 16 multiplies and 16
//    FMAs of the state update, 8 for its share of the u term
//    (y_j = sum_i r_i S_ij + v_j sum_i r_i u_i k_i, the same function
//    with the bonus term summed once per key instead of per element; S
//    keeps the reference's update S_ij <- w_i S_ij + k_i v_j exactly).
//  * y off the step's critical path. Each thread writes its partial y of
//    its four columns (a float4) to shared memory, and the HD / 4 key
//    groups' partials are summed once per chunk, in the pass that writes
//    y with coalesced 16-byte stores; a step's critical path is then a
//    shared load, a 5-deep FMA chain and a store. (A shuffle
//    reduce-scatter on every step, 5 dependent shuffles at HD 64, was
//    slower: PERF.md.) Steps run in groups of 8 with no branch between
//    them: the group's shared loads first, then its steps, then its stores
//    (a store to shared memory may alias the next loads, so a step at a
//    time would wait a load latency behind the last one's store).
//  * Overlapped chunk loads. r, k, w (all keys) and v (the block's
//    columns) of 16 steps form a chunk; a ring of 4 chunks in dynamic
//    shared memory is filled with 16-byte cp.async, chunks c+1..c+3 in
//    flight while chunk c's steps run. Inputs whose bases or strides are
//    not 16-byte multiples are staged by plain loads through the same
//    buffers.
//  * Not taken: the chunked matrix form (GLA-style intra-chunk products on
//    tensor cores). TF32 cannot hold the 1e-4 parity gate, and the products
//    of w over a chunk (w = sigmoid(x), mean 0.5) under- and overflow the
//    k / A factors of that form.
#include "common.cuh"

namespace {

constexpr int kRPT = 4;   // keys per thread
constexpr int kCPT = 4;   // value columns per thread
constexpr int kCH = 16;   // time steps per staged chunk
constexpr int kU = 8;     // steps per group of loads (divides kCH)
constexpr int kBufs = 4;  // chunks in the ring: 3 in flight
static_assert(kRPT % 4 == 0, "keys are read as float4");

struct Args {
  const float* r;
  const float* k;
  const float* v;
  const float* w;
  const float* u;   // (H, HD) contiguous
  const float* s0;  // (B, H, HD, HD) contiguous
  float* y;         // (B, T, H, HD) contiguous
  float* sfin;      // (B, H, HD, HD) contiguous
  int B, T, H, aligned;
  long long sb[4], st[4], sh[4];  // strides of r, k, v, w (head dim is 1)
};

// Shape of the kernel for one head dim: columns per block, key groups and
// column groups (threads = key groups x column groups), the padded row of
// the partial sums, shared floats.
template <int HD>
struct Wkv {
  static constexpr int JB = HD < 32 ? HD : 32;
  static constexpr int TK = HD / kRPT;
  static constexpr int TC = JB / kCPT;
  static constexpr int NT = TK * TC;
  static constexpr int PJ = JB + 4;  // a key group's row of partial y
  static constexpr int BUF = kCH * (3 * HD + JB);  // r, k, w, v of a chunk
  static constexpr int kFloats = kBufs * BUF + kCH * TK * PJ;  // + partials
};

template <int HD>
__global__ void __launch_bounds__(Wkv<HD>::NT) wkv6_kernel(Args a) {
  using W = Wkv<HD>;
  constexpr int JB = W::JB;
  constexpr int TK = W::TK;
  constexpr int PJ = W::PJ;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  // partial y of each step and key group: [kCH][TK][PJ] (rows padded so a
  // quarter-warp's 16-byte stores fall in distinct banks)
  float* part = smem + kBufs * W::BUF;
  // chunk buffer x: r, k, w as [kCH][HD], then v as [kCH][JB]
  auto sx = [&](int buf, int x) { return smem + buf * W::BUF + x * kCH * HD; };

  const int jb = blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int j0 = jb * JB;
  const int tid = threadIdx.x;
  const int kg = tid % TK;  // keys kg*kRPT .. +kRPT-1
  const int cg = tid / TK;  // columns j0 + cg*4 .. +3
  const long long bh = static_cast<long long>(b) * a.H + h;

  float S[kRPT][kCPT];
  float uu[kRPT];
#pragma unroll
  for (int i = 0; i < kRPT; ++i) {
    const int key = kg * kRPT + i;
    uu[i] = a.u[h * HD + key];
#pragma unroll
    for (int c = 0; c < kCPT; ++c)
      S[i][c] = a.s0[(bh * HD + key) * HD + j0 + cg * kCPT + c];
  }

  const float* src[4] = {a.r, a.k, a.w, a.v};
  const int srcx[4] = {0, 1, 3, 2};  // index of r, k, w, v in a.sb/st/sh
  // stage steps [t0, t0 + n) of r, k, w (all keys) and v (the block's
  // columns) into buffer buf: 16-byte cp.async, or plain loads
  auto issue = [&](int buf, int t0) {
    const int n = min(kCH, a.T - t0);
#pragma unroll
    for (int x = 0; x < 4; ++x) {
      const int cols = x < 3 ? HD : JB;
      const int off = x < 3 ? 0 : j0;
      const int nv = n * cols / 4;
      const int sx_ = srcx[x];
      const float* base =
          src[x] + b * a.sb[sx_] + t0 * a.st[sx_] + h * a.sh[sx_] + off;
      float* dst = sx(buf, x);
      for (int idx = tid; idx < nv; idx += W::NT) {
        const int t = idx / (cols / 4);
        const int c4 = (idx % (cols / 4)) * 4;
        const float* g = base + t * a.st[sx_] + c4;
        float* s = dst + t * cols + c4;
        if (a.aligned) {
          kern::cp_async16(s, g);
        } else {
          *reinterpret_cast<float4*>(s) =
              make_float4(g[0], g[1], g[2], g[3]);
        }
      }
    }
    kern::cp_async_commit();
  };

  // a ring of kBufs chunks: kBufs - 1 in flight while one is used (one
  // group of copies per chunk, empty past the end, so the count is fixed)
  const int nch = (a.T + kCH - 1) / kCH;
#pragma unroll
  for (int c = 0; c < kBufs - 1; ++c) {
    if (c < nch)
      issue(c, c * kCH);
    else
      kern::cp_async_commit();
  }
  for (int ch = 0; ch < nch; ++ch) {
    const int t0 = ch * kCH;
    const int n = min(kCH, a.T - t0);
    const int ahead = ch + kBufs - 1;
    if (ahead < nch)
      issue(ahead % kBufs, ahead * kCH);  // overlaps this chunk's steps
    else
      kern::cp_async_commit();
    kern::cp_async_wait<kBufs - 1>();  // this thread's copies of chunk ch
    __syncthreads();                   // everyone's
    const int buf = ch % kBufs;
    const float* sr = sx(buf, 0);
    const float* sk = sx(buf, 1);
    const float* sw = sx(buf, 2);
    const float* sv = sx(buf, 3);
    // kU steps at a time: every shared load of the group first, then the
    // steps, then the stores of their partial y (a store may alias the
    // next loads, so a step at a time would wait a load latency behind the
    // last one's store). `lim` live steps of the group: kU (a constant once
    // inlined, so a full chunk's groups carry no branch between steps) or
    // fewer in the last chunk.
    auto group = [&](int g0, int lim) {
      // each thread's keys and columns as float4: kRPT / 4 of r, k and w
      float4 r4[kU][kRPT / 4], k4[kU][kRPT / 4], w4[kU][kRPT / 4], v4[kU];
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        const int tt = g0 + u;  // past lim: stale values, never used
#pragma unroll
        for (int q = 0; q < kRPT / 4; ++q) {
          const int off = tt * HD + kg * kRPT + 4 * q;
          r4[u][q] = *reinterpret_cast<const float4*>(sr + off);
          k4[u][q] = *reinterpret_cast<const float4*>(sk + off);
          w4[u][q] = *reinterpret_cast<const float4*>(sw + off);
        }
        v4[u] = *reinterpret_cast<const float4*>(sv + tt * JB + cg * 4);
      }
      float4 y4[kU];
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        if (u >= lim) break;  // uniform over the block
        float rr[kRPT], kk[kRPT], ww[kRPT];
#pragma unroll
        for (int q = 0; q < kRPT / 4; ++q) {
          kern::split4(r4[u][q], rr + 4 * q);
          kern::split4(k4[u][q], kk + 4 * q);
          kern::split4(w4[u][q], ww + 4 * q);
        }
        const float vv[kCPT] = {v4[u].x, v4[u].y, v4[u].z, v4[u].w};
        // this thread's share of sum_i r_i u_i k_i
        float ruk = 0.f;
#pragma unroll
        for (int i = 0; i < kRPT; ++i) ruk = fmaf(rr[i] * uu[i], kk[i], ruk);
        float y[kCPT];
#pragma unroll
        for (int c = 0; c < kCPT; ++c) {
          float x = vv[c] * ruk;
#pragma unroll
          for (int i = 0; i < kRPT; ++i) x = fmaf(rr[i], S[i][c], x);
          y[c] = x;
        }
        y4[u] = make_float4(y[0], y[1], y[2], y[3]);
#pragma unroll
        for (int i = 0; i < kRPT; ++i)
#pragma unroll
          for (int c = 0; c < kCPT; ++c)
            S[i][c] = fmaf(ww[i], S[i][c], kk[i] * vv[c]);
      }
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        if (u >= lim) break;
        *reinterpret_cast<float4*>(part + ((g0 + u) * TK + kg) * PJ +
                                   cg * 4) = y4[u];
      }
    };
    if (n == kCH) {
      for (int g0 = 0; g0 < kCH; g0 += kU) group(g0, kU);
    } else {
      for (int g0 = 0; g0 < n; g0 += kU) group(g0, min(kU, n - g0));
    }
    __syncthreads();  // the chunk's partials are in; its buffer is free
    // y_t[j] = the sum of the TK key groups' partials, written as float4
    float* yb = a.y + ((static_cast<long long>(b) * a.T + t0) * a.H + h) * HD +
                j0;
    for (int idx = tid; idx < n * JB / 4; idx += W::NT) {
      const int tt = idx / (JB / 4);
      const int c4 = (idx % (JB / 4)) * 4;
      const float* pp = part + tt * TK * PJ + c4;
      float4 acc = *reinterpret_cast<const float4*>(pp);
#pragma unroll
      for (int g = 1; g < TK; ++g) {
        const float4 x = *reinterpret_cast<const float4*>(pp + g * PJ);
        acc.x += x.x;
        acc.y += x.y;
        acc.z += x.z;
        acc.w += x.w;
      }
      *reinterpret_cast<float4*>(yb + static_cast<long long>(tt) * a.H * HD +
                                 c4) = acc;
    }
    // the next chunk's steps write the partials only after the
    // __syncthreads() that follows its wait, so these reads are done
  }
  kern::cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < kRPT; ++i) {
    const int key = kg * kRPT + i;
#pragma unroll
    for (int c = 0; c < kCPT; ++c)
      a.sfin[(bh * HD + key) * HD + j0 + cg * kCPT + c] = S[i][c];
  }
}

template <int HD>
cudaError_t launch(const Args& a, cudaStream_t s) {
  using W = Wkv<HD>;
  const int smem = W::kFloats * 4;
  cudaError_t err = cudaFuncSetAttribute(
      wkv6_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  wkv6_kernel<HD><<<dim3(HD / W::JB, a.H, a.B), W::NT, smem, s>>>(a);
  return cudaGetLastError();
}

}  // namespace

// float32 only. r, k, v, w are (B, T, H, hd) with a contiguous head dim and
// the (b, t, h) strides, in elements, in `strides` (a host array of 12:
// r's three, then k's, v's and w's); u (H, hd), state, y and sfin are
// contiguous, y 16-byte aligned. hd is one of 8, 16, 32, 64, 128. Returns
// cudaGetLastError() of the launch (0 on success).
extern "C" int wkv6_launch(const float* r, const float* k, const float* v,
                           const float* w, const float* u, const float* s0,
                           float* y, float* sfin, int B, int T, int H, int hd,
                           const long long* strides, void* stream) {
  if (B < 1 || T < 0 || H < 1 || B > 65535 || H > 65535 ||
      reinterpret_cast<uintptr_t>(y) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  Args a{r, k, v, w, u, s0, y, sfin, B, T, H, 1, {}, {}, {}};
  const float* src[4] = {r, k, v, w};
  for (int x = 0; x < 4; ++x) {
    a.sb[x] = strides[3 * x];
    a.st[x] = strides[3 * x + 1];
    a.sh[x] = strides[3 * x + 2];
    if (reinterpret_cast<uintptr_t>(src[x]) % 16 != 0 || a.sb[x] % 4 != 0 ||
        a.st[x] % 4 != 0 || a.sh[x] % 4 != 0)
      a.aligned = 0;  // staged by plain loads
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 8: return static_cast<int>(launch<8>(a, s));
    case 16: return static_cast<int>(launch<16>(a, s));
    case 32: return static_cast<int>(launch<32>(a, s));
    case 64: return static_cast<int>(launch<64>(a, s));
    case 128: return static_cast<int>(launch<128>(a, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
