// Blocked prefill attention with the fused KVComm context mass, for sm_90a.
//
// Replaces the Pallas kernel src/repro/kernels/flash_attention.py
// (_flash_kernel). KV rows [0, context_len) are the sender prefix at
// absolute positions [0, context_len); the self rows sit at q_offset + j,
// and query row i at q_offset + i. Query row i attends KV row c when
//     (!causal || kv_pos(c) <= q_pos(i))  and  (window < 0 || q_pos(i) - kv_pos(c) < window)
// and only real rows and columns take part: unlike the Pallas kernel (which
// is handed block-padded lengths), no padding can leak into a row. The
// optional mass output is, per (b, q head, query row), the softmax mass the
// row puts on the context prefix (the paper's Eq. (1)), normalised by the
// row's own denominator; rows that attend nothing give zeros (out and mass).
//
// Bound: 4*D flops per attended (query row, KV column, q head) against the
// bytes of q, k, v and out once: a prefill of thousands of tokens is bound
// by operations (989 TFLOP/s in bf16 on the tensor cores), a short query
// over a long prefix by bytes.
//
// bf16 / fp16 (flash_attention_tc_kernel): only wgmma reaches the tensor
// cores' rate (the CUDA cores in float32 give 67 TFLOP/s at most, 7% of
// it), only TMA and a ring keep tiles arriving while products run, and a
// short query over a long context fills few blocks unless its KV range is
// split. This design:
//  * Packs GQA rows: a block's 64-row M tile holds packed rows r = i*G + g
//    (query row i, head g of KV head hk's group), so each K/V tile is read
//    once per KV head; masks use the query row's position.
//  * Loads K/V tiles of BN = 64 positions (32 above D 192) by TMA (4-D
//    tensor maps over (D, Hkv, S, B), boxes of 64 head values, 128-byte
//    swizzle, zero fill past D and S) into a 2-stage ring signalled on
//    mbarriers (the map and barrier helpers in tma.cuh, which K3 shares):
//    one producer warp issues the loads, one consumer warpgroup computes.
//    The Q tile is loaded once with 16-byte loads into the same
//    swizzled layout.
//  * Runs S = Q K^T as wgmma m64nBNk16 with Q and K in shared memory, the
//    online softmax (base 2, float32) on the accumulator's registers, and
//    O += P V as wgmma m64nDPk16 with P converted to bf16/fp16 in registers
//    (the accumulator layout of 16 columns is the A fragment) and V read
//    transposed from shared memory. P goes in as a 16-bit high part plus
//    the 16-bit rounding of its residual, two products on one V tile: P
//    rounded once (2^-9 relative) put a causal prefill's early rows, whose
//    output is a short sum of large values, 2.3x past the element-wise
//    bf16 gate; the residual costs half again the products and keeps P to
//    ~2^-17.
//  * Skips KV tiles outside the causal or window band before loading them
//    (tile_live; tiles run heaviest first) and masks only tiles that are not
//    wholly inside it (tile_full), on real lengths: rows past Sq and the
//    zero-filled positions past Skv never take part.
//  * Rescales the Eq. (1) context mass with the same alpha as l.
//  * Splits the KV tiles of each query tile over nsplit blocks when the
//    grid would be small (the wrapper's choice, from the SM count); the
//    float32 (o, m, l, mass) partials are merged by a second kernel of the
//    same launch with the log-sum-exp step K1 shares (common.cuh:
//    lse_scale).
// Not done yet: two consumer warpgroups, overlap of the softmax with the
// next tile's products, a persistent grid.
//
// float32 (flash_attention_kernel, unchanged): wgmma takes no float32
// operands and TF32 would not hold float32 parity, so float32 keeps the
// CUDA-core kernel: one block per (query tile of kBQ rows, q head, batch
// row), tiles heaviest first under a causal mask. K and V tiles of BK rows
// are staged through shared memory (converted to float32, rows padded by
// one word against bank conflicts) one after the other in one buffer; 256
// threads as a 16 x 16 grid each own kTM query rows x (BK / 16) columns of
// the score tile and kTM rows x DPT head-dim columns of the float32
// accumulator (rows and columns strided by 16, so a half-warp reads 16
// banks). Each row keeps an online softmax (m, l) and the context-mass
// accumulator, rescaled with the same alpha as the output; row statistics
// reduce over the 16 lanes of a half-warp with shuffles. KV tiles wholly
// outside the causal or window band are skipped before they are loaded.
#include <climits>
#include <cstdint>

#include "common.cuh"
#include "tma.cuh"
#include "wgmma.cuh"

namespace {

using kern::from_f;
using kern::kNegInf;
using kern::make_map;
using kern::mbar_arrive;
using kern::mbar_expect_tx;
using kern::mbar_init;
using kern::mbar_wait;
using kern::pack2;
using kern::smem_u32;
using kern::tma_load;
using kern::to_f;
using kern::unpack2;

constexpr int kBQ = 64;        // query rows per block
constexpr int kThreads = 256;  // a 16 x 16 thread grid
constexpr int kTM = kBQ / 16;  // query rows per thread

struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* out;
  float* mass;  // (B, Hq, Sq) float32, or null
  int B, Sq, Skv, Hq, Hkv, D, context_len, q_offset, causal, window;
  long long q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh;
  long long o_sb, o_ss, o_sh;
  float scale;
};

// kv_pos, allowed and tile_live serve both paths (Args and TcArgs).
template <class A>
__device__ __forceinline__ int kv_pos(const A& a, int c) {
  return c < a.context_len ? c : a.q_offset + (c - a.context_len);
}

template <class A>
__device__ __forceinline__ bool allowed(const A& a, int row, int col) {
  if (row >= a.Sq || col >= a.Skv) return false;
  const int qp = a.q_offset + row;
  const int kp = kv_pos(a, col);
  if (a.causal && kp > qp) return false;
  if (a.window >= 0 && qp - kp >= a.window) return false;
  return true;
}

// Whether any (row, col) of the query rows [r0, r1) and KV rows [c0, c1)
// can be attended. kv_pos is increasing on each of the two segments, so
// its extremes over the tile sit at the segment ends.
template <class A>
__device__ __forceinline__ bool tile_live(const A& a, int r0, int r1,
                                          int c0, int c1) {
  const int qmin = a.q_offset + r0;
  const int qmax = a.q_offset + r1 - 1;
  int kmin = INT_MAX;
  int kmax = INT_MIN;
  if (c0 < a.context_len) {
    kmin = min(kmin, c0);
    kmax = max(kmax, min(c1, a.context_len) - 1);
  }
  if (c1 > a.context_len) {
    kmin = min(kmin, kv_pos(a, max(c0, a.context_len)));
    kmax = max(kmax, kv_pos(a, c1 - 1));
  }
  if (a.causal && kmin > qmax) return false;
  if (a.window >= 0 && qmin - kmax >= a.window) return false;
  return true;
}

// Stage rows [c0, c0 + rows) of a (B, S, H, D) tensor's (b, h) slice into
// dst (rows x ld floats); rows past S are zeros.
template <typename T>
__device__ __forceinline__ void stage(float* dst, const T* src, long long ss,
                                      int c0, int rows, int S, int D, int ld) {
  for (int idx = threadIdx.x; idx < rows * D; idx += kThreads) {
    const int r = idx / D;
    const int c = idx % D;
    const int row = c0 + r;
    dst[r * ld + c] = row < S ? to_f(src[row * ss + c]) : 0.f;
  }
}

// DPT: head-dim columns per thread (D <= 16 * DPT); BK: KV rows per tile.
template <typename T, int DPT, int BK>
__global__ void __launch_bounds__(kThreads)
    flash_attention_kernel(Args a) {
  constexpr int TN = BK / 16;  // score columns per thread
  extern __shared__ float smem[];
  const int D = a.D;
  const int LD = D + 1;
  const int LP = BK + 1;
  float* sq = smem;            // kBQ x LD
  float* skv = sq + kBQ * LD;  // BK x LD: the K tile, then the V tile
  float* sp = skv + BK * LD;   // kBQ x LP: probabilities

  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  const int nq = gridDim.x;
  const int qt = nq - 1 - static_cast<int>(blockIdx.x);  // heaviest first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (a.Hq / a.Hkv);
  const int r0 = qt * kBQ;
  const int r1 = min(r0 + kBQ, a.Sq);

  const T* qp = static_cast<const T*>(a.q) + b * a.q_sb + h * a.q_sh;
  const T* kp = static_cast<const T*>(a.k) + b * a.k_sb + hk * a.k_sh;
  const T* vp = static_cast<const T*>(a.v) + b * a.v_sb + hk * a.v_sh;
  stage<T>(sq, qp + r0 * a.q_ss, a.q_ss, 0, kBQ, a.Sq - r0, D, LD);

  float acc[kTM][DPT];
  float m[kTM];
  float l[kTM];
  float ms[kTM];
#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
    ms[i] = 0.f;
#pragma unroll
    for (int c = 0; c < DPT; ++c) acc[i][c] = 0.f;
  }

  for (int c0 = 0; c0 < a.Skv; c0 += BK) {
    const int c1 = min(c0 + BK, a.Skv);
    if (!tile_live(a, r0, r1, c0, c1)) continue;  // uniform over the block
    __syncthreads();  // the previous V tile (and the Q stage) are done
    stage<T>(skv, kp, a.k_ss, c0, BK, a.Skv, D, LD);
    __syncthreads();

    float s[kTM][TN];
#pragma unroll
    for (int i = 0; i < kTM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float qv[kTM];
      float kv[TN];
#pragma unroll
      for (int i = 0; i < kTM; ++i) qv[i] = sq[(ty + 16 * i) * LD + d];
#pragma unroll
      for (int j = 0; j < TN; ++j) kv[j] = skv[(tx + 16 * j) * LD + d];
#pragma unroll
      for (int i = 0; i < kTM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) s[i][j] += qv[i] * kv[j];
    }

    float alpha[kTM];
#pragma unroll
    for (int i = 0; i < kTM; ++i) {
      const int row = r0 + ty + 16 * i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const int col = c0 + tx + 16 * j;
        s[i][j] = allowed(a, row, col) ? s[i][j] * a.scale : kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
      mx = kern::group_max<16>(mx);
      const float m_new = fmaxf(m[i], mx);
      alpha[i] = expf(m[i] - m_new);
      float rs = 0.f;
      float cs = 0.f;
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const int col = c0 + tx + 16 * j;
        const float p = s[i][j] > kNegInf ? expf(s[i][j] - m_new) : 0.f;
        rs += p;
        if (col < a.context_len) cs += p;
        sp[(ty + 16 * i) * LP + tx + 16 * j] = p;
      }
      rs = kern::group_sum<16>(rs);
      cs = kern::group_sum<16>(cs);
      l[i] = l[i] * alpha[i] + rs;
      ms[i] = ms[i] * alpha[i] + cs;
      m[i] = m_new;
    }
    __syncthreads();  // every thread is done with the K tile; P is written
    stage<T>(skv, vp, a.v_ss, c0, BK, a.Skv, D, LD);
    __syncthreads();

#pragma unroll
    for (int i = 0; i < kTM; ++i)
#pragma unroll
      for (int c = 0; c < DPT; ++c) acc[i][c] *= alpha[i];
#pragma unroll 4
    for (int j = 0; j < BK; ++j) {
      float pv[kTM];
      float vv[DPT];
#pragma unroll
      for (int i = 0; i < kTM; ++i) pv[i] = sp[(ty + 16 * i) * LP + j];
#pragma unroll
      for (int c = 0; c < DPT; ++c) {
        const int col = tx + 16 * c;
        vv[c] = col < D ? skv[j * LD + col] : 0.f;
      }
#pragma unroll
      for (int i = 0; i < kTM; ++i)
#pragma unroll
        for (int c = 0; c < DPT; ++c) acc[i][c] += pv[i] * vv[c];
    }
  }

  T* op = static_cast<T*>(a.out) + b * a.o_sb + h * a.o_sh;
#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    const int row = r0 + ty + 16 * i;
    if (row >= a.Sq) continue;
    const float inv = l[i] > 0.f ? 1.f / l[i] : 0.f;
#pragma unroll
    for (int c = 0; c < DPT; ++c) {
      const int col = tx + 16 * c;
      if (col < D) op[row * a.o_ss + col] = from_f<T>(acc[i][c] * inv);
    }
    if (a.mass != nullptr && tx == 0)
      a.mass[(static_cast<long long>(b) * a.Hq + h) * a.Sq + row] =
          ms[i] * inv;
  }
}

template <typename T, int DPT, int BK>
cudaError_t launch_k(const Args& a, cudaStream_t s) {
  const int smem =
      static_cast<int>(sizeof(float)) *
      (kBQ * (a.D + 1) + BK * (a.D + 1) + kBQ * (BK + 1));
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_kernel<T, DPT, BK>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.Sq + kBQ - 1) / kBQ, a.Hq, a.B);
  flash_attention_kernel<T, DPT, BK><<<grid, kThreads, smem, s>>>(a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const Args& a, cudaStream_t s) {
  if (a.D <= 16) return launch_k<T, 1, 64>(a, s);
  if (a.D <= 32) return launch_k<T, 2, 64>(a, s);
  if (a.D <= 64) return launch_k<T, 4, 64>(a, s);
  if (a.D <= 128) return launch_k<T, 8, 64>(a, s);
  return launch_k<T, 16, 32>(a, s);
}


// ---------------------------------------------------------------------------
// bf16 / fp16: tensor cores (wgmma) fed by TMA
// ---------------------------------------------------------------------------
constexpr int kTcRows = 64;      // packed (query row, head) rows per block
constexpr int kTcStages = 2;     // K/V ring depth
constexpr int kTcThreads = 160;  // one consumer warpgroup + a producer warp
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

struct TcArgs {
  const void* q;
  void* out;
  float* mass;  // (B, Hq, Sq), or null
  float* po;    // split partials (B, Hkv, nsplit, Sq*G, DP), or null
  float* pm;    // (B, Hkv, nsplit, Sq*G): max (natural log), denominator,
  float* pl;    // context mass
  float* pms;
  int B, Sq, Skv, Hq, Hkv, G, D, context_len, q_offset, causal, window;
  int nsplit, kt_per_split;
  long long q_sb, q_ss, q_sh, o_sb, o_ss, o_sh;
  float scale_log2;  // softmax scale * log2(e): scores live in base 2
};

// Head dim padded to whole 64-value column blocks, and KV tile rows: 64, or
// 32 above DP 192, where the output accumulator takes DP / 2 = 128
// registers a thread (the wrapper's kv_tile sizes its split the same way).
inline int tc_dp(int D) { return (D + 63) / 64 * 64; }
inline int tc_bn(int D) { return tc_dp(D) > 192 ? 32 : 64; }

// Shared-memory matrix descriptor with the 128-byte swizzle: start
// address, leading and stride byte offsets (16-byte units).
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) |
         (1ull << 62);
}


// Whether every (row, col) of the packed rows [r0, r0 + kTcRows) and KV
// rows [c0, c0 + BN) is attended, so the tile needs no mask.
__device__ __forceinline__ bool tile_full(const TcArgs& a, int r0, int c0,
                                          int bn) {
  if (r0 + kTcRows > a.Sq * a.G || c0 + bn > a.Skv) return false;
  const int qmin = a.q_offset + r0 / a.G;
  const int qmax = a.q_offset + (r0 + kTcRows - 1) / a.G;
  const int c1 = c0 + bn;
  int kmin = INT_MAX;
  int kmax = INT_MIN;
  if (c0 < a.context_len) {
    kmin = min(kmin, c0);
    kmax = max(kmax, min(c1, a.context_len) - 1);
  }
  if (c1 > a.context_len) {
    kmin = min(kmin, kv_pos(a, max(c0, a.context_len)));
    kmax = max(kmax, kv_pos(a, c1 - 1));
  }
  if (a.causal && kmax > qmin) return false;
  if (a.window >= 0 && qmax - kmin >= a.window) return false;
  return true;
}

// Shared memory of one block: the Q tile, then kTcStages (K, V) tiles, each
// DP / 64 column blocks of [rows][64 values] in the 128-byte swizzle (the
// layout a TMA box of 64 values writes), then the barriers.
template <int DP, int BN>
struct TcSmem {
  static constexpr int kQ = kTcRows * DP * 2;
  static constexpr int kKV = BN * DP * 2;
  static constexpr int kBars = kQ + 2 * kTcStages * kKV;
  static constexpr int kBytes = kBars + 2 * kTcStages * 8 + 1024;  // + align
};

// Grid (query tiles, Hkv, B * nsplit), 160 threads. Warps 0-3 (a
// warpgroup) compute; warp 4 issues the TMA loads.
template <typename T, int DP, int BN>
__global__ void __launch_bounds__(kTcThreads, DP > 128 ? 1 : 2)
    flash_attention_tc_kernel(const TcArgs a,
                              const __grid_constant__ CUtensorMap tmk,
                              const __grid_constant__ CUtensorMap tmv) {
  using L = TcSmem<DP, BN>;
  constexpr int NCB = DP / 64;  // 64-value column blocks
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;  // swizzle atoms: 1024 B
  unsigned char* smem = smem_raw + (base - raw);
  const uint32_t sQ = base;
  auto sK = [&](int st) { return base + L::kQ + (2 * st) * L::kKV; };
  auto sV = [&](int st) { return base + L::kQ + (2 * st + 1) * L::kKV; };
  auto full = [&](int st) { return base + L::kBars + 8 * st; };
  auto empty = [&](int st) {
    return base + L::kBars + 8 * (kTcStages + st);
  };

  const int nq = gridDim.x;
  const int qt = nq - 1 - static_cast<int>(blockIdx.x);  // heaviest first
  const int hk = blockIdx.y;
  const int b = blockIdx.z / a.nsplit;
  const int sp = blockIdx.z % a.nsplit;
  const int G = a.G;
  const int rtot = a.Sq * G;
  const int r0 = qt * kTcRows;
  const int r1 = min(r0 + kTcRows, rtot);
  const int i_lo = r0 / G;          // query rows the tile spans
  const int i_hi = (r1 - 1) / G + 1;
  const int nkt = (a.Skv + BN - 1) / BN;
  const int kt0 = sp * a.kt_per_split;
  const int kt1 = min(nkt, kt0 + a.kt_per_split);
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;

  if (tid == 0) {
    for (int st = 0; st < kTcStages; ++st) {
      mbar_init(full(st), 1);
      mbar_init(empty(st), 128);
    }
    kern::mbar_init_fence();
  }
  __syncthreads();

  if (warp == 4) {  // producer: one lane keeps the ring full
    if (lane == 0) {
      int it = 0;
      for (int kt = kt0; kt < kt1; ++kt) {
        const int c0 = kt * BN;
        if (!tile_live(a, i_lo, i_hi, c0, min(c0 + BN, a.Skv))) continue;
        const int st = it % kTcStages;
        if (it >= kTcStages) mbar_wait(empty(st), ((it / kTcStages) & 1) ^ 1);
        mbar_expect_tx(full(st), 2 * L::kKV);
        for (int cb = 0; cb < NCB; ++cb) {
          tma_load(sK(st) + cb * BN * 128, &tmk, cb * 64, hk, c0, b,
                   full(st));
          tma_load(sV(st) + cb * BN * 128, &tmv, cb * 64, hk, c0, b,
                   full(st));
        }
        ++it;
      }
    }
    return;
  }

  // --- consumer warpgroup ---
  // Q tile: packed row r is query row (r0 + r) / G, head hk * G + (r0 + r) % G
  {
    const T* q = static_cast<const T*>(a.q) + b * a.q_sb;
    constexpr int CH = DP / 8;  // 16-byte chunks per row
    for (int idx = tid; idx < kTcRows * CH; idx += 128) {
      const int r = idx / CH;
      const int ch = idx % CH;
      const int R = r0 + r;
      uint4 val = make_uint4(0, 0, 0, 0);
      if (R < rtot && ch * 8 < a.D) {
        const int i = R / G;
        const int h = hk * G + R % G;
        val = *reinterpret_cast<const uint4*>(q + i * a.q_ss + h * a.q_sh +
                                              ch * 8);
      }
      const int off = (ch / 8) * kTcRows * 128 + r * 128 +
                      (((ch % 8) ^ (r & 7)) * 16);
      *reinterpret_cast<uint4*>(smem + off) = val;
    }
    // generic-proxy stores, then async-proxy (wgmma) reads
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    asm volatile("bar.sync 1, 128;\n" ::: "memory");
  }

  const int t4 = lane % 4;
  int row_q[2];     // query row of the thread's two tile rows
  bool row_ok[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int R = r0 + warp * 16 + lane / 4 + 8 * h;
    row_ok[h] = R < rtot;
    row_q[h] = R / G;
  }

  float o[DP / 2];
  float s[BN / 2];
  float m[2] = {kNegInf, kNegInf};  // base 2
  float l[2] = {0.f, 0.f};          // this thread's columns (quad-summed last)
  float ms[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) o[i] = 0.f;

  int it = 0;
  for (int kt = kt0; kt < kt1; ++kt) {
    const int c0 = kt * BN;
    if (!tile_live(a, i_lo, i_hi, c0, min(c0 + BN, a.Skv))) continue;
    const int st = it % kTcStages;
    mbar_wait(full(st), (it / kTcStages) & 1);

    // S = Q K^T over DP / 16 steps of 16 values
    kern::fence_regs<BN / 2>(s);
    kern::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
      const uint32_t off = (kk % 4) * 32;  // 32 bytes into the swizzle row
      const uint64_t da =
          sw128_desc(sQ + (kk / 4) * kTcRows * 128 + off, 16, 1024);
      const uint64_t db = sw128_desc(sK(st) + (kk / 4) * BN * 128 + off, 16,
                                     1024);
      kern::Wgmma<BN, T>::ss(s, da, db, kk > 0);
    }
    kern::wgmma_commit();
    kern::wgmma_wait<0>();
    kern::fence_regs<BN / 2>(s);

    // online softmax on the accumulator layout: s[4j + 2h + e] is tile row
    // warp*16 + lane/4 + 8h, column c0 + 8j + 2*(lane%4) + e
    const bool nomask = tile_full(a, r0, c0, BN);
    const bool all_ctx = c0 + BN <= a.context_len;
    const bool no_ctx = c0 >= a.context_len;
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float& x = s[4 * j + 2 * h + e];
          x *= a.scale_log2;
          if (!nomask) {
            const int col = c0 + 8 * j + 2 * t4 + e;
            if (!row_ok[h] || !allowed(a, row_q[h], col)) x = kNegInf;
          }
          mx[h] = fmaxf(mx[h], x);
        }
    float alpha[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
      const float m_new = fmaxf(m[h], mx[h]);
      alpha[h] = exp2f(m[h] - m_new);
      m[h] = m_new;
    }
    float rs[2] = {0.f, 0.f};
    float cs[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float& x = s[4 * j + 2 * h + e];
          x = (nomask || x > kNegInf) ? exp2f(x - m[h]) : 0.f;
          rs[h] += x;
          if (!all_ctx && !no_ctx && c0 + 8 * j + 2 * t4 + e < a.context_len)
            cs[h] += x;
        }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      l[h] = l[h] * alpha[h] + rs[h];
      ms[h] = ms[h] * alpha[h] + (all_ctx ? rs[h] : cs[h]);
    }
#pragma unroll
    for (int j = 0; j < DP / 8; ++j) {
      o[4 * j + 0] *= alpha[0];
      o[4 * j + 1] *= alpha[0];
      o[4 * j + 2] *= alpha[1];
      o[4 * j + 3] *= alpha[1];
    }

    // P as the register A operand, 16 columns per step (the accumulator
    // layout of two 8-column blocks is the A fragment's), split into a
    // 16-bit high part and the 16-bit rounding of its residual: two
    // products against the same V tile keep P to ~2^-17 relative instead
    // of the 2^-9 of one rounding
    uint32_t ph[BN / 16][4];
    uint32_t pl[BN / 16][4];
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float x = s[8 * kk + 2 * r];
        const float y = s[8 * kk + 2 * r + 1];
        ph[kk][r] = pack2<T>(x, y);
        const float2 hi = unpack2<T>(ph[kk][r]);
        pl[kk][r] = pack2<T>(x - hi.x, y - hi.y);
      }

    // O += P V: V is [BN positions][DP values], read transposed (MN-major):
    // column blocks BN * 128 bytes apart, 8-row groups 1024 bytes apart
    kern::fence_regs<DP / 2>(o);
    kern::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) {
      const uint64_t db =
          sw128_desc(sV(st) + kk * 16 * 128, BN * 128, 1024);
      kern::Wgmma<DP, T>::rs(o, ph[kk], db, 1);
      kern::Wgmma<DP, T>::rs(o, pl[kk], db, 1);
    }
    kern::wgmma_commit();
    kern::wgmma_wait<0>();
    kern::fence_regs<DP / 2>(o);
    mbar_arrive(empty(st));  // this thread is done with the K/V stage
    ++it;
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
    ms[h] += __shfl_xor_sync(0xffffffffu, ms[h], 1);
    ms[h] += __shfl_xor_sync(0xffffffffu, ms[h], 2);
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (!row_ok[h]) continue;
    const int R = r0 + warp * 16 + lane / 4 + 8 * h;
    const int i = row_q[h];
    const int head = hk * G + R % G;
    if (a.nsplit == 1) {
      const float inv = l[h] > 0.f ? 1.f / l[h] : 0.f;
      T* op = static_cast<T*>(a.out) + b * a.o_sb + i * a.o_ss +
              head * a.o_sh;
#pragma unroll
      for (int j = 0; j < DP / 8; ++j) {
        const int col = 8 * j + 2 * t4;
        if (col < a.D)
          *reinterpret_cast<uint32_t*>(op + col) = pack2<T>(
              o[4 * j + 2 * h] * inv, o[4 * j + 2 * h + 1] * inv);
      }
      if (a.mass != nullptr && t4 == 0)
        a.mass[(static_cast<long long>(b) * a.Hq + head) * a.Sq + i] =
            ms[h] * inv;
    } else {
      const long long P =
          (static_cast<long long>(b * a.Hkv + hk) * a.nsplit + sp) * rtot + R;
      float* po = a.po + P * DP;
#pragma unroll
      for (int j = 0; j < DP / 8; ++j)
        *reinterpret_cast<float2*>(po + 8 * j + 2 * t4) =
            make_float2(o[4 * j + 2 * h], o[4 * j + 2 * h + 1]);
      if (t4 == 0) {
        a.pm[P] = m[h] * kLn2;
        a.pl[P] = l[h];
        a.pms[P] = ms[h];
      }
    }
  }
}

// One thread per (b, KV head, packed row, d): merges the nsplit partials of
// the split path with the log-sum-exp rule (the mass rescaled like o) and
// writes the output and the row's mass.
template <typename T, int DP>
__global__ void flash_attention_merge_kernel(const TcArgs a) {
  const int rtot = a.Sq * a.G;
  const long long total = static_cast<long long>(a.B) * a.Hkv * rtot * a.D;
  const long long idx =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  const int d = static_cast<int>(idx % a.D);
  const long long x = idx / a.D;
  const int R = static_cast<int>(x % rtot);
  const int bh = static_cast<int>(x / rtot);  // b * Hkv + hk
  const int hk = bh % a.Hkv;
  const int b = bh / a.Hkv;
  const long long P0 = static_cast<long long>(bh) * a.nsplit * rtot + R;
  // two passes, so the second's loads do not wait on one another
  float M = kNegInf;
#pragma unroll 4
  for (int s = 0; s < a.nsplit; ++s) {
    const long long P = P0 + static_cast<long long>(s) * rtot;
    M = fmaxf(M, a.pl[P] > 0.f ? a.pm[P] : kNegInf);
  }
  float L = 0.f;
  float O = 0.f;
  float MS = 0.f;
#pragma unroll 4
  for (int s = 0; s < a.nsplit; ++s) {
    const long long P = P0 + static_cast<long long>(s) * rtot;
    const float ls = a.pl[P];
    const float f = kern::lse_scale(a.pm[P], ls, M);
    L += ls * f;
    O += a.po[P * DP + d] * f;
    MS += a.pms[P] * f;
  }
  const float inv = L > 0.f ? 1.f / L : 0.f;
  const int i = R / a.G;
  const int head = hk * a.G + R % a.G;
  static_cast<T*>(a.out)[b * a.o_sb + i * a.o_ss + head * a.o_sh + d] =
      from_f<T>(O * inv);
  if (a.mass != nullptr && d == 0)
    a.mass[(static_cast<long long>(b) * a.Hq + head) * a.Sq + i] = MS * inv;
}

template <typename T, int DP, int BN>
cudaError_t launch_tc_k(const TcArgs& a, const CUtensorMap& tmk,
                        const CUtensorMap& tmv, cudaStream_t s) {
  const int smem = TcSmem<DP, BN>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_tc_kernel<T, DP, BN>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.Sq * a.G + kTcRows - 1) / kTcRows, a.Hkv,
                  a.B * a.nsplit);
  flash_attention_tc_kernel<T, DP, BN><<<grid, kTcThreads, smem, s>>>(
      a, tmk, tmv);
  err = cudaGetLastError();
  if (err != cudaSuccess || a.nsplit == 1) return err;
  const long long total =
      static_cast<long long>(a.B) * a.Hkv * a.Sq * a.G * a.D;
  const unsigned blocks = static_cast<unsigned>((total + 255) / 256);
  flash_attention_merge_kernel<T, DP><<<blocks, 256, 0, s>>>(a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_tc(const TcArgs& a, const CUtensorMap& tmk,
                      const CUtensorMap& tmv, cudaStream_t s) {
  switch (tc_dp(a.D)) {
    case 64: return launch_tc_k<T, 64, 64>(a, tmk, tmv, s);
    case 128: return launch_tc_k<T, 128, 64>(a, tmk, tmv, s);
    case 192: return launch_tc_k<T, 192, 64>(a, tmk, tmv, s);
    default: return launch_tc_k<T, 256, 32>(a, tmk, tmv, s);
  }
}

}  // namespace

// dtype: 0 float32 (CUDA-core kernel), 1 bfloat16, 2 float16 (tensor-core
// kernel). window < 0 means none; mass may be null. Strides are in
// elements; the head dim of q, k, v and out must be contiguous; for bf16 and
// fp16 the bases and strides of q, k, v and out must be multiples of 16
// bytes and D a multiple of 16. nsplit > 1 (bf16/fp16 only) splits each
// query tile's KV tiles over nsplit blocks of kt_per_split tiles, whose
// float32 partials go to `scratch` (B * Hkv * nsplit * Sq * G * (DP + 3)
// floats, DP = D rounded up to 64) and are merged by a second kernel.
// Returns the launches' cudaGetLastError() (0 on success).
extern "C" int flash_attention_launch(
    const void* q, const void* k, const void* v, void* out, float* mass,
    float* scratch, int B, int Sq, int Skv, int Hq, int Hkv, int D,
    int context_len, int q_offset, int causal, int window, int nsplit,
    int kt_per_split, long long q_sb, long long q_ss, long long q_sh,
    long long k_sb, long long k_ss, long long k_sh, long long v_sb,
    long long v_ss, long long v_sh, long long o_sb, long long o_ss,
    long long o_sh, float scale, int dtype, void* stream) {
  if (B < 1 || Sq < 1 || Skv < 0 || Hkv < 1 || Hq % Hkv != 0 || D < 1 ||
      D > 256 || Hq > 65535 || B > 65535 || nsplit < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    if (nsplit != 1) return static_cast<int>(cudaErrorInvalidValue);
    Args a{q,    k,    v,    out,  mass, B,    Sq,   Skv,  Hq,   Hkv,
           D,    context_len, q_offset, causal, window, q_sb, q_ss, q_sh,
           k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, o_sb, o_ss, o_sh, scale};
    return static_cast<int>(launch<float>(a, s));
  }
  if (dtype != 1 && dtype != 2) return static_cast<int>(cudaErrorInvalidValue);
  const int G = Hq / Hkv;
  const int DP = tc_dp(D);
  const int bn = tc_bn(D);
  if (D % 16 != 0 || B * nsplit > 65535 || Skv < 1 ||
      (nsplit > 1 && (scratch == nullptr ||
                      static_cast<long long>(nsplit) * kt_per_split <
                          (Skv + bn - 1) / bn)))
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap tmk;
  CUtensorMap tmv;
  // boxes of 64 head values x bn positions in the 128-byte swizzle
  if (!make_map(&tmk, k, dtype, B, Skv, Hkv, D, k_sb, k_ss, k_sh, 64, bn,
                true) ||
      !make_map(&tmv, v, dtype, B, Skv, Hkv, D, v_sb, v_ss, v_sh, 64, bn,
                true))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long rows = static_cast<long long>(B) * Hkv * nsplit * Sq * G;
  float* po = nsplit > 1 ? scratch : nullptr;
  float* pm = nsplit > 1 ? scratch + rows * DP : nullptr;
  TcArgs a{q,    out,  mass, po,   pm,   pm ? pm + rows : nullptr,
           pm ? pm + 2 * rows : nullptr, B, Sq, Skv, Hq, Hkv, G, D,
           context_len, q_offset, causal, window, nsplit,
           nsplit > 1 ? kt_per_split : (Skv + bn - 1) / bn,
           q_sb, q_ss, q_sh, o_sb, o_ss, o_sh, scale * kLog2e};
  return static_cast<int>(dtype == 1 ? launch_tc<__nv_bfloat16>(a, tmk, tmv, s)
                                     : launch_tc<__half>(a, tmk, tmv, s));
}
