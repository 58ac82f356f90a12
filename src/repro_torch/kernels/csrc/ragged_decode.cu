// Ragged one-token GQA decode over a two-segment slot-table row, for sm_90a.
//
// Replaces the Pallas kernel src/repro/kernels/ragged_decode.py
// (_ragged_decode_kernel). Each cache row is
//     [ prefix bucket (prefix_len) | self tokens | pad ]
// and position j of row b is attended when
//     j < prefix_len ? j < pfx[b] : j < kv_len[b]      (and j < Skv).
// RoPE is applied by the caller, so the kernel is position-free.
//
// Bound: one decode step reads every attended K and V row once and does
// 4*G*D flops per attended position and KV head, far below the card's
// flop/byte balance, so the kernel is bound by the bytes of K and V: at the
// serving shape 17 MB, about 5 us at 3.35 TB/s. Reaching it takes many
// loads in flight: one block per (row, KV head) is 32 blocks for 132 SMs,
// and a warp that loads one position's K and V rows before using them
// waits a memory latency per position.
// Design:
//  * Attended positions only. Row b attends n_b = min(pfx, prefix_len) +
//    max(min(kv_len, Skv) - prefix_len, 0) positions; index t < n_b maps to
//    cache position t < pfx ? t : prefix_len + (t - pfx), so the dead gap
//    [pfx, prefix_len) of the bucket and everything past kv_len are never
//    visited or loaded.
//  * Split-KV. The grid is (Hkv * ngrp, B, nsplit) with nsplit =
//    ceil(Skv / chunk), sized on the host from Skv alone (the lengths stay
//    on the device: no host sync). Block sp takes indices [sp*chunk,
//    (sp+1)*chunk) of its row's attended positions and exits at once if
//    that starts at or past n_b. A block covers all G query heads of its KV
//    head when G <= 8, so each K/V row is read once for the whole group.
//  * Wider groups (starcoder2's G 9, any G up to a Hq/Hkv of 64 and more)
//    split into ngrp = ceil(G / 8) head groups of gs = ceil(G / ngrp) <= 8
//    heads, one block each, so every block runs the G <= 8 code: q,
//    scores and accumulators stay in registers at MAXG 8 (a MAXG 16
//    instance would double them, ~2x the registers, and its warp-merge
//    scratch would pass 48 KB of static shared memory). The cost is that
//    each K/V row is read once per head group (twice at G 9 to 16; the
//    second read of a tile mostly hits L2, since both blocks run at once).
//    G <= 8 takes one group, g0 = 0: the instances and their work are
//    those of the kernel before the split.
//  * cp.async staging. A sub-tile is 2 KB of K and 2 KB of V per position
//    a lane takes (4 KB for float32 rows over 512 bytes): TPP lanes share
//    a position, each copying VPT 16-byte vectors of its K row and of its V
//    row with cp.async into its own shared-memory slots (so consecutive
//    lanes hit consecutive 16-byte bank groups whatever the row stride, and
//    no block barrier is needed in the loop). A lane takes PPT = 2
//    positions of each sub-tile (1 where it holds two vectors), so two
//    rows' loads, dot products and shuffles are in flight at once and one
//    softmax step (one rescale) covers both. A 3-stage ring keeps two
//    sub-tiles in flight while the third is used; a block walks 4
//    sub-tiles (64 positions at bf16 D 128). Rows whose base or strides are
//    not 16-byte multiples are staged by plain loads.
//  * Scores without a full-warp reduction per position: a lane holds
//    VPT*16 bytes of the head dim of q (pre-scaled) for each of the G heads
//    and of each of its K rows, and the TPP lanes of a position sum their
//    partial dot products with log2(TPP) shuffles (4 at bf16/fp16 D 128,
//    for 4 positions per warp at once). Tensor-core products were not taken: at
//    G <= 8 an mma tile would be at least half padding, and the kernel is
//    bound by bytes, not products.
//  * Each position group keeps a float32 online softmax (m, l, acc) per
//    head; the groups of a warp merge with shuffles, the 4 warps through
//    shared memory, both with the log-sum-exp step of common.cuh
//    (lse_merge), into a float32 partial (o, m, l) per (row, KV head,
//    split, q head) in scratch the wrapper allocates. A second kernel,
//    launched from the same entry point, merges a row's live splits
//    (ceil(n_b / chunk) of them) in two passes (decode_merge.cuh, the
//    merge K3 shares; common.cuh: lse_scale, the step K2's split path
//    shares), one block per (row, q head) with the splits spread over its
//    threads, into the output; a row that attends nothing (n_b == 0) gives
//    exact zeros.
// One template serves float32, bf16 and fp16 (any G, D <= 256).
#include <cstdint>

#include "common.cuh"
#include "decode_merge.cuh"

namespace {

using kern::cp_async16;
using kern::cp_async_commit;
using kern::cp_async_wait;
using kern::from_f;
using kern::kNegInf;
using kern::lse_merge;
using kern::to_f;
using kern::unpack;

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kStages = 3;  // cp.async ring depth (sub-tiles)
constexpr int kSub = 4;     // sub-tiles per block: chunk = kSub * PPT * P
constexpr int kMaxD = 256;
using kern::kMergeThreads;

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const int* kv_len;
  const int* pfx;
  float* po;  // (B, Hkv, nsplit, G, D)
  float* pm;  // (B, Hkv, nsplit, G)
  float* pl;  // (B, Hkv, nsplit, G)
  void* out;
  int B, Hkv, G, D, Skv, prefix_len, nsplit, chunk, tpp, aligned;
  int gs, ngrp;  // query heads per block (<= 8) and head groups per KV head
  long long q_sb, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, o_sb, o_sh;
  float scale;
};

// Geometry shared by the host and the kernel: 16-byte vectors per row
// (VPR), vectors per lane (VPT), lanes per position (TPP, a power of two).
__host__ __device__ inline int max_g(int G) {
  return G <= 1 ? 1 : G <= 2 ? 2 : G <= 4 ? 4 : 8;
}
// Head groups of at most 8 heads per KV head, as even as they go.
__host__ __device__ inline int head_groups(int G) { return (G + 7) / 8; }
__host__ __device__ inline int heads_per_group(int G) {
  const int n = head_groups(G);
  return (G + n - 1) / n;
}
// One vector a lane keeps q, K, V and the accumulator of every head to
// ~100 registers (at G <= 4), so 4-5 blocks fit an SM; two only for float32
// rows over 512 bytes, where one would need more than a warp per position.
__host__ __device__ inline int vectors_per_lane(int G, int D, int esize) {
  const int vpr = (D * esize + 15) / 16;
  return vpr > 32 ? 2 : 1;
}
// Positions a lane takes per sub-tile: two, one where it holds two vectors
// (the ring's 16-byte slots then stay within 48 KB of static shared memory).
__host__ __device__ constexpr int positions_per_lane(int vpt) {
  return vpt == 1 ? 2 : 1;
}
__host__ __device__ inline int lanes_per_position(int G, int D, int esize) {
  const int vpr = (D * esize + 15) / 16;
  const int vpt = vectors_per_lane(G, D, esize);
  const int need = (vpr + vpt - 1) / vpt;
  int t = 1;
  while (t < need) t <<= 1;
  return t;
}

// Attended positions of row b; *pc receives the real bucket entries.
__device__ __forceinline__ int attended(const int* kv_len, const int* pfx,
                                        int b, int Skv, int prefix_len,
                                        int* pc) {
  *pc = min(max(pfx[b], 0), prefix_len);
  return *pc + max(min(kv_len[b], Skv) - prefix_len, 0);
}

// Copy vector vi of a K or V row into a 16-byte slot: cp.async when the
// row is 16-byte aligned, else element by element (zeros past D).
template <typename T>
__device__ __forceinline__ void stage_vec(uint4* slot, const T* row, int vi,
                                          int D, bool aligned) {
  constexpr int VE = 16 / sizeof(T);
  if (aligned) {
    cp_async16(slot, row + vi * VE);
    return;
  }
  __align__(16) T tmp[VE];
#pragma unroll
  for (int e = 0; e < VE; ++e) {
    const int d = vi * VE + e;
    tmp[e] = d < D ? row[d] : from_f<T>(0.f);
  }
  *slot = *reinterpret_cast<const uint4*>(tmp);
}

template <typename T, int MAXG, int VPT>
__global__ void __launch_bounds__(kThreads)
    ragged_split_kernel(Args a) {
  constexpr int VE = 16 / sizeof(T);
  constexpr int kPPT = positions_per_lane(VPT);
  constexpr int kRingBytes = kStages * 2 * kPPT * VPT * kThreads * 16;
  constexpr int kRedBytes = kWarps * MAXG * kMaxD * 4;
  constexpr int kBytes = kRingBytes > kRedBytes ? kRingBytes : kRedBytes;
  // the ring while the loop runs, then the warps' partials
  __shared__ __align__(16) unsigned char smem[kBytes];
  __shared__ float red_m[kWarps][MAXG];
  __shared__ float red_l[kWarps][MAXG];
  uint4* ring = reinterpret_cast<uint4*>(smem);

  const int h = blockIdx.x / a.ngrp;
  const int g0 = (blockIdx.x % a.ngrp) * a.gs;  // first head of the group
  const int b = blockIdx.y;
  const int sp = blockIdx.z;
  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  const int G = min(a.gs, a.G - g0);  // heads of this block
  const int D = a.D;
  const int TPP = a.tpp;
  const int P = kThreads / TPP;
  const int p = tid / TPP;
  const int c = tid % TPP;
  const int vpr = (D + VE - 1) / VE;
  const bool aligned = a.aligned != 0;

  int pc;
  const int n = attended(a.kv_len, a.pfx, b, a.Skv, a.prefix_len, &pc);
  const int t0 = sp * a.chunk;
  if (t0 >= n) return;  // uniform over the block; the merge skips it
  const int SP = P * kPPT;  // positions per sub-tile
  const int nsub = min(kSub, (n - t0 + SP - 1) / SP);

  const T* kb = static_cast<const T*>(a.k) + b * a.k_sb + h * a.k_sh;
  const T* vb = static_cast<const T*>(a.v) + b * a.v_sb + h * a.v_sh;
  const T* q = static_cast<const T*>(a.q) + b * a.q_sb;

  // slot (stage, K or V, position u, vector j) of this lane; the lane's
  // positions in sub-tile s are t0 + s * SP + u * P + p
  auto slot = [&](int st, int kv, int u, int j) -> uint4* {
    return ring + (((st * 2 + kv) * kPPT + u) * VPT + j) * kThreads + tid;
  };
  auto issue = [&](int s) {
#pragma unroll
    for (int u = 0; u < kPPT; ++u) {
      const int t = t0 + s * SP + u * P + p;
      if (s < nsub && t < n) {
        const int pos = t < pc ? t : a.prefix_len + (t - pc);
        const int st = s % kStages;
#pragma unroll
        for (int j = 0; j < VPT; ++j) {
          const int vi = c + j * TPP;
          if (vi < vpr) {
            stage_vec<T>(slot(st, 0, u, j), kb + pos * a.k_ss, vi, D,
                         aligned);
            stage_vec<T>(slot(st, 1, u, j), vb + pos * a.v_ss, vi, D,
                         aligned);
          }
        }
      }
    }
    cp_async_commit();  // one group per sub-tile, empty or not
  };
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) issue(s);

  float qr[MAXG][VPT][VE];
  float acc[MAXG][VPT][VE];
  float m[MAXG];
  float l[MAXG];
#pragma unroll
  for (int g = 0; g < MAXG; ++g) {
    m[g] = kNegInf;
    l[g] = 0.f;
#pragma unroll
    for (int j = 0; j < VPT; ++j)
#pragma unroll
      for (int e = 0; e < VE; ++e) {
        const int d = (c + j * TPP) * VE + e;
        qr[g][j][e] = (g < G && d < D)
                          ? to_f(q[(h * a.G + g0 + g) * a.q_sh + d]) *
                                a.scale
                          : 0.f;
        acc[g][j][e] = 0.f;
      }
  }

  for (int s = 0; s < nsub; ++s) {
    issue(s + kStages - 1);
    cp_async_wait<kStages - 1>();  // this lane's copies of sub-tile s
    const int st = s % kStages;
    // scores of the lane's kPPT positions for every head, summed over the
    // TPP lanes of each position (aligned lane groups)
    float sc[kPPT][MAXG];
#pragma unroll
    for (int u = 0; u < kPPT; ++u) {
      float kf[VPT][VE];
#pragma unroll
      for (int j = 0; j < VPT; ++j) {
        if (c + j * TPP < vpr) {
          unpack<T>(*slot(st, 0, u, j), kf[j]);
        } else {
#pragma unroll
          for (int e = 0; e < VE; ++e) kf[j][e] = 0.f;
        }
      }
#pragma unroll
      for (int g = 0; g < MAXG; ++g) {
        float x = 0.f;
#pragma unroll
        for (int j = 0; j < VPT; ++j)
#pragma unroll
          for (int e = 0; e < VE; ++e) x += qr[g][j][e] * kf[j][e];
        sc[u][g] = x;
      }
    }
    for (int o = TPP / 2; o > 0; o >>= 1)
#pragma unroll
      for (int u = 0; u < kPPT; ++u)
#pragma unroll
        for (int g = 0; g < MAXG; ++g)
          sc[u][g] += __shfl_xor_sync(0xffffffffu, sc[u][g], o);
    bool live[kPPT];  // uniform over a position's lanes
#pragma unroll
    for (int u = 0; u < kPPT; ++u) live[u] = t0 + s * SP + u * P + p < n;
    if (!live[0]) continue;  // positions fill in order: u > 0 is dead too
    float vf[kPPT][VPT][VE];
#pragma unroll
    for (int u = 0; u < kPPT; ++u)
#pragma unroll
      for (int j = 0; j < VPT; ++j) {
        if (live[u] && c + j * TPP < vpr) {
          unpack<T>(*slot(st, 1, u, j), vf[u][j]);
        } else {
#pragma unroll
          for (int e = 0; e < VE; ++e) vf[u][j][e] = 0.f;
        }
      }
    // one online-softmax step over the lane's live positions
#pragma unroll
    for (int g = 0; g < MAXG; ++g) {
      if (g >= G) break;
      float m_new = m[g];
#pragma unroll
      for (int u = 0; u < kPPT; ++u)
        if (live[u]) m_new = fmaxf(m_new, sc[u][g]);
      const float alpha = expf(m[g] - m_new);
      float pe[kPPT];
      float ps = 0.f;
#pragma unroll
      for (int u = 0; u < kPPT; ++u) {
        pe[u] = live[u] ? expf(sc[u][g] - m_new) : 0.f;
        ps += pe[u];
      }
      l[g] = l[g] * alpha + ps;
#pragma unroll
      for (int j = 0; j < VPT; ++j)
#pragma unroll
        for (int e = 0; e < VE; ++e) {
          float x = acc[g][j][e] * alpha;
#pragma unroll
          for (int u = 0; u < kPPT; ++u) x += pe[u] * vf[u][j][e];
          acc[g][j][e] = x;
        }
      m[g] = m_new;
    }
  }
  cp_async_wait<0>();

  // merge the position groups of the warp (lanes TPP apart) ...
  for (int o = TPP; o < 32; o <<= 1) {
#pragma unroll
    for (int g = 0; g < MAXG; ++g) {
      const float m2 = __shfl_xor_sync(0xffffffffu, m[g], o);
      const float l2 = __shfl_xor_sync(0xffffffffu, l[g], o);
      const float2 f = lse_merge(m[g], l[g], m2, l2);
#pragma unroll
      for (int j = 0; j < VPT; ++j)
#pragma unroll
        for (int e = 0; e < VE; ++e) {
          const float a2 = __shfl_xor_sync(0xffffffffu, acc[g][j][e], o);
          acc[g][j][e] = acc[g][j][e] * f.x + a2 * f.y;
        }
    }
  }
  // ... then the warps, through shared memory (the ring is done with)
  __syncthreads();
  float* red = reinterpret_cast<float*>(smem);  // [kWarps][MAXG][kMaxD]
  if (lane < TPP) {
#pragma unroll
    for (int g = 0; g < MAXG; ++g) {
      if (lane == 0) {
        red_m[warp][g] = m[g];
        red_l[warp][g] = l[g];
      }
#pragma unroll
      for (int j = 0; j < VPT; ++j)
#pragma unroll
        for (int e = 0; e < VE; ++e) {
          const int d = (c + j * TPP) * VE + e;
          if (d < D) red[(warp * MAXG + g) * kMaxD + d] = acc[g][j][e];
        }
    }
  }
  __syncthreads();
  const long long row0 =
      (static_cast<long long>(b * a.Hkv + h) * a.nsplit + sp) * a.G + g0;
  for (int idx = tid; idx < G * D; idx += kThreads) {
    const int g = idx / D;
    const int d = idx % D;
    float M = kNegInf;
    float L = 0.f;
    float o = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float2 f = lse_merge(M, L, red_m[w][g], red_l[w][g]);
      o = o * f.x + red[(w * MAXG + g) * kMaxD + d] * f.y;
    }
    a.po[(row0 + g) * D + d] = o;
    if (d == 0) {
      a.pm[row0 + g] = M;
      a.pl[row0 + g] = L;
    }
  }
}

// One block per (b, q head): merges the row's live splits (ceil(n_b /
// chunk) of them) with the decode merge K3 shares (decode_merge.cuh).
template <typename T>
__global__ void __launch_bounds__(kMergeThreads)
    ragged_merge_kernel(Args a) {
  const int Hq = a.Hkv * a.G;
  const int hq = blockIdx.x % Hq;
  const int b = blockIdx.x / Hq;
  int pc;
  const int n = attended(a.kv_len, a.pfx, b, a.Skv, a.prefix_len, &pc);
  kern::merge_splits<T, false>(a, b, hq, (n + a.chunk - 1) / a.chunk);
}

template <typename T, int MAXG>
cudaError_t launch_g(const Args& a, cudaStream_t s) {
  const dim3 grid(a.Hkv * a.ngrp, a.B, a.nsplit);
  if (vectors_per_lane(a.G, a.D, sizeof(T)) == 2)
    ragged_split_kernel<T, MAXG, 2><<<grid, kThreads, 0, s>>>(a);
  else
    ragged_split_kernel<T, MAXG, 1><<<grid, kThreads, 0, s>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  ragged_merge_kernel<T><<<a.B * a.Hkv * a.G, kMergeThreads, 0, s>>>(a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const Args& a, cudaStream_t s) {
  switch (max_g(a.gs)) {
    case 1: return launch_g<T, 1>(a, s);
    case 2: return launch_g<T, 2>(a, s);
    case 4: return launch_g<T, 4>(a, s);
    default: return launch_g<T, 8>(a, s);
  }
}

int esize_of(int dtype) { return dtype == 0 ? 4 : 2; }

}  // namespace

// Positions one split block covers (the wrapper sizes its scratch with it):
// kSub sub-tiles of PPT * 128 / TPP positions. dtype: 0 float32, 1 bfloat16,
// 2 float16.
extern "C" int ragged_decode_chunk(int G, int D, int dtype) {
  const int es = esize_of(dtype);
  return kSub * positions_per_lane(vectors_per_lane(G, D, es)) *
         (kThreads / lanes_per_position(G, D, es));
}

// q (B, Hq, D), k/v (B, Skv, Hkv, D), out (B, Hq, D); strides in elements,
// the head dim contiguous. po/pm/pl: float32 scratch of (B, Hkv, nsplit,
// G[, D]) with nsplit = max(1, ceil(Skv / chunk)). Returns the launches'
// cudaGetLastError() (0 on success).
extern "C" int ragged_decode_launch(
    const void* q, const void* k, const void* v, const int* kv_len,
    const int* pfx, float* po, float* pm, float* pl, void* out, int B,
    int Hkv, int G, int D, int Skv, int prefix_len, int nsplit,
    long long q_sb, long long q_sh, long long k_sb, long long k_ss,
    long long k_sh, long long v_sb, long long v_ss, long long v_sh,
    long long o_sb, long long o_sh, float scale, int dtype, void* stream) {
  if (G < 1 || D < 1 || D > kMaxD || B < 1 || B > 65535 ||
      Hkv < 1 || Skv < 0 || dtype < 0 || dtype > 2)
    return static_cast<int>(cudaErrorInvalidValue);
  const int es = esize_of(dtype);
  const int chunk = ragged_decode_chunk(G, D, dtype);
  // Skv == 0 still takes one split block, which exits at once
  if (nsplit != max(1, (Skv + chunk - 1) / chunk) || nsplit > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto al = [es](const void* p, long long s1, long long s2,
                       long long s3) {
    return (reinterpret_cast<uintptr_t>(p) % 16 == 0) &&
           (s1 * es) % 16 == 0 && (s2 * es) % 16 == 0 && (s3 * es) % 16 == 0;
  };
  const int aligned = (D * es) % 16 == 0 && al(k, k_sb, k_ss, k_sh) &&
                      al(v, v_sb, v_ss, v_sh);
  Args a{q,    k,    v,    kv_len, pfx,  po,   pm,   pl,   out,
         B,    Hkv,  G,    D,      Skv,  prefix_len, nsplit, chunk,
         lanes_per_position(G, D, es), aligned, heads_per_group(G),
         head_groups(G),
         q_sb, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, o_sb, o_sh, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return static_cast<int>(launch<float>(a, s));
    case 1: return static_cast<int>(launch<__nv_bfloat16>(a, s));
    default: return static_cast<int>(launch<__half>(a, s));
  }
}
