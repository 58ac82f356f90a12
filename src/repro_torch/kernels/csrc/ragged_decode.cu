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
// serving shape 17 MB, about 5 us at 3.35 TB/s. A step is short, so what
// holds it back is latency: how soon every SM has its loads in flight, how
// much it keeps in flight, and the fixed cost around them (a block's set-up,
// its partial, the merge). The earlier design (cp.async per lane, every
// head's q, scores and accumulators in registers on the CUDA cores, 64-
// position splits) held 8 heads in ~220 registers, moved 32 KB a block,
// read starcoder2's G 9 twice (two head groups of at most 8) and reached
// 6-10% of the bound at G 6-9, Skv ~1,000, behind SDPA. This design
// reaches about a quarter of the bound at the serving shape and 13-22% at
// G 6-9, ahead of SDPA at every served geometry; of its ~20 us there, the
// merge is ~3.5, the tensor-core products ~2, and the rest the stream and
// its fixed cost, a block's first tile arriving microseconds after its
// start (PERF.md).
// Design:
//  * Attended positions only. Row b attends n_b = min(pfx, prefix_len) +
//    max(min(kv_len, Skv) - prefix_len, 0) positions; index t < n_b maps to
//    cache position t < pfx ? t : prefix_len + (t - pfx), so the dead gap
//    [pfx, prefix_len) of the bucket and everything past kv_len are never
//    visited or loaded. A split block's indices [t0, t1) are at most two
//    runs of positions (Runs): [t0, min(t1, pfx)) in the bucket and the
//    self-region run after it; its tiles start at each run's first position
//    and are masked past its end.
//  * Split-KV from a host plan. The grid is (Hkv * ngrp, B, nsplit), each
//    block taking `chunk` attended indices of its row; the wrapper sizes
//    nsplit and chunk from shapes alone (B, Hkv, head groups, Skv; the
//    lengths stay on the device: no host sync), in whole tiles, so that the
//    grid is about one wave of the blocks an SM holds
//    (ragged_decode_geometry asks the occupancy of the instance). A block
//    past its row's n_b exits at once.
//  * bf16 / fp16: the tensor-core split block K3 shares (decode_mma.cuh),
//    K3 with a two-run tile plan and no window. S = Q K^T and O += P V as
//    mma.sync m16n8k16 with the group's heads as the rows of A (rows 0-7
//    for G <= 8, 0-15 for G <= 16), so any G <= 16 is one head group that
//    reads each K/V row once; G > 16 splits into groups of at most 16. K/V
//    arrive by TMA into a ring of 2-3 stages kept full by one producer
//    warp, four consumer warps compute. A first version copied each row by
//    a plain bulk copy (cp.async.bulk, no tensor map): the TMA unit takes
//    such copies one at a time, ~25 ns each per SM, 128 a tile, and the
//    kernel ran at 0.5-1.2 TB/s (PERF.md). A box of 64 rows is one
//    request. The maps come from a cache keyed on the cache buffer's
//    address, shape and strides (tma.cuh: cached_map), so the host encodes
//    them once per buffer, not per call. Rows a map cannot describe are
//    staged by the producer warp with plain loads into the same ring: the
//    same kernel, never refused.
//  * float32 on the CUDA cores (ragged_split_kernel, the earlier design:
//    mma.sync takes no float32 operands and TF32 would not hold float32
//    parity): TPP lanes share a position, each holding 16-byte vectors of
//    q (pre-scaled) for every head and of its K and V rows, staged with
//    cp.async into a 3-stage ring; head groups of at most 8; fixed splits
//    of 4 sub-tiles.
//  * Both split kernels fold their warps into a float32 partial (o, m, l)
//    per (row, KV head, split, q head) in scratch the wrapper allocates
//    (decode_merge.cuh: store_partial), and a second kernel of the same C
//    call, the merge K3 shares, merges a row's live splits (ceil(n_b /
//    chunk) of them), one block per (row, q head), into the output; a row
//    that attends nothing (n_b == 0) gives exact zeros. The merge is ~20%
//    of K1's device time at Skv ~1,000. Folding it into the split kernel
//    (the last split block of a row merges, behind an arrival counter) was
//    measured and lost up to 8 us at G 8-9: that block merges the group's
//    heads after its own work, serially over its warps (PERF.md).
// One entry point serves float32, bf16 and fp16 (any G, D <= 256).
#include <cstdint>

#include "common.cuh"
#include "decode_merge.cuh"
#include "decode_mma.cuh"
#include "tma.cuh"

namespace {

using kern::cp_async16;
using kern::cp_async_commit;
using kern::cp_async_wait;
using kern::from_f;
using kern::kDecTile;
using kern::kMergeThreads;
using kern::kNegInf;
using kern::lse_merge;
using kern::to_f;
using kern::unpack;

constexpr int kThreads = 128;  // the CUDA-core kernel
constexpr int kWarps = kThreads / 32;
constexpr int kStages = 3;     // cp.async ring depth (sub-tiles)
constexpr int kSub = 4;        // sub-tiles per CUDA-core split block
constexpr int kMaxD = 256;

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
  int gs, ngrp;  // query heads per block and head groups per KV head
  long long q_sb, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, o_sb, o_sh;
  float scale;
};

// Head groups of at most `cap` heads per KV head, as even as they go: 16 on
// the tensor cores (the rows of A), 8 on the CUDA cores (MAXG 8).
__host__ __device__ inline int head_cap(bool tc) { return tc ? 16 : 8; }
__host__ __device__ inline int head_groups(int G, int cap) {
  return (G + cap - 1) / cap;
}
__host__ __device__ inline int heads_per_group(int G, int cap) {
  const int n = head_groups(G, cap);
  return (G + n - 1) / n;
}

// The merge kernel is launched to overlap the split kernel's end
// (programmatic dependent launch: each split block lets it launch at its
// start, and it waits for the split grid's completion before it reads);
// it hides ~1-2 us of its launch (PERF.md).
constexpr bool kOverlapMerge = true;
__device__ __forceinline__ void merge_may_launch() {
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
}

// Attended positions of row b; *pc receives the real bucket entries.
__device__ __forceinline__ int attended(const int* kv_len, const int* pfx,
                                        int b, int Skv, int prefix_len,
                                        int* pc) {
  *pc = min(max(pfx[b], 0), prefix_len);
  return *pc + max(min(kv_len[b], Skv) - prefix_len, 0);
}

// ---------------------------------------------------------------------------
// bf16 / fp16: the tensor-core kernel (the split block K3 shares)
// ---------------------------------------------------------------------------
// A split block's attended indices [t0, t1) as runs of cache positions:
// [a0, a0 + na) in the bucket, then [b0, b0 + nb) in the self region; the
// block's tiles start at each run's first position.
struct Runs {
  int a0, na, b0, nb, ta;
  __device__ __forceinline__ Runs(int t0, int t1, int pc, int prefix_len) {
    a0 = t0;
    na = max(0, min(t1, pc) - t0);
    const int s = max(t0, pc);
    b0 = prefix_len + (s - pc);
    nb = max(0, t1 - s);
    ta = (na + kDecTile - 1) / kDecTile;
  }
  __device__ __forceinline__ int count() const {
    return ta + (nb + kDecTile - 1) / kDecTile;
  }
  // First position of tile it and the end of its run.
  __device__ __forceinline__ void tile(int it, int* pos0, int* end) const {
    if (it < ta) {
      *pos0 = a0 + it * kDecTile;
      *end = a0 + na;
    } else {
      *pos0 = b0 + (it - ta) * kDecTile;
      *end = b0 + nb;
    }
  }
};

// Grid (Hkv * ngrp, B, nsplit), kern::kDecThreads threads: block sp takes
// attended indices [sp * chunk, ...) of its row, at most two runs of
// positions, through the shared tensor-core block, the group's heads in
// rows 0-7 (NR = 1) or 0-15 (NR = 2) of A.
template <typename T, int DP, int NR>
__global__ void __launch_bounds__(kern::kDecThreads)
    ragged_mma_kernel(const Args a, const __grid_constant__ CUtensorMap tmk,
                      const __grid_constant__ CUtensorMap tmv) {
  const int h = blockIdx.x / a.ngrp;
  const int g0 = (blockIdx.x % a.ngrp) * a.gs;  // first head of the group
  const int b = blockIdx.y;
  const int sp = blockIdx.z;
  merge_may_launch();
  int pc;
  const int n = attended(a.kv_len, a.pfx, b, a.Skv, a.prefix_len, &pc);
  const int t0 = sp * a.chunk;
  if (t0 >= n) return;  // uniform over the block; the merge skips it
  kern::mma_decode_block<T, DP, NR>(
      a, &tmk, &tmv, Runs(t0, min(n, t0 + a.chunk), pc, a.prefix_len), b, h,
      g0, min(a.gs, a.G - g0), sp);
}

// ---------------------------------------------------------------------------
// float32: the CUDA-core kernel
// ---------------------------------------------------------------------------
// Geometry shared by the host and the kernel: 16-byte vectors per row
// (VPR), vectors per lane (VPT), lanes per position (TPP, a power of two).
__host__ __device__ inline int max_g(int G) {
  return G <= 1 ? 1 : G <= 2 ? 2 : G <= 4 ? 4 : 8;
}
// One vector a lane keeps q, K, V and the accumulator of every head to
// ~100 registers (at G <= 4), so 4-5 blocks fit an SM; two only for float32
// rows over 512 bytes, where one would need more than a warp per position.
__host__ __device__ inline int vectors_per_lane(int D, int esize) {
  const int vpr = (D * esize + 15) / 16;
  return vpr > 32 ? 2 : 1;
}
// Positions a lane takes per sub-tile: two, one where it holds two vectors
// (the ring's 16-byte slots then stay within 48 KB of static shared memory).
__host__ __device__ constexpr int positions_per_lane(int vpt) {
  return vpt == 1 ? 2 : 1;
}
__host__ __device__ inline int lanes_per_position(int D, int esize) {
  const int vpr = (D * esize + 15) / 16;
  const int vpt = vectors_per_lane(D, esize);
  const int need = (vpr + vpt - 1) / vpt;
  int t = 1;
  while (t < need) t <<= 1;
  return t;
}
// Positions of one sub-tile: PPT * 128 / TPP.
__host__ __device__ inline int sub_tile_positions(int D, int esize) {
  return positions_per_lane(vectors_per_lane(D, esize)) *
         (kThreads / lanes_per_position(D, esize));
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

// Grid (Hkv * ngrp, B, nsplit), kThreads threads. A block walks the
// sub-tiles of its chunk of attended indices: TPP lanes share a position,
// each lane takes PPT positions of a sub-tile, staged by cp.async into a
// kStages-deep ring, and keeps a float32 online softmax per head.
template <typename T, int MAXG, int VPT>
__global__ void __launch_bounds__(kThreads)
    ragged_split_kernel(const Args a) {
  constexpr int VE = 16 / sizeof(T);
  constexpr int kPPT = positions_per_lane(VPT);
  constexpr int kRingBytes = kStages * 2 * kPPT * VPT * kThreads * 16;
  constexpr int kRedBytes = kWarps * MAXG * kMaxD * 4;
  constexpr int kBytes = kRingBytes > kRedBytes ? kRingBytes : kRedBytes;
  // the ring while the loop runs, then the warps' partials
  __shared__ __align__(16) unsigned char smem[kBytes];
  __shared__ float sm_m[kWarps][MAXG];
  __shared__ float sm_l[kWarps][MAXG];
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

  merge_may_launch();
  int pc;
  const int n = attended(a.kv_len, a.pfx, b, a.Skv, a.prefix_len, &pc);
  const int t0 = sp * a.chunk;
  if (t0 >= n) return;  // uniform over the block; the merge skips it
  const int SP = P * kPPT;  // positions per sub-tile
  const int nsub = min(a.chunk / SP, (n - t0 + SP - 1) / SP);

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
  float* red = reinterpret_cast<float*>(smem);  // [kWarps][MAXG][D]
  if (lane < TPP) {
#pragma unroll
    for (int g = 0; g < MAXG; ++g) {
      if (lane == 0) {
        sm_m[warp][g] = m[g];
        sm_l[warp][g] = l[g];
      }
#pragma unroll
      for (int j = 0; j < VPT; ++j)
#pragma unroll
        for (int e = 0; e < VE; ++e) {
          const int d = (c + j * TPP) * VE + e;
          if (d < D) red[(warp * MAXG + g) * D + d] = acc[g][j][e];
        }
    }
  }
  __syncthreads();
  kern::store_partial<MAXG, kWarps, kThreads>(a, red, sm_m, sm_l, b, h, g0,
                                              G, sp);
}

// One block per (b, q head): merges the row's live splits (ceil(n_b /
// chunk) of them) with the decode merge K3 shares (decode_merge.cuh),
// once the split kernel has finished (launched to overlap that kernel's
// end).
template <typename T>
__global__ void __launch_bounds__(kMergeThreads)
    ragged_merge_kernel(const Args a) {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  const int Hq = a.Hkv * a.G;
  const int hq = blockIdx.x % Hq;
  const int b = blockIdx.x / Hq;
  int pc;
  const int n = attended(a.kv_len, a.pfx, b, a.Skv, a.prefix_len, &pc);
  kern::merge_splits<T, false>(a, b, hq, (n + a.chunk - 1) / a.chunk);
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

// Launch the tensor-core kernel over the split grid, or, with `resident`
// set, write the blocks of it one SM holds instead.
template <typename T, int DP, int NR>
cudaError_t launch_mma(const Args& a, const CUtensorMap& tmk,
                       const CUtensorMap& tmv, cudaStream_t s,
                       int* resident) {
  static unsigned ready = 0;
  const auto fn = ragged_mma_kernel<T, DP, NR>;
  const int smem = kern::dec_smem(DP, NR, a.D);
  cudaError_t err = allow_smem(fn, smem, &ready);
  if (err != cudaSuccess) return err;
  if (resident != nullptr)
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        resident, fn, kern::kDecThreads, smem);
  ragged_mma_kernel<T, DP, NR>
      <<<dim3(a.Hkv * a.ngrp, a.B, a.nsplit), kern::kDecThreads, smem, s>>>(
          a, tmk, tmv);
  return cudaGetLastError();
}

template <typename T, int DP>
cudaError_t launch_dp(const Args& a, const CUtensorMap& tmk,
                      const CUtensorMap& tmv, cudaStream_t s,
                      int* resident) {
  return a.gs <= 8 ? launch_mma<T, DP, 1>(a, tmk, tmv, s, resident)
                   : launch_mma<T, DP, 2>(a, tmk, tmv, s, resident);
}

// The CUDA-core kernel, or its occupancy.
template <typename T, int MAXG>
cudaError_t launch_g(const Args& a, cudaStream_t s, int* resident) {
  const auto fn = vectors_per_lane(a.D, sizeof(T)) == 2
                      ? ragged_split_kernel<T, MAXG, 2>
                      : ragged_split_kernel<T, MAXG, 1>;
  if (resident != nullptr)
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(resident, fn,
                                                         kThreads, 0);
  fn<<<dim3(a.Hkv * a.ngrp, a.B, a.nsplit), kThreads, 0, s>>>(a);
  return cudaGetLastError();
}

// The split kernel (or its occupancy), then the merge: bf16 / fp16 on the
// tensor cores, which match or beat the CUDA-core kernel at every G, 1 and
// 2 included (PERF.md); float32 on the CUDA cores.
template <typename T>
cudaError_t launch(const Args& a, const CUtensorMap& tmk,
                   const CUtensorMap& tmv, cudaStream_t s, int* resident) {
  cudaError_t err;
  if constexpr (sizeof(T) == 2) {
    switch (kern::dec_dp(a.D)) {
      case 64: err = launch_dp<T, 64>(a, tmk, tmv, s, resident); break;
      case 128: err = launch_dp<T, 128>(a, tmk, tmv, s, resident); break;
      case 192: err = launch_dp<T, 192>(a, tmk, tmv, s, resident); break;
      default: err = launch_dp<T, 256>(a, tmk, tmv, s, resident); break;
    }
  } else {
    switch (max_g(a.gs)) {
      case 1: err = launch_g<T, 1>(a, s, resident); break;
      case 2: err = launch_g<T, 2>(a, s, resident); break;
      case 4: err = launch_g<T, 4>(a, s, resident); break;
      default: err = launch_g<T, 8>(a, s, resident); break;
    }
  }
  if (err != cudaSuccess || resident != nullptr) return err;
  cudaLaunchAttribute overlap[1];
  overlap[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  overlap[0].val.programmaticStreamSerializationAllowed = kOverlapMerge;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(a.B * a.Hkv * a.G);
  cfg.blockDim = dim3(kMergeThreads);
  cfg.stream = s;
  cfg.attrs = overlap;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, ragged_merge_kernel<T>, a);
}

cudaError_t dispatch(const Args& a, int dtype, const CUtensorMap& tmk,
                     const CUtensorMap& tmv, cudaStream_t s, int* resident) {
  switch (dtype) {
    case 0: return launch<float>(a, tmk, tmv, s, resident);
    case 1: return launch<__nv_bfloat16>(a, tmk, tmv, s, resident);
    default: return launch<__half>(a, tmk, tmv, s, resident);
  }
}

int esize_of(int dtype) { return dtype == 0 ? 4 : 2; }

// Attended positions per tile of the route: kDecTile on the tensor cores,
// a CUDA-core sub-tile (PPT * 128 / TPP) on the CUDA cores. A split's
// chunk is a whole number of them.
int tile_of(bool tc, int D, int es) {
  return tc ? kDecTile : sub_tile_positions(D, es);
}

}  // namespace

// The geometry the wrapper plans a launch with, for G query heads per KV
// head, head dim D and dtype (0 float32, 1 bfloat16, 2 float16), on the
// current device: out[0] 1 on the tensor cores, 0 on the CUDA cores;
// out[1] split blocks one SM holds (the occupancy of the instance); out[2]
// the positions of one tile (a chunk is a multiple); out[3] the chunk of
// the CUDA-core route (kSub sub-tiles; 0 on the tensor cores, whose
// chunks the wrapper sizes to the grid); out[4] heads per head group at
// most. Returns a cudaError_t (0 on success).
extern "C" int ragged_decode_geometry(int G, int D, int dtype, int* out) {
  if (G < 1 || D < 1 || D > kMaxD || dtype < 0 || dtype > 2)
    return static_cast<int>(cudaErrorInvalidValue);
  const int es = esize_of(dtype);
  const bool tc = dtype != 0;
  const int cap = head_cap(tc);
  Args a{};
  a.B = a.Hkv = a.nsplit = 1;
  a.G = G;
  a.D = D;
  a.gs = heads_per_group(G, cap);
  a.ngrp = head_groups(G, cap);
  int resident = 0;
  const CUtensorMap none{};
  const cudaError_t err = dispatch(a, dtype, none, none, nullptr,
                                   &resident);
  out[0] = tc;
  out[1] = resident;
  out[2] = tile_of(tc, D, es);
  out[3] = tc ? 0 : kSub * tile_of(tc, D, es);
  out[4] = cap;
  return static_cast<int>(err);
}

// q (B, Hq, D), k/v (B, Skv, Hkv, D), out (B, Hq, D); strides in elements,
// the head dim contiguous. po/pm/pl: float32 scratch of (B, Hkv, nsplit,
// G[, D]); nsplit = max(1, ceil(Skv / chunk)) blocks per (row, head group)
// of `chunk` attended indices each, chunk a whole number of the route's
// tiles (ragged_decode_geometry). Returns the launches'
// cudaGetLastError() (0 on success).
extern "C" int ragged_decode_launch(
    const void* q, const void* k, const void* v, const int* kv_len,
    const int* pfx, float* po, float* pm, float* pl, void* out, int B,
    int Hkv, int G, int D, int Skv, int prefix_len, int nsplit, int chunk,
    long long q_sb, long long q_sh, long long k_sb, long long k_ss,
    long long k_sh, long long v_sb, long long v_ss, long long v_sh,
    long long o_sb, long long o_sh, float scale, int dtype, void* stream) {
  if (G < 1 || D < 1 || D > kMaxD || B < 1 || B > 65535 || Hkv < 1 ||
      Skv < 0 || prefix_len < 0 || prefix_len > Skv || dtype < 0 ||
      dtype > 2)
    return static_cast<int>(cudaErrorInvalidValue);
  const int es = esize_of(dtype);
  const bool tc = dtype != 0;
  const int cap = head_cap(tc);
  // Skv == 0 still takes one split block, which exits at once
  if (chunk < 1 || chunk % tile_of(tc, D, es) != 0 ||
      nsplit != max(1, (Skv + chunk - 1) / chunk) || nsplit > 65535 ||
      static_cast<long long>(Hkv) * head_groups(G, cap) > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  // The tensor cores read K and V by TMA where maps describe them (cached:
  // the serving buffers persist), the CUDA cores by cp.async where rows are
  // 16-byte aligned (a stride of a dim of size 1 is never stepped); either
  // kernel stages the other rows by plain loads.
  CUtensorMap tmk{};
  CUtensorMap tmv{};
  const auto al = [es](const void* p, long long sb, long long ss,
                       long long sh, int B, int S, int H) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0 &&
           (B == 1 || (sb * es) % 16 == 0) &&
           (S == 1 || (ss * es) % 16 == 0) && (H == 1 || (sh * es) % 16 == 0);
  };
  const int aligned =
      tc ? Skv > 0 &&
               kern::cached_map(&tmk, k, dtype, B, Skv, Hkv, D, k_sb, k_ss,
                                k_sh, 64, kDecTile, true) &&
               kern::cached_map(&tmv, v, dtype, B, Skv, Hkv, D, v_sb, v_ss,
                                v_sh, 64, kDecTile, true)
         : (D * es) % 16 == 0 && al(k, k_sb, k_ss, k_sh, B, Skv, Hkv) &&
               al(v, v_sb, v_ss, v_sh, B, Skv, Hkv);
  Args a{q,     k,    v,    kv_len, pfx,    po,
         pm,    pl,   out,  B,      Hkv,    G,
         D,     Skv,  prefix_len,   nsplit, chunk,
         lanes_per_position(D, es),   aligned,
         heads_per_group(G, cap),     head_groups(G, cap),
         q_sb,  q_sh, k_sb, k_ss,   k_sh,   v_sb,
         v_ss,  v_sh, o_sb, o_sh,   scale};
  return static_cast<int>(dispatch(a, dtype, tmk, tmv,
                                   static_cast<cudaStream_t>(stream),
                                   nullptr));
}
