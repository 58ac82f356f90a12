// One-token GQA decode over a single-segment KV cache, for sm_90a.
//
// Replaces the Pallas kernel src/repro/kernels/flash_decode.py
// (_decode_kernel), in both of its forms: the normalised output
// (flash_decode) and the unnormalised (o, m, l) partials that the
// sequence-sharded decode merges across shards with the log-sum-exp rule
// (flash_decode_partials). Row b attends position j when
//     j < min(kv_len[b], Skv)   and, with a window,   (kv_len[b]-1) - j < window
// so the attended positions of a row are one contiguous range [lo, hi),
// hi = min(kv_len, Skv), lo = window ? max(0, kv_len - window) : 0.
//
// Bound: a decode reads every attended K and V row once and does 4*G*D
// flops per attended position and KV head, far below the card's
// flop/byte balance, so the kernel is bound by the bytes of K and V: at 32k
// positions, B 4, 8 KV heads of 128 in bf16, 421 MB, 126 us at 3.35 TB/s.
// Reaching that takes ~2 MB in flight across the card, blocks of equal
// work, and consumers that keep up with the stream.
// Design:
//  * Fixed chunks, grid from Skv. A block takes CHUNK positions of a row's
//    attended range, [lo + sp*CHUNK, lo + (sp+1)*CHUNK) within [lo, hi);
//    the grid is (Hkv, B, ceil(S_eff / CHUNK)), S_eff = min(Skv, window),
//    sized on the host from shapes alone (the lengths stay on the device:
//    no host sync). A block of a short row does the same work as a block
//    of a long row, and a block past its row's end exits after one length
//    read. CHUNK at bf16 / fp16 is 1,024 positions up to D 128 (about 750
//    live blocks at the 32k cache) and 256 above (64 blocks at a window of
//    1,024 with 4 KV heads of 256 and B 4); at float32 8 tiles.
//  * K/V by TMA into a ring. 4-D tensor maps over the cache's own (B, Skv,
//    Hkv, D) strides (tma.cuh; encoded on the host once per buffer and
//    layout, then taken from a cache) load boxes of one
//    KV head x a tile of positions into a ring of 2-4 stages in dynamic
//    shared memory (3 stages of 32 KB at bf16 D 128, two blocks an SM);
//    one producer warp issues the loads and four consumer warps compute,
//    with full and empty mbarriers per stage, so up to ~190 KB per SM are
//    in flight while the consumers work. The sharded decode's
//    sequence slices are plain strided views and take the same maps. Rows a
//    map cannot describe (a base, stride or row that is not a multiple of 16
//    bytes) are staged by the producer warp with plain loads into the same
//    ring: the same kernel, never refused. Per-lane cp.async was not
//    taken: K1's earlier split kernel, which staged with it, read at 0.30
//    of the HBM rate at its long cache (PERF.md), and TMA keeps a whole
//    tile in flight per instruction. K1 now runs the same tensor-core
//    block over the same maps.
//  * bf16 / fp16 on the tensor cores (decode_mma_kernel). A first version
//    computed on the CUDA cores as the float32 path does; its consumers
//    alone (no loads) took longer than the stream alone (no compute) at the
//    32k cache, so both products moved to mma.sync m16n8k16, in the split
//    block K1 shares (decode_mma.cuh; K3 gives it one run of positions a
//    block, K1 two): a tile is 64 positions of K and V as
//    64-value column blocks in the 128-byte swizzle (K2's layout), each
//    consumer warp takes 16 positions, the group's heads are the rows of A
//    (rows 0-7 for G <= 8, rows 0-15 for G <= 16), and O += P V takes P
//    from the score registers as a 16-bit high part plus the rounding of
//    its residual. V rows past the chunk's end are zeroed before the
//    product (0 * NaN would reach O).
//  * float32 on the CUDA cores (decode_split_kernel; mma.sync takes no
//    float32 operands and TF32 would not hold float32 parity): TPP lanes
//    share a position, each holding one 16-byte vector of q (pre-scaled)
//    per head and reading 16-byte vectors of K and V rows from shared
//    memory; the TPP lanes sum their partial dot products with log2(TPP)
//    shuffles, two positions at once, and one online-softmax step covers
//    both.
//  * The position groups (or lanes) of a warp and then the warps merge
//    through shared memory (decode_merge.cuh: store_partial) into one
//    float32 partial (o, m, l) per (row, KV head, chunk, q head) in
//    scratch. A second kernel of the same C call, the merge K1 launches too
//    (decode_merge.cuh), merges a row's live chunks, ceil((hi - lo) /
//    CHUNK), one block per (row, q head), and writes the normalised output
//    (exact zeros where hi <= lo) or the merged partials (m = -1e30, l = 0
//    for an empty row).
//  * Wider groups split into ngrp head groups of gs heads, one block each
//    (grid x = Hkv * ngrp): at most 16 heads on the tensor cores, so
//    starcoder2's G 9 and any G up to 16 read each K/V tile once, and at
//    most 8 on the CUDA cores, where the float32 path keeps q and the
//    accumulators in registers at MAXG 8 (G 9 to 16 read each tile twice
//    there; the second read mostly hits L2, as both blocks run at once).
//    G <= 8 takes one group, g0 = 0, in rows 0-7 of A: the instances and
//    their work are those of the kernel before the groups.
// Both kernels take any G and D <= 256; both write through the same merge.
#include <cstdint>

#include "common.cuh"
#include "decode_merge.cuh"
#include "decode_mma.cuh"
#include "tma.cuh"

namespace {

using kern::from_f;
using kern::kMergeThreads;
using kern::kNegInf;
using kern::lse_merge;
using kern::mbar_arrive;
using kern::mbar_expect_tx;
using kern::mbar_init;
using kern::mbar_wait;
using kern::smem_u32;
using kern::to_f;
using kern::unpack;

constexpr int kConsumers = 128;  // four consumer warps
constexpr int kWarps = kConsumers / 32;
constexpr int kThreads = kConsumers + 32;  // and one producer warp
constexpr int kTilesPerChunk = 8;
constexpr int kMaxD = 256;

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const int* kv_len;
  float* po;  // (B, Hkv, nsplit, G, D)
  float* pm;  // (B, Hkv, nsplit, G)
  float* pl;  // (B, Hkv, nsplit, G)
  void* out;     // normalised: (B, Hq, D) in the input dtype
  float* o_out;  // or the merged partials: (B, Hq, D), (B, Hq), (B, Hq)
  float* m_out;
  float* l_out;
  int B, Hkv, G, D, Skv, window, nsplit, chunk, tile, tpp, aligned;
  int gs, ngrp;  // query heads per block (<= 8 / 16) and groups per KV head
  long long q_sb, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, o_sb, o_sh;
  float scale;
};

// Geometry shared by the host and the kernel: 16-byte vectors per row
// (vpr), vectors per lane (one, two above 512-byte rows), lanes per
// position (a power of two), positions per tile (4 per lane group, at
// most 256, the largest TMA box) and ring stages.
__host__ __device__ inline int vectors_per_row(int D, int es) {
  return (D * es + 15) / 16;
}
__host__ __device__ inline int vectors_per_lane(int D, int es) {
  return vectors_per_row(D, es) > 32 ? 2 : 1;
}
__host__ __device__ inline int lanes_per_position(int D, int es) {
  const int need = (vectors_per_row(D, es) + vectors_per_lane(D, es) - 1) /
                   vectors_per_lane(D, es);
  int t = 1;
  while (t < need) t <<= 1;
  return t;
}
__host__ __device__ inline int tile_positions(int D, int es) {
  const int p = kConsumers / lanes_per_position(D, es);
  return 4 * p < 256 ? 4 * p : 256;
}
__host__ __device__ constexpr int ring_stages(int vpt) {
  return vpt == 1 ? 4 : 2;
}
// Head groups of at most `cap` heads per KV head, as even as they go: 8
// on the CUDA cores (float32), 16 on the tensor cores (the rows of A).
__host__ __device__ inline int head_groups(int G, int cap) {
  return (G + cap - 1) / cap;
}
__host__ __device__ inline int heads_per_group(int G, int cap) {
  const int n = head_groups(G, cap);
  return (G + n - 1) / n;
}

// Attended range [lo, hi) of row b.
__device__ __forceinline__ void row_range(const int* kv_len, int b, int Skv,
                                          int window, int* lo, int* hi) {
  const int n = kv_len[b];
  *hi = min(n, Skv);
  *lo = window >= 0 ? max(0, n - window) : 0;
}

// Stage one tile of K or V rows [pos0, pos0 + tile) by plain loads into
// 16-byte vectors (zeros past D and for positions at or past `end`): the
// route for rows a tensor map cannot describe. The 32 lanes of the
// producer warp share it.
template <typename T>
__device__ __forceinline__ void stage_tile(unsigned char* dst, const T* rows,
                                           long long ss, int pos0, int end,
                                           int tile, int vpr, int D,
                                           int lane) {
  constexpr int VE = 16 / sizeof(T);
  for (int idx = lane; idx < tile * vpr; idx += 32) {
    const int r = idx / vpr;
    const int vi = idx % vpr;
    const int pos = pos0 + r;
    __align__(16) T tmp[VE];
#pragma unroll
    for (int e = 0; e < VE; ++e) {
      const int d = vi * VE + e;
      tmp[e] = (pos < end && d < D) ? rows[pos * ss + d] : from_f<T>(0.f);
    }
    *reinterpret_cast<uint4*>(dst + idx * 16) =
        *reinterpret_cast<const uint4*>(tmp);
  }
}

// Grid (Hkv * ngrp, B, nsplit), kThreads threads: warps 0-3 compute, warp
// 4 loads. Dynamic shared memory: the ring (stages x (K tile, V tile), each
// tile rows of vpr 16-byte vectors), reused after the loop for the warps'
// partials, then the full and empty barriers.
template <typename T, int MAXG, int VPT>
__global__ void __launch_bounds__(kThreads)
    decode_split_kernel(const Args a, const __grid_constant__ CUtensorMap tmk,
                        const __grid_constant__ CUtensorMap tmv) {
  constexpr int VE = 16 / sizeof(T);
  constexpr int kStages = ring_stages(VPT);
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 127) & ~uintptr_t(127));
  const int h = blockIdx.x / a.ngrp;
  const int g0 = (blockIdx.x % a.ngrp) * a.gs;  // first head of the group
  const int G = min(a.gs, a.G - g0);             // heads of this block
  const int D = a.D;
  const int vpr = (D + VE - 1) / VE;
  const int TILE = a.tile;
  const int tile_bytes = TILE * vpr * 16;
  const int ring_bytes = kStages * 2 * tile_bytes;
  const int red_bytes = kWarps * MAXG * D * 4;
  const uint32_t bars =
      smem_u32(smem) + (ring_bytes > red_bytes ? ring_bytes : red_bytes);
  auto full = [&](int st) { return bars + 8 * st; };
  auto empty = [&](int st) { return bars + 8 * (kStages + st); };

  const int b = blockIdx.y;
  const int sp = blockIdx.z;
  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  int lo, hi;
  row_range(a.kv_len, b, a.Skv, a.window, &lo, &hi);
  const int t0 = lo + sp * a.chunk;
  if (t0 >= hi) return;  // uniform over the block; the merge skips it
  const int end = min(hi, t0 + a.chunk);
  const int ntile = (end - t0 + TILE - 1) / TILE;
  const bool aligned = a.aligned != 0;

  if (tid == 0) {
    for (int st = 0; st < kStages; ++st) {
      mbar_init(full(st), aligned ? 1 : 32);
      mbar_init(empty(st), kConsumers);
    }
    kern::mbar_init_fence();
  }
  __syncthreads();

  if (warp == kWarps) {  // producer: keeps the ring full
    const T* kb = static_cast<const T*>(a.k) + b * a.k_sb + h * a.k_sh;
    const T* vb = static_cast<const T*>(a.v) + b * a.v_sb + h * a.v_sh;
    for (int it = 0; it < ntile; ++it) {
      const int st = it % kStages;
      const int pos0 = t0 + it * TILE;
      if (aligned) {
        if (lane == 0) {
          if (it >= kStages)
            mbar_wait(empty(st), ((it / kStages) & 1) ^ 1);
          mbar_expect_tx(full(st), 2 * tile_bytes);
          const uint32_t dst = smem_u32(smem) + st * 2 * tile_bytes;
          kern::tma_load(dst, &tmk, 0, h, pos0, b, full(st));
          kern::tma_load(dst + tile_bytes, &tmv, 0, h, pos0, b, full(st));
        }
      } else {
        if (it >= kStages) mbar_wait(empty(st), ((it / kStages) & 1) ^ 1);
        unsigned char* dst = smem + st * 2 * tile_bytes;
        stage_tile<T>(dst, kb, a.k_ss, pos0, end, TILE, vpr, D, lane);
        stage_tile<T>(dst + tile_bytes, vb, a.v_ss, pos0, end, TILE, vpr, D,
                      lane);
        mbar_arrive(full(st));
      }
    }
    return;
  }

  // --- consumers: lane group p (TPP lanes, c = lane in the group) takes
  // rows p, p + P, ... of each tile, two at a time
  const int TPP = a.tpp;
  const int P = kConsumers / TPP;
  const int p = tid / TPP;
  const int c = tid % TPP;
  const int npair = TILE / (2 * P);
  const T* q = static_cast<const T*>(a.q) + b * a.q_sb;

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

  for (int it = 0; it < ntile; ++it) {
    const int st = it % kStages;
    mbar_wait(full(st), (it / kStages) & 1);
    const uint4* kt =
        reinterpret_cast<const uint4*>(smem + st * 2 * tile_bytes);
    const uint4* vt = kt + tile_bytes / 16;
    const int base = t0 + it * TILE;
    for (int ps = 0; ps < npair; ++ps) {
      int row[2];
      bool live[2];  // uniform over a position's lanes
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        row[u] = (2 * ps + u) * P + p;
        live[u] = base + row[u] < end;
      }
      // scores of the two positions for every head, summed over the TPP
      // lanes of each position (aligned lane groups)
      float sc[2][MAXG];
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        float kf[VPT][VE];
#pragma unroll
        for (int j = 0; j < VPT; ++j) {
          const int vi = c + j * TPP;
          if (vi < vpr) {
            unpack<T>(kt[row[u] * vpr + vi], kf[j]);
          } else {
#pragma unroll
            for (int e = 0; e < VE; ++e) kf[j][e] = 0.f;
          }
        }
#pragma unroll
        for (int g = 0; g < MAXG; ++g) {
          float x = 0.f;
          if (g < G) {  // uniform: heads past G cost nothing
#pragma unroll
            for (int j = 0; j < VPT; ++j)
#pragma unroll
              for (int e = 0; e < VE; ++e) x += qr[g][j][e] * kf[j][e];
          }
          sc[u][g] = x;
        }
      }
      for (int o = TPP / 2; o > 0; o >>= 1)
#pragma unroll
        for (int u = 0; u < 2; ++u)
#pragma unroll
          for (int g = 0; g < MAXG; ++g)
            if (g < G) sc[u][g] += __shfl_xor_sync(0xffffffffu, sc[u][g], o);
      if (!live[0]) continue;  // rows fill in order: u = 1 is dead too
      float vf[2][VPT][VE];
#pragma unroll
      for (int u = 0; u < 2; ++u)
#pragma unroll
        for (int j = 0; j < VPT; ++j) {
          const int vi = c + j * TPP;
          if (live[u] && vi < vpr) {
            unpack<T>(vt[row[u] * vpr + vi], vf[u][j]);
          } else {
#pragma unroll
            for (int e = 0; e < VE; ++e) vf[u][j][e] = 0.f;
          }
        }
      // one online-softmax step over the group's live positions
#pragma unroll
      for (int g = 0; g < MAXG; ++g) {
        if (g >= G) break;
        float m_new = fmaxf(m[g], sc[0][g]);
        if (live[1]) m_new = fmaxf(m_new, sc[1][g]);
        const float alpha = expf(m[g] - m_new);
        const float p0 = expf(sc[0][g] - m_new);
        const float p1 = live[1] ? expf(sc[1][g] - m_new) : 0.f;
        l[g] = l[g] * alpha + p0 + p1;
#pragma unroll
        for (int j = 0; j < VPT; ++j)
#pragma unroll
          for (int e = 0; e < VE; ++e)
            acc[g][j][e] =
                acc[g][j][e] * alpha + p0 * vf[0][j][e] + p1 * vf[1][j][e];
        m[g] = m_new;
      }
    }
    mbar_arrive(empty(st));  // this thread is done with the stage
  }

  // merge the position groups of the warp (lanes TPP apart) ...
  for (int o = TPP; o < 32; o <<= 1) {
#pragma unroll
    for (int g = 0; g < MAXG; ++g) {
      if (g >= G) break;
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
  // ... then the warps, through shared memory: the ring is done with once
  // every consumer has passed its last tile (the producer has exited)
  asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumers) : "memory");
  float* red = reinterpret_cast<float*>(smem);  // [kWarps][MAXG][D]
  __shared__ float sm_m[kWarps][MAXG];
  __shared__ float sm_l[kWarps][MAXG];
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
  asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumers) : "memory");
  kern::store_partial<MAXG, kWarps, kConsumers>(a, red, sm_m, sm_l, b, h,
                                                g0, G, sp);
}

// ---------------------------------------------------------------------------
// bf16 / fp16: the tensor-core split block K1 shares (decode_mma.cuh)
// ---------------------------------------------------------------------------
constexpr int kTcTile = kern::kDecTile;  // positions per tile

// Tiles per chunk: 512 KB of K and V up to D 128 (1,024 positions: a
// block's ramp is then a small part of its life), 256 KB above (256
// positions, so that a window of 1,024 still fills 64 blocks at
// B*Hkv = 16).
__host__ __device__ constexpr int tc_tiles_per_chunk(int DP) {
  return DP <= 64 ? 32 : DP <= 128 ? 16 : 4;
}

// A block's one run of positions [t0, end), in tiles from t0.
struct OneRun {
  int t0, end;
  __device__ __forceinline__ int count() const {
    return (end - t0 + kTcTile - 1) / kTcTile;
  }
  __device__ __forceinline__ void tile(int it, int* pos0, int* e) const {
    *pos0 = t0 + it * kTcTile;
    *e = end;
  }
};

// Grid (Hkv * ngrp, B, nsplit), kThreads threads: block sp takes the
// chunk [lo + sp * CHUNK, ...) of its row's attended range through the
// shared tensor-core block, the group's heads in rows 0-7 (NR = 1) or 0-15
// (NR = 2) of A.
template <typename T, int DP, int NR>
__global__ void __launch_bounds__(kThreads)
    decode_mma_kernel(const Args a, const __grid_constant__ CUtensorMap tmk,
                      const __grid_constant__ CUtensorMap tmv) {
  const int h = blockIdx.x / a.ngrp;
  const int g0 = (blockIdx.x % a.ngrp) * a.gs;  // first head of the group
  const int b = blockIdx.y;
  const int sp = blockIdx.z;
  int lo, hi;
  row_range(a.kv_len, b, a.Skv, a.window, &lo, &hi);
  const int t0 = lo + sp * a.chunk;
  if (t0 >= hi) return;  // uniform over the block; the merge skips it
  kern::mma_decode_block<T, DP, NR>(a, &tmk, &tmv,
                                    OneRun{t0, min(hi, t0 + a.chunk)}, b, h,
                                    g0, min(a.gs, a.G - g0), sp);
}

// One block per (b, q head): merges the row's live chunks.
template <typename T, bool kPartials>
__global__ void __launch_bounds__(kMergeThreads)
    decode_merge_kernel(const Args a) {
  const int Hq = a.Hkv * a.G;
  const int hq = blockIdx.x % Hq;
  const int b = blockIdx.x / Hq;
  int lo, hi;
  row_range(a.kv_len, b, a.Skv, a.window, &lo, &hi);
  kern::merge_splits<T, kPartials>(a, b, hq,
                                   (max(0, hi - lo) + a.chunk - 1) / a.chunk);
}

int max_g(int G) { return G <= 1 ? 1 : G <= 2 ? 2 : G <= 4 ? 4 : 8; }

template <typename T, int MAXG, int VPT>
cudaError_t launch_split(const Args& a, const CUtensorMap& tmk,
                         const CUtensorMap& tmv, cudaStream_t s) {
  const int vpr = vectors_per_row(a.D, sizeof(T));
  const int ring = ring_stages(VPT) * 2 * a.tile * vpr * 16;
  const int red = kWarps * MAXG * a.D * 4;
  const int smem = (ring > red ? ring : red) + 2 * ring_stages(VPT) * 8 + 128;
  cudaError_t err = cudaFuncSetAttribute(
      decode_split_kernel<T, MAXG, VPT>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  decode_split_kernel<T, MAXG, VPT>
      <<<dim3(a.Hkv * a.ngrp, a.B, a.nsplit), kThreads, smem, s>>>(a, tmk,
                                                                   tmv);
  return cudaGetLastError();
}

template <typename T, int MAXG>
cudaError_t launch_g(const Args& a, const CUtensorMap& tmk,
                     const CUtensorMap& tmv, cudaStream_t s) {
  return vectors_per_lane(a.D, sizeof(T)) == 2
             ? launch_split<T, MAXG, 2>(a, tmk, tmv, s)
             : launch_split<T, MAXG, 1>(a, tmk, tmv, s);
}

template <typename T, int DP, int NR>
cudaError_t launch_mma_nr(const Args& a, const CUtensorMap& tmk,
                          const CUtensorMap& tmv, cudaStream_t s) {
  const int smem = kern::dec_smem(DP, NR, a.D);
  cudaError_t err = cudaFuncSetAttribute(
      decode_mma_kernel<T, DP, NR>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  decode_mma_kernel<T, DP, NR>
      <<<dim3(a.Hkv * a.ngrp, a.B, a.nsplit), kThreads, smem, s>>>(a, tmk,
                                                                   tmv);
  return cudaGetLastError();
}

template <typename T, int DP>
cudaError_t launch_mma(const Args& a, const CUtensorMap& tmk,
                       const CUtensorMap& tmv, cudaStream_t s) {
  return a.gs <= 8 ? launch_mma_nr<T, DP, 1>(a, tmk, tmv, s)
                   : launch_mma_nr<T, DP, 2>(a, tmk, tmv, s);
}

// float32 on the CUDA cores (mma.sync takes no float32 operands and TF32
// would not hold float32 parity), bf16 / fp16 on the tensor cores; then
// the merge.
template <typename T>
cudaError_t launch(const Args& a, const CUtensorMap& tmk,
                   const CUtensorMap& tmv, cudaStream_t s) {
  cudaError_t err;
  if constexpr (sizeof(T) == 4) {
    switch (max_g(a.gs)) {
      case 1: err = launch_g<T, 1>(a, tmk, tmv, s); break;
      case 2: err = launch_g<T, 2>(a, tmk, tmv, s); break;
      case 4: err = launch_g<T, 4>(a, tmk, tmv, s); break;
      default: err = launch_g<T, 8>(a, tmk, tmv, s); break;
    }
  } else {
    switch (kern::dec_dp(a.D)) {
      case 64: err = launch_mma<T, 64>(a, tmk, tmv, s); break;
      case 128: err = launch_mma<T, 128>(a, tmk, tmv, s); break;
      case 192: err = launch_mma<T, 192>(a, tmk, tmv, s); break;
      default: err = launch_mma<T, 256>(a, tmk, tmv, s); break;
    }
  }
  if (err != cudaSuccess) return err;
  const int blocks = a.B * a.Hkv * a.G;
  if (a.out != nullptr)
    decode_merge_kernel<T, false><<<blocks, kMergeThreads, 0, s>>>(a);
  else
    decode_merge_kernel<T, true><<<blocks, kMergeThreads, 0, s>>>(a);
  return cudaGetLastError();
}

int esize_of(int dtype) { return dtype == 0 ? 4 : 2; }

// Positions of one tile: float32 rows of up to 512 bytes in 4-position
// lane-group tiles; bf16 / fp16 kTcTile.
int tile_of(int D, int dtype) {
  return dtype == 0 ? tile_positions(D, 4) : kTcTile;
}

// Tensor maps of K and V whose boxes are one tile: whole rows for float32,
// 64-value column blocks in the 128-byte swizzle for bf16 / fp16; false
// where either view cannot be described (its rows are then staged).
bool make_maps(CUtensorMap* tmk, CUtensorMap* tmv, const void* k,
               const void* v, int B, int Hkv, int D, int Skv, long long k_sb,
               long long k_ss, long long k_sh, long long v_sb, long long v_ss,
               long long v_sh, int dtype) {
  const int tile = tile_of(D, dtype);
  const int box = dtype == 0 ? D : 64;
  const bool sw = dtype != 0;
  return Skv > 0 &&
         kern::cached_map(tmk, k, dtype, B, Skv, Hkv, D, k_sb, k_ss, k_sh,
                          box, tile, sw) &&
         kern::cached_map(tmv, v, dtype, B, Skv, Hkv, D, v_sb, v_ss, v_sh,
                          box, tile, sw);
}

}  // namespace

// Positions one split block covers (the wrapper sizes the grid and the
// scratch with it). dtype: 0 float32, 1 bfloat16, 2 float16.
extern "C" int flash_decode_chunk(int D, int dtype) {
  return dtype == 0 ? kTilesPerChunk * tile_positions(D, 4)
                    : tc_tiles_per_chunk(kern::dec_dp(D)) * kTcTile;
}

// Whether the fast route serves these K and V views: both describable by a
// tensor map (bases, strides and rows multiples of 16 bytes). The other
// route stages rows by plain loads in the same kernel.
extern "C" int flash_decode_tma_route(const void* k, const void* v, int B,
                                      int Hkv, int D, int Skv,
                                      long long k_sb, long long k_ss,
                                      long long k_sh, long long v_sb,
                                      long long v_ss, long long v_sh,
                                      int dtype) {
  CUtensorMap tmk;
  CUtensorMap tmv;
  return make_maps(&tmk, &tmv, k, v, B, Hkv, D, Skv, k_sb, k_ss, k_sh, v_sb,
                   v_ss, v_sh, dtype);
}

// dtype: 0 float32, 1 bfloat16, 2 float16. window < 0 means none. Strides
// are in elements; the head dim of q, k and v must be contiguous. nsplit
// must be max(1, ceil(S_eff / chunk)), S_eff = min(Skv, window) with a
// window, else Skv, and chunk = flash_decode_chunk(D, dtype). The scratch
// po/pm/pl holds (B, Hkv, nsplit, G[, D]) float32. normalize=1 writes `out`
// (B, Hq, D) contiguous in the input dtype; normalize=0 writes the merged
// partials o_out (B, Hq, D), m_out and l_out (B, Hq) in float32. Returns
// the launches' cudaGetLastError() (0 on success).
extern "C" int flash_decode_launch(
    const void* q, const void* k, const void* v, const int* kv_len, float* po,
    float* pm, float* pl, void* out, float* o_out, float* m_out, float* l_out,
    int B, int Hkv, int G, int D, int Skv, int window, int nsplit,
    long long q_sb, long long q_sh, long long k_sb, long long k_ss,
    long long k_sh, long long v_sb, long long v_ss, long long v_sh,
    float scale, int dtype, int normalize, void* stream) {
  if (G < 1 || D < 1 || D > kMaxD || B < 1 || B > 65535 ||
      Hkv < 1 || Skv < 0 || dtype < 0 || dtype > 2)
    return static_cast<int>(cudaErrorInvalidValue);
  const int es = esize_of(dtype);
  const int chunk = flash_decode_chunk(D, dtype);
  const int s_eff = window >= 0 ? (window < Skv ? window : Skv) : Skv;
  // an empty range still takes one split block, which exits at once
  if (nsplit != max(1, (s_eff + chunk - 1) / chunk) || nsplit > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap tmk{};
  CUtensorMap tmv{};
  const int aligned = make_maps(&tmk, &tmv, k, v, B, Hkv, D, Skv, k_sb, k_ss,
                                k_sh, v_sb, v_ss, v_sh, dtype);
  const long long Hq = static_cast<long long>(Hkv) * G;
  const int cap = dtype == 0 ? 8 : 16;  // heads per group
  // normalize = 1: the merge writes out; 0: the merged partials
  Args a{q,      k,      v,     kv_len, po,     pm,
         pl,     normalize ? out : nullptr, normalize ? nullptr : o_out,
         m_out,  l_out,  B,     Hkv,    G,      D,
         Skv,    window, nsplit, chunk, tile_of(D, dtype),
         lanes_per_position(D, es), aligned, heads_per_group(G, cap),
         head_groups(G, cap), q_sb, q_sh, k_sb, k_ss,
         k_sh,   v_sb,   v_ss,  v_sh,   Hq * D, D,
         scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return static_cast<int>(launch<float>(a, tmk, tmv, s));
    case 1: return static_cast<int>(launch<__nv_bfloat16>(a, tmk, tmv, s));
    default: return static_cast<int>(launch<__half>(a, tmk, tmv, s));
  }
}
