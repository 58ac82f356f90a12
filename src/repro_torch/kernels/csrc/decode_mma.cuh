// The tensor-core split block that the one-token decode kernels share (K1
// ragged_decode.cu, K3 flash_decode.cu) for bf16 / fp16, sm_90a.
//
// A block holds the query heads of one head group of one KV head and walks
// the tiles of kDecTile positions of K and V its caller's tile plan names
// (K3: one run of a row's attended range; K1: at most two runs, the real
// bucket entries and the self region). One producer warp keeps a ring of
// dec_stages tiles full: by TMA, a box of one KV head x 64 positions x 64
// values per column block in the 128-byte swizzle (K2's layout), from a
// tensor map over the cache's own (B, S, Hkv, D) strides; or, for rows a
// map cannot describe (a base, stride or row that is not a multiple of 16
// bytes), by plain loads into the same layout. Full and empty mbarriers per
// stage. Consumer warp w takes rows 16w..16w+15 of every tile. S = Q K^T
// and O += P V run as mma.sync m16n8k16 with the group's heads as the rows
// of A: NR = 1 holds G <= 8 heads in rows 0-7 (rows 8-15 zero, no registers
// spent on them), NR = 2 holds G <= 16 heads in rows 0-15, so a group of 9
// to 16 heads reads each K/V row once. K is read by ldmatrix and V by
// transposed ldmatrix. The softmax is base 2 and online over the
// accumulator's registers: a quad of lanes holds each of its heads' 16
// scores of a tile slice. P enters the second product as a 16-bit high part
// plus the 16-bit rounding of its residual (P to ~2^-17, as K2 does), so
// bf16 / fp16 keep the float32 plain version's tolerance. A TMA box holds
// whatever the cache has past a run's end; those V rows are zeroed before
// the product (0 * NaN would reach O). The warps' partials fold into the
// block's float32 (o, m, l) (decode_merge.cuh: store_partial).
#pragma once

#include <cstdint>

#include "common.cuh"
#include "decode_merge.cuh"
#include "tma.cuh"

namespace kern {

constexpr int kDecTile = 64;        // positions per tile: 16 per consumer warp
constexpr int kDecConsumers = 128;  // four consumer warps
constexpr int kDecWarps = kDecConsumers / 32;
constexpr int kDecThreads = kDecConsumers + 32;  // and one producer warp
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// Byte offset of 16-byte chunk c (of DP / 8) of row r in a tile laid out as
// DP / 64 column blocks of [kDecTile rows][128 bytes] in the 128-byte
// swizzle (the layout a TMA box of 64 values writes).
__device__ __forceinline__ uint32_t swz(int r, int c) {
  return (c >> 3) * (kDecTile * 128) + r * 128 + (((c & 7) ^ (r & 7)) << 4);
}

// Head dim padded to whole 64-value column blocks (one TMA box each), ring
// stages (3 of 32 KB at D 128, two blocks an SM) and the dynamic shared
// memory of a block: 1,024 bytes for the swizzle atoms' alignment, the ring
// (or the warps' partials, where larger), the barriers.
__host__ __device__ constexpr int dec_dp(int D) { return (D + 63) / 64 * 64; }
__host__ __device__ constexpr int dec_stages(int DP) {
  return DP <= 128 ? 3 : 2;
}
__host__ __device__ constexpr int dec_smem(int DP, int NR, int D) {
  return (dec_stages(DP) * 2 * kDecTile * DP * 2 > kDecWarps * 8 * NR * D * 4
              ? dec_stages(DP) * 2 * kDecTile * DP * 2
              : kDecWarps * 8 * NR * D * 4) +
         2 * dec_stages(DP) * 8 + 1024;
}

__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t& r0,
                                        uint32_t& r1, uint32_t& r2,
                                        uint32_t& r3) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
      : "r"(addr));
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t addr, uint32_t& r0,
                                              uint32_t& r1, uint32_t& r2,
                                              uint32_t& r3) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
      : "r"(addr));
}

// D += A B, m16n8k16, float32 accumulators. a0 / a1 hold A's rows lane/4
// and lane/4 + 8 at columns 2*(lane%4) + {0, 1}, a2 / a3 the same rows at
// columns + 8; d0, d1 are D's row lane/4 and d2, d3 row lane/4 + 8, at
// columns 2*(lane%4) + {0, 1}.
template <typename T>
__device__ __forceinline__ void mma16(float& d0, float& d1, float& d2,
                                      float& d3, uint32_t a0, uint32_t a1,
                                      uint32_t a2, uint32_t a3, uint32_t b0,
                                      uint32_t b1);
template <>
__device__ __forceinline__ void mma16<__nv_bfloat16>(
    float& d0, float& d1, float& d2, float& d3, uint32_t a0, uint32_t a1,
    uint32_t a2, uint32_t a3, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d0), "+f"(d1), "+f"(d2), "+f"(d3)
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}
template <>
__device__ __forceinline__ void mma16<__half>(float& d0, float& d1, float& d2,
                                              float& d3, uint32_t a0,
                                              uint32_t a1, uint32_t a2,
                                              uint32_t a3, uint32_t b0,
                                              uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d0), "+f"(d1), "+f"(d2), "+f"(d3)
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// D += A B over the NR row halves of A that hold heads: a[half][rh] is A's
// row lane/4 + 8*rh at columns 8*half + 2*(lane%4) + {0, 1}; d[rh] is D's
// row lane/4 + 8*rh. With NR = 1, rows 8-15 of A are zero and their sums
// are dropped.
template <typename T, int NR>
__device__ __forceinline__ void mma_heads(float (&d)[NR][2],
                                          const uint32_t (&a)[2][NR],
                                          uint32_t b0, uint32_t b1) {
  if constexpr (NR == 1) {
    float d2 = 0.f, d3 = 0.f;
    mma16<T>(d[0][0], d[0][1], d2, d3, a[0][0], 0u, a[1][0], 0u, b0, b1);
  } else {
    mma16<T>(d[0][0], d[0][1], d[1][0], d[1][1], a[0][0], a[0][1], a[1][0],
             a[1][1], b0, b1);
  }
}

// One consumer warp's state: q's heads as A fragments, the output rows and
// the running base-2 max and denominator of each head the lane holds
// (lane/4 + 8*rh). DP is the head dim padded to what the layout holds.
template <typename T, int DP, int NR>
struct MmaDecode {
  uint32_t qa[DP / 16][2][NR];
  float o[DP / 8][NR][2];
  float m[NR];
  float l[NR];  // this lane's share (its quad sums it in finish)

  // q points at the group's first head of the row; heads past G and values
  // past D are zero.
  __device__ __forceinline__ void init(const T* q, long long q_sh, int G,
                                       int D) {
    const int lane = threadIdx.x % 32;
    const int gq = lane >> 2;
    const int t4 = lane & 3;
    const uint16_t* q16 = reinterpret_cast<const uint16_t*>(q);
#pragma unroll
    for (int rh = 0; rh < NR; ++rh) {
      const int g = gq + 8 * rh;
      const uint16_t* qg = q16 + g * q_sh;
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int d = kk * 16 + half * 8 + 2 * t4;
          const uint32_t x0 = (g < G && d < D) ? qg[d] : 0u;
          const uint32_t x1 = (g < G && d + 1 < D) ? qg[d + 1] : 0u;
          qa[kk][half][rh] = x0 | (x1 << 16);
        }
      m[rh] = kNegInf;
      l[rh] = 0.f;
#pragma unroll
      for (int nd = 0; nd < DP / 8; ++nd) o[nd][rh][0] = o[nd][rh][1] = 0.f;
    }
  }

  // The warp's 16 rows r0.. of the tile whose K and V sit at shared
  // addresses sK and sV, of which the first `live` (> 0) are attended;
  // sl2 is the softmax scale in base 2. The rows past `live` must hold
  // finite values (0 * NaN would reach O).
  __device__ __forceinline__ void step(uint32_t sK, uint32_t sV, int r0,
                                       int live, float sl2) {
    const int lane = threadIdx.x % 32;
    const int t4 = lane & 3;
    // S: the warp's 16 rows as two blocks of 8 positions
    float s[2][NR][2];
#pragma unroll
    for (int nb = 0; nb < 2; ++nb) {
#pragma unroll
      for (int rh = 0; rh < NR; ++rh) s[nb][rh][0] = s[nb][rh][1] = 0.f;
#pragma unroll
      for (int k2 = 0; k2 < DP / 32; ++k2) {
        uint32_t b0, b1, b2, b3;
        ldsm_x4(sK + swz(r0 + nb * 8 + (lane & 7), k2 * 4 + (lane >> 3)),
                b0, b1, b2, b3);
        mma_heads<T, NR>(s[nb], qa[2 * k2], b0, b1);
        mma_heads<T, NR>(s[nb], qa[2 * k2 + 1], b2, b3);
      }
    }
    // online softmax of each head over its 16 scores (4 per lane of a quad)
    bool ok[2][2];
#pragma unroll
    for (int nb = 0; nb < 2; ++nb)
#pragma unroll
      for (int e = 0; e < 2; ++e) ok[nb][e] = nb * 8 + 2 * t4 + e < live;
    float alpha[NR];
#pragma unroll
    for (int rh = 0; rh < NR; ++rh) {
      float mx = kNegInf;
#pragma unroll
      for (int nb = 0; nb < 2; ++nb)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          s[nb][rh][e] = ok[nb][e] ? s[nb][rh][e] * sl2 : kNegInf;
          mx = fmaxf(mx, s[nb][rh][e]);
        }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[rh], mx);  // a real score: row 0 is live
      alpha[rh] = exp2f(m[rh] - m_new);
      m[rh] = m_new;
      float ps = 0.f;
#pragma unroll
      for (int nb = 0; nb < 2; ++nb)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          s[nb][rh][e] = ok[nb][e] ? exp2f(s[nb][rh][e] - m_new) : 0.f;
          ps += s[nb][rh][e];
        }
      l[rh] = l[rh] * alpha[rh] + ps;
#pragma unroll
      for (int nd = 0; nd < DP / 8; ++nd) {
        o[nd][rh][0] *= alpha[rh];
        o[nd][rh][1] *= alpha[rh];
      }
    }
    // P as A fragments: positions 2*t4 + {0, 1} (block 0) and + 8 (block
    // 1), high part and the rounding of the residual
    uint32_t ph[2][NR];
    uint32_t pl[2][NR];
#pragma unroll
    for (int nb = 0; nb < 2; ++nb)
#pragma unroll
      for (int rh = 0; rh < NR; ++rh) {
        ph[nb][rh] = pack2<T>(s[nb][rh][0], s[nb][rh][1]);
        const float2 hi = unpack2<T>(ph[nb][rh]);
        pl[nb][rh] = pack2<T>(s[nb][rh][0] - hi.x, s[nb][rh][1] - hi.y);
      }
    // O += P V: V^T fragments of 16 head values per transposed load
#pragma unroll
    for (int n2 = 0; n2 < DP / 16; ++n2) {
      uint32_t v0, v1, v2, v3;
      ldsm_x4_trans(sV + swz(r0 + ((lane >> 3) & 1) * 8 + (lane & 7),
                             n2 * 2 + (lane >> 4)),
                    v0, v1, v2, v3);
      mma_heads<T, NR>(o[2 * n2], ph, v0, v1);
      mma_heads<T, NR>(o[2 * n2], pl, v0, v1);
      mma_heads<T, NR>(o[2 * n2 + 1], ph, v2, v3);
      mma_heads<T, NR>(o[2 * n2 + 1], pl, v2, v3);
    }
  }

  // The warp's partial for heads 0..G-1 of the group into shared memory:
  // red [warps][8*NR][D], the maxima (natural log, as the partials keep
  // them) and denominators in sm_m / sm_l [warps][8*NR].
  __device__ __forceinline__ void finish(float* red, float (*sm_m)[8 * NR],
                                         float (*sm_l)[8 * NR], int warp,
                                         int G, int D) {
    const int lane = threadIdx.x % 32;
    const int gq = lane >> 2;
    const int t4 = lane & 3;
#pragma unroll
    for (int rh = 0; rh < NR; ++rh) {
      l[rh] += __shfl_xor_sync(0xffffffffu, l[rh], 1);
      l[rh] += __shfl_xor_sync(0xffffffffu, l[rh], 2);
      const int g = gq + 8 * rh;
      if (g >= G) continue;
      if (t4 == 0) {
        sm_m[warp][g] = m[rh] * kLn2;
        sm_l[warp][g] = l[rh];
      }
#pragma unroll
      for (int nd = 0; nd < DP / 8; ++nd)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int d = nd * 8 + 2 * t4 + e;
          if (d < D) red[(warp * 8 * NR + g) * D + d] = o[nd][rh][e];
        }
    }
  }
};

// Stage one tile of K or V rows [pos0, pos0 + kDecTile) by plain loads into
// the swizzled layout (zeros past D and for positions at or past `end`):
// the producer warp's route for rows a tensor map cannot describe.
template <typename T, int DP>
__device__ __forceinline__ void stage_tile_swz(unsigned char* dst,
                                               const T* rows, long long ss,
                                               int pos0, int end, int D,
                                               int lane) {
  constexpr int NC = DP / 8;  // 16-byte chunks per row
  for (int idx = lane; idx < kDecTile * NC; idx += 32) {
    const int r = idx / NC;
    const int c = idx % NC;
    const int pos = pos0 + r;
    __align__(16) T tmp[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const int d = c * 8 + e;
      tmp[e] = (pos < end && d < D) ? rows[pos * ss + d] : from_f<T>(0.f);
    }
    *reinterpret_cast<uint4*>(dst + swz(r, c)) =
        *reinterpret_cast<const uint4*>(tmp);
  }
}

// One split block of a kernel launched with kDecThreads threads and
// dec_smem(DP, NR, D) bytes of dynamic shared memory: the heads g0..g0+G-1
// of KV head h of row b over the tiles of `tiles` (count() tiles; tile(it,
// &pos0, &end) the first position of tile it and the end of its run), into
// the partial of split sp. `a` is the caller's argument struct: q, k, v and
// their strides (q_sb, q_sh, k_sb, k_ss, k_sh, v_*), G, D, scale, aligned
// (1 where the maps describe K and V), and the scratch store_partial
// writes. Every thread of the block calls it.
template <typename T, int DP, int NR, class A, class Tiles>
__device__ __forceinline__ void mma_decode_block(const A& a,
                                                 const CUtensorMap* tmk,
                                                 const CUtensorMap* tmv,
                                                 const Tiles& tiles, int b,
                                                 int h, int g0, int G,
                                                 int sp) {
  constexpr int NCB = DP / 64;
  constexpr int MR = 8 * NR;
  constexpr int kStages = dec_stages(DP);
  constexpr int kTileBytes = kDecTile * DP * 2;  // K or V of one tile
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t sbase = (raw + 1023) & ~1023u;  // swizzle atoms: 1024 B
  unsigned char* smem = smem_raw + (sbase - raw);
  const int red_bytes = kDecWarps * MR * a.D * 4;
  const uint32_t bars =
      sbase + (kStages * 2 * kTileBytes > red_bytes ? kStages * 2 * kTileBytes
                                                    : red_bytes);
  auto full = [&](int st) { return bars + 8 * st; };
  auto empty = [&](int st) { return bars + 8 * (kStages + st); };

  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  const int D = a.D;
  const int ntile = tiles.count();
  const bool aligned = a.aligned != 0;

  if (tid == 0) {
    for (int st = 0; st < kStages; ++st) {
      mbar_init(full(st), aligned ? 1 : 32);
      mbar_init(empty(st), kDecConsumers);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (warp == kDecWarps) {  // producer: keeps the ring full
    const T* kb = static_cast<const T*>(a.k) + b * a.k_sb + h * a.k_sh;
    const T* vb = static_cast<const T*>(a.v) + b * a.v_sb + h * a.v_sh;
    for (int it = 0; it < ntile; ++it) {
      const int st = it % kStages;
      int pos0, end;
      tiles.tile(it, &pos0, &end);
      if (aligned) {
        if (lane == 0) {
          if (it >= kStages)
            mbar_wait(empty(st), ((it / kStages) & 1) ^ 1);
          mbar_expect_tx(full(st), 2 * kTileBytes);
          const uint32_t dk = sbase + st * 2 * kTileBytes;
#pragma unroll
          for (int cb = 0; cb < NCB; ++cb) {
            tma_load(dk + cb * kDecTile * 128, tmk, cb * 64, h, pos0, b,
                     full(st));
            tma_load(dk + kTileBytes + cb * kDecTile * 128, tmv, cb * 64, h,
                     pos0, b, full(st));
          }
        }
      } else {
        if (it >= kStages) mbar_wait(empty(st), ((it / kStages) & 1) ^ 1);
        unsigned char* dst = smem + st * 2 * kTileBytes;
        stage_tile_swz<T, DP>(dst, kb, a.k_ss, pos0, end, D, lane);
        stage_tile_swz<T, DP>(dst + kTileBytes, vb, a.v_ss, pos0, end, D,
                              lane);
        mbar_arrive(full(st));
      }
    }
    return;
  }

  // --- consumers
  const int r0 = warp * 16;  // the warp's rows of each tile
  MmaDecode<T, DP, NR> c;
  c.init(static_cast<const T*>(a.q) + b * a.q_sb + (h * a.G + g0) * a.q_sh,
         a.q_sh, G, D);
  const float sl2 = a.scale * kLog2e;  // scores in base 2
  for (int it = 0; it < ntile; ++it) {
    const int st = it % kStages;
    int pos0, end;
    tiles.tile(it, &pos0, &end);
    mbar_wait(full(st), (it / kStages) & 1);
    const uint32_t sK = sbase + st * 2 * kTileBytes;
    const int live = end - (pos0 + r0);  // live rows of the warp
    if (live > 0) {
      if (live < 16 && aligned) {
        // the TMA loaded whatever the cache holds past `end`: zero those V
        // rows, whose products would otherwise reach O (0 * NaN)
        unsigned char* vt = smem + st * 2 * kTileBytes + kTileBytes;
        for (int idx = lane; idx < (16 - live) * NCB * 8; idx += 32) {
          const int r = r0 + live + idx / (NCB * 8);
          const int cc = idx % (NCB * 8);
          *reinterpret_cast<uint4*>(vt + (cc >> 3) * (kDecTile * 128) +
                                    r * 128 + (cc & 7) * 16) =
              make_uint4(0u, 0u, 0u, 0u);
        }
        __syncwarp();
      }
      c.step(sK, sK + kTileBytes, r0, live, sl2);
      if (live < 16 && aligned)  // generic writes before the next TMA fill
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    }
    mbar_arrive(empty(st));  // this thread is done with the stage
  }

  // the warps' partials through shared memory (the ring is done with once
  // every consumer has passed its last tile; the producer has exited)
  asm volatile("bar.sync 1, %0;\n" ::"n"(kDecConsumers) : "memory");
  float* red = reinterpret_cast<float*>(smem);  // [kDecWarps][MR][D]
  __shared__ float sm_m[kDecWarps][MR];
  __shared__ float sm_l[kDecWarps][MR];
  c.finish(red, sm_m, sm_l, warp, G, D);
  asm volatile("bar.sync 1, %0;\n" ::"n"(kDecConsumers) : "memory");
  store_partial<MR, kDecWarps, kDecConsumers>(a, red, sm_m, sm_l, b, h, g0,
                                              G, sp);
}

}  // namespace kern
