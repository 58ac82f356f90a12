// Error-compensated TF32 products on the tensor cores (sm_80 and later):
// mma.sync m16n8k8 with float32 operands split into a TF32 high part and a
// TF32 low part, and D += A_lo B_hi + A_hi B_lo + A_hi B_hi accumulated in
// float32 ("3xTF32": each operand keeps 21 of float32's 24 bits through the
// pair, and only the lo x lo term, ~2^-22 of the product, is dropped).
//
// Fragment layouts of m16n8k8 .tf32 (lane = 4 * g + q, g = lane / 4,
// q = lane % 4):
//   A (16 x 8, row):  a0 (g, q)  a1 (g + 8, q)  a2 (g, q + 4)  a3 (g + 8, q + 4)
//   B (8 x 8, col):   b0 (q, g)  b1 (q + 4, g)
//   C (16 x 8):       c0 (g, 2q) c1 (g, 2q + 1) c2 (g + 8, 2q) c3 (g + 8, 2q + 1)
// The contraction index k may be permuted as long as A and B agree: a C
// fragment (g, 2q), (g, 2q + 1) then serves as a B fragment whose k = q,
// q + 4 stand for columns 2q, 2q + 1.
#pragma once

#include <cstdint>

namespace kern {

// x = hi + lo: hi is x rounded to TF32 at its 13th bit (half an ulp up in
// magnitude, then the low 13 bits cleared: round to nearest, ties away, as
// cvt.rna), lo the exact float32 residual x - hi. The tensor core reads
// the top 19 bits of a .tf32 operand, so lo enters the product truncated
// to TF32: |x - hi - lo_tf32| < 2^-21 |x| (CUTLASS's fast 3xTF32 split).
__device__ __forceinline__ void tf32_split(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

struct FragA3 {
  uint32_t hi[4], lo[4];
};
struct FragB3 {
  uint32_t hi[2], lo[2];
};

__device__ __forceinline__ FragA3 frag_a(float a0, float a1, float a2,
                                         float a3) {
  FragA3 f;
  tf32_split(a0, f.hi[0], f.lo[0]);
  tf32_split(a1, f.hi[1], f.lo[1]);
  tf32_split(a2, f.hi[2], f.lo[2]);
  tf32_split(a3, f.hi[3], f.lo[3]);
  return f;
}
__device__ __forceinline__ FragB3 frag_b(float b0, float b1) {
  FragB3 f;
  tf32_split(b0, f.hi[0], f.lo[0]);
  tf32_split(b1, f.hi[1], f.lo[1]);
  return f;
}

// d += a b, one m16n8k8 TF32 product accumulated in float32.
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Pass p (0: lo x hi, 1: hi x lo, 2: hi x hi) of d += a b in 3xTF32, the
// small terms first. A caller runs pass 0 over all its independent tiles,
// then pass 1, then pass 2, so that a tile's next product never waits on
// the one before it (mma.sync issues in order).
__device__ __forceinline__ void mma3_pass(int p, float (&d)[4],
                                          const FragA3& a, const FragB3& b) {
  if (p == 0)
    mma_tf32(d, a.lo, b.hi);
  else if (p == 1)
    mma_tf32(d, a.hi, b.lo);
  else
    mma_tf32(d, a.hi, b.hi);
}

}  // namespace kern
