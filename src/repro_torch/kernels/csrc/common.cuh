// Helpers shared by the port's attention and scan kernels (sm_90a):
// conversions between the storage types and float32, 16- and 4-byte
// cp.async copies, and warp reductions.
#pragma once

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

namespace kern {

constexpr float kNegInf = -1e30f;  // the reference's NEG_INF

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f(__half x) { return __half2float(x); }

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}
template <>
__device__ __forceinline__ __half from_f<__half>(float x) {
  return __float2half(x);
}

// 16-byte copies from device to shared memory (cp.async, cached in L2
// only), committed in groups and waited on per thread.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}
// 4-byte copies (cp.async, cached in L1 and L2): any float's address
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The 16 / sizeof(T) values of one 16-byte vector, as float32.
template <typename T>
__device__ __forceinline__ void unpack(const uint4& u, float* f);
template <>
__device__ __forceinline__ void unpack<float>(const uint4& u, float* f) {
  f[0] = __uint_as_float(u.x);
  f[1] = __uint_as_float(u.y);
  f[2] = __uint_as_float(u.z);
  f[3] = __uint_as_float(u.w);
}
template <>
__device__ __forceinline__ void unpack<__nv_bfloat16>(const uint4& u,
                                                      float* f) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 x = __bfloat1622float2(h[i]);
    f[2 * i] = x.x;
    f[2 * i + 1] = x.y;
  }
}
template <>
__device__ __forceinline__ void unpack<__half>(const uint4& u, float* f) {
  const __half2* h = reinterpret_cast<const __half2*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 x = __half22float2(h[i]);
    f[2 * i] = x.x;
    f[2 * i + 1] = x.y;
  }
}

// The four values of a float4.
__device__ __forceinline__ void split4(const float4& v, float* f) {
  f[0] = v.x;
  f[1] = v.y;
  f[2] = v.z;
  f[3] = v.w;
}

// Two float32 values rounded into one 32-bit pair of bf16 or fp16, and back.
template <typename T>
__device__ __forceinline__ uint32_t pack2(float x, float y);
template <>
__device__ __forceinline__ uint32_t pack2<__nv_bfloat16>(float x, float y) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  return *reinterpret_cast<const uint32_t*>(&h);
}
template <>
__device__ __forceinline__ uint32_t pack2<__half>(float x, float y) {
  const __half2 h = __floats2half2_rn(x, y);
  return *reinterpret_cast<const uint32_t*>(&h);
}
template <typename T>
__device__ __forceinline__ float2 unpack2(uint32_t u);
template <>
__device__ __forceinline__ float2 unpack2<__nv_bfloat16>(uint32_t u) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u));
}
template <>
__device__ __forceinline__ float2 unpack2<__half>(uint32_t u) {
  return __half22float2(*reinterpret_cast<const __half2*>(&u));
}

// Sum / max over the `width` lanes of an aligned lane group (width a power
// of two dividing 32).
template <int width = 32>
__device__ __forceinline__ float group_sum(float x) {
#pragma unroll
  for (int o = width / 2; o > 0; o >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}
template <int width = 32>
__device__ __forceinline__ float group_max(float x) {
#pragma unroll
  for (int o = width / 2; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

// One log-sum-exp merge step of two softmax partials, each an unnormalised
// sum o with its running max m and denominator l: folds (m2, l2) into
// (m, l) and returns the factors the two sums take,
//     o = o * f.x + o2 * f.y
// (and the same for any other sum rescaled like o, such as a context
// mass). A side with l == 0 attended nothing and adds nothing, so a merge
// of empty partials stays at (m, 0) and normalises to exact zeros.
__device__ __forceinline__ float2 lse_merge(float& m, float& l, float m2,
                                            float l2) {
  if (!(l2 > 0.f)) return make_float2(1.f, 0.f);
  if (!(l > 0.f)) {
    m = m2;
    l = l2;
    return make_float2(0.f, 1.f);
  }
  const float M = fmaxf(m, m2);
  const float2 f = make_float2(expf(m - M), expf(m2 - M));
  l = l * f.x + l2 * f.y;
  m = M;
  return f;
}

// The same step for a merge of many partials in two passes (first the
// largest max M of the partials with l > 0, then the sums): the factor a
// partial (m, l) takes, zero for one that attended nothing.
__device__ __forceinline__ float lse_scale(float m, float l, float M) {
  return l > 0.f ? expf(m - M) : 0.f;
}

}  // namespace kern
