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
// flop/byte balance, so the kernel is bound by the bytes of K and V.
// Design: one block per (kv_head, batch row) covers all G query heads of
// the group, so each K/V row is read from device memory once for G heads.
// The block's warps split the KV positions; each warp keeps a float32
// online softmax (m, l, acc) for its positions, a lane holding EPL
// consecutive elements of the head dim (a warp reads a whole row in one
// coalesced sweep), and the block merges the warps' partials with the
// log-sum-exp rule at the end. Masked positions are skipped before any
// load, which is the explicit p == 0 of the reference; a row with no
// attended position (l == 0 everywhere) writes exact zeros. Split-KV
// across blocks, cp.async/TMA staging and tensor-core products are left
// for a later change: at B*Hkv = 32..64 blocks the 132 SMs are underfilled.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 4;
constexpr float kNegInf = -1e30f;

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

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const int* kv_len;
  const int* pfx;
  void* out;
  int B, Hkv, G, D, Skv, prefix_len;
  long long q_sb, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, o_sb, o_sh;
  float scale;
};

// EPL: head-dim elements per lane (D <= 32 * EPL); MAXG: query heads per
// KV head the registers are sized for (G <= MAXG).
template <typename T, int EPL, int MAXG>
__global__ void __launch_bounds__(kWarps * 32)
    ragged_decode_kernel(Args a) {
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int G = a.G;
  const int D = a.D;
  const int d0 = lane * EPL;
  const T* q = static_cast<const T*>(a.q) + b * a.q_sb;
  const T* kb = static_cast<const T*>(a.k) + b * a.k_sb + h * a.k_sh;
  const T* vb = static_cast<const T*>(a.v) + b * a.v_sb + h * a.v_sh;
  const int kv_len = a.kv_len[b];
  const int pfx = a.pfx[b];

  float qr[MAXG][EPL];
  float acc[MAXG][EPL];
  float m[MAXG];
  float l[MAXG];
#pragma unroll
  for (int g = 0; g < MAXG; ++g) {
    m[g] = kNegInf;
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < EPL; ++e) {
      const int d = d0 + e;
      qr[g][e] = (g < G && d < D) ? to_f(q[(h * G + g) * a.q_sh + d]) : 0.f;
      acc[g][e] = 0.f;
    }
  }

  for (int j = warp; j < a.Skv; j += kWarps) {
    const bool allow = (j < a.prefix_len) ? (j < pfx) : (j < kv_len);
    if (!allow) continue;  // uniform across the warp
    const T* kj = kb + j * a.k_ss;
    const T* vj = vb + j * a.v_ss;
    float kr[EPL];
    float vr[EPL];
#pragma unroll
    for (int e = 0; e < EPL; ++e) {
      const int d = d0 + e;
      kr[e] = d < D ? to_f(kj[d]) : 0.f;
      vr[e] = d < D ? to_f(vj[d]) : 0.f;
    }
#pragma unroll
    for (int g = 0; g < MAXG; ++g) {
      if (g >= G) break;
      float s = 0.f;
#pragma unroll
      for (int e = 0; e < EPL; ++e) s += qr[g][e] * kr[e];
      s = warp_sum(s) * a.scale;
      const float m_new = fmaxf(m[g], s);
      const float alpha = expf(m[g] - m_new);
      const float p = expf(s - m_new);
      l[g] = l[g] * alpha + p;
#pragma unroll
      for (int e = 0; e < EPL; ++e) acc[g][e] = acc[g][e] * alpha + p * vr[e];
      m[g] = m_new;
    }
  }

  __shared__ float sm_m[kWarps][MAXG];
  __shared__ float sm_l[kWarps][MAXG];
  __shared__ float sm_acc[kWarps][MAXG][EPL * 32];
#pragma unroll
  for (int g = 0; g < MAXG; ++g) {
    if (lane == 0) {
      sm_m[warp][g] = m[g];
      sm_l[warp][g] = l[g];
    }
#pragma unroll
    for (int e = 0; e < EPL; ++e) sm_acc[warp][g][d0 + e] = acc[g][e];
  }
  __syncthreads();

  T* out = static_cast<T*>(a.out) + b * a.o_sb;
  for (int idx = threadIdx.x; idx < G * D; idx += blockDim.x) {
    const int g = idx / D;
    const int d = idx % D;
    float M = kNegInf;
#pragma unroll
    for (int w = 0; w < kWarps; ++w)
      if (sm_l[w][g] > 0.f) M = fmaxf(M, sm_m[w][g]);
    float L = 0.f;
    float o = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      if (sm_l[w][g] > 0.f) {  // warps that attended nothing add nothing
        const float c = expf(sm_m[w][g] - M);
        L += sm_l[w][g] * c;
        o += sm_acc[w][g][d] * c;
      }
    }
    out[(h * G + g) * a.o_sh + d] = from_f<T>(L > 0.f ? o / L : 0.f);
  }
}

template <typename T, int EPL>
cudaError_t launch_g(const Args& a, cudaStream_t s) {
  const dim3 grid(a.Hkv, a.B);
  const dim3 block(kWarps * 32);
  if (a.G <= 1)
    ragged_decode_kernel<T, EPL, 1><<<grid, block, 0, s>>>(a);
  else if (a.G <= 2)
    ragged_decode_kernel<T, EPL, 2><<<grid, block, 0, s>>>(a);
  else if (a.G <= 4)
    ragged_decode_kernel<T, EPL, 4><<<grid, block, 0, s>>>(a);
  else
    ragged_decode_kernel<T, EPL, 8><<<grid, block, 0, s>>>(a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_d(const Args& a, cudaStream_t s) {
  if (a.D <= 32) return launch_g<T, 1>(a, s);
  if (a.D <= 64) return launch_g<T, 2>(a, s);
  if (a.D <= 128) return launch_g<T, 4>(a, s);
  return launch_g<T, 8>(a, s);
}

}  // namespace

// dtype: 0 float32, 1 bfloat16, 2 float16. Strides are in elements; the
// head dim of q, k, v and out must be contiguous. Returns the launch's
// cudaGetLastError() (0 on success).
extern "C" int ragged_decode_launch(
    const void* q, const void* k, const void* v, const int* kv_len,
    const int* pfx, void* out, int B, int Hkv, int G, int D, int Skv,
    int prefix_len, long long q_sb, long long q_sh, long long k_sb,
    long long k_ss, long long k_sh, long long v_sb, long long v_ss,
    long long v_sh, long long o_sb, long long o_sh, float scale, int dtype,
    void* stream) {
  if (G < 1 || G > 8 || D < 1 || D > 256 || B < 1 || Hkv < 1 || Skv < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  Args a{q,    k,    v,    kv_len, pfx,  out,  B,    Hkv,  G,    D,
         Skv,  prefix_len, q_sb, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh,
         o_sb, o_sh, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (dtype) {
    case 0: err = launch_d<float>(a, s); break;
    case 1: err = launch_d<__nv_bfloat16>(a, s); break;
    case 2: err = launch_d<__half>(a, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(err);
}
