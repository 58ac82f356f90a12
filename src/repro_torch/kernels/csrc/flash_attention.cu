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
// by operations, a short query over a long prefix by bytes.
// Design: one block per (query tile of kBQ rows, q head, batch row); the
// tiles run heaviest first under a causal mask. K and V tiles of BK rows are
// staged through shared memory (converted to float32, rows padded by one
// word against bank conflicts) one after the other in one buffer; 256
// threads as a 16 x 16 grid each own kTM query rows x (BK / 16) columns of
// the score tile and kTM rows x DPT head-dim columns of the float32
// accumulator (rows and columns strided by 16, so a half-warp reads 16
// banks). Each row keeps an online softmax (m, l) and the context-mass
// accumulator, rescaled with the same alpha as the output; row statistics
// reduce over the 16 lanes of a half-warp with shuffles. KV tiles wholly
// outside the causal or window band are skipped before they are loaded.
// The products run on the CUDA cores in float32; wgmma, TMA and a
// producer/consumer pipeline are left for a later change.
#include <climits>

#include "common.cuh"

namespace {

using kern::from_f;
using kern::kNegInf;
using kern::to_f;

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

__device__ __forceinline__ int kv_pos(const Args& a, int c) {
  return c < a.context_len ? c : a.q_offset + (c - a.context_len);
}

__device__ __forceinline__ bool allowed(const Args& a, int row, int col) {
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
__device__ __forceinline__ bool tile_live(const Args& a, int r0, int r1,
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

}  // namespace

// dtype: 0 float32, 1 bfloat16, 2 float16. window < 0 means none; mass may
// be null. Strides are in elements; the head dim of q, k, v and out must be
// contiguous. Returns cudaGetLastError() of the launch (0 on success).
extern "C" int flash_attention_launch(
    const void* q, const void* k, const void* v, void* out, float* mass,
    int B, int Sq, int Skv, int Hq, int Hkv, int D, int context_len,
    int q_offset, int causal, int window, long long q_sb, long long q_ss,
    long long q_sh, long long k_sb, long long k_ss, long long k_sh,
    long long v_sb, long long v_ss, long long v_sh, long long o_sb,
    long long o_ss, long long o_sh, float scale, int dtype, void* stream) {
  if (B < 1 || Sq < 1 || Skv < 0 || Hkv < 1 || Hq % Hkv != 0 || D < 1 ||
      D > 256 || Hq > 65535 || B > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  Args a{q,    k,    v,    out,  mass, B,    Sq,   Skv,  Hq,   Hkv,
         D,    context_len, q_offset, causal, window, q_sb, q_ss, q_sh,
         k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, o_sb, o_ss, o_sh, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return static_cast<int>(launch<float>(a, s));
    case 1: return static_cast<int>(launch<__nv_bfloat16>(a, s));
    case 2: return static_cast<int>(launch<__half>(a, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
