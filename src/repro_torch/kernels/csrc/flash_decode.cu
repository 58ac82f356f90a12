// One-token GQA decode over a single-segment KV cache, for sm_90a.
//
// Replaces the Pallas kernel src/repro/kernels/flash_decode.py
// (_decode_kernel), in both of its forms: the normalised output
// (flash_decode) and the unnormalised (o, m, l) partials that the
// sequence-sharded decode merges across shards with the log-sum-exp rule
// (flash_decode_partials). Row b attends position j when
//     j < min(kv_len[b], Skv)   and, with a window,   (kv_len[b]-1) - j < window
// so the attended positions of a row are one contiguous range [lo, hi).
//
// Bound: a decode reads every attended K and V row once and does 4*G*D
// flops per attended position and KV head, far below the card's flop/byte
// balance, so the kernel is bound by the bytes of K and V.
// Design: split-KV. The grid is (Hkv, B, nsplit); a block covers all G query
// heads of one KV head, so each K/V row is read from device memory once for
// the whole group, straight from the cache's own (B, Skv, Hkv, D) layout
// through strides, and only inside [lo, hi): masked positions are never
// loaded. Block `sp` takes the sp-th of nsplit equal slices of [lo, hi), so
// a windowed or short row spreads over as many blocks as a long one and the
// 132 SMs fill at small B*Hkv. The block's warps take U positions at a time
// (U loads in flight per lane before the first use) with a float32 online
// softmax each, merge with the log-sum-exp rule in shared memory and write
// a float32 partial (o, m, l) per (row, KV head, slice, query head) to
// scratch. A second kernel merges the nsplit partials the same way and
// writes either the normalised output (exact zeros where nothing was
// attended) or the merged partials. Tensor-core products and TMA staging
// are left for a later change.
#include "common.cuh"

namespace {

using kern::from_f;
using kern::kNegInf;
using kern::to_f;

constexpr int kWarps = 4;

struct SplitArgs {
  const void* q;
  const void* k;
  const void* v;
  const int* kv_len;
  float* po;  // (B, Hkv, nsplit, G, D)
  float* pm;  // (B, Hkv, nsplit, G)
  float* pl;  // (B, Hkv, nsplit, G)
  int B, Hkv, G, D, Skv, window, nsplit;
  long long q_sb, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh;
  float scale;
};

// EPL: head-dim elements per lane (D <= 32 * EPL); MAXG: query heads per KV
// head the registers are sized for (G <= MAXG); U: positions per warp step.
template <typename T, int EPL, int MAXG, int U>
__global__ void __launch_bounds__(kWarps * 32)
    decode_split_kernel(SplitArgs a) {
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int sp = blockIdx.z;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int G = a.G;
  const int D = a.D;
  const int d0 = lane * EPL;

  const int kv_len = a.kv_len[b];
  const int hi = min(kv_len, a.Skv);
  const int lo = a.window >= 0 ? max(0, kv_len - a.window) : 0;
  const int n = max(0, hi - lo);
  const int chunk = (n + a.nsplit - 1) / a.nsplit;
  const int start = lo + sp * chunk;
  const int end = min(hi, start + chunk);

  const T* q = static_cast<const T*>(a.q) + b * a.q_sb;
  const T* kb = static_cast<const T*>(a.k) + b * a.k_sb + h * a.k_sh;
  const T* vb = static_cast<const T*>(a.v) + b * a.v_sb + h * a.v_sh;

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

  for (int base = start + warp * U; base < end; base += kWarps * U) {
    float kr[U][EPL];
    float vr[U][EPL];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int j = base + u;
      const bool ok = j < end;
      const T* kj = kb + j * a.k_ss;
      const T* vj = vb + j * a.v_ss;
#pragma unroll
      for (int e = 0; e < EPL; ++e) {
        const int d = d0 + e;
        kr[u][e] = (ok && d < D) ? to_f(kj[d]) : 0.f;
        vr[u][e] = (ok && d < D) ? to_f(vj[d]) : 0.f;
      }
    }
#pragma unroll
    for (int g = 0; g < MAXG; ++g) {
      if (g >= G) break;
      float s[U];
      float smax = kNegInf;
#pragma unroll
      for (int u = 0; u < U; ++u) {
        float x = 0.f;
#pragma unroll
        for (int e = 0; e < EPL; ++e) x += qr[g][e] * kr[u][e];
        x = kern::group_sum(x) * a.scale;
        s[u] = (base + u < end) ? x : kNegInf;
        smax = fmaxf(smax, s[u]);
      }
      // base < end, so smax is a real score and alpha is finite
      const float m_new = fmaxf(m[g], smax);
      const float alpha = expf(m[g] - m_new);
      l[g] *= alpha;
#pragma unroll
      for (int e = 0; e < EPL; ++e) acc[g][e] *= alpha;
#pragma unroll
      for (int u = 0; u < U; ++u) {
        if (base + u < end) {
          const float p = expf(s[u] - m_new);
          l[g] += p;
#pragma unroll
          for (int e = 0; e < EPL; ++e) acc[g][e] += p * vr[u][e];
        }
      }
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

  // index of (b, h, sp, g = 0) in the (B, Hkv, nsplit, G) scratch
  const long long row0 =
      (static_cast<long long>(b * a.Hkv + h) * a.nsplit + sp) * G;
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
    a.po[(row0 + g) * D + d] = o;
    if (d == 0) {
      a.pm[row0 + g] = M;
      a.pl[row0 + g] = L;
    }
  }
}

struct CombineArgs {
  const float* po;
  const float* pm;
  const float* pl;
  void* out;     // normalised: (B, Hq, D) contiguous, in the input dtype
  float* o_out;  // partials: (B, Hq, D), (B, Hq), (B, Hq) float32
  float* m_out;
  float* l_out;
  int B, Hkv, G, D, nsplit, normalize;
};

// One thread per output element (b, q head, d): merges the nsplit slice
// partials with the log-sum-exp rule.
template <typename T>
__global__ void decode_combine_kernel(CombineArgs a) {
  const int Hq = a.Hkv * a.G;
  const long long total = static_cast<long long>(a.B) * Hq * a.D;
  const long long idx = static_cast<long long>(blockIdx.x) * blockDim.x +
                        threadIdx.x;
  if (idx >= total) return;
  const int d = static_cast<int>(idx % a.D);
  const long long bq = idx / a.D;  // b * Hq + q head
  const int hq = static_cast<int>(bq % Hq);
  const int b = static_cast<int>(bq / Hq);
  const int h = hq / a.G;
  const int g = hq % a.G;
  const long long row0 =
      static_cast<long long>(b * a.Hkv + h) * a.nsplit * a.G + g;
  float M = kNegInf;
  for (int s = 0; s < a.nsplit; ++s) {
    const long long r = row0 + static_cast<long long>(s) * a.G;
    if (a.pl[r] > 0.f) M = fmaxf(M, a.pm[r]);
  }
  float L = 0.f;
  float o = 0.f;
  for (int s = 0; s < a.nsplit; ++s) {
    const long long r = row0 + static_cast<long long>(s) * a.G;
    if (a.pl[r] > 0.f) {
      const float c = expf(a.pm[r] - M);
      L += a.pl[r] * c;
      o += a.po[r * a.D + d] * c;
    }
  }
  if (a.normalize) {
    static_cast<T*>(a.out)[idx] = from_f<T>(L > 0.f ? o / L : 0.f);
  } else {
    a.o_out[idx] = o;
    if (d == 0) {
      a.m_out[bq] = M;
      a.l_out[bq] = L;
    }
  }
}

template <typename T, int EPL, int MAXG>
void launch_split(const SplitArgs& a, cudaStream_t s) {
  const dim3 grid(a.Hkv, a.B, a.nsplit);
  const dim3 block(kWarps * 32);
  constexpr int U = EPL >= 8 ? 2 : 4;
  decode_split_kernel<T, EPL, MAXG, U><<<grid, block, 0, s>>>(a);
}

template <typename T, int EPL>
void launch_g(const SplitArgs& a, cudaStream_t s) {
  if (a.G <= 1)
    launch_split<T, EPL, 1>(a, s);
  else if (a.G <= 2)
    launch_split<T, EPL, 2>(a, s);
  else if (a.G <= 4)
    launch_split<T, EPL, 4>(a, s);
  else
    launch_split<T, EPL, 8>(a, s);
}

template <typename T>
cudaError_t launch(const SplitArgs& a, const CombineArgs& c, cudaStream_t s) {
  if (a.D <= 32)
    launch_g<T, 1>(a, s);
  else if (a.D <= 64)
    launch_g<T, 2>(a, s);
  else if (a.D <= 128)
    launch_g<T, 4>(a, s);
  else
    launch_g<T, 8>(a, s);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const long long total = static_cast<long long>(c.B) * c.Hkv * c.G * c.D;
  const int threads = 256;
  const unsigned blocks = static_cast<unsigned>((total + threads - 1) / threads);
  decode_combine_kernel<T><<<blocks, threads, 0, s>>>(c);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 float32, 1 bfloat16, 2 float16. window < 0 means none. Strides
// are in elements; the head dim of q, k and v must be contiguous. The
// scratch po/pm/pl holds (B, Hkv, nsplit, G[, D]) float32. normalize=1
// writes `out` (B, Hq, D) in the input dtype; normalize=0 writes the merged
// partials o_out (B, Hq, D), m_out and l_out (B, Hq) in float32. Returns
// the launches' cudaGetLastError() (0 on success).
extern "C" int flash_decode_launch(
    const void* q, const void* k, const void* v, const int* kv_len, float* po,
    float* pm, float* pl, void* out, float* o_out, float* m_out, float* l_out,
    int B, int Hkv, int G, int D, int Skv, int window, int nsplit,
    long long q_sb, long long q_sh, long long k_sb, long long k_ss,
    long long k_sh, long long v_sb, long long v_ss, long long v_sh,
    float scale, int dtype, int normalize, void* stream) {
  if (G < 1 || G > 8 || D < 1 || D > 256 || B < 1 || Hkv < 1 || Skv < 0 ||
      nsplit < 1 || nsplit > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  SplitArgs a{q,    k,    v,    kv_len, po,   pm,   pl,   B,    Hkv,
              G,    D,    Skv,  window, nsplit, q_sb, q_sh, k_sb, k_ss,
              k_sh, v_sb, v_ss, v_sh, scale};
  CombineArgs c{po, pm, pl, out, o_out, m_out, l_out, B, Hkv, G, D, nsplit,
                normalize};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (dtype) {
    case 0: err = launch<float>(a, c, s); break;
    case 1: err = launch<__nv_bfloat16>(a, c, s); break;
    case 2: err = launch<__half>(a, c, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(err);
}
