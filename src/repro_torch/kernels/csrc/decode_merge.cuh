// The split-KV merge that the one-token decode kernels (K1 ragged decode,
// K3 flash decode) share, and the step before it that folds a split
// block's warps into its partial (store_partial). The merge: one block of
// kMergeThreads per (batch row, q head) merges that row's live split
// partials with the log-sum-exp rule (common.cuh: lse_scale) in two
// passes, the splits' maxima and factors spread over the block and staged
// in shared memory, so each thread's loads of its head-dim elements of the
// partials are independent of one another (a 32k row has a few hundred
// splits).
//
// The partials are float32 (o, m, l) per (b, KV head, split, q head of the
// group[, d]) in (B, Hkv, nsplit, G[, D]) scratch; only the first `live`
// splits of a row are read (the split blocks past a row's end exit without
// writing). The merge writes either the normalised output in the input
// dtype, exact zeros where nothing was attended, or the merged (o, m, l)
// partials in float32 (m = -1e30 and l = 0 for a row that attended
// nothing).
#pragma once

#include "common.cuh"

namespace kern {

constexpr int kMergeThreads = 128;
constexpr int kMergeMaxD = 256;

// A split block's partial: the partials of its `warps` warps, staged in
// shared memory (red [warps][MAXG][D], the maxima and denominators in
// sm_m / sm_l [warps][MAXG]), merged with the log-sum-exp step into one
// float32 (o, m, l) per q head of the block's group (G heads from g0) in
// the scratch po / pm / pl of `a` at split sp. The block's first
// `nthreads` threads call it.
template <int MAXG, int warps, int nthreads, class A>
__device__ __forceinline__ void store_partial(const A& a, const float* red,
                                              const float (*sm_m)[MAXG],
                                              const float (*sm_l)[MAXG],
                                              int b, int h, int g0, int G,
                                              int sp) {
  const int D = a.D;
  const long long row0 =
      (static_cast<long long>(b * a.Hkv + h) * a.nsplit + sp) * a.G + g0;
  for (int idx = threadIdx.x; idx < G * D; idx += nthreads) {
    const int g = idx / D;
    const int d = idx % D;
    float M = kNegInf;
    float L = 0.f;
    float o = 0.f;
#pragma unroll
    for (int w = 0; w < warps; ++w) {
      const float2 f = lse_merge(M, L, sm_m[w][g], sm_l[w][g]);
      o = o * f.x + red[(w * MAXG + g) * D + d] * f.y;
    }
    a.po[(row0 + g) * D + d] = o;
    if (d == 0) {
      a.pm[row0 + g] = M;
      a.pl[row0 + g] = L;
    }
  }
}

// The merge of (b, q head hq) over its first `live` splits; called by a
// __global__ wrapper with one block of kMergeThreads per (b, q head). `a`
// is the calling kernel's own argument struct, read as it is (a first
// version took a struct of its own, filled from the caller's, and K1 ran
// 4% slower: PERF.md). It holds the partials po (B, Hkv, nsplit, G, D),
// pm and pl (B, Hkv, nsplit, G), Hkv, G, D and nsplit, and either the
// normalised output out with its strides o_sb, o_sh (the head dim
// contiguous) or, with kPartials, the merged partials o_out (B, Hq, D),
// m_out and l_out (B, Hq).
template <typename T, bool kPartials, class A>
__device__ __forceinline__ void merge_splits(const A& a, int b, int hq,
                                             int live) {
  __shared__ float sf[kMergeThreads];
  __shared__ float red[kMergeThreads / 32];
  const int h = hq / a.G;
  const int g = hq % a.G;
  const int tid = threadIdx.x;
  const long long row0 =
      static_cast<long long>(b * a.Hkv + h) * a.nsplit * a.G + g;
  // a block-wide reduction through red[] (op: max or sum)
  auto block_reduce = [&](float x, bool is_max) {
    x = is_max ? group_max<32>(x) : group_sum<32>(x);
    __syncthreads();  // red[] is free
    if (tid % 32 == 0) red[tid / 32] = x;
    __syncthreads();
    x = red[0];
#pragma unroll
    for (int w = 1; w < kMergeThreads / 32; ++w)
      x = is_max ? fmaxf(x, red[w]) : x + red[w];
    return x;
  };
  float M = kNegInf;
  for (int s = tid; s < live; s += kMergeThreads) {
    const long long r = row0 + static_cast<long long>(s) * a.G;
    M = fmaxf(M, a.pl[r] > 0.f ? a.pm[r] : kNegInf);
  }
  M = block_reduce(M, true);
  float L = 0.f;
  float o[kMergeMaxD / kMergeThreads] = {};
  for (int s0 = 0; s0 < live; s0 += kMergeThreads) {
    float f = 0.f;
    if (s0 + tid < live) {
      const long long r = row0 + static_cast<long long>(s0 + tid) * a.G;
      f = lse_scale(a.pm[r], a.pl[r], M);
      L += a.pl[r] * f;
    }
    __syncthreads();  // the previous tile's factors are read
    sf[tid] = f;
    __syncthreads();
    const int cnt = min(kMergeThreads, live - s0);
    const float* po = a.po + (row0 + static_cast<long long>(s0) * a.G) * a.D;
#pragma unroll 8
    for (int j = 0; j < cnt; ++j) {
      const float fj = sf[j];
      const float* pj = po + static_cast<long long>(j) * a.G * a.D;
#pragma unroll
      for (int i = 0; i < kMergeMaxD / kMergeThreads; ++i) {
        const int d = tid + i * kMergeThreads;
        if (d < a.D) o[i] += pj[d] * fj;
      }
    }
  }
  L = block_reduce(L, false);
  if constexpr (kPartials) {
    const long long bq = static_cast<long long>(b) * a.Hkv * a.G + hq;
#pragma unroll
    for (int i = 0; i < kMergeMaxD / kMergeThreads; ++i) {
      const int d = tid + i * kMergeThreads;
      if (d < a.D) a.o_out[bq * a.D + d] = o[i];
    }
    if (tid == 0) {
      a.m_out[bq] = M;
      a.l_out[bq] = L;
    }
  } else {
    T* out = static_cast<T*>(a.out) + b * a.o_sb + hq * a.o_sh;
#pragma unroll
    for (int i = 0; i < kMergeMaxD / kMergeThreads; ++i) {
      const int d = tid + i * kMergeThreads;
      if (d < a.D) out[d] = from_f<T>(L > 0.f ? o[i] / L : 0.f);
    }
  }
}

}  // namespace kern
