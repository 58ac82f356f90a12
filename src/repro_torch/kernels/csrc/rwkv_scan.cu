// RWKV6 WKV recurrence with the state kept on chip, for sm_90a.
//
// Replaces the Pallas kernel src/repro/kernels/rwkv_scan.py (_wkv_kernel).
// Per (batch row, head), with the state S (key x value, HD x HD):
//     y_t = r_t . (S + diag(u) k_t v_t^T)        (a vector over value columns)
//     S  <- diag(w_t) S + k_t v_t^T
//
// Bound: HBM sees one read of r, k, v, w and one write of y per token, and
// about 7*HD*HD float32 flops per token and head, so a long scan sits near
// the card's float32 balance; the recurrence is serial in t, so what this
// kernel has to fight is latency, not either peak.
// Design: one block per (head, batch row); the block's HD * kR threads own
// the state in registers, kR threads per value column j, each holding the
// HD / kR key rows i = part, part + kR, ... of that column (interleaved, so
// the kR threads of a column read kR neighbouring shared-memory banks). The
// time axis is staged through shared memory kCH steps at a time (r, k, w,
// v read in one coalesced sweep, y written back the same way), so the step
// loop itself touches no device memory: each thread updates its share of
// the column, and the kR partial sums of y_t[j] reduce with shuffles.
// Overlapping the next chunk's loads with this chunk's steps is left for a
// later change.
#include "common.cuh"

namespace {

constexpr int kR = 8;  // threads per value column

struct Args {
  const float* r;
  const float* k;
  const float* v;
  const float* w;
  const float* u;   // (H, HD) contiguous
  const float* s0;  // (B, H, HD, HD) contiguous
  float* y;         // (B, T, H, HD) contiguous
  float* sfin;      // (B, H, HD, HD) contiguous
  int B, T, H;
  long long sb[4], st[4], sh[4];  // strides of r, k, v, w (head dim is 1)
};

template <int HD>
__global__ void __launch_bounds__(HD * kR) wkv6_kernel(Args a) {
  constexpr int RPT = HD / kR;     // key rows per thread
  constexpr int kCH = 2048 / HD;   // time steps staged per chunk
  __shared__ float sx[4][kCH][HD];  // r, k, v, w of the chunk
  __shared__ float sy[kCH][HD];
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int j = tid / kR;     // value column
  const int part = tid % kR;  // key rows part + kR * i

  const long long bh = static_cast<long long>(b) * a.H + h;
  float S[RPT];
  float uu[RPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int key = part + kR * i;
    S[i] = a.s0[(bh * HD + key) * HD + j];
    uu[i] = a.u[h * HD + key];
  }
  const float* src[4] = {a.r, a.k, a.v, a.w};

  for (int t0 = 0; t0 < a.T; t0 += kCH) {
    const int n = min(kCH, a.T - t0);
    for (int idx = tid; idx < 4 * n * HD; idx += HD * kR) {
      const int x = idx / (n * HD);
      const int rest = idx % (n * HD);
      const int tt = rest / HD;
      const int c = rest % HD;
      sx[x][tt][c] = src[x][b * a.sb[x] + (t0 + tt) * a.st[x] +
                            h * a.sh[x] + c];
    }
    __syncthreads();
    for (int tt = 0; tt < n; ++tt) {
      const float vj = sx[2][tt][j];
      float y0 = 0.f;
      float y1 = 0.f;
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        const int key = part + kR * i;
        const float kv = sx[1][tt][key] * vj;
        const float term = sx[0][tt][key] * (S[i] + uu[i] * kv);
        if (i % 2 == 0)
          y0 += term;
        else
          y1 += term;
        S[i] = sx[3][tt][key] * S[i] + kv;
      }
      const float yj = kern::group_sum<kR>(y0 + y1);
      if (part == 0) sy[tt][j] = yj;
    }
    __syncthreads();
    for (int idx = tid; idx < n * HD; idx += HD * kR) {
      const int tt = idx / HD;
      const int c = idx % HD;
      a.y[((static_cast<long long>(b) * a.T + t0 + tt) * a.H + h) * HD + c] =
          sy[tt][c];
    }
    // the next chunk's stage writes sx only, and its steps write sy only
    // after the __syncthreads() that follows that stage
  }

#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int key = part + kR * i;
    a.sfin[(bh * HD + key) * HD + j] = S[i];
  }
}

}  // namespace

// float32 only. r, k, v, w are (B, T, H, hd) with a contiguous head dim and
// the (b, t, h) strides, in elements, in `strides` (a host array of 12:
// r's three, then k's, v's and w's); u (H, hd), state, y and sfin are
// contiguous. hd is one of 8, 16, 32, 64, 128. Returns cudaGetLastError()
// of the launch (0 on success).
extern "C" int wkv6_launch(const float* r, const float* k, const float* v,
                           const float* w, const float* u, const float* s0,
                           float* y, float* sfin, int B, int T, int H, int hd,
                           const long long* strides, void* stream) {
  if (B < 1 || T < 0 || H < 1 || B > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  Args a{r, k, v, w, u, s0, y, sfin, B, T, H, {}, {}, {}};
  for (int x = 0; x < 4; ++x) {
    a.sb[x] = strides[3 * x];
    a.st[x] = strides[3 * x + 1];
    a.sh[x] = strides[3 * x + 2];
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(H, B);
  switch (hd) {
    case 8: wkv6_kernel<8><<<grid, 8 * kR, 0, s>>>(a); break;
    case 16: wkv6_kernel<16><<<grid, 16 * kR, 0, s>>>(a); break;
    case 32: wkv6_kernel<32><<<grid, 32 * kR, 0, s>>>(a); break;
    case 64: wkv6_kernel<64><<<grid, 64 * kR, 0, s>>>(a); break;
    case 128: wkv6_kernel<128><<<grid, 128 * kR, 0, s>>>(a); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
