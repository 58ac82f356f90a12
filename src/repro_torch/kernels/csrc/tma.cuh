// Tensor Memory Accelerator (TMA) loads with mbarrier completion, for
// sm_90a: the helpers the prefill attention (K2) and the decode (K1, K3)
// kernels share.
//
// Device side: mbarrier init / arrive / expect_tx / parity wait, and a 4-D
// tensor-map load into shared memory whose completion is counted in bytes
// on an mbarrier. Host side: cuTensorMapEncodeTiled, taken from the driver
// the runtime already loaded (no driver library linked), a 4-D map of a
// (B, S, H, D) attention tensor read through its own strides, and a cache
// of such maps.
#pragma once

#include <array>
#include <cstdint>
#include <mutex>
#include <unordered_map>

#include <cuda.h>  // CUtensorMap and its enums (no driver library linked)
#include <cuda_runtime.h>

namespace kern {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}
// Make the initialised barriers visible to the other threads and to the
// async proxy (TMA); a block barrier must follow before they are used.
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}
__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// One box of a 4-D tensor map (D, H, S, B) into shared memory at `dst`,
// completion counted on `bar`.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         int c0, int c1, int c2, int c3,
                                         uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3), "r"(bar)
      : "memory");
}

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType,
                                  cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle,
                                  CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver the runtime already loaded.
inline EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &q) == cudaSuccess &&
        q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// A (D, H, S, B) map of a (B, S, H, D) tensor read through its strides (in
// elements; dtype 0 float32, 1 bfloat16, 2 float16), whose boxes are
// `box_d` head values x `rows` positions of one head and one batch row;
// values past D or S read as zeros. swizzle128 lays a box out in the 128-byte
// swizzle that wgmma reads (box_d * esize must then be 128), else densely,
// row after row. A dim of size 1 gets the stride its neighbour implies.
// Returns false where the tensor cannot be described (a base or a stride
// that is not a multiple of 16 bytes, a box out of range).
inline bool make_map(CUtensorMap* map, const void* ptr, int dtype, int B,
                     int S, int H, int D, long long sb, long long ss,
                     long long sh, int box_d, int rows, bool swizzle128) {
  EncodeTiledFn enc = encode_tiled();
  if (enc == nullptr) return false;
  const long long es = dtype == 0 ? 4 : 2;
  if (reinterpret_cast<uintptr_t>(ptr) % 16 != 0 || (box_d * es) % 16 != 0)
    return false;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(D),
                              static_cast<cuuint64_t>(H),
                              static_cast<cuuint64_t>(S),
                              static_cast<cuuint64_t>(B)};
  cuuint64_t strides[3] = {static_cast<cuuint64_t>(sh * es),
                           static_cast<cuuint64_t>(ss * es),
                           static_cast<cuuint64_t>(sb * es)};
  if (H == 1) strides[0] = static_cast<cuuint64_t>(D * es);
  if (S == 1) strides[1] = strides[0] * H;
  if (B == 1) strides[2] = strides[1] * S;
  for (cuuint64_t s : strides)
    if (s % 16 != 0) return false;
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(box_d), 1,
                             static_cast<cuuint32_t>(rows), 1};
  const cuuint32_t estr[4] = {1, 1, 1, 1};
  const CUtensorMapDataType ty =
      dtype == 0   ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
      : dtype == 1 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                   : CU_TENSOR_MAP_DATA_TYPE_FLOAT16;
  return enc(map, ty, 4, const_cast<void*>(ptr), dims, strides, box, estr,
             CU_TENSOR_MAP_INTERLEAVE_NONE,
             swizzle128 ? CU_TENSOR_MAP_SWIZZLE_128B
                        : CU_TENSOR_MAP_SWIZZLE_NONE,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// make_map through a cache of the maps made so far, keyed on every
// argument: a map describes an address and a layout, not the values there,
// so a hit is the map make_map would encode. A decode step reads the same
// cache buffers layer after layer and step after step (56 maps for a
// 28-layer model), so the host pays the encode once per buffer, not per
// call. The cache is emptied when it passes 4,096 maps. Thread-safe.
inline bool cached_map(CUtensorMap* map, const void* ptr, int dtype, int B,
                       int S, int H, int D, long long sb, long long ss,
                       long long sh, int box_d, int rows, bool swizzle128) {
  using Key = std::array<long long, 12>;
  struct Hash {
    size_t operator()(const Key& key) const {
      uint64_t h = 1469598103934665603ull;  // FNV-1a over the key's words
      for (long long k : key) h = (h ^ static_cast<uint64_t>(k)) *
                                  1099511628211ull;
      return static_cast<size_t>(h);
    }
  };
  struct Entry {
    CUtensorMap map;
    bool ok;
  };
  static std::mutex mu;
  static std::unordered_map<Key, Entry, Hash> cache;
  const Key key = {static_cast<long long>(reinterpret_cast<uintptr_t>(ptr)),
                   dtype, B, S, H, D, sb, ss, sh, box_d, rows, swizzle128};
  std::lock_guard<std::mutex> lock(mu);
  auto it = cache.find(key);
  if (it == cache.end()) {
    if (cache.size() >= 4096) cache.clear();
    Entry e;
    e.ok = make_map(&e.map, ptr, dtype, B, S, H, D, sb, ss, sh, box_d, rows,
                    swizzle128);
    it = cache.emplace(key, e).first;
  }
  *map = it->second.map;
  return it->second.ok;
}

}  // namespace kern
