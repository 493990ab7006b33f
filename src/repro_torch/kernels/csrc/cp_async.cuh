// Asynchronous copies into shared memory and shared-memory reads shared by
// the port's gather kernels (bell_spmm.cu, bell_spmm_fused.cu,
// bell_spmm_dw.cu, tcgnn_spmm_fused.cu, tcgnn_spmm_dw.cu).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace repro_torch {

// Copies `bytes` (0..g) bytes of one g-byte granule from global src to
// shared dst and zero-fills the rest.  g in {16, 8, 4} is a cp.async (16
// bypasses L1); g = 2 (bfloat16 rows of odd pitch) is a plain copy.
__device__ __forceinline__ void copy_granule(void* dst, const void* src,
                                             int g, int bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  switch (g) {
    case 16:
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
                   "l"(src), "r"(bytes));
      break;
    case 8:
      asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(d),
                   "l"(src), "r"(bytes));
      break;
    case 4:
      asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
                   "l"(src), "r"(bytes));
      break;
    default:
      *static_cast<uint16_t*>(dst) =
          bytes > 0 ? *static_cast<const uint16_t*>(src) : uint16_t{0};
  }
}

// Copies `rows` rows of `gpr` g-byte granules from src (row pitch sp
// elements) to dst (row pitch dp elements), zero-filling each row past its
// first n elements.  Thread tid of nthr moves every nthr-th granule; the
// row of a granule is e / gpr, taken in float (exact for e < 2^21).
template <typename T>
__device__ __forceinline__ void copy_rows(T* dst, int dp, const T* src,
                                          int sp, int n, int rows, int gpr,
                                          float inv_gpr, int g, int tid,
                                          int nthr) {
  const int eg = g / static_cast<int>(sizeof(T));
  for (int e = tid; e < rows * gpr; e += nthr) {
    const int r = static_cast<int>((e + 0.5f) * inv_gpr);
    const int col = (e - r * gpr) * eg;
    const int bytes =
        max(0, min(g, (n - col) * static_cast<int>(sizeof(T))));
    copy_granule(dst + r * dp + col,
                 src + static_cast<size_t>(r) * sp + (bytes > 0 ? col : 0), g,
                 bytes);
  }
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// Waits until at most N committed copy groups are still in flight.
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// 4 consecutive elements from shared memory, widened to float32 (16-byte
// aligned for float32, 8-byte for bfloat16).
__device__ __forceinline__ void ld4(const float* p, float* v) {
  const float4 t = *reinterpret_cast<const float4*>(p);
  v[0] = t.x;
  v[1] = t.y;
  v[2] = t.z;
  v[3] = t.w;
}
__device__ __forceinline__ void ld4(const __nv_bfloat16* p, float* v) {
  const uint2 t = *reinterpret_cast<const uint2*>(p);
  const auto* h = reinterpret_cast<const __nv_bfloat162*>(&t);
  const float2 a = __bfloat1622float2(h[0]);
  const float2 b = __bfloat1622float2(h[1]);
  v[0] = a.x;
  v[1] = a.y;
  v[2] = b.x;
  v[3] = b.y;
}

__host__ __device__ constexpr int align16(int bytes) {
  return (bytes + 15) & ~15;
}

// Largest copy granule (16, 8, 4 or 2 bytes) dividing both the row pitch
// and the base address.
inline int granule(long long pitch_bytes, const void* base) {
  const auto a = reinterpret_cast<uintptr_t>(base);
  for (int g = 16; g >= 4; g >>= 1)
    if (pitch_bytes % g == 0 && a % g == 0) return g;
  return 2;
}

}  // namespace repro_torch
