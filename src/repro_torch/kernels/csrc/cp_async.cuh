// Asynchronous copies into shared memory and shared-memory reads shared by
// the port's gather kernels (bell_spmm.cu, bell_spmm_fused.cu,
// bell_spmm_dw.cu, tcgnn_spmm_fused.cu, tcgnn_spmm_dw.cu) and its scans
// (rwkv6_chunked.cu, mamba_scan.cu).
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

// Copies a tile of `rows` rows into dst (row pitch DP elements, a
// multiple of G bytes) from src (row pitch sp elements) in G-byte granules:
// a row below `valid` takes src's first n elements and zeros past them, a
// row at or past `valid` is all zeros.  Thread tid of nthr moves every
// nthr-th granule, starting at its tid-th (a caller staging several tiles
// rotates tid so that the threads share the granules evenly); G and DP are
// compile-time, so a granule's row and column are shifts.
template <int G, int DP, typename T>
__device__ __forceinline__ void copy_tile_g(T* dst, const T* src,
                                            long long sp, int n, int rows,
                                            int valid, int tid, int nthr) {
  constexpr int kEg = G / static_cast<int>(sizeof(T));
  constexpr int kGpr = DP / kEg;
  static_assert(kEg >= 1 && DP % kEg == 0, "G must divide a row");
  for (int e = tid; e < rows * kGpr; e += nthr) {
    const int r = e / kGpr;
    const int col = (e - r * kGpr) * kEg;
    const int bytes =
        r < valid
            ? max(0, min(G, (n - col) * static_cast<int>(sizeof(T))))
            : 0;
    copy_granule(dst + r * DP + col, bytes > 0 ? src + r * sp + col : src,
                 G, bytes);
  }
}

// copy_tile_g at the runtime granule g (16, 8 or 4, or 2 for 2-byte T),
// which the host picks to divide both pitches.
template <int DP, typename T>
__device__ __forceinline__ void copy_tile(T* dst, const T* src, long long sp,
                                          int n, int rows, int valid, int g,
                                          int tid, int nthr) {
  constexpr int kRow = DP * static_cast<int>(sizeof(T));
  if constexpr (kRow % 16 == 0)
    if (g == 16)
      return copy_tile_g<16, DP>(dst, src, sp, n, rows, valid, tid, nthr);
  if constexpr (kRow % 8 == 0)
    if (g == 8)
      return copy_tile_g<8, DP>(dst, src, sp, n, rows, valid, tid, nthr);
  if (g == 4)
    return copy_tile_g<4, DP>(dst, src, sp, n, rows, valid, tid, nthr);
  if constexpr (sizeof(T) == 2)
    copy_tile_g<2, DP>(dst, src, sp, n, rows, valid, tid, nthr);
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

// mbarriers and 1-D bulk copies (the TMA's cp.async.bulk): a copy
// completes on an mbarrier whose phase awaits its bytes, and moves up to
// megabytes without a request per 16 bytes from the issuing threads.
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count));
}

// The calling thread's arrival, announcing `bytes` more to come.
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, int bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

// Returns once the phase of parity `parity` has completed; traps after
// 2^24 polls, so a lost copy fails the launch instead of holding the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_u32(bar);
  uint32_t done;
  for (uint32_t n = 0;; ++n) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
    if (done) return;
    if (n == (1u << 24)) __trap();
  }
}

// `bytes` (a multiple of 16, both addresses 16-byte aligned) from global
// src to shared dst, completing on `bar`.  The fence orders this thread's
// earlier shared-memory accesses (and, after a barrier, the CTA's) before
// the copy's writes.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          int bytes, uint64_t* bar) {
  asm volatile(
      "fence.proxy.async.shared::cta;\n"
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
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
