// Blocked-ELL SpMM on Hopper:
//   Y[i] = sum_{k < K_i} blocks[i, k] X[col_idx[i, k]] (+ Y_in[i]).
//
// Replaces the Pallas TPU kernel repro/kernels/bell_spmm.py (bell_spmm,
// _kernel / _kernel_acc): the inter-community tier of the AdaptGear
// decomposition, a CSR over (B, B) blocks padded to K blocks per block row.
//
// Design.  On the TPU the grid walks (block row, feature tile, k) in order
// and carries the sum in VMEM scratch from one k step to the next.  Here
// the k loop runs inside one CTA per (block row, feature tile), so the sum
// stays in registers and nothing crosses CTAs.  The loop takes the stored
// blocks in chunks of kc: the CTA copies kc consecutive (B, B) blocks (one
// contiguous run of device memory) and the kc gathered (B, ft) slices of X
// into shared memory as float32, synchronises, and each thread adds the
// chunk's products to the outputs it owns.  A chunk puts 8-16 independent
// loads per thread in flight, which is what a latency-bound gather needs.
//
// The loop stops at n_valid[i] when the payload's count of real blocks is
// given: padding slots are all-zero blocks by the format's contract, so
// skipping them changes no sum and saves their bytes.  With n_valid null
// all K slots run, as on the TPU.
//
// Bound.  Each stored block is read once and each X slice it names is
// gathered once per block (from L2 for the main path's X, 1.3 MB).  The
// blocks dominate the bytes, with 8 FMAs per float32 byte at F = 16, so the
// kernel is bound by bytes.  Tensor cores are not used, to keep float32
// products exact.
//
// Limits.  B <= 64; up to kMaxOut outputs per thread; shared memory is
// kc * B * (B + ft) floats <= 40 KB.  Any F >= 1 and K >= 1.
#include <cstdint>

#include "dtype.cuh"

namespace {

using repro_torch::from_f32;
using repro_torch::to_f32;

constexpr int kThreads = 256;
constexpr int kMaxOut = 8;                          // outputs per thread
constexpr int kSmemFloats = 40 * 1024 / 4;          // 40 KB of float32
constexpr int kMaxChunk = 8;                        // blocks per chunk

template <typename T>
__global__ void __launch_bounds__(kThreads)
    bell_kernel(const T* __restrict__ blocks, const int* __restrict__ col_idx,
                const int* __restrict__ n_valid, const T* __restrict__ x,
                const T* __restrict__ y_in, T* __restrict__ y, int K, int B,
                int F, int ft, int kc) {
  extern __shared__ float smem[];
  float* a_s = smem;                 // (kc, B, B)
  float* x_s = smem + kc * B * B;    // (kc, B, ft)

  const int i = blockIdx.x;          // block row
  const int f0 = blockIdx.y * ft;
  const int fw = min(ft, F - f0);
  const int n_out = B * fw;
  const int BB = B * B;
  const int kn = n_valid != nullptr ? min(n_valid[i], K) : K;
  const size_t row0 = static_cast<size_t>(i) * B;

  float acc[kMaxOut];
#pragma unroll
  for (int p = 0; p < kMaxOut; ++p) {
    const int o = threadIdx.x + p * kThreads;
    acc[p] = 0.f;
    if (y_in != nullptr && o < n_out) {
      const int r = o / fw;
      acc[p] = to_f32(y_in[(row0 + r) * F + f0 + (o - r * fw)]);
    }
  }

  const T* a_row = blocks + static_cast<size_t>(i) * K * BB;
  const int* c_row = col_idx + static_cast<size_t>(i) * K;
  for (int k0 = 0; k0 < kn; k0 += kc) {
    const int kw = min(kc, kn - k0);
    // kw stored blocks are one contiguous run of kw * B * B elements
    const T* a = a_row + static_cast<size_t>(k0) * BB;
    for (int e = threadIdx.x; e < kw * BB; e += kThreads) a_s[e] = to_f32(a[e]);
    const int slice = B * fw;
    for (int e = threadIdx.x; e < kw * slice; e += kThreads) {
      const int kk = e / slice;
      const int rem = e - kk * slice;
      const int j = rem / fw;
      const int c = rem - j * fw;
      const size_t src = static_cast<size_t>(c_row[k0 + kk]) * B + j;
      x_s[(kk * B + j) * ft + c] = to_f32(x[src * F + f0 + c]);
    }
    __syncthreads();
#pragma unroll
    for (int p = 0; p < kMaxOut; ++p) {
      const int o = threadIdx.x + p * kThreads;
      if (o < n_out) {
        const int r = o / fw;
        const int c = o - r * fw;
        float s = acc[p];
        for (int kk = 0; kk < kw; ++kk) {
          const float* ar = a_s + kk * BB + r * B;
          const float* xc = x_s + kk * B * ft + c;
#pragma unroll 8
          for (int j = 0; j < B; ++j) s = fmaf(ar[j], xc[j * ft], s);
        }
        acc[p] = s;
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int p = 0; p < kMaxOut; ++p) {
    const int o = threadIdx.x + p * kThreads;
    if (o < n_out) {
      const int r = o / fw;
      y[(row0 + r) * F + f0 + (o - r * fw)] = from_f32<T>(acc[p]);
    }
  }
}

template <typename T>
cudaError_t launch(const void* blocks, const int* col_idx, const int* n_valid,
                   const void* x, const void* y_in, void* y, int nbr, int K,
                   int B, int F, cudaStream_t stream) {
  // feature tile: at most 64 wide and at most kMaxOut outputs per thread
  int ft = F < 64 ? F : 64;
  const int ft_cap = kMaxOut * kThreads / B;
  if (ft > ft_cap) ft = ft_cap;
  int kc = kSmemFloats / (B * (B + ft));
  if (kc > kMaxChunk) kc = kMaxChunk;
  if (kc < 1) kc = 1;
  const dim3 grid(nbr, (F + ft - 1) / ft);
  const size_t smem = static_cast<size_t>(kc) * B * (B + ft) * sizeof(float);
  bell_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(blocks), col_idx, n_valid,
      static_cast<const T*>(x), static_cast<const T*>(y_in),
      static_cast<T*>(y), K, B, F, ft, kc);
  return cudaGetLastError();
}

}  // namespace

// Launches on `stream`; returns the cudaError_t of the launch (0 = success).
// blocks (nbr, K, B, B), col_idx (nbr, K) int32, n_valid (nbr,) int32 or
// null, x (n_cols, F), y and y_in (nbr*B, F) with y_in optional; all
// contiguous, of the element type `dtype` (0 = float32, 1 = bfloat16).
// col_idx entries must name block columns of x (n_cols / B of them).
extern "C" int bell_spmm_launch(const void* blocks, const void* col_idx,
                                const void* n_valid, const void* x,
                                const void* y_in, void* y, int nbr, int K,
                                int B, int F, int dtype, void* stream) {
  if (nbr <= 0 || F <= 0) return 0;
  if (B < 1 || B > 64 || K < 1) return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* ci = static_cast<const int*>(col_idx);
  const auto* nv = static_cast<const int*>(n_valid);
  switch (dtype) {
    case repro_torch::kFloat32:
      return static_cast<int>(
          launch<float>(blocks, ci, nv, x, y_in, y, nbr, K, B, F, s));
    case repro_torch::kBFloat16:
      return static_cast<int>(
          launch<__nv_bfloat16>(blocks, ci, nv, x, y_in, y, nbr, K, B, F, s));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" const char* bell_spmm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
