// Block-diagonal SpMM on Hopper: Y = blockdiag(A_1 .. A_nb) X (+ Y_in).
//
// Replaces the Pallas TPU kernel repro/kernels/block_diag_spmm.py
// (block_diag_spmm, _kernel / _kernel_acc): the intra-community tier of the
// AdaptGear decomposition, one dense (B, B) adjacency block per community.
//
// Design.  One CTA per (block, feature tile).  The CTA stages the (B, B)
// block and the block's (B, ft) slice of X in shared memory as float32,
// then each thread forms outputs Y[r, c] = sum_j A[r, j] X[j, c] with a
// float32 FMA chain and adds Y_in when given.  Every input element is read
// from device memory once and every output written once, so the kernel is
// bound by bytes: at the main path's shapes (B = 16, F = 16 or 3) the block
// and the X slice are 1 KB each and the product is 8 FMAs per byte read,
// far below the card's float32 FMA rate per byte.  Tensor cores are not
// used: float32 inputs must keep full float32 products, and at these
// widths the work is a few microseconds of memory traffic.
//
// Limits.  B <= 64 (the block sizes the blocked-ELL block picker can return
// are 8..64); shared memory is (B*B + B*ft) floats <= 32 KB.  Any F >= 1.
#include <cstdint>

#include "dtype.cuh"

namespace {

using repro_torch::from_f32;
using repro_torch::to_f32;

constexpr int kThreads = 256;
constexpr int kMaxFt = 64;

template <typename T>
__global__ void __launch_bounds__(kThreads)
    block_diag_kernel(const T* __restrict__ blocks, const T* __restrict__ x,
                      const T* __restrict__ y_in, T* __restrict__ y, int B,
                      int F, int ft) {
  extern __shared__ float smem[];
  float* a_s = smem;           // (B, B)
  float* x_s = smem + B * B;   // (B, ft)

  const int blk = blockIdx.x;
  const int f0 = blockIdx.y * ft;
  const int fw = min(ft, F - f0);
  const size_t row0 = static_cast<size_t>(blk) * B;

  const T* a = blocks + static_cast<size_t>(blk) * B * B;
  for (int e = threadIdx.x; e < B * B; e += blockDim.x) a_s[e] = to_f32(a[e]);
  for (int e = threadIdx.x; e < B * fw; e += blockDim.x) {
    const int r = e / fw;
    const int c = e - r * fw;
    x_s[r * ft + c] = to_f32(x[(row0 + r) * F + f0 + c]);
  }
  __syncthreads();

  for (int o = threadIdx.x; o < B * fw; o += blockDim.x) {
    const int r = o / fw;
    const int c = o - r * fw;
    const float* ar = a_s + r * B;
    float acc = 0.f;
#pragma unroll 8
    for (int j = 0; j < B; ++j) acc = fmaf(ar[j], x_s[j * ft + c], acc);
    const size_t off = (row0 + r) * F + f0 + c;
    if (y_in != nullptr) acc = to_f32(y_in[off]) + acc;
    y[off] = from_f32<T>(acc);
  }
}

template <typename T>
cudaError_t launch(const void* blocks, const void* x, const void* y_in,
                   void* y, int nb, int B, int F, cudaStream_t stream) {
  const int ft = F < kMaxFt ? F : kMaxFt;
  const dim3 grid(nb, (F + ft - 1) / ft);
  const size_t smem = static_cast<size_t>(B * B + B * ft) * sizeof(float);
  block_diag_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(blocks), static_cast<const T*>(x),
      static_cast<const T*>(y_in), static_cast<T*>(y), B, F, ft);
  return cudaGetLastError();
}

}  // namespace

// Launches on `stream`; returns the cudaError_t of the launch (0 = success).
// blocks (nb, B, B), x and y (nb*B, F), y_in (nb*B, F) or null; all
// contiguous, of the element type `dtype` (0 = float32, 1 = bfloat16).
extern "C" int block_diag_spmm_launch(const void* blocks, const void* x,
                                      const void* y_in, void* y, int nb,
                                      int B, int F, int dtype,
                                      void* stream) {
  if (nb <= 0 || F <= 0) return 0;
  if (B < 1 || B > 64) return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case repro_torch::kFloat32:
      return static_cast<int>(launch<float>(blocks, x, y_in, y, nb, B, F, s));
    case repro_torch::kBFloat16:
      return static_cast<int>(
          launch<__nv_bfloat16>(blocks, x, y_in, y, nb, B, F, s));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" const char* block_diag_spmm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
