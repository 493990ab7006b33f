// Fused blocked-ELL transform+aggregate on Hopper:
//   Y[i] = sum_{k < K_i} blocks[i, k] (X[col_idx[i, k]] W) (+ Y_in[i]).
//
// Replaces the Pallas TPU kernels repro/kernels/bell_spmm_fused.py
// (bell_spmm_fused, _kernel / _kernel_acc) and
// repro/kernels/block_diag_spmm_fused.py (block_diag_spmm_fused): the
// block-diagonal form is this kernel with K = 1 and identity block columns
// (col_idx null), Y[i] = A_i (X_i W).  As on the TPU, H = X W never reaches
// device memory, and each stored block transforms its gathered (B, Fi) rows
// of X again: a source block named by k stored blocks is transformed k
// times (once on the diagonal tier).  The fusion trades that recompute for
// the write and read of H; the selector decides per tier which side wins.
// With the transposed-read flag each stored block is read transposed while
// it is staged (an index swap), so the backward pass dX = A^T (dY W^T) of
// the diagonal tier needs no transposed copy of the blocks.
//
// Design.  On the TPU the k loop is a sequential grid axis that carries the
// sum in VMEM.  Here one CTA per (block row, Fo tile of at most 64 columns)
// runs the k loop itself and keeps its outputs in registers, so nothing
// crosses CTAs.  For each stored block the CTA walks Fi in chunks of kc
// columns: it stages the gathered (B, kc) slice of X and the (kc, ft) slice
// of W as float32, and each thread adds the chunk's products to the H
// outputs it keeps in registers.  Then H goes to shared memory beside the
// staged (B, B) block and each thread adds its outputs of A H.  When Fi fits
// in one chunk (the narrow layers), the W slice is staged once for the whole
// row.  The loop stops at n_valid[i]: padding slots are all-zero blocks by
// the format's contract, so skipping them changes no sum.
//
// Bound.  The function needs each real block, each source row of X and W
// read once and Y written once, and 2 n Fi Fo + 2 nnzb B B Fo flops: at the
// main path's first layer (62826 stored blocks, B = 16, Fi = 500, Fo = 16)
// about 105 MB and 8.3e8 flops, so it is bound by bytes.  This kernel's
// per-block recompute does 2 B Fi Fo flops per stored block instead, 1.66e10
// in all, and reads both FMA operands from shared memory: it sits far above
// the function's bound by design.  Register tiling, tensor cores, or
// transforming each source block once per CTA are the next steps.
//
// Limits.  B <= 64, any Fi >= 1 and Fo >= 1, K >= 1 (K = 1 when col_idx is
// null); shared memory is B*B + B*(kc+1) + kc*ft + B*ft floats <= 40 KB.
#include <cstdint>

#include "dtype.cuh"

namespace {

using repro_torch::from_f32;
using repro_torch::to_f32;

constexpr int kThreads = 256;
constexpr int kMaxOut = 16;                   // outputs per thread: B*ft <= 4096
constexpr int kMaxFt = 64;
constexpr int kMaxChunk = 64;                 // Fi columns per chunk
constexpr int kSmemFloats = 40 * 1024 / 4;    // 40 KB of float32

// kOut: outputs per thread, the least power of two >= B*ft / kThreads, so a
// launch holds only the registers its shape needs (B = 16, ft = 16 takes 1).
template <typename T, int kOut>
__global__ void __launch_bounds__(kThreads)
    bell_fused_kernel(const T* __restrict__ blocks,
                      const int* __restrict__ col_idx,
                      const int* __restrict__ n_valid,
                      const T* __restrict__ x, const T* __restrict__ w,
                      const T* __restrict__ y_in, T* __restrict__ y, int K,
                      int B, int Fi, int Fo, int ft, int kc, int transpose) {
  extern __shared__ float smem[];
  const int xs = kc + 1;             // padded row stride: no bank conflicts
  float* a_s = smem;                 // (B, B)
  float* x_s = a_s + B * B;          // (B, kc + 1)
  float* w_s = x_s + B * xs;         // (kc, ft)
  float* h_s = w_s + kc * ft;        // (B, ft)

  const int i = blockIdx.x;          // block row
  const int f0 = blockIdx.y * ft;
  const int fw = min(ft, Fo - f0);
  const int n_out = B * fw;
  const int BB = B * B;
  const int kn = n_valid != nullptr ? min(n_valid[i], K) : K;
  const size_t row0 = static_cast<size_t>(i) * B;
  const bool w_once = Fi <= kc;      // one chunk: stage W once per row

  float acc[kOut];
#pragma unroll
  for (int p = 0; p < kOut; ++p) {
    const int o = threadIdx.x + p * kThreads;
    acc[p] = 0.f;
    if (y_in != nullptr && o < n_out) {
      const int r = o / fw;
      acc[p] = to_f32(y_in[(row0 + r) * Fo + f0 + (o - r * fw)]);
    }
  }
  if (w_once) {
    for (int e = threadIdx.x; e < Fi * fw; e += kThreads) {
      const int j = e / fw;
      const int c = e - j * fw;
      w_s[j * ft + c] = to_f32(w[static_cast<size_t>(j) * Fo + f0 + c]);
    }
  }

  for (int k = 0; k < kn; ++k) {
    const T* a = blocks + (static_cast<size_t>(i) * K + k) * BB;
    const size_t src0 =
        static_cast<size_t>(col_idx != nullptr ? col_idx[i * K + k] : i) * B;
    for (int e = threadIdx.x; e < BB; e += kThreads)
      a_s[e] = to_f32(a[transpose ? (e % B) * B + e / B : e]);

    float h[kOut];
#pragma unroll
    for (int p = 0; p < kOut; ++p) h[p] = 0.f;
    for (int c0 = 0; c0 < Fi; c0 += kc) {
      const int cw = min(kc, Fi - c0);
      for (int e = threadIdx.x; e < B * cw; e += kThreads) {
        const int r = e / cw;
        const int j = e - r * cw;
        x_s[r * xs + j] = to_f32(x[(src0 + r) * Fi + c0 + j]);
      }
      if (!w_once) {
        for (int e = threadIdx.x; e < cw * fw; e += kThreads) {
          const int j = e / fw;
          const int c = e - j * fw;
          w_s[j * ft + c] =
              to_f32(w[static_cast<size_t>(c0 + j) * Fo + f0 + c]);
        }
      }
      __syncthreads();
#pragma unroll
      for (int p = 0; p < kOut; ++p) {
        const int o = threadIdx.x + p * kThreads;
        if (o < n_out) {
          const int r = o / fw;
          const int c = o - r * fw;
          const float* xr = x_s + r * xs;
          float s = h[p];
#pragma unroll 8
          for (int j = 0; j < cw; ++j) s = fmaf(xr[j], w_s[j * ft + c], s);
          h[p] = s;
        }
      }
      __syncthreads();
    }

#pragma unroll
    for (int p = 0; p < kOut; ++p) {
      const int o = threadIdx.x + p * kThreads;
      if (o < n_out) {
        const int r = o / fw;
        h_s[r * ft + (o - r * fw)] = h[p];
      }
    }
    __syncthreads();
#pragma unroll
    for (int p = 0; p < kOut; ++p) {
      const int o = threadIdx.x + p * kThreads;
      if (o < n_out) {
        const int r = o / fw;
        const int c = o - r * fw;
        const float* ar = a_s + r * B;
        float s = acc[p];
#pragma unroll 8
        for (int j = 0; j < B; ++j) s = fmaf(ar[j], h_s[j * ft + c], s);
        acc[p] = s;
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int p = 0; p < kOut; ++p) {
    const int o = threadIdx.x + p * kThreads;
    if (o < n_out) {
      const int r = o / fw;
      y[(row0 + r) * Fo + f0 + (o - r * fw)] = from_f32<T>(acc[p]);
    }
  }
}

template <typename T>
cudaError_t launch(const void* blocks, const int* col_idx, const int* n_valid,
                   const void* x, const void* w, const void* y_in, void* y,
                   int nbr, int K, int B, int Fi, int Fo, int transpose,
                   cudaStream_t stream) {
  const int ft = Fo < kMaxFt ? Fo : kMaxFt;
  int kc = (kSmemFloats - B * B - B * ft - B) / (B + ft);
  if (kc > kMaxChunk) kc = kMaxChunk;
  if (kc > Fi) kc = Fi;
  if (kc < 1) kc = 1;
  const dim3 grid(nbr, (Fo + ft - 1) / ft);
  const size_t smem =
      static_cast<size_t>(B * B + B * (kc + 1) + kc * ft + B * ft) *
      sizeof(float);
  const int per = (B * ft + kThreads - 1) / kThreads;
  auto kernel = per <= 1   ? bell_fused_kernel<T, 1>
                : per <= 2 ? bell_fused_kernel<T, 2>
                : per <= 4 ? bell_fused_kernel<T, 4>
                : per <= 8 ? bell_fused_kernel<T, 8>
                           : bell_fused_kernel<T, kMaxOut>;
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(blocks), col_idx, n_valid,
      static_cast<const T*>(x), static_cast<const T*>(w),
      static_cast<const T*>(y_in), static_cast<T*>(y), K, B, Fi, Fo, ft, kc,
      transpose);
  return cudaGetLastError();
}

}  // namespace

// Launches on `stream`; returns the cudaError_t of the launch (0 = success).
// blocks (nbr, K, B, B), col_idx (nbr, K) int32 or null (identity block
// columns, K = 1), n_valid (nbr,) int32 or null, x (n_cols, Fi), w (Fi, Fo),
// y and y_in (nbr*B, Fo) with y_in optional; all contiguous, of the element
// type `dtype` (0 = float32, 1 = bfloat16).  col_idx entries must name block
// columns of x.  transpose != 0 reads each stored block transposed.
extern "C" int bell_spmm_fused_launch(const void* blocks, const void* col_idx,
                                      const void* n_valid, const void* x,
                                      const void* w, const void* y_in,
                                      void* y, int nbr, int K, int B, int Fi,
                                      int Fo, int transpose, int dtype,
                                      void* stream) {
  if (nbr <= 0 || Fo <= 0) return 0;
  if (B < 1 || B > 64 || K < 1 || Fi < 1 || (col_idx == nullptr && K != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* ci = static_cast<const int*>(col_idx);
  const auto* nv = static_cast<const int*>(n_valid);
  switch (dtype) {
    case repro_torch::kFloat32:
      return static_cast<int>(launch<float>(blocks, ci, nv, x, w, y_in, y,
                                            nbr, K, B, Fi, Fo, transpose, s));
    case repro_torch::kBFloat16:
      return static_cast<int>(launch<__nv_bfloat16>(
          blocks, ci, nv, x, w, y_in, y, nbr, K, B, Fi, Fo, transpose, s));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" const char* bell_spmm_fused_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
