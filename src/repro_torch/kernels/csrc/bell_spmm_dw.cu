// Weight gradient of the fused kernels on Hopper:
//   dW = X^T (A^T G) = sum_i X_i^T (sum_{k < K_i} At[i, k] G[col_t[i, k]]),
// a reduction of every block row into one (Fi, Fo) float32 result.
//
// Replaces the Pallas TPU kernel repro/kernels/bell_spmm_fused.py
// (bell_spmm_dw, _dw_kernel).  It runs over the transpose payload (At =
// the stored blocks of A^T), so no (n, F) intermediate is written.  The
// diagonal tier reuses it with K = 1, identity block columns (col_idx null)
// and the transposed-read flag over its own blocks (repro/kernels/ops.py
// _bd_dw_impl), so no transposed copy of the blocks is made either.
//
// Design.  On the TPU the block rows are sequential grid steps that add into
// one VMEM accumulator.  On Hopper, CTAs run in no order and nothing carries
// across them, and float atomics would make the sum's order, and so its
// bits, change from run to run.  So the reduction has two phases:
//   1. one CTA per (split, Fi tile, Fo tile); split s owns the fixed block
//      rows [s * rows_per, (s + 1) * rows_per).  For each row the CTA forms
//      z_i = sum_k At[i, k] G[col_t[i, k]] (B, fo tile) with the k loop of
//      bell_spmm (chunks of kc blocks and their gathered G slices in shared
//      memory), then adds X_i^T z_i to the (fi tile, fo tile) partial sum its
//      threads keep in registers, and writes its partial to a workspace;
//   2. one thread per output element sums the splits' partials in split
//      order (dw_reduce.cuh, shared with tcgnn_spmm_dw.cu).
// Every sum is taken in a fixed order, so the result is the same bits on
// every run, on any card.  A row's z_i is formed once per Fi tile; the tiles
// are as wide as the registers allow (Fi = 500, Fo = 16 takes two).
//
// Bound.  Each stored block of At, the X rows and the gathered G slices are
// read once, so at the main path's first layer (62826 stored blocks,
// B = 16, Fi = 500, Fo = 16) the kernel is bound by bytes: about 105 MB.
//
// Limits.  B <= 64, any Fi >= 1 and Fo >= 1, K >= 1 (K = 1 when col_idx is
// null); shared memory is B*fi_t + B*fo_t + kc*B*(B + fo_t) floats <= 48 KB.
#include <cstdint>

#include "dtype.cuh"
#include "dw_reduce.cuh"

namespace {

using repro_torch::to_f32;

constexpr int kThreads = 256;
constexpr int kMaxOut = 16;                  // outputs per thread
constexpr int kMaxFo = 64;
constexpr int kMaxChunk = 8;                 // blocks per chunk
constexpr int kSmemFloats = 48 * 1024 / 4;   // 48 KB of float32

template <typename T>
__global__ void __launch_bounds__(kThreads)
    dw_partial_kernel(const T* __restrict__ blocks,
                      const int* __restrict__ col_idx,
                      const int* __restrict__ n_valid,
                      const T* __restrict__ x, const T* __restrict__ g,
                      float* __restrict__ partial, int nbr, int K, int B,
                      int Fi, int Fo, int fi_t, int fo_t, int kc,
                      int rows_per, int transpose) {
  extern __shared__ float smem[];
  float* x_s = smem;                 // (B, fi_t)
  float* z_s = x_s + B * fi_t;       // (B, fo_t)
  float* a_s = z_s + B * fo_t;       // (kc, B, B)
  float* g_s = a_s + kc * B * B;     // (kc, B, fo_t)

  const int split = blockIdx.x;
  const int fi0 = blockIdx.y * fi_t;
  const int fo0 = blockIdx.z * fo_t;
  const int fiw = min(fi_t, Fi - fi0);
  const int fow = min(fo_t, Fo - fo0);
  const int n_part = fiw * fow;
  const int n_z = B * fow;
  const int BB = B * B;

  float part[kMaxOut];
#pragma unroll
  for (int p = 0; p < kMaxOut; ++p) part[p] = 0.f;

  const int i_end = min(nbr, (split + 1) * rows_per);
  for (int i = split * rows_per; i < i_end; ++i) {
    const int kn = n_valid != nullptr ? min(n_valid[i], K) : K;
    if (kn == 0) continue;           // uniform across the CTA
    const T* a_row = blocks + static_cast<size_t>(i) * K * BB;
    const int* c_row =
        col_idx != nullptr ? col_idx + static_cast<size_t>(i) * K : nullptr;

    float z[kMaxOut];
#pragma unroll
    for (int q = 0; q < kMaxOut; ++q) z[q] = 0.f;
    for (int k0 = 0; k0 < kn; k0 += kc) {
      const int kw = min(kc, kn - k0);
      // kw stored blocks are one contiguous run of kw * B * B elements
      const T* a = a_row + static_cast<size_t>(k0) * BB;
      for (int e = threadIdx.x; e < kw * BB; e += kThreads) {
        const int kk = e / BB;
        const int q = e - kk * BB;
        a_s[e] = to_f32(a[kk * BB + (transpose ? (q % B) * B + q / B : q)]);
      }
      const int slice = B * fow;
      for (int e = threadIdx.x; e < kw * slice; e += kThreads) {
        const int kk = e / slice;
        const int rem = e - kk * slice;
        const int j = rem / fow;
        const int c = rem - j * fow;
        const size_t col = c_row != nullptr ? c_row[k0 + kk] : i;
        g_s[(kk * B + j) * fo_t + c] = to_f32(g[(col * B + j) * Fo + fo0 + c]);
      }
      __syncthreads();
#pragma unroll
      for (int q = 0; q < kMaxOut; ++q) {
        const int o = threadIdx.x + q * kThreads;
        if (o < n_z) {
          const int r = o / fow;
          const int c = o - r * fow;
          float s = z[q];
          for (int kk = 0; kk < kw; ++kk) {
            const float* ar = a_s + kk * BB + r * B;
            const float* gc = g_s + kk * B * fo_t + c;
#pragma unroll 8
            for (int j = 0; j < B; ++j) s = fmaf(ar[j], gc[j * fo_t], s);
          }
          z[q] = s;
        }
      }
      __syncthreads();
    }

#pragma unroll
    for (int q = 0; q < kMaxOut; ++q) {
      const int o = threadIdx.x + q * kThreads;
      if (o < n_z) {
        const int r = o / fow;
        z_s[r * fo_t + (o - r * fow)] = z[q];
      }
    }
    const size_t xrow0 = static_cast<size_t>(i) * B;
    for (int e = threadIdx.x; e < B * fiw; e += kThreads) {
      const int r = e / fiw;
      const int a = e - r * fiw;
      x_s[r * fi_t + a] = to_f32(x[(xrow0 + r) * Fi + fi0 + a]);
    }
    __syncthreads();
#pragma unroll
    for (int p = 0; p < kMaxOut; ++p) {
      const int o = threadIdx.x + p * kThreads;
      if (o < n_part) {
        const int a = o / fow;
        const int b = o - a * fow;
        float s = part[p];
#pragma unroll 8
        for (int r = 0; r < B; ++r)
          s = fmaf(x_s[r * fi_t + a], z_s[r * fo_t + b], s);
        part[p] = s;
      }
    }
    __syncthreads();
  }

  float* out = partial + static_cast<size_t>(split) * Fi * Fo;
#pragma unroll
  for (int p = 0; p < kMaxOut; ++p) {
    const int o = threadIdx.x + p * kThreads;
    if (o < n_part) {
      const int a = o / fow;
      out[static_cast<size_t>(fi0 + a) * Fo + fo0 + (o - a * fow)] = part[p];
    }
  }
}

template <typename T>
cudaError_t launch(const void* blocks, const int* col_idx, const int* n_valid,
                   const void* x, const void* g, float* partial, float* dw,
                   int nbr, int K, int B, int Fi, int Fo, int rows_per,
                   int transpose, cudaStream_t stream) {
  int fo_t = Fo < kMaxFo ? Fo : kMaxFo;
  int fi_t = kMaxOut * kThreads / fo_t;
  if (fi_t > Fi) fi_t = Fi;
  // shrink the tiles until one chunk of one block fits in shared memory
  while (B * fi_t + B * fo_t + B * (B + fo_t) > kSmemFloats) {
    if (fi_t > fo_t) {
      fi_t = (fi_t + 1) / 2;
    } else {
      fo_t = (fo_t + 1) / 2;
    }
  }
  int kc = (kSmemFloats - B * fi_t - B * fo_t) / (B * (B + fo_t));
  if (kc > kMaxChunk) kc = kMaxChunk;
  if (kc > K) kc = K;
  const int n_split = (nbr + rows_per - 1) / rows_per;
  if (n_split > 0) {
    const dim3 grid(n_split, (Fi + fi_t - 1) / fi_t, (Fo + fo_t - 1) / fo_t);
    const size_t smem = static_cast<size_t>(B * fi_t + B * fo_t +
                                            kc * B * (B + fo_t)) *
                        sizeof(float);
    dw_partial_kernel<T><<<grid, kThreads, smem, stream>>>(
        static_cast<const T*>(blocks), col_idx, n_valid,
        static_cast<const T*>(x), static_cast<const T*>(g), partial, nbr, K,
        B, Fi, Fo, fi_t, fo_t, kc, rows_per, transpose);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return repro_torch::launch_dw_reduce(partial, dw, n_split, Fi * Fo, stream);
}

}  // namespace

// Launches on `stream`; returns the cudaError_t of the launch (0 = success).
// blocks (nbr, K, B, B) of the transpose payload, col_idx (nbr, K) int32 or
// null (identity block columns, K = 1), n_valid (nbr,) int32 or null,
// x (nbr*B, Fi), g (n_cols, Fo), all of the element type `dtype`
// (0 = float32, 1 = bfloat16); partial (ceil(nbr / rows_per), Fi, Fo) and
// dw (Fi, Fo) float32.  All contiguous.  transpose != 0 reads each stored
// block transposed.
extern "C" int bell_spmm_dw_launch(const void* blocks, const void* col_idx,
                                   const void* n_valid, const void* x,
                                   const void* g, void* partial, void* dw,
                                   int nbr, int K, int B, int Fi, int Fo,
                                   int rows_per, int transpose, int dtype,
                                   void* stream) {
  if (Fi <= 0 || Fo <= 0) return 0;
  if (B < 1 || B > 64 || K < 1 || nbr < 0 || rows_per < 1 ||
      (col_idx == nullptr && K != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* ci = static_cast<const int*>(col_idx);
  const auto* nv = static_cast<const int*>(n_valid);
  auto* ps = static_cast<float*>(partial);
  auto* out = static_cast<float*>(dw);
  switch (dtype) {
    case repro_torch::kFloat32:
      return static_cast<int>(launch<float>(blocks, ci, nv, x, g, ps, out,
                                            nbr, K, B, Fi, Fo, rows_per,
                                            transpose, s));
    case repro_torch::kBFloat16:
      return static_cast<int>(launch<__nv_bfloat16>(
          blocks, ci, nv, x, g, ps, out, nbr, K, B, Fi, Fo, rows_per,
          transpose, s));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" const char* bell_spmm_dw_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
