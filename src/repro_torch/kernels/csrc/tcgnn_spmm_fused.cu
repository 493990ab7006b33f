// Fused column-condensed transform+aggregate on Hopper:
//   Y[i*B + r] = sum_{s < C} tiles[i, r, s] (X[gather_idx[i, s]] W) (+ Y_in).
//
// Replaces the Pallas TPU kernel repro/kernels/tcgnn_tile.py
// (tcgnn_spmm_fused, _fmv_kernel / _fmv_kernel_acc).  As on the TPU, H =
// X W never reaches device memory, and each condensed slot transforms its
// gathered row of X once per block row that names it.  Unlike the TPU
// path, the kernel gathers the rows of X itself: the (nbr, C, Fi) stripe
// XLA writes there (316 MB at pubmed's Fi = 500) is never formed.  The
// backward pass dX = A^T (dY W^T) is this kernel over the transpose
// payload with W^T.
//
// Design.  One CTA per (block row, Fo tile of at most 64 columns).  The
// CTA walks the C slots in chunks of cs.  For each chunk it walks Fi in
// chunks of kc columns, staging the gathered (cs, kc) slice of X and the
// (kc, ft) slice of W in shared memory as float32; each thread adds the
// chunk's products to the H outputs it keeps in registers (one H row per
// slot: each slot is transformed once).  When Fi fits in one chunk (the
// narrow layers and the dX pass), W is staged once for the whole CTA.
// Then H goes to shared memory beside the chunk's (B, cs) tile slice and
// each thread adds its outputs of tiles @ H.  The output is seeded from
// Y_in in accumulate mode.  Every slot is walked, padding included (zero
// weights on row 0): the payload carries no count of real slots.
//
// Bound.  At pubmed's inter tier (nbr = 1233, B = 16, C = 128) and layer
// 1's widths (Fi = 500, Fo = 16) the function reads 10.1 MB of tiles, the
// 39.5 MB of X (every source row is named by some slot) and W, and writes
// Y: about 51.5 MB, so it is bound by bytes (0.0154 ms).  This kernel
// transforms every slot, 2 nbr C Fi Fo = 2.5 GFLOP (0.038 ms at the
// float32 rate), with both FMA operands read from shared memory; half of
// the slots are padding.  Register tiling, tensor cores and skipping
// padded slots are the next steps.
//
// Limits.  B <= 64, any C, Fi, Fo >= 1; shared memory is
// B*cs + cs*(kc+1) + kc*ft + cs*ft floats <= 48 KB.
#include <cstdint>

#include "dtype.cuh"

namespace {

using repro_torch::from_f32;
using repro_torch::to_f32;

constexpr int kThreads = 256;
constexpr int kMaxFt = 64;
constexpr int kMaxChunk = 64;                 // Fi columns per chunk
constexpr int kSmemFloats = 48 * 1024 / 4;    // 48 KB of float32

// kOut: outputs per thread, enough for both the (cs, ft) H chunk and the
// (B, ft) output tile, as a power of two.
template <typename T, int kOut>
__global__ void __launch_bounds__(kThreads)
    tcgnn_fused_kernel(const float* __restrict__ tiles,
                       const int* __restrict__ gather_idx,
                       const T* __restrict__ x, const T* __restrict__ w,
                       const T* __restrict__ y_in, T* __restrict__ y, int B,
                       int C, int Fi, int Fo, int ft, int cs, int kc) {
  extern __shared__ float smem[];
  const int xs = kc + 1;             // padded row stride: no bank conflicts
  float* t_s = smem;                 // (B, cs)
  float* x_s = t_s + B * cs;         // (cs, kc + 1)
  float* w_s = x_s + cs * xs;        // (kc, ft)
  float* h_s = w_s + kc * ft;        // (cs, ft)

  const int i = blockIdx.x;          // block row
  const int f0 = blockIdx.y * ft;
  const int fw = min(ft, Fo - f0);
  const int n_out = B * fw;
  const size_t row0 = static_cast<size_t>(i) * B;
  const float* t_row = tiles + row0 * C;
  const int* g_row = gather_idx + static_cast<size_t>(i) * C;
  const bool w_once = Fi <= kc;      // one chunk: stage W once per CTA

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

  for (int c0 = 0; c0 < C; c0 += cs) {
    const int cw = min(cs, C - c0);
    const int n_h = cw * fw;
    for (int e = threadIdx.x; e < B * cw; e += kThreads) {
      const int r = e / cw;
      const int s = e - r * cw;
      t_s[r * cs + s] = t_row[static_cast<size_t>(r) * C + c0 + s];
    }

    float h[kOut];
#pragma unroll
    for (int q = 0; q < kOut; ++q) h[q] = 0.f;
    for (int k0 = 0; k0 < Fi; k0 += kc) {
      const int kw = min(kc, Fi - k0);
      for (int e = threadIdx.x; e < cw * kw; e += kThreads) {
        const int s = e / kw;
        const int j = e - s * kw;
        const size_t src = static_cast<size_t>(__ldg(g_row + c0 + s));
        x_s[s * xs + j] = to_f32(x[src * Fi + k0 + j]);
      }
      if (!w_once) {
        for (int e = threadIdx.x; e < kw * fw; e += kThreads) {
          const int j = e / fw;
          const int c = e - j * fw;
          w_s[j * ft + c] =
              to_f32(w[static_cast<size_t>(k0 + j) * Fo + f0 + c]);
        }
      }
      __syncthreads();
#pragma unroll
      for (int q = 0; q < kOut; ++q) {
        const int o = threadIdx.x + q * kThreads;
        if (o < n_h) {
          const int s = o / fw;
          const int c = o - s * fw;
          const float* xr = x_s + s * xs;
          float v = h[q];
#pragma unroll 8
          for (int j = 0; j < kw; ++j) v = fmaf(xr[j], w_s[j * ft + c], v);
          h[q] = v;
        }
      }
      __syncthreads();
    }

#pragma unroll
    for (int q = 0; q < kOut; ++q) {
      const int o = threadIdx.x + q * kThreads;
      if (o < n_h) {
        const int s = o / fw;
        h_s[s * ft + (o - s * fw)] = h[q];
      }
    }
    __syncthreads();
#pragma unroll
    for (int p = 0; p < kOut; ++p) {
      const int o = threadIdx.x + p * kThreads;
      if (o < n_out) {
        const int r = o / fw;
        const int c = o - r * fw;
        const float* tr = t_s + r * cs;
        float v = acc[p];
#pragma unroll 8
        for (int j = 0; j < cw; ++j) v = fmaf(tr[j], h_s[j * ft + c], v);
        acc[p] = v;
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
cudaError_t launch(const float* tiles, const int* gather_idx, const void* x,
                   const void* w, const void* y_in, void* y, int nbr, int B,
                   int C, int Fi, int Fo, cudaStream_t stream) {
  const int ft = Fo < kMaxFt ? Fo : kMaxFt;
  int cs = 4096 / ft;                // H chunk of at most 4096 outputs
  if (cs > 64) cs = 64;
  if (cs > C) cs = C;
  int kc = (kSmemFloats - B * cs - cs - cs * ft) / (cs + ft);
  if (kc > kMaxChunk) kc = kMaxChunk;
  if (kc > Fi) kc = Fi;
  if (kc < 1) return cudaErrorInvalidValue;
  const dim3 grid(nbr, (Fo + ft - 1) / ft);
  const size_t smem =
      static_cast<size_t>(B * cs + cs * (kc + 1) + kc * ft + cs * ft) *
      sizeof(float);
  const int n_max = (B > cs ? B : cs) * ft;
  const int per = (n_max + kThreads - 1) / kThreads;
  auto kernel = per <= 1   ? tcgnn_fused_kernel<T, 1>
                : per <= 2 ? tcgnn_fused_kernel<T, 2>
                : per <= 4 ? tcgnn_fused_kernel<T, 4>
                : per <= 8 ? tcgnn_fused_kernel<T, 8>
                           : tcgnn_fused_kernel<T, 16>;
  kernel<<<grid, kThreads, smem, stream>>>(
      tiles, gather_idx, static_cast<const T*>(x), static_cast<const T*>(w),
      static_cast<const T*>(y_in), static_cast<T*>(y), B, C, Fi, Fo, ft, cs,
      kc);
  return cudaGetLastError();
}

}  // namespace

// Launches on `stream`; returns the cudaError_t of the launch (0 = success).
// tiles (nbr, B, C) float32, gather_idx (nbr, C) int32 rows of x,
// x (n_cols, Fi), w (Fi, Fo), y and y_in (nbr*B, Fo) with y_in optional, of
// the element type `dtype` (0 = float32, 1 = bfloat16); all contiguous.
extern "C" int tcgnn_spmm_fused_launch(const void* tiles,
                                       const void* gather_idx, const void* x,
                                       const void* w, const void* y_in,
                                       void* y, int nbr, int B, int C, int Fi,
                                       int Fo, int dtype, void* stream) {
  if (nbr <= 0 || Fo <= 0) return 0;
  if (B < 1 || B > 64 || C < 1 || Fi < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* t = static_cast<const float*>(tiles);
  const auto* gi = static_cast<const int*>(gather_idx);
  switch (dtype) {
    case repro_torch::kFloat32:
      return static_cast<int>(
          launch<float>(t, gi, x, w, y_in, y, nbr, B, C, Fi, Fo, s));
    case repro_torch::kBFloat16:
      return static_cast<int>(
          launch<__nv_bfloat16>(t, gi, x, w, y_in, y, nbr, B, C, Fi, Fo, s));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" const char* tcgnn_spmm_fused_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
