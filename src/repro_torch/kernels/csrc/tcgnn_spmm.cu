// Column-condensed SpMM on Hopper:
//   Y[i*B + r] = sum_{s < C} tiles[i, r, s] X[gather_idx[i, s]] (+ Y_in).
//
// Replaces the Pallas TPU kernel repro/kernels/tcgnn_tile.py (tcgnn_spmm,
// _mv_kernel / _mv_kernel_acc): the TC-GNN-style format packs each block
// row's distinct source columns into a dense (B, C) tile and records them
// in gather_idx.  On the TPU, XLA gathers x[gather_idx] into an (nbr, C, F)
// stripe before the kernel (the per-column gather cannot be a BlockSpec),
// and the kernel contracts tiles @ stripe.  Here the kernel gathers the
// rows itself, so the stripe is never written to device memory.
//
// Design.  One CTA per (block row, feature tile of at most 64 columns).
// The CTA walks the C slots in chunks: it stages the (B, cc) slice of the
// tile and the cc gathered rows of X (as float32, in 16-byte loads along F
// when F and X's address allow) in shared memory, synchronises, and each
// thread adds the chunk's products to the outputs it keeps in registers.
// At the main path's shapes (B = 16, C = 128, F = 16) one chunk holds the
// whole tile: 8 KB of tile and 8 KB of gathered X.  The output is seeded
// from Y_in in accumulate mode.  Every slot is walked, padding included:
// the payload has no per-row count of real slots (it is the reference's,
// byte for byte), and padded slots are zero weights on row 0.
//
// Bound.  At pubmed's inter tier (nbr = 1233, B = 16, C = 128, F = 16)
// the function reads 10.1 MB of tiles, 0.6 MB of gather_idx and X's rows,
// and writes Y: about 13.3 MB, so it is bound by bytes (0.004 ms at
// 3.35 TB/s); 2 nbr B C F = 81 MFLOP is far under the float32 rate.  The
// gathered rows are read once per slot that names them, from L2 for the
// main path's 1.3 MB X.  About half the slots are padding at pubmed (64.4
// real columns per block row on average): their bytes and FMAs are the
// first thing a redesign would drop.
//
// Limits.  B <= 64, any C >= 1 and F >= 1; shared memory is
// cc * (B + ft) floats <= 40 KB.
#include <cstdint>

#include "dtype.cuh"

namespace {

using repro_torch::from_f32;
using repro_torch::to_f32;
using repro_torch::Vec16;

constexpr int kThreads = 256;
constexpr int kMaxFt = 64;
constexpr int kMaxChunk = 128;                // slots per chunk
constexpr int kSmemFloats = 40 * 1024 / 4;    // 40 KB of float32

// kOut: outputs per thread (B * ft / kThreads, rounded up to a power of
// two).  kVec: X rows are read in 16-byte vectors (F a multiple of the
// vector width, X 16-byte aligned).
template <typename T, int kOut, bool kVec>
__global__ void __launch_bounds__(kThreads)
    tcgnn_kernel(const float* __restrict__ tiles,
                 const int* __restrict__ gather_idx, const T* __restrict__ x,
                 const T* __restrict__ y_in, T* __restrict__ y, int B, int C,
                 int F, int ft, int cc) {
  extern __shared__ float smem[];
  float* t_s = smem;                 // (B, cc)
  float* x_s = t_s + B * cc;         // (cc, ft)

  const int i = blockIdx.x;          // block row
  const int f0 = blockIdx.y * ft;
  const int fw = min(ft, F - f0);
  const int n_out = B * fw;
  const size_t row0 = static_cast<size_t>(i) * B;
  const float* t_row = tiles + row0 * C;
  const int* g_row = gather_idx + static_cast<size_t>(i) * C;

  float acc[kOut];
#pragma unroll
  for (int p = 0; p < kOut; ++p) {
    const int o = threadIdx.x + p * kThreads;
    acc[p] = 0.f;
    if (y_in != nullptr && o < n_out) {
      const int r = o / fw;
      acc[p] = to_f32(y_in[(row0 + r) * F + f0 + (o - r * fw)]);
    }
  }

  for (int c0 = 0; c0 < C; c0 += cc) {
    const int cw = min(cc, C - c0);
    for (int e = threadIdx.x; e < B * cw; e += kThreads) {
      const int r = e / cw;
      const int s = e - r * cw;
      t_s[r * cc + s] = t_row[static_cast<size_t>(r) * C + c0 + s];
    }
    if (kVec) {
      constexpr int V = Vec16<T>::kN;
      const int nv = fw / V;
      for (int e = threadIdx.x; e < cw * nv; e += kThreads) {
        const int s = e / nv;
        const int v = e - s * nv;
        const size_t src = static_cast<size_t>(__ldg(g_row + c0 + s));
        float tmp[V];
        Vec16<T>::load(x + src * F + f0 + v * V, tmp);
#pragma unroll
        for (int k = 0; k < V; ++k) x_s[s * ft + v * V + k] = tmp[k];
      }
    } else {
      for (int e = threadIdx.x; e < cw * fw; e += kThreads) {
        const int s = e / fw;
        const int c = e - s * fw;
        const size_t src = static_cast<size_t>(__ldg(g_row + c0 + s));
        x_s[s * ft + c] = to_f32(x[src * F + f0 + c]);
      }
    }
    __syncthreads();
#pragma unroll
    for (int p = 0; p < kOut; ++p) {
      const int o = threadIdx.x + p * kThreads;
      if (o < n_out) {
        const int r = o / fw;
        const int c = o - r * fw;
        const float* tr = t_s + r * cc;
        float s = acc[p];
#pragma unroll 8
        for (int j = 0; j < cw; ++j) s = fmaf(tr[j], x_s[j * ft + c], s);
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
      y[(row0 + r) * F + f0 + (o - r * fw)] = from_f32<T>(acc[p]);
    }
  }
}

template <typename T, bool kVec>
cudaError_t launch_vec(const float* tiles, const int* gather_idx, const T* x,
                       const T* y_in, T* y, int nbr, int B, int C, int F,
                       cudaStream_t stream) {
  const int ft = F < kMaxFt ? F : kMaxFt;
  int cc = kSmemFloats / (B + ft);
  if (cc > kMaxChunk) cc = kMaxChunk;
  if (cc > C) cc = C;
  const dim3 grid(nbr, (F + ft - 1) / ft);
  const size_t smem = static_cast<size_t>(cc) * (B + ft) * sizeof(float);
  const int per = (B * ft + kThreads - 1) / kThreads;
  auto kernel = per <= 1   ? tcgnn_kernel<T, 1, kVec>
                : per <= 2 ? tcgnn_kernel<T, 2, kVec>
                : per <= 4 ? tcgnn_kernel<T, 4, kVec>
                : per <= 8 ? tcgnn_kernel<T, 8, kVec>
                           : tcgnn_kernel<T, 16, kVec>;
  kernel<<<grid, kThreads, smem, stream>>>(tiles, gather_idx, x, y_in, y, B,
                                           C, F, ft, cc);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const float* tiles, const int* gather_idx, const void* x,
                   const void* y_in, void* y, int nbr, int B, int C, int F,
                   cudaStream_t stream) {
  const auto* xt = static_cast<const T*>(x);
  const auto* yi = static_cast<const T*>(y_in);
  auto* yt = static_cast<T*>(y);
  const bool vec = F % Vec16<T>::kN == 0 &&
                   reinterpret_cast<uintptr_t>(x) % 16 == 0;
  return vec ? launch_vec<T, true>(tiles, gather_idx, xt, yi, yt, nbr, B, C,
                                   F, stream)
             : launch_vec<T, false>(tiles, gather_idx, xt, yi, yt, nbr, B, C,
                                    F, stream);
}

}  // namespace

// Launches on `stream`; returns the cudaError_t of the launch (0 = success).
// tiles (nbr, B, C) float32, gather_idx (nbr, C) int32 rows of x,
// x (n_cols, F), y and y_in (nbr*B, F) with y_in optional, of the element
// type `dtype` (0 = float32, 1 = bfloat16); all contiguous.
extern "C" int tcgnn_spmm_launch(const void* tiles, const void* gather_idx,
                                 const void* x, const void* y_in, void* y,
                                 int nbr, int B, int C, int F, int dtype,
                                 void* stream) {
  if (nbr <= 0 || F <= 0) return 0;
  if (B < 1 || B > 64 || C < 1) return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* t = static_cast<const float*>(tiles);
  const auto* gi = static_cast<const int*>(gather_idx);
  switch (dtype) {
    case repro_torch::kFloat32:
      return static_cast<int>(
          launch<float>(t, gi, x, y_in, y, nbr, B, C, F, s));
    case repro_torch::kBFloat16:
      return static_cast<int>(
          launch<__nv_bfloat16>(t, gi, x, y_in, y, nbr, B, C, F, s));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" const char* tcgnn_spmm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
