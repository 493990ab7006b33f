// Weight gradient of the fused column-condensed kernel on Hopper:
//   dW = X^T (A^T G) = sum_i X_i^T (tiles_t[i] G[gather_idx_t[i]]),
// a reduction of every block row into one (Fi, Fo) float32 result.
//
// Replaces the Pallas TPU kernel repro/kernels/tcgnn_tile.py
// (tcgnn_spmm_dw, _dw_kernel).  It runs over the transpose payload
// (tiles_t, gather_idx_t = the condensed form of A^T), so no (n, F)
// intermediate is written, and it gathers the rows of G itself: the
// (nbr, C, Fo) stripe XLA gathers before the TPU kernel is never formed.
//
// Design.  As in bell_spmm_dw.cu, a deterministic two-phase reduction, so
// the result is the same bits on every run, without atomics:
//   1. one CTA per (split, Fi tile, Fo tile); split s owns the fixed block
//      rows [s * rows_per, (s + 1) * rows_per).  For each row the CTA forms
//      z_i = tiles_t[i] G[gather_idx_t[i]] (B, fo tile) with tcgnn_spmm's
//      chunked loop (a (B, cc) tile slice and cc gathered G rows in shared
//      memory, 16-byte loads where G allows), then adds X_i^T z_i to the
//      (fi tile, fo tile) partial sum its threads keep in registers, and
//      writes its partial to a workspace;
//   2. dw_reduce.cuh sums the splits' partials in split order.
//
// Bound.  At pubmed's transpose tier (nbr = 1233, B = 16, C = 128) and
// layer 1's widths (Fi = 500, Fo = 16) the function reads 10.1 MB of
// tiles_t, the 39.5 MB of X and G's rows, and writes dW: about 51.5 MB,
// bound by bytes (0.0154 ms).  z_i is formed once per Fi tile (two at
// Fi = 500), and every slot is walked, padding included.
//
// Limits.  B <= 64, any C, Fi, Fo >= 1; shared memory is
// B*fi_t + B*fo_t + cc*(B + fo_t) floats <= 48 KB.
#include <cstdint>

#include "dtype.cuh"
#include "dw_reduce.cuh"

namespace {

using repro_torch::to_f32;
using repro_torch::Vec16;

constexpr int kThreads = 256;
constexpr int kMaxOut = 16;                  // outputs per thread
constexpr int kMaxFo = 64;
constexpr int kMaxChunk = 128;               // slots per chunk
constexpr int kSmemFloats = 48 * 1024 / 4;   // 48 KB of float32

template <typename T, bool kVec>
__global__ void __launch_bounds__(kThreads)
    dw_partial_kernel(const float* __restrict__ tiles,
                      const int* __restrict__ gather_idx,
                      const T* __restrict__ x, const T* __restrict__ g,
                      float* __restrict__ partial, int nbr, int B, int C,
                      int Fi, int Fo, int fi_t, int fo_t, int cc,
                      int rows_per) {
  extern __shared__ float smem[];
  float* x_s = smem;                 // (B, fi_t)
  float* z_s = x_s + B * fi_t;       // (B, fo_t)
  float* t_s = z_s + B * fo_t;       // (B, cc)
  float* g_s = t_s + B * cc;         // (cc, fo_t)

  const int split = blockIdx.x;
  const int fi0 = blockIdx.y * fi_t;
  const int fo0 = blockIdx.z * fo_t;
  const int fiw = min(fi_t, Fi - fi0);
  const int fow = min(fo_t, Fo - fo0);
  const int n_part = fiw * fow;
  const int n_z = B * fow;

  float part[kMaxOut];
#pragma unroll
  for (int p = 0; p < kMaxOut; ++p) part[p] = 0.f;

  const int i_end = min(nbr, (split + 1) * rows_per);
  for (int i = split * rows_per; i < i_end; ++i) {
    const size_t row0 = static_cast<size_t>(i) * B;
    const float* t_row = tiles + row0 * C;
    const int* g_row = gather_idx + static_cast<size_t>(i) * C;

    float z[kMaxOut];
#pragma unroll
    for (int q = 0; q < kMaxOut; ++q) z[q] = 0.f;
    for (int c0 = 0; c0 < C; c0 += cc) {
      const int cw = min(cc, C - c0);
      for (int e = threadIdx.x; e < B * cw; e += kThreads) {
        const int r = e / cw;
        const int s = e - r * cw;
        t_s[r * cc + s] = t_row[static_cast<size_t>(r) * C + c0 + s];
      }
      if (kVec) {
        constexpr int V = Vec16<T>::kN;
        const int nv = fow / V;
        for (int e = threadIdx.x; e < cw * nv; e += kThreads) {
          const int s = e / nv;
          const int v = e - s * nv;
          const size_t src = static_cast<size_t>(__ldg(g_row + c0 + s));
          float tmp[V];
          Vec16<T>::load(g + src * Fo + fo0 + v * V, tmp);
#pragma unroll
          for (int k = 0; k < V; ++k) g_s[s * fo_t + v * V + k] = tmp[k];
        }
      } else {
        for (int e = threadIdx.x; e < cw * fow; e += kThreads) {
          const int s = e / fow;
          const int c = e - s * fow;
          const size_t src = static_cast<size_t>(__ldg(g_row + c0 + s));
          g_s[s * fo_t + c] = to_f32(g[src * Fo + fo0 + c]);
        }
      }
      __syncthreads();
#pragma unroll
      for (int q = 0; q < kMaxOut; ++q) {
        const int o = threadIdx.x + q * kThreads;
        if (o < n_z) {
          const int r = o / fow;
          const int c = o - r * fow;
          const float* tr = t_s + r * cc;
          float s = z[q];
#pragma unroll 8
          for (int j = 0; j < cw; ++j) s = fmaf(tr[j], g_s[j * fo_t + c], s);
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
    for (int e = threadIdx.x; e < B * fiw; e += kThreads) {
      const int r = e / fiw;
      const int a = e - r * fiw;
      x_s[r * fi_t + a] = to_f32(x[(row0 + r) * Fi + fi0 + a]);
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
cudaError_t launch(const float* tiles, const int* gather_idx, const void* x,
                   const void* g, float* partial, float* dw, int nbr, int B,
                   int C, int Fi, int Fo, int rows_per, cudaStream_t stream) {
  int fo_t = Fo < kMaxFo ? Fo : kMaxFo;
  int fi_t = kMaxOut * kThreads / fo_t;
  if (fi_t > Fi) fi_t = Fi;
  // shrink the tiles until one slot chunk of 8 fits in shared memory
  while (B * fi_t + B * fo_t + 8 * (B + fo_t) > kSmemFloats) {
    if (fi_t > fo_t) {
      fi_t = (fi_t + 1) / 2;
    } else {
      fo_t = (fo_t + 1) / 2;
    }
  }
  int cc = (kSmemFloats - B * fi_t - B * fo_t) / (B + fo_t);
  if (cc > kMaxChunk) cc = kMaxChunk;
  if (cc > C) cc = C;
  const int n_split = (nbr + rows_per - 1) / rows_per;
  if (n_split > 0) {
    const dim3 grid(n_split, (Fi + fi_t - 1) / fi_t, (Fo + fo_t - 1) / fo_t);
    const size_t smem = static_cast<size_t>(B * fi_t + B * fo_t +
                                            cc * (B + fo_t)) *
                        sizeof(float);
    const auto* xt = static_cast<const T*>(x);
    const auto* gt = static_cast<const T*>(g);
    // 16-byte G loads: every Fo tile a multiple of the vector width
    const bool vec = Fo % Vec16<T>::kN == 0 && fo_t % Vec16<T>::kN == 0 &&
                     reinterpret_cast<uintptr_t>(g) % 16 == 0;
    if (vec) {
      dw_partial_kernel<T, true><<<grid, kThreads, smem, stream>>>(
          tiles, gather_idx, xt, gt, partial, nbr, B, C, Fi, Fo, fi_t, fo_t,
          cc, rows_per);
    } else {
      dw_partial_kernel<T, false><<<grid, kThreads, smem, stream>>>(
          tiles, gather_idx, xt, gt, partial, nbr, B, C, Fi, Fo, fi_t, fo_t,
          cc, rows_per);
    }
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return repro_torch::launch_dw_reduce(partial, dw, n_split, Fi * Fo, stream);
}

}  // namespace

// Launches on `stream`; returns the cudaError_t of the launch (0 = success).
// tiles (nbr, B, C) float32 and gather_idx (nbr, C) int32 rows of g: the
// transpose payload; x (nbr*B, Fi), g (n_cols, Fo), of the element type
// `dtype` (0 = float32, 1 = bfloat16); partial (ceil(nbr / rows_per), Fi,
// Fo) and dw (Fi, Fo) float32.  All contiguous.
extern "C" int tcgnn_spmm_dw_launch(const void* tiles, const void* gather_idx,
                                    const void* x, const void* g,
                                    void* partial, void* dw, int nbr, int B,
                                    int C, int Fi, int Fo, int rows_per,
                                    int dtype, void* stream) {
  if (Fi <= 0 || Fo <= 0) return 0;
  if (B < 1 || B > 64 || C < 1 || nbr < 0 || rows_per < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* t = static_cast<const float*>(tiles);
  const auto* gi = static_cast<const int*>(gather_idx);
  auto* ps = static_cast<float*>(partial);
  auto* out = static_cast<float*>(dw);
  switch (dtype) {
    case repro_torch::kFloat32:
      return static_cast<int>(launch<float>(t, gi, x, g, ps, out, nbr, B, C,
                                            Fi, Fo, rows_per, s));
    case repro_torch::kBFloat16:
      return static_cast<int>(launch<__nv_bfloat16>(
          t, gi, x, g, ps, out, nbr, B, C, Fi, Fo, rows_per, s));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" const char* tcgnn_spmm_dw_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
