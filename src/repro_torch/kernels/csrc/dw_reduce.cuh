// Second phase of the port's deterministic dW reductions
// (bell_spmm_dw.cu, tcgnn_spmm_dw.cu): dw[e] = sum over splits of
// partial[split, e] in a fixed order, so the result's bits do not depend on
// how CTAs were scheduled.  A CTA of 256 threads owns 32 consecutive
// outputs; warp w sums the splits s = w (mod 8) in order (each load of a
// warp is 128 contiguous bytes), and warp 0 adds the 8 sums in warp order,
// so a thread's chain of loads is an eighth of the splits long.
#pragma once

#include <cuda_runtime.h>

namespace repro_torch {

constexpr int kReduceThreads = 256;
constexpr int kReduceGroups = kReduceThreads / 32;

__global__ void __launch_bounds__(kReduceThreads)
    dw_reduce_kernel(const float* __restrict__ partial, float* __restrict__ dw,
                     int n_split, int n) {
  __shared__ float sums[kReduceGroups][32];
  const int lane = threadIdx.x & 31, grp = threadIdx.x >> 5;
  const int e = blockIdx.x * 32 + lane;
  float s = 0.f;
  if (e < n) {
#pragma unroll 4
    for (int t = grp; t < n_split; t += kReduceGroups)
      s += partial[static_cast<size_t>(t) * n + e];
  }
  sums[grp][lane] = s;
  __syncthreads();
  if (grp != 0 || e >= n) return;
  float total = sums[0][lane];
  for (int w = 1; w < kReduceGroups; ++w) total += sums[w][lane];
  dw[e] = total;
}

// Launches the reduction of partial (n_split, n) into dw (n) on `stream`.
inline cudaError_t launch_dw_reduce(const float* partial, float* dw,
                                    int n_split, int n, cudaStream_t stream) {
  if (n <= 0) return cudaSuccess;
  dw_reduce_kernel<<<(n + 31) / 32, kReduceThreads, 0, stream>>>(
      partial, dw, n_split, n);
  return cudaGetLastError();
}

}  // namespace repro_torch
