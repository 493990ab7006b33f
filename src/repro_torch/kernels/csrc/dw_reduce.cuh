// Second phase of the port's deterministic dW reductions
// (bell_spmm_dw.cu, tcgnn_spmm_dw.cu): dw[e] = sum over splits of
// partial[split, e], added in split order, so the result's bits do not
// depend on how CTAs were scheduled.
#pragma once

#include <cuda_runtime.h>

namespace repro_torch {

constexpr int kReduceThreads = 256;

__global__ void __launch_bounds__(kReduceThreads)
    dw_reduce_kernel(const float* __restrict__ partial, float* __restrict__ dw,
                     int n_split, int n) {
  const int e = blockIdx.x * kReduceThreads + threadIdx.x;
  if (e >= n) return;
  float s = 0.f;
  for (int t = 0; t < n_split; ++t) s += partial[static_cast<size_t>(t) * n + e];
  dw[e] = s;
}

// Launches the reduction of partial (n_split, n) into dw (n) on `stream`.
inline cudaError_t launch_dw_reduce(const float* partial, float* dw,
                                    int n_split, int n, cudaStream_t stream) {
  if (n <= 0) return cudaSuccess;
  dw_reduce_kernel<<<(n + kReduceThreads - 1) / kReduceThreads,
                     kReduceThreads, 0, stream>>>(partial, dw, n_split, n);
  return cudaGetLastError();
}

}  // namespace repro_torch
