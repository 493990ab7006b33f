// Selective SSM scan (Mamba) on Hopper, forward, from a zero state:
//   h_t = exp(dt_t A) h_{t-1} + dt_t B_t x_t ;   y_t = C_t . h_t + D x_t
//
// Replaces the Pallas TPU kernel src/repro/kernels/mamba_scan.py:59
// (mamba_scan, _kernel): x (B, T, di) in the model type, dt (B, T, di)
// post-softplus, B and C (B, T, ds), A (di, ds), D (di,) all float32 ->
// y (B, T, di) in x's type.  The state and every product are float32.
//
// The Pallas kernel walks a sequential grid of T / chunk steps per
// (b, d_tile) with the (d_tile, ds) state in VMEM, and inside a chunk runs
// an associative scan over (chunk, d_tile, ds) tensors.  Here the state of
// one channel is ds <= 16 floats: it lives in registers, and the loop over
// T runs in order, so the rounding follows the sequential oracle
// (ref.mamba_ssm) rather than the in-chunk scan.  exp(dt A) <= 1 since
// A < 0 and dt > 0, so nothing grows past the state's own size.
//
// Parallelism.  One thread per (b, d): a CTA owns kThreads = 64
// consecutive channels of one batch row, so x, dt and y move coalesced
// along d.  Per chunk of kTC = 32 steps the CTA stages x and dt (32 x 64)
// and B and C (32 x ds, shared by all its channels) in shared memory, one
// barrier, then each thread runs the 32 steps on its registers; several
// CTAs per SM overlap one CTA's loads with another's steps.  At
// (4, 1024, 8192, 16) that is 512 CTAs.  d_state is a template parameter
// (2, 4, 8 or 16, the caller's ds padded up): a padded state slot gets
// A = 0 and B = C = 0, so it stays 0 and adds nothing, and the inner loop
// has no mask.
//
// Bound on this card.  x, dt and y in float32 are read or written once,
// B, C, A and D read once: 403.7 MB at (4, 1024, 8192, 16), 0.1205 ms at
// 3.35 TB/s.  mamba_scan_flops counts 8 per state element, 4.29 GFLOP,
// 0.064 ms on the float32 CUDA cores, so the bound is bytes.  The kernel
// itself issues about ten float32 instructions per state element (expf
// with its range reduction, the update, the C product): about 0.18 ms of
// issue at one warp instruction per scheduler per clock, so it sits near
// the issue limit rather than the memory one.  Splitting a channel's
// state across lanes, a cheaper exp and copy/compute overlap (cp.async)
// are later work.
//
// Limits.  1 <= ds <= 16; any B, T, di >= 0; 20.5 KB of static shared
// memory at ds = 16.
#include <cstdint>

#include "dtype.cuh"

namespace {

using repro_torch::from_f32;
using repro_torch::to_f32;

constexpr int kThreads = 64;     // channels per CTA
constexpr int kTC = 32;          // steps staged per chunk
constexpr int kMaxDs = 16;

template <typename E, int DS>
__global__ void __launch_bounds__(kThreads)
    mamba_scan_kernel(const E* __restrict__ x, const float* __restrict__ dt,
                      const float* __restrict__ bc,
                      const float* __restrict__ cc,
                      const float* __restrict__ a_mat,
                      const float* __restrict__ d_vec, E* __restrict__ y,
                      int T, int di, int ds) {
  __shared__ float xs[kTC][kThreads];
  __shared__ float dts[kTC][kThreads];
  __shared__ float bs[kTC][DS];
  __shared__ float cs[kTC][DS];
  const int tid = threadIdx.x;
  const int d = blockIdx.x * kThreads + tid;
  const bool live = d < di;
  const int64_t row0 = static_cast<int64_t>(blockIdx.y) * T;  // (b, t = 0)

  float a[DS], h[DS];
#pragma unroll
  for (int s = 0; s < DS; ++s) {
    a[s] = (live && s < ds) ? a_mat[static_cast<int64_t>(d) * ds + s] : 0.f;
    h[s] = 0.f;
  }
  const float dd = live ? d_vec[d] : 0.f;

  for (int t0 = 0; t0 < T; t0 += kTC) {
    const int n = min(kTC, T - t0);
    __syncthreads();  // the previous chunk's reads of the buffers are done
#pragma unroll 8
    for (int j = 0; j < n; ++j) {
      const int64_t off = (row0 + t0 + j) * di + d;
      xs[j][tid] = live ? to_f32(x[off]) : 0.f;
      dts[j][tid] = live ? dt[off] : 0.f;
    }
    for (int i = tid; i < n * DS; i += kThreads) {
      const int j = i / DS, s = i % DS;
      float bv = 0.f, cv = 0.f;
      if (s < ds) {
        const int64_t off = (row0 + t0 + j) * ds + s;
        bv = bc[off];
        cv = cc[off];
      }
      bs[j][s] = bv;
      cs[j][s] = cv;
    }
    __syncthreads();
    if (!live) continue;
    for (int j = 0; j < n; ++j) {
      const float xv = xs[j][tid];
      const float dv = dts[j][tid];
      const float dx = dv * xv;
      float acc = 0.f;
#pragma unroll
      for (int s = 0; s < DS; ++s) {
        const float da = expf(dv * a[s]);
        h[s] = da * h[s] + dx * bs[j][s];
        acc += h[s] * cs[j][s];
      }
      y[(row0 + t0 + j) * di + d] = from_f32<E>(acc + xv * dd);
    }
  }
}

template <typename E, int DS>
cudaError_t launch_ds(const void* x, const void* dt, const void* bc,
                      const void* cc, const void* a, const void* d, void* y,
                      int B, int T, int di, int ds, cudaStream_t stream) {
  const dim3 grid((di + kThreads - 1) / kThreads, B);
  mamba_scan_kernel<E, DS><<<grid, kThreads, 0, stream>>>(
      static_cast<const E*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(bc), static_cast<const float*>(cc),
      static_cast<const float*>(a), static_cast<const float*>(d),
      static_cast<E*>(y), T, di, ds);
  return cudaGetLastError();
}

template <typename E>
cudaError_t launch(const void* x, const void* dt, const void* bc,
                   const void* cc, const void* a, const void* d, void* y,
                   int B, int T, int di, int ds, cudaStream_t stream) {
  if (ds <= 2)
    return launch_ds<E, 2>(x, dt, bc, cc, a, d, y, B, T, di, ds, stream);
  if (ds <= 4)
    return launch_ds<E, 4>(x, dt, bc, cc, a, d, y, B, T, di, ds, stream);
  if (ds <= 8)
    return launch_ds<E, 8>(x, dt, bc, cc, a, d, y, B, T, di, ds, stream);
  return launch_ds<E, 16>(x, dt, bc, cc, a, d, y, B, T, di, ds, stream);
}

}  // namespace

// Launches on `stream`; returns the cudaError_t of the launch (0 = success).
// x, y (B, T, di) contiguous, of the element type `dtype` (0 = float32,
// 1 = bfloat16); dt (B, T, di), bc and cc (B, T, ds), a (di, ds) and d (di,)
// contiguous float32.
extern "C" int mamba_scan_launch(const void* x, const void* dt,
                                 const void* bc, const void* cc,
                                 const void* a, const void* d, void* y,
                                 int B, int T, int di, int ds, int dtype,
                                 void* stream) {
  if (B < 0 || T < 0 || di < 0 || ds < 1 || ds > kMaxDs || B > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0 || T == 0 || di == 0) return 0;
  const auto s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case repro_torch::kFloat32:
      return static_cast<int>(
          launch<float>(x, dt, bc, cc, a, d, y, B, T, di, ds, s));
    case repro_torch::kBFloat16:
      return static_cast<int>(
          launch<__nv_bfloat16>(x, dt, bc, cc, a, d, y, B, T, di, ds, s));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" const char* mamba_scan_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
