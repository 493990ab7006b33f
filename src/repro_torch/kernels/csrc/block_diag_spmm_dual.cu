// Dual-weight block-diagonal transform+aggregate on Hopper (SAGE's epilogue):
//   Y_b = A_b (X_b W) + X_b W_self (+ Y_in_b)   for every diagonal block b.
//
// Replaces the Pallas TPU kernel repro/kernels/block_diag_spmm_fused.py
// (block_diag_spmm_dual, _kernel_dual / _kernel_dual_acc).  As on the TPU,
// the diagonal tier's row block is its own source block, so both transforms
// come from one on-chip copy of the block's rows of X: H = X_b W stays on
// chip, and the self term S = X_b W_self is added straight into the output
// tile.  Neither H nor S reaches device memory.
//
// Design.  The TPU grid is (block, Fo tile) with a whole (B, Fi) row block
// and both (Fi, Ft) stripes in VMEM.  Here one CTA takes 32 rows (32 / B
// consecutive diagonal blocks, or one block when B > 32) and one Fo tile of
// at most 64 columns, and walks Fi in chunks of kc (a multiple of 4)
// columns: it stages the rows' (R, kc) slice of X and both weights' (kc, ft)
// slices, transposed, as float32 in shared memory.  Each thread owns one
// output column c and kRows rows (rg, rg + RG, ...), and keeps their H and S
// sums in registers: per 4 columns of the chunk it reads W's and W_self's
// 4 values of column c as one float4 each and each row's 4 values of X as
// one float4 (a broadcast within the warp), then does 8 kRows FMAs.  After
// the last chunk H goes to shared memory beside the staged diagonal blocks,
// and each thread adds A_b H to its S sums (+ Y_in) and writes Y once.
// Staging several blocks per CTA shares each weight chunk among them; the
// chunk's tail is zero-filled to a multiple of 4 columns.  The staging loops
// walk their tiles with incremented (row, column) pairs, not a division per
// element, and read X 4 elements at a time (one 16- or 8-byte load where
// Fi % 4 == 0 and x is aligned): a first version that divided per element
// spent more instructions on staging than on the FMAs.  Each thread fetches
// the next chunk's elements into registers before it computes on the
// current one, so the loads' latency hides behind the FMAs.
//
// Bound.  The function reads X, both weights and the blocks once and writes
// Y once, and does 4 n Fi Fo + 2 nb B B Fo flops.  At the main path's first
// SAGE layer (n = 19728, B = 16, Fi = 500, Fo = 16) that is about 42 MB and
// 0.64 GFLOP: 12.6 us of HBM against 9.6 us of float32 FMA, so bytes bound it
// by a small margin and the FMA rate is close behind.  The design keeps both
// in view: X is read once from device memory, and at kRows = 4 a thread
// issues 6 shared-memory loads (float4) per 32 FMAs.  Tensor cores (a
// float32 answer within 1e-4 rules out TF32) and a TMA pipeline for the X
// chunks come later.
//
// Limits.  B <= 64, any Fi >= 1 and Fo >= 1; shared memory stays within
// 40 KB, so no opt-in above the 48 KB default is needed.
#include <cstdint>

#include "dtype.cuh"

namespace {

using repro_torch::from_f32;
using repro_torch::to_f32;

constexpr int kMaxThreads = 256;
constexpr int kMaxFt = 64;
constexpr int kRowsPerCta = 32;
constexpr int kMaxChunk = 64;                 // Fi columns per chunk
constexpr int kSmemFloats = 40 * 1024 / 4;    // 40 KB of float32
// fetch registers per thread: at pubmed's widths they cap the chunk at 32
// Fi columns and keep the main path's variant near 80 registers, so 6 CTAs
// of 128 threads fit on an SM
constexpr int kXPer = 2;    // X float4s a thread fetches per chunk, at most
constexpr int kWPer = 4;    // (W, W_self) pairs a thread fetches per chunk

// 4 consecutive elements of T from global memory as float32: one aligned
// vector load when `vec`, else `valid` scalar loads and zeros after them.
template <typename T>
__device__ __forceinline__ float4 load4(const T* p, int valid, bool vec);
template <>
__device__ __forceinline__ float4 load4<float>(const float* p, int valid,
                                               bool vec) {
  if (vec) return __ldg(reinterpret_cast<const float4*>(p));
  return make_float4(valid > 0 ? p[0] : 0.f, valid > 1 ? p[1] : 0.f,
                     valid > 2 ? p[2] : 0.f, valid > 3 ? p[3] : 0.f);
}
template <>
__device__ __forceinline__ float4 load4<__nv_bfloat16>(
    const __nv_bfloat16* p, int valid, bool vec) {
  if (vec) {
    const uint2 v = __ldg(reinterpret_cast<const uint2*>(p));
    const float2 a =
        __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v.x));
    const float2 b =
        __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v.y));
    return make_float4(a.x, a.y, b.x, b.y);
  }
  return make_float4(valid > 0 ? to_f32(p[0]) : 0.f,
                     valid > 1 ? to_f32(p[1]) : 0.f,
                     valid > 2 ? to_f32(p[2]) : 0.f,
                     valid > 3 ? to_f32(p[3]) : 0.f);
}

// kRows: rows per thread.  blockDim.x = ft * RG with RG * kRows >= the CTA's
// rows; a thread's rows are rg, rg + RG, ..., its column c = t % ft.
template <typename T, int kRows>
__global__ void __launch_bounds__(kMaxThreads)
    dual_kernel(const T* __restrict__ blocks, const T* __restrict__ x,
                const T* __restrict__ w, const T* __restrict__ ws,
                const T* __restrict__ y_in, T* __restrict__ y, int nb, int B,
                int Fi, int Fo, int ft, int kc, int bpc, int RG, int vec) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int xs = kc + 4;             // row stride, a multiple of 4
  const int as = B + 1;              // padded row stride of the blocks
  const int rcap = RG * kRows;
  float* x_s = smem;                 // (rcap, xs)
  float* w_s = x_s + rcap * xs;      // (ft, xs): W's chunk, transposed
  float* s_s = w_s + ft * xs;        // (ft, xs): W_self's chunk, transposed
  float* a_s = s_s + ft * xs;        // (bpc * B, B + 1)
  float* h_s = a_s + bpc * B * as;   // (bpc * B, ft)

  const int b0 = blockIdx.x * bpc;
  const int nbl = min(bpc, nb - b0);
  const int R = nbl * B;             // this CTA's rows
  const size_t row0 = static_cast<size_t>(b0) * B;
  const int f0 = blockIdx.y * ft;
  const int fw = min(ft, Fo - f0);
  const int t = threadIdx.x;
  const int nt = blockDim.x;
  const int c = t % ft;
  const int rg = t / ft;
  const int BB = B * B;

  for (int e = t; e < nbl * BB; e += nt) {
    const int blk = e / BB;
    const int rem = e - blk * BB;
    const int i = rem / B;
    a_s[(blk * B + i) * as + (rem - i * B)] =
        to_f32(blocks[static_cast<size_t>(b0) * BB + e]);
  }

  float h[kRows], s[kRows];
#pragma unroll
  for (int q = 0; q < kRows; ++q) h[q] = s[q] = 0.f;

  // Each chunk's X and weight elements are fetched into registers one
  // chunk ahead (the launcher bounds them to kXPer float4s and kWPer weight
  // pairs per thread), so their device-memory latency overlaps the FMAs of
  // the chunk before.  Both walks step (row, column) pairs by increments.
  float4 xa[kXPer];
  float wa[kWPer], sa[kWPer];
  const int wdj = nt / fw;
  const int wdc = nt - wdj * fw;
  auto fetch = [&](int c0) {
    const int cw = min(kc, Fi - c0);
    const int Q = (cw + 3) >> 2;       // float4 columns of the chunk
    const int dr = nt / Q;
    const int dq = nt - dr * Q;
    int r = t / Q;
    int q = t - r * Q;
#pragma unroll
    for (int k = 0; k < kXPer; ++k) {
      xa[k] = r < R ? load4(x + (row0 + r) * Fi + c0 + 4 * q, cw - 4 * q,
                            vec != 0)
                    : make_float4(0.f, 0.f, 0.f, 0.f);
      q += dq;
      r += dr;
      if (q >= Q) {
        q -= Q;
        ++r;
      }
    }
    int j = t / fw;
    int cc = t - j * fw;
#pragma unroll
    for (int k = 0; k < kWPer; ++k) {
      const bool in = j < cw;
      const size_t g = static_cast<size_t>(c0 + j) * Fo + f0 + cc;
      wa[k] = in ? to_f32(w[g]) : 0.f;
      sa[k] = in ? to_f32(ws[g]) : 0.f;
      cc += wdc;
      j += wdj;
      if (cc >= fw) {
        cc -= fw;
        ++j;
      }
    }
  };
  auto store = [&](int c0) {
    const int Q = (min(kc, Fi - c0) + 3) >> 2;
    const int dr = nt / Q;
    const int dq = nt - dr * Q;
    int r = t / Q;
    int q = t - r * Q;
#pragma unroll
    for (int k = 0; k < kXPer; ++k) {
      if (r < R) *reinterpret_cast<float4*>(x_s + r * xs + 4 * q) = xa[k];
      q += dq;
      r += dr;
      if (q >= Q) {
        q -= Q;
        ++r;
      }
    }
    int j = t / fw;
    int cc = t - j * fw;
#pragma unroll
    for (int k = 0; k < kWPer; ++k) {
      if (j < 4 * Q) {                 // zeros past the chunk's width
        w_s[cc * xs + j] = wa[k];
        s_s[cc * xs + j] = sa[k];
      }
      cc += wdc;
      j += wdj;
      if (cc >= fw) {
        cc -= fw;
        ++j;
      }
    }
  };

  fetch(0);
  for (int c0 = 0; c0 < Fi; c0 += kc) {
    const int cw4 = (min(kc, Fi - c0) + 3) & ~3;
    store(c0);
    __syncthreads();
    if (c0 + kc < Fi) fetch(c0 + kc);
    if (c < fw) {
      const float* wr = w_s + c * xs;
      const float* sr = s_s + c * xs;
      for (int j = 0; j < cw4; j += 4) {
        const float4 wv = *reinterpret_cast<const float4*>(wr + j);
        const float4 sv = *reinterpret_cast<const float4*>(sr + j);
#pragma unroll
        for (int q = 0; q < kRows; ++q) {
          // rows past the CTA's R read stale values; their sums are dropped
          const float4 xv = *reinterpret_cast<const float4*>(
              x_s + (rg + q * RG) * xs + j);
          h[q] = fmaf(xv.x, wv.x, h[q]);
          s[q] = fmaf(xv.x, sv.x, s[q]);
          h[q] = fmaf(xv.y, wv.y, h[q]);
          s[q] = fmaf(xv.y, sv.y, s[q]);
          h[q] = fmaf(xv.z, wv.z, h[q]);
          s[q] = fmaf(xv.z, sv.z, s[q]);
          h[q] = fmaf(xv.w, wv.w, h[q]);
          s[q] = fmaf(xv.w, sv.w, s[q]);
        }
      }
    }
    __syncthreads();
  }

  if (c < fw) {
#pragma unroll
    for (int q = 0; q < kRows; ++q) {
      const int r = rg + q * RG;
      if (r < R) h_s[r * ft + c] = h[q];
    }
  }
  __syncthreads();
  if (c < fw) {
#pragma unroll
    for (int q = 0; q < kRows; ++q) {
      const int r = rg + q * RG;
      if (r < R) {
        const float* ar = a_s + r * as;
        const float* hb = h_s + (r / B) * B * ft + c;
        float acc = s[q];
        for (int j = 0; j < B; ++j) acc = fmaf(ar[j], hb[j * ft], acc);
        const size_t o = (row0 + r) * Fo + f0 + c;
        if (y_in != nullptr) acc += to_f32(y_in[o]);
        y[o] = from_f32<T>(acc);
      }
    }
  }
}

template <typename T>
cudaError_t launch(const void* blocks, const void* x, const void* w,
                   const void* ws, const void* y_in, void* y, int nb, int B,
                   int Fi, int Fo, cudaStream_t stream) {
  // X's chunks start 4-element aligned when Fi % 4 == 0 and x is aligned
  const int vec = Fi % 4 == 0 &&
                  reinterpret_cast<uintptr_t>(x) % (4 * sizeof(T)) == 0;
  const int ft = Fo < kMaxFt ? Fo : kMaxFt;
  const int bpc = B < kRowsPerCta ? kRowsPerCta / B : 1;
  const int rows = bpc * B;
  int kr = 4;                        // rows per thread: 4, 8 or 16
  while (kr < 16 && ft * ((rows + kr - 1) / kr) > kMaxThreads) kr *= 2;
  const int RG = (rows + kr - 1) / kr;
  const int rcap = RG * kr;
  const int fixed = rows * (B + 1) + rows * ft;
  int kc = (kSmemFloats - fixed) / (rcap + 2 * ft) - 4;
  if (kc > kMaxChunk) kc = kMaxChunk;
  const int fi4 = (Fi + 3) & ~3;
  if (kc > fi4) kc = fi4;
  const int nt = ft * RG;
  if (kc > kXPer * 4 * nt / rows) kc = kXPer * 4 * nt / rows;
  if (kc > kWPer * RG) kc = kWPer * RG;
  kc &= ~3;
  if (kc < 4) kc = 4;
  // every staged element needs a fetch slot of some thread
  if (rows * (kc / 4) > kXPer * nt || kc * ft > kWPer * nt)
    return cudaErrorInvalidConfiguration;
  const size_t smem =
      (static_cast<size_t>(rcap + 2 * ft) * (kc + 4) + fixed) * sizeof(float);
  const dim3 grid((nb + bpc - 1) / bpc, (Fo + ft - 1) / ft);
  auto kernel = kr == 4   ? dual_kernel<T, 4>
                : kr == 8 ? dual_kernel<T, 8>
                          : dual_kernel<T, 16>;
  kernel<<<grid, nt, smem, stream>>>(
      static_cast<const T*>(blocks), static_cast<const T*>(x),
      static_cast<const T*>(w), static_cast<const T*>(ws),
      static_cast<const T*>(y_in), static_cast<T*>(y), nb, B, Fi, Fo, ft, kc,
      bpc, RG, vec);
  return cudaGetLastError();
}

}  // namespace

// Launches on `stream`; returns the cudaError_t of the launch (0 = success).
// blocks (nb, B, B), x (nb*B, Fi), w and w_self (Fi, Fo), y and y_in
// (nb*B, Fo) with y_in optional (null); all contiguous, of the element type
// `dtype` (0 = float32, 1 = bfloat16).
extern "C" int block_diag_spmm_dual_launch(const void* blocks, const void* x,
                                           const void* w, const void* w_self,
                                           const void* y_in, void* y, int nb,
                                           int B, int Fi, int Fo, int dtype,
                                           void* stream) {
  if (nb <= 0 || Fo <= 0) return 0;
  if (B < 1 || B > 64 || Fi < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case repro_torch::kFloat32:
      return static_cast<int>(
          launch<float>(blocks, x, w, w_self, y_in, y, nb, B, Fi, Fo, s));
    case repro_torch::kBFloat16:
      return static_cast<int>(launch<__nv_bfloat16>(blocks, x, w, w_self,
                                                    y_in, y, nb, B, Fi, Fo, s));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" const char* block_diag_spmm_dual_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
