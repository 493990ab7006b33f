// Column-condensed SpMM on Hopper:
//   Y[i*B + r] = sum_{s < C} tiles[i, r, s] X[gather_idx[i, s]] (+ Y_in).
//
// Replaces the Pallas TPU kernel repro/kernels/tcgnn_tile.py (tcgnn_spmm,
// _mv_kernel / _mv_kernel_acc): the TC-GNN-style format packs each block
// row's distinct source columns into a dense (B, C) tile and records them
// in gather_idx.  On the TPU, XLA gathers x[gather_idx] into an (nbr, C, F)
// stripe before the kernel (the per-column gather cannot be a BlockSpec),
// and the kernel contracts tiles @ stripe.  Here the kernel gathers the
// rows itself, so the stripe is never written to device memory.  The
// backward pass dX = A^T dY is this kernel over the transpose payload.
//
// Bound.  At pubmed's inter tier (nbr = 1233, B = 16, C = 128, F = 16)
// the function reads 10.1 MB of tiles, 0.6 MB of gather_idx and X's rows,
// and writes Y: about 13.3 MB, so it is bound by bytes (0.004 ms at
// 3.35 TB/s); 2 nnz F = 2.8 MFLOP is nothing.  The tiles are three
// quarters of the bytes and must be read whole: that is how the real slots
// are known.  What a kernel loses on top is latency: a block row's tile,
// then its real slots' rows of X, then the products, one after another.
//
// What the first design lost (0.0246 ms at F = 16, 0.0204 at F = 3 on an
// H100 at 700 W).  A CTA of 256 threads took one block row: it staged the
// 8 KB tile and gathered all 128 slots' rows of X, padding included, waited,
// then each thread ran one accumulator through a dependent chain of 128 FMAs
// out of shared memory.  Nothing overlapped inside a CTA, 1233 such CTAs
// made 1.17 waves, and at F = 3 only 48 of the 256 threads held an output.
//
// Design.  A warp owns a block row (and a tile of at most 32 columns of F);
// a CTA of 4 warps shares nothing but the launch, so pubmed's 1233 rows are
// 1233 warps, all resident at once: every tile is requested in the first
// microsecond.  A warp (row kernel)
//  1. brings its row's (B, C) tile into shared memory with one bulk copy
//     (TMA) a tile row, at a pitch of C + 4 floats so the 8 rows an MMA
//     fragment reads sit in distinct banks, and the row's gather indices
//     with one more, on one mbarrier: no per-thread copy instructions;
//  2. counts the real slots from the staged tile (tcgnn_real.cuh: a slot
//     past the last tile column with a non-zero adds nothing; pubmed's rows
//     hold 64.4 of 128 on average), one float4 column group a lane;
//  3. loads the B fragments of only those slots' rows of X (the slice
//     [f0, f0 + 32) of F) straight from device memory into registers, 64
//     slots (8 k-steps) at a time, all in flight at once;
//  4. multiplies on the tensor cores: tiles (B rows x 8 slots) times X (8
//     slots x 8 columns) per mma.sync m16n8k8, float32 split into TF32
//     high and low parts (mma_tf32.cuh, three MMAs a product; a bfloat16 X
//     is exact in TF32, two), accumulated in registers in a fixed order (the
//     same bits every run);
//  5. writes Y, seeded from Y_in in accumulate mode (read at the start).
// A tile that does not fit a warp's share of shared memory (C > 128, C not
// a multiple of 4, or B large) takes the chunk kernel: the real slots are
// counted from device memory, then staged in chunks with cp.async.
// Skipping an all-zero slot changes the result only where its gathered row
// of X holds an infinity or a NaN (0 * inf is NaN in the plain version).
//
// Measured (H100 80GB HBM3, 700 W, tools/port_kernels_bench.py): 0.010 to
// 0.012 ms at F = 16 and F = 3, over tc and tc_t alike, 2.8 to 3.1 times
// the bound, against 0.020 to 0.025 ms for the first design.  Phase
// timestamps taken while tuning showed most of it is the 10 MB of tiles
// landing, every warp's at nearly the same time, after which the rows are
// counted, gathered and multiplied together, with nothing left to overlap.
// Three variants were slower: the rows of X gathered into shared memory
// with cp.async, a persistent CTA an SM feeding its rows in order through
// an mbarrier ring, and the gather issued from the indices before the tile
// lands.
//
// Limits.  B <= 64, any C >= 1 and F >= 1, float32 or bfloat16 X; a warp's
// share of shared memory (the tile or a chunk of it, and the indices) stays
// within 24 KB: 8.8 KB at B = 16, C = 128.
#include <cstdint>
#include <type_traits>

#include "cp_async.cuh"
#include "dtype.cuh"
#include "mma_tf32.cuh"
#include "tcgnn_real.cuh"

namespace {

using repro_torch::align16;
using repro_torch::bulk_copy;
using repro_torch::copy_rows;
using repro_torch::cp_commit;
using repro_torch::cp_wait;
using repro_torch::from_f32;
using repro_torch::mbar_expect_tx;
using repro_torch::mbar_init;
using repro_torch::mbar_wait;
using repro_torch::mma_3xtf32;
using repro_torch::mma_tf32;
using repro_torch::real_slots_part;
using repro_torch::split_tf32;
using repro_torch::staged_real_slots;
using repro_torch::to_f32;

constexpr int kFT = 32;                     // F columns a CTA
constexpr int kGS = 64;                     // slots a gather round
constexpr int kMaxOne = 128;                // a whole tile in a warp's share
constexpr int kWarps = 4;                   // block rows a CTA, one a warp
constexpr int kWarpSmem = 24 * 1024;        // a warp's share, at most

template <typename T>
struct Args {
  const float* tiles;
  const int* gather_idx;
  const T* x;
  const T* y_in;   // optional
  T* y;
  int nbr, B, C, F;
};

struct Cfg {
  int cs;          // slots a staged tile or chunk, a multiple of 8
  int tp;          // row pitch of the staged tile in floats: cs + 4
  int gt, gi;      // cp.async granules of the tile and the indices
  int t_bytes;     // a staged tile
  int slot_bytes;  // a warp's share: a staged tile and its indices
};

// The accumulator fragments of a warp's block row (acc[m][n]: rows 16 m + g
// (+ 8), columns 8 n + 2 tq (+ 1) of the F tile at f0), seeded from Y_in.
template <typename T, int kMT, int kNT>
__device__ __forceinline__ void seed(float (&acc)[kMT][kNT][4],
                                     const Args<T>& p, int row, int f0,
                                     int fw, int g, int tq) {
#pragma unroll
  for (int m = 0; m < kMT; ++m)
#pragma unroll
    for (int n = 0; n < kNT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = 16 * m + g + (e >> 1) * 8;
        const int col = 8 * n + 2 * tq + (e & 1);
        acc[m][n][e] =
            p.y_in != nullptr && r < p.B && col < fw
                ? to_f32(p.y_in[(static_cast<size_t>(row) * p.B + r) * p.F +
                                f0 + col])
                : 0.f;
      }
}

template <typename T, int kMT, int kNT>
__device__ __forceinline__ void store(const float (&acc)[kMT][kNT][4],
                                      const Args<T>& p, int row, int f0,
                                      int fw, int g, int tq) {
#pragma unroll
  for (int m = 0; m < kMT; ++m)
#pragma unroll
    for (int n = 0; n < kNT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = 16 * m + g + (e >> 1) * 8;
        const int col = 8 * n + 2 * tq + (e & 1);
        if (r < p.B && col < fw)
          p.y[(static_cast<size_t>(row) * p.B + r) * p.F + f0 + col] =
              from_f32<T>(acc[m][n][e]);
      }
}

// acc += tile[:, 0 .. cw) X[gather_idx[0 .. cw)] for the cw real slots of a
// staged tile or chunk t_s (B rows of pitch tp, zeros past cw up to the
// next 8) and their indices g_s.  64 slots a round: the B fragments of the
// round's 8 k-steps, X[g_s[s]][f0 + 8 n + g] for slots s = 8 ks + tq (+ 4),
// are loaded straight from device memory (L2) all at once, zeros past cw
// and F; then per k-step the A fragment (tile rows x 8 slots) and the MMAs.
template <typename T, int kMT, int kNT>
__device__ __forceinline__ void multiply(float (&acc)[kMT][kNT][4],
                                         const Args<T>& p, const float* t_s,
                                         int tp, const int* g_s, int cw,
                                         int f0, int fw, int g, int tq) {
  const int B = p.B;
  for (int s0 = 0; s0 < cw; s0 += kGS) {
    const int nk = (min(kGS, cw - s0) + 7) >> 3;
    float bv[kGS / 8][kNT][2];
#pragma unroll
    for (int ks = 0; ks < kGS / 8; ++ks)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int sl = s0 + 8 * ks + tq + 4 * h;
        const T* xr = sl < cw ? p.x + static_cast<size_t>(g_s[sl]) * p.F + f0
                              : nullptr;
#pragma unroll
        for (int n = 0; n < kNT; ++n) {
          const int col = 8 * n + g;
          bv[ks][n][h] =
              xr != nullptr && col < fw ? to_f32(__ldg(xr + col)) : 0.f;
        }
      }
#pragma unroll
    for (int ks = 0; ks < kGS / 8; ++ks) {
      if (ks >= nk) break;
      uint32_t ah[kMT][4], al[kMT][4];
#pragma unroll
      for (int m = 0; m < kMT; ++m) {
        const int r = 16 * m + g;
        const float* ta = t_s + r * tp + s0 + 8 * ks + tq;
        split_tf32(r < B ? ta[0] : 0.f, ah[m][0], al[m][0]);
        split_tf32(r + 8 < B ? ta[8 * tp] : 0.f, ah[m][1], al[m][1]);
        split_tf32(r < B ? ta[4] : 0.f, ah[m][2], al[m][2]);
        split_tf32(r + 8 < B ? ta[8 * tp + 4] : 0.f, ah[m][3], al[m][3]);
      }
#pragma unroll
      for (int n = 0; n < kNT; ++n) {
        if constexpr (sizeof(T) == 4) {
          uint32_t b0h, b0l, b1h, b1l;
          split_tf32(bv[ks][n][0], b0h, b0l);
          split_tf32(bv[ks][n][1], b1h, b1l);
#pragma unroll
          for (int m = 0; m < kMT; ++m)
            mma_3xtf32(acc[m][n], ah[m], al[m], b0h, b1h, b0l, b1l);
        } else {   // bfloat16 X is exact in TF32
          const uint32_t b0 = __float_as_uint(bv[ks][n][0]);
          const uint32_t b1 = __float_as_uint(bv[ks][n][1]);
#pragma unroll
          for (int m = 0; m < kMT; ++m) {
            mma_tf32(acc[m][n], al[m], b0, b1);
            mma_tf32(acc[m][n], ah[m], b0, b1);
          }
        }
      }
    }
  }
}

// Row kernel (a whole tile in a warp's share: C <= 128, C % 4 == 0,
// aligned).  A warp a block row, all rows' tiles requested at once: one
// bulk copy a tile row and one for the gather indices, on one mbarrier.
template <typename T, int kMT, int kNT>
__global__ void __launch_bounds__(32 * kWarps)
    tcgnn_spmm_row_kernel(const Args<T> p, const Cfg c) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ uint64_t bars[kWarps];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tq = lane & 3;
  const int row = blockIdx.x * kWarps + warp;   // this warp's block row
  if (row >= p.nbr) return;                     // only warp barriers follow
  const int B = p.B, C = p.C;
  const int f0 = blockIdx.y * kFT;
  const int fw = min(kFT, p.F - f0);
  auto* t_s = reinterpret_cast<float*>(smem + warp * c.slot_bytes);
  auto* g_s = reinterpret_cast<int*>(smem + warp * c.slot_bytes + c.t_bytes);
  uint64_t* bar = &bars[warp];
  if (lane == 0) {
    mbar_init(bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    mbar_expect_tx(bar, (B + 1) * C * 4);
  }
  __syncwarp();
  for (int r = lane; r <= B; r += 32) {
    if (r < B)
      bulk_copy(t_s + r * c.tp,
                p.tiles + (static_cast<size_t>(row) * B + r) * C, C * 4, bar);
    else
      bulk_copy(g_s, p.gather_idx + static_cast<size_t>(row) * C, C * 4,
                bar);
  }
  // the columns past C up to the next multiple of 8 read as zeros
  if (C % 8 != 0)
    for (int r = lane; r < B; r += 32)
      *reinterpret_cast<float4*>(t_s + r * c.tp + C) =
          make_float4(0.f, 0.f, 0.f, 0.f);

  float acc[kMT][kNT][4];
  seed(acc, p, row, f0, fw, g, tq);
  mbar_wait(bar, 0);
  __syncwarp();
  const int n_real = staged_real_slots(t_s, B, c.tp, C >> 2, lane);
  multiply(acc, p, t_s, c.tp, g_s, n_real, f0, fw, g, tq);
  store(acc, p, row, f0, fw, g, tq);
}

// Chunk kernel (every other tile): a warp a block row; the real slots are
// counted from device memory, then staged in chunks of cs slots with
// cp.async.
template <typename T, int kMT, int kNT>
__global__ void __launch_bounds__(32 * kWarps)
    tcgnn_spmm_chunk_kernel(const Args<T> p, const Cfg c) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tq = lane & 3;
  const int row = blockIdx.x * kWarps + warp;   // this warp's block row
  if (row >= p.nbr) return;                     // only warp barriers follow
  const int B = p.B, C = p.C;
  const int f0 = blockIdx.y * kFT;
  const int fw = min(kFT, p.F - f0);
  auto* t_s = reinterpret_cast<float*>(smem + warp * c.slot_bytes);
  auto* g_s = reinterpret_cast<int*>(smem + warp * c.slot_bytes + c.t_bytes);
  const float* t_row = p.tiles + static_cast<size_t>(row) * B * C;
  const int* g_row = p.gather_idx + static_cast<size_t>(row) * C;

  float acc[kMT][kNT][4];
  seed(acc, p, row, f0, fw, g, tq);
  const bool vec = C % 4 == 0 && c.gt == 16;
  const int n_real = __reduce_max_sync(
      0xffffffffu, real_slots_part(t_row, B, C, vec, lane, 32));
  for (int c0 = 0; c0 < n_real; c0 += c.cs) {
    const int cw = min(c.cs, n_real - c0);
    const int t_gpr = c.tp * 4 / c.gt;
    copy_rows(t_s, c.tp, t_row + c0, C, cw, B, t_gpr,
              1.f / static_cast<float>(t_gpr), c.gt, lane, 32);
    const int i_gpr = c.cs * 4 / c.gi;
    copy_rows(g_s, c.cs, g_row + c0, C, cw, 1, i_gpr,
              1.f / static_cast<float>(i_gpr), c.gi, lane, 32);
    cp_commit();
    cp_wait<0>();
    __syncwarp();
    multiply(acc, p, t_s, c.tp, g_s, cw, f0, fw, g, tq);
    __syncwarp();   // the next chunk overwrites the staged slots
  }
  store(acc, p, row, f0, fw, g, tq);
}

template <typename K>
cudaError_t set_smem(K* kernel, int bytes) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributePreferredSharedMemoryCarveout,
                              cudaSharedmemCarveoutMaxShared);
}

template <typename T, int kMT, int kNT>
cudaError_t launch_shape(const Args<T>& p, Cfg c, cudaStream_t stream) {
  const bool aligned =
      p.C % 4 == 0 && reinterpret_cast<uintptr_t>(p.tiles) % 16 == 0 &&
      reinterpret_cast<uintptr_t>(p.gather_idx) % 16 == 0;
  c.gt = aligned ? 16 : 4;
  c.gi = aligned ? 16 : 4;
  // a warp's share: the whole tile where it fits (row kernel), else the
  // most slots (a multiple of 8) that fit (chunk kernel)
  auto bytes = [&](int cs) {
    return align16(p.B * (cs + 4) * 4) + align16(cs * 4);
  };
  const int c8 = (p.C + 7) & ~7;
  const bool one = aligned && p.C <= kMaxOne && bytes(c8) <= kWarpSmem;
  int cs = c8 < kMaxOne ? c8 : kMaxOne;
  while (cs > 8 && bytes(cs) > kWarpSmem) cs -= 8;
  c.cs = cs;
  c.tp = cs + 4;
  c.t_bytes = align16(p.B * c.tp * 4);
  c.slot_bytes = bytes(cs);
  const int smem = kWarps * c.slot_bytes;
  auto kernel = one ? tcgnn_spmm_row_kernel<T, kMT, kNT>
                    : tcgnn_spmm_chunk_kernel<T, kMT, kNT>;
  const cudaError_t err = set_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.nbr + kWarps - 1) / kWarps, (p.F + kFT - 1) / kFT);
  kernel<<<grid, 32 * kWarps, smem, stream>>>(p, c);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const Args<T>& p, cudaStream_t stream) {
  const int fw = p.F < kFT ? p.F : kFT;
  const int nt = fw <= 8 ? 1 : fw <= 16 ? 2 : 4;
  const int mt = p.B <= 16 ? 1 : p.B <= 32 ? 2 : 4;
  const Cfg c{};
  auto by_nt = [&](auto mtc) -> cudaError_t {
    constexpr int M = decltype(mtc)::value;
    return nt == 1   ? launch_shape<T, M, 1>(p, c, stream)
           : nt == 2 ? launch_shape<T, M, 2>(p, c, stream)
                     : launch_shape<T, M, 4>(p, c, stream);
  };
  return mt == 1   ? by_nt(std::integral_constant<int, 1>{})
         : mt == 2 ? by_nt(std::integral_constant<int, 2>{})
                   : by_nt(std::integral_constant<int, 4>{});
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
    case repro_torch::kFloat32: {
      using T = float;
      const Args<T> p{t, gi, static_cast<const T*>(x),
                      static_cast<const T*>(y_in), static_cast<T*>(y), nbr,
                      B, C, F};
      return static_cast<int>(launch(p, s));
    }
    case repro_torch::kBFloat16: {
      using T = __nv_bfloat16;
      const Args<T> p{t, gi, static_cast<const T*>(x),
                      static_cast<const T*>(y_in), static_cast<T*>(y), nbr,
                      B, C, F};
      return static_cast<int>(launch(p, s));
    }
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" const char* tcgnn_spmm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
