// Blocked-ELL SpMM on Hopper:
//   Y[i] = sum_{k < K_i} blocks[i, k] X[col_idx[i, k]] (+ Y_in[i]).
//
// Replaces the Pallas TPU kernel repro/kernels/bell_spmm.py (bell_spmm,
// _kernel / _kernel_acc): the inter-community tier of the AdaptGear
// decomposition, a CSR over (B, B) blocks padded to K blocks per block row.
//
// Design.  On the TPU the grid walks (block row, feature tile, k) in order
// and carries the sum in VMEM scratch from one k step to the next.  Here one
// CTA of 256 threads owns a block row and a feature tile (the whole of F
// where B * F allows, so at the main path's F = 16 and F = 3), and its eight
// warps split the row's stored blocks: warp w takes the slots k = w (mod 8).
// Each warp streams its blocks through its own 3-stage cp.async ring: a
// stage holds one (B, B) block and the (B, ft) slice of X that it names,
// copied a row at a time in the largest granule the pitch and base allow
// (16 bytes at B = 16 and F = 16, 4 at F = 3).  The warp's block columns
// come in one load of 32 (lane l holds its slot l's), read by shuffle as the
// copies are issued; the first two blocks are copied at once, before that
// load and the row's count of real blocks arrive, so only their X slices
// wait on an index.  A lane keeps a 2-row x 4-column piece of the warp's
// (B, ft) partial in registers and reads the block and X as 16-byte
// vectors: 6 vector loads feed 32 FMAs.  Where the row has fewer pieces than
// lanes (F = 3: 8 pieces) the lanes of a piece split the block's inner index
// and add their shares by shuffle at the end.  The eight partials are then
// summed in shared memory in warp order, Y_in first: every sum is taken in a
// fixed order, so the result is the same bits on every run.  Staged rows
// past B and X columns past those copied are cleared once (none at B = 16,
// F = 16), so the padded inner index adds nothing.  float32 products are
// float32 FMAs on the CUDA cores (TF32 would break the float32 gate);
// bfloat16 is copied as it is and widened as it is read from shared memory.
//
// The loop stops at n_valid[i] when the payload's count of real blocks is
// given: padding slots are all-zero blocks by the format's contract, so
// skipping them changes no sum and saves their bytes.  With n_valid null
// all K slots run, as on the TPU.
//
// Bound.  Each stored block is read once and each X slice it names is
// gathered once per block, mostly from L2 (X is 1.3 MB at the main path's
// F = 16).  At pubmed's inter tier (62826 real blocks, B = 16) the blocks
// are 64.3 MB, so the kernel is bound by bytes (0.0200 ms at F = 16); the
// X slices add 64 MB (F = 16) or 12 MB (F = 3) read from L2.  On an NVIDIA
// H100 80GB HBM3 at 700 W (tools/port_kernels_bench.py, L2 flushed) it takes
// 0.049 ms at F = 16 and 0.043 at F = 3 (the BSR product: 0.066 and 0.27),
// the same over the transpose payload, and no faster with L2 warm: the
// block stream takes most of the time, the X slices and the FMAs less.
// Two or four ring stages, or 128 threads a CTA, were no faster.
//
// Limits.  B <= 64, any F >= 1 and K >= 1.  A CTA's output tile is at most
// 256 pieces (B * ft <= 2048 outputs: ft = 64 up to B = 32, 32 at B = 64).
// Shared memory is the warps' rings, at most 96 KB (55 KB at B = 16, F = 16
// float32); larger blocks stream through fewer warps.
#include <cstdint>
#include <type_traits>

#include "cp_async.cuh"
#include "dtype.cuh"

namespace {

using repro_torch::align16;
using repro_torch::copy_rows;
using repro_torch::cp_commit;
using repro_torch::cp_wait;
using repro_torch::from_f32;
using repro_torch::granule;
using repro_torch::ld4;
using repro_torch::to_f32;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kStages = 3;              // per-warp ring
constexpr int kRingBytes = 96 * 1024;   // all warps' rings, at most
constexpr int kMaxFt = 64;              // feature columns of a CTA
constexpr int kMaxPieces = 256;         // (row pair, 4 columns) pieces

struct Cfg {
  int ft;                 // feature columns of a CTA (F where it fits)
  int pw;                 // warps that stream blocks
  int bp;                 // B rounded up to 4: the staged inner index
  int ap, xp;             // shared pitch (elements) of a block's / slice's rows
  int ga, gx;             // copy granules (bytes): block rows, X rows
  int a_gpr, x_gpr;       // granules per staged row
  float inv_a_gpr, inv_x_gpr;
  int a_bytes, stage_bytes, warp_bytes;
  int nrp, ncg, npieces;  // row pairs, 4-column groups, pieces
  int lp;                 // lanes per piece (they split the inner index)
  int x_cover;            // columns of an X row the copies write
};

template <typename T, int PL>
__global__ void __launch_bounds__(kThreads)
    bell_kernel(const T* __restrict__ blocks, const int* __restrict__ col_idx,
                const int* __restrict__ n_valid, const T* __restrict__ x,
                const T* __restrict__ y_in, T* __restrict__ y, int K, int B,
                int F, const Cfg c) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int i = blockIdx.x;            // block row
  const int f0 = blockIdx.y * c.ft;
  const int fw = min(c.ft, F - f0);
  const bool streams = warp < c.pw;
  const T* a_row = blocks + static_cast<size_t>(i) * K * B * B;
  const int* c_row = col_idx + static_cast<size_t>(i) * K;

  // this warp's block columns, 32 slots a window (lane l: window slot l);
  // read before K_i is known, so the two loads overlap
  int idx = 0;
  auto load_idx = [&](int it0) {
    const int k = warp + c.pw * (it0 + lane);
    idx = streams && k < K ? __ldg(c_row + k) : 0;
  };
  load_idx(0);
  const int kn = n_valid != nullptr ? min(__ldg(n_valid + i), K) : K;
  const int mine = streams ? max(0, (kn - warp + c.pw - 1) / c.pw) : 0;

  // clear, once, what the copies never write and the FMAs read: the rows
  // past B (of a block and of a slice) and an X row's columns past those
  // copied; they stay zero
  unsigned char* ring = smem + warp * c.warp_bytes;
  if (streams) {
    const T zero = from_f32<T>(0.f);
    const int xw = c.xp - c.x_cover;
    for (int st = 0; st < kStages; ++st) {
      T* sa = reinterpret_cast<T*>(ring + st * c.stage_bytes);
      T* sx = reinterpret_cast<T*>(ring + st * c.stage_bytes + c.a_bytes);
      for (int e = lane; e < (c.bp - B) * c.ap; e += 32) sa[B * c.ap + e] = zero;
      for (int e = lane; e < (c.bp - B) * c.xp; e += 32) sx[B * c.xp + e] = zero;
      for (int e = lane; e < B * xw; e += 32)
        sx[e / xw * c.xp + c.x_cover + e % xw] = zero;
    }
  }
  __syncwarp();

  // stage `it`: this warp's it-th block and the X slice it names
  auto copy_block = [&](int it) {
    copy_rows(reinterpret_cast<T*>(ring + (it % kStages) * c.stage_bytes),
              c.ap, a_row + static_cast<size_t>(warp + c.pw * it) * B * B, B,
              B, B, c.a_gpr, c.inv_a_gpr, c.ga, lane, 32);
  };
  auto copy_slice = [&](int it) {
    if ((it & 31) == 0 && it > 0) load_idx(it);
    const int src = __shfl_sync(0xffffffffu, idx, it & 31);
    copy_rows(reinterpret_cast<T*>(ring + (it % kStages) * c.stage_bytes +
                                   c.a_bytes),
              c.xp, x + static_cast<size_t>(src) * B * F + f0, F, fw, B,
              c.x_gpr, c.inv_x_gpr, c.gx, lane, 32);
  };
  // the first stages' blocks need neither K_i nor an index, so they are
  // copied at once (for the slots that exist; those past K_i are zero
  // blocks, never read); their X slices follow when the index arrives
  const int pro = streams ? min(kStages - 1, (K - warp + c.pw - 1) / c.pw)
                          : 0;
  for (int it = 0; it < pro; ++it) copy_block(it);
  for (int it = 0; it < kStages - 1; ++it) {
    if (it < mine) copy_slice(it);
    cp_commit();
  }
  int issued = min(mine, kStages - 1);
  auto issue = [&]() {
    if (issued < mine) {
      copy_block(issued);
      copy_slice(issued);
      ++issued;
    }
    cp_commit();
  };

  // lane pieces: rows pr and pr + nrp, columns 4 pc .. 4 pc + 3 (pr = nrp:
  // no piece); with lp lanes a piece, lane share `part` takes the inner
  // indices j = 4 part + 4 lp m .. + 3
  const int part = c.lp > 1 ? lane / c.npieces : 0;
  int pr[PL], pc[PL];
#pragma unroll
  for (int u = 0; u < PL; ++u) {
    const int pi = c.lp > 1 ? lane % c.npieces : lane + 32 * u;
    pr[u] = pi < c.npieces ? pi / c.ncg : c.nrp;
    pc[u] = pi < c.npieces ? pi - pr[u] * c.ncg : 0;
  }
  float acc[PL][2][4];
#pragma unroll
  for (int u = 0; u < PL; ++u)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int n = 0; n < 4; ++n) acc[u][h][n] = 0.f;

  for (int it = 0; it < mine; ++it) {
    cp_wait<kStages - 2>();
    __syncwarp();
    issue();
    const unsigned char* st = ring + (it % kStages) * c.stage_bytes;
    const T* sa = reinterpret_cast<const T*>(st);
    const T* sx = reinterpret_cast<const T*>(st + c.a_bytes);
#pragma unroll
    for (int u = 0; u < PL; ++u) {
      if (pr[u] >= c.nrp) continue;
      const T* a0 = sa + pr[u] * c.ap;
      const T* a1 = a0 + c.nrp * c.ap;
      const T* xc = sx + 4 * pc[u];
#pragma unroll 4
      for (int j = 4 * part; j < c.bp; j += 4 * c.lp) {
        float a4[2][4];
        ld4(a0 + j, a4[0]);
        ld4(a1 + j, a4[1]);
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          float x4[4];
          ld4(xc + (j + q) * c.xp, x4);
#pragma unroll
          for (int h = 0; h < 2; ++h)
#pragma unroll
            for (int n = 0; n < 4; ++n)
              acc[u][h][n] = fmaf(a4[h][q], x4[n], acc[u][h][n]);
        }
      }
    }
    __syncwarp();
  }
  cp_wait<0>();

  // the lanes of a piece add their shares (a fixed butterfly order)
  if (c.lp > 1)
    for (int o = c.npieces; o < 32; o <<= 1)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int n = 0; n < 4; ++n)
          acc[0][h][n] += __shfl_xor_sync(0xffffffffu, acc[0][h][n], o);

  // the warps' partials, (B, 4 ncg) floats each, over the rings; then
  // Y = Y_in + partial 0 + partial 1 + ... in warp order
  __syncthreads();
  const int rp = 4 * c.ncg;
  float* red = reinterpret_cast<float*>(smem);
  if (streams && part == 0) {
#pragma unroll
    for (int u = 0; u < PL; ++u) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = pr[u] + h * c.nrp;
        if (pr[u] < c.nrp && r < B)
          *reinterpret_cast<float4*>(red + (warp * B + r) * rp + 4 * pc[u]) =
              make_float4(acc[u][h][0], acc[u][h][1], acc[u][h][2],
                          acc[u][h][3]);
      }
    }
  }
  __syncthreads();
  const size_t row0 = static_cast<size_t>(i) * B;
  for (int o = t; o < B * fw; o += kThreads) {
    const int r = o / fw, cc = o - r * fw;
    const size_t at = (row0 + r) * F + f0 + cc;
    float v = y_in != nullptr ? to_f32(y_in[at]) : 0.f;
    for (int w = 0; w < c.pw; ++w) v += red[(w * B + r) * rp + cc];
    y[at] = from_f32<T>(v);
  }
}

template <typename T>
cudaError_t launch(const void* blocks, const int* col_idx, const int* n_valid,
                   const void* x, const void* y_in, void* y, int nbr, int K,
                   int B, int F, cudaStream_t stream) {
  constexpr int sz = sizeof(T);
  Cfg c;
  c.nrp = (B + 1) / 2;
  // feature tile: all of F where the pieces fit, else a multiple of 8
  // (16-byte aligned tile starts for either element type)
  const int ft_cap = (4 * (kMaxPieces / c.nrp)) / 8 * 8;
  c.ft = F <= kMaxFt && F <= ft_cap ? F : (ft_cap < kMaxFt ? ft_cap : kMaxFt);
  c.ncg = (c.ft + 3) / 4;
  c.npieces = c.nrp * c.ncg;
  const bool pow2 = (c.npieces & (c.npieces - 1)) == 0;
  c.lp = c.npieces < 32 && pow2 ? 32 / c.npieces : 1;
  const int per = c.lp > 1 ? 1 : (c.npieces + 31) / 32;
  c.bp = (B + 3) & ~3;
  c.ga = granule(static_cast<long long>(B) * sz, blocks);
  c.gx = granule(static_cast<long long>(F) * sz, x);
  // a block row's staged width covers bp; 16 bytes of padding keep the 8
  // rows one load instruction reads in distinct banks
  const int a_cols = (c.bp * sz + c.ga - 1) / c.ga * c.ga / sz;
  c.ap = a_cols + 16 / sz;
  c.a_gpr = a_cols * sz / c.ga;
  const int ftw = (c.ft + 3) & ~3;
  c.xp = (ftw * sz + c.gx - 1) / c.gx * c.gx / sz;
  c.x_gpr = (c.ft * sz + c.gx - 1) / c.gx;
  c.x_cover = c.x_gpr * c.gx / sz;
  c.inv_a_gpr = 1.f / static_cast<float>(c.a_gpr);
  c.inv_x_gpr = 1.f / static_cast<float>(c.x_gpr);
  c.a_bytes = align16(c.bp * c.ap * sz);
  c.stage_bytes = c.a_bytes + align16(c.bp * c.xp * sz);
  c.warp_bytes = kStages * c.stage_bytes;
  c.pw = c.warp_bytes * kWarps <= kRingBytes
             ? kWarps
             : (kRingBytes / c.warp_bytes > 0 ? kRingBytes / c.warp_bytes : 1);
  const int red_bytes = c.pw * B * 4 * c.ncg * 4;
  const int rings = c.pw * c.warp_bytes;
  const int smem = rings > red_bytes ? rings : red_bytes;
  const dim3 grid(nbr, (F + c.ft - 1) / c.ft);
  auto go = [&](auto pl) -> cudaError_t {
    constexpr int kPL = decltype(pl)::value;
    cudaError_t err = cudaFuncSetAttribute(
        bell_kernel<T, kPL>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (err != cudaSuccess) return err;
    bell_kernel<T, kPL><<<grid, kThreads, smem, stream>>>(
        static_cast<const T*>(blocks), col_idx, n_valid,
        static_cast<const T*>(x), static_cast<const T*>(y_in),
        static_cast<T*>(y), K, B, F, c);
    return cudaGetLastError();
  };
  return per <= 1   ? go(std::integral_constant<int, 1>{})
         : per <= 2 ? go(std::integral_constant<int, 2>{})
         : per <= 4 ? go(std::integral_constant<int, 4>{})
                    : go(std::integral_constant<int, 8>{});
}

}  // namespace

// Launches on `stream`; returns the cudaError_t of the launch (0 = success).
// blocks (nbr, K, B, B), col_idx (nbr, K) int32, n_valid (nbr,) int32 or
// null, x (n_cols, F), y and y_in (nbr*B, F) with y_in optional; all
// contiguous, of the element type `dtype` (0 = float32, 1 = bfloat16).
// col_idx entries must name block columns of x (n_cols / B of them).
extern "C" int bell_spmm_launch(const void* blocks, const void* col_idx,
                                const void* n_valid, const void* x,
                                const void* y_in, void* y, int nbr, int K,
                                int B, int F, int dtype, void* stream) {
  if (nbr <= 0 || F <= 0) return 0;
  if (B < 1 || B > 64 || K < 1) return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* ci = static_cast<const int*>(col_idx);
  const auto* nv = static_cast<const int*>(n_valid);
  switch (dtype) {
    case repro_torch::kFloat32:
      return static_cast<int>(
          launch<float>(blocks, ci, nv, x, y_in, y, nbr, K, B, F, s));
    case repro_torch::kBFloat16:
      return static_cast<int>(
          launch<__nv_bfloat16>(blocks, ci, nv, x, y_in, y, nbr, K, B, F, s));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" const char* bell_spmm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
