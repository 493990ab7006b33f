// Fused blocked-ELL transform+aggregate on Hopper:
//   Y[i] = sum_{k < K_i} blocks[i, k] (X[col_idx[i, k]] W) (+ Y_in[i]).
//
// Replaces the Pallas TPU kernels repro/kernels/bell_spmm_fused.py
// (bell_spmm_fused, _kernel / _kernel_acc) and
// repro/kernels/block_diag_spmm_fused.py (block_diag_spmm_fused): the
// block-diagonal form is this kernel with K = 1 and identity block columns
// (col_idx null), Y[i] = A_i (X_i W).  As on the TPU, H = X W never reaches
// device memory, and each stored block transforms its gathered (B, Fi) rows
// of X again: a source block named by k stored blocks is transformed k
// times (once on the diagonal tier).  The fusion trades that recompute for
// the write and read of H; the selector decides per tier which side wins.
// With the transposed-read flag each stored block is read transposed (an
// index swap where it is read from shared memory), so the backward pass
// dX = A^T (dY W^T) of the diagonal tier needs no transposed copy.
//
// Design.  The launch picks one of two kernels from the shape.
//  - Wide (Fi > 32, or B > 32, or Fo > 64: layer 1): a CTA of 256 threads
//    owns one block row (the diagonal form: 128 / B consecutive block rows)
//    and one 16-column tile of Fo.  It stacks the gathered (B, Fi) slices of
//    up to 128 / B stored blocks into a (128, Fi) tile and multiplies it by
//    the (Fi, 16) stripe of W, staged once per CTA where it fits in 64 KB
//    (32 KB at Fi = 500) and otherwise streamed beside X.  Fi goes in tiles
//    of 8 copy granules a row (32 columns for float32 rows whose pitch allows
//    16-byte copies) through a 3-stage cp.async ring, so two tiles are in
//    flight while one is multiplied.  Two warp groups each take half of a
//    tile's columns; a thread keeps a 4 x 4 micro-tile of H in registers and
//    reads X and W as 16-byte vectors (64 FMAs for 8 vector loads).  When a
//    chunk's last tile is done, both halves of H go to shared memory over
//    the spent X tile, and each thread applies the chunk's (B, B) blocks,
//    staged with that last tile, to H0 + H1 for its outputs of the row's Y,
//    kept in registers across chunks.  A row's blocks are summed in a fixed
//    order, so the bits do not depend on scheduling.  The hardware hands the
//    1233 row CTAs of the main path to SMs as they free up (2 CTAs an SM),
//    which balances rows of 0 to 83 blocks.
//  - Narrow (Fi <= 32, B <= 32, Fo <= 64: layer 2 and its dX pass): W as
//    float32 in shared memory, 8 warps a CTA.  The blocked-ELL form gives a
//    CTA one block row and splits its blocks over the warps (slots k = w
//    mod 8), whose pieces of Y are added in warp order at the end, so the
//    longest row is not one warp's critical path; the diagonal form gives
//    each warp a row.  A warp streams its blocks and their gathered X slices
//    through its own 3-stage cp.async ring (no CTA barriers), the next
//    block's column loaded one block ahead, forms H = X_k W in a warp slice
//    of shared memory and adds A_k H to the Y it keeps in registers, 4
//    columns a lane.  Where a block row has fewer than 32 (row, 4-column)
//    outputs, 2, 4, ... lanes split Fi and B and combine by a fixed
//    butterfly of shuffles.
// Copies are 16-byte cp.async where the row pitch and base allow it, else
// 8 or 4 bytes; bfloat16 rows of odd pitch (2-byte alignment) are copied
// with plain loads.  Tails are zero-filled by the copy's source size.  The
// float32 path is float32 FMAs on the CUDA cores (TF32 alone would break
// the float32 gate at Fi = 500); bfloat16 inputs are widened to float32 as
// they are read from shared memory.
//
// Bound.  The function needs each real block, each source row of X and W
// read once and Y written once, and 2 n Fi Fo + 2 nnzb B B Fo flops: at the
// main path's first layer (62826 stored blocks, B = 16, Fi = 500, Fo = 16)
// about 105 MB, bound by bytes (0.0314 ms).  The recompute design needs
// 2 B Fi Fo flops per stored block instead, 1.6e10 in all (0.2477 ms at the
// float32 peak), and gathers 2.01 GB of X rows, 16 KB per stored block and
// 51 times each source block, from L2.  That gather is what bounds the wide
// kernel on the H100: its time scales with Fi, and stays the same with the
// source rows confined to 4 MB of L2 or with L2 warm
// (tools/bell_kernels_bench.py), at about 2 TB/s.
//
// Limits.  B <= 64, any Fi >= 1 and Fo >= 1, K >= 1 (K = 1 when col_idx is
// null).  Shared memory, wide: 3 stages of (128 x (tile + 16 B) X elements
// and 128 / B blocks) plus the W stripe: 109 KB at B = 16, Fi = 500 float32
// (2 CTAs an SM), 181 KB at B = 64.  Narrow: W plus, per warp, 3 stages of
// one block and its X slice, and H: 62 KB at B = 16, Fi = 16.
#include <cstdint>

#include "cp_async.cuh"
#include "dtype.cuh"

namespace {

using repro_torch::align16;
using repro_torch::copy_granule;
using repro_torch::cp_commit;
using repro_torch::cp_wait;
using repro_torch::from_f32;
using repro_torch::granule;
using repro_torch::ld4;
using repro_torch::to_f32;

// ---------------------------------------------------------------------------
// copies and shared-memory reads
// ---------------------------------------------------------------------------

// Copies `rows` rows of `gpr` g-byte granules from src (row pitch sp
// elements) to dst (row pitch dp elements), zero-filling each row past its
// first n elements.  Thread tid of nthr moves every nthr-th granule; the
// row of a granule is e / gpr, taken in float (exact for e < 2^21).
template <typename T>
__device__ __forceinline__ void copy_rows(T* dst, int dp, const T* src,
                                          int sp, int n, int rows, int gpr,
                                          float inv_gpr, int g, int tid,
                                          int nthr) {
  const int eg = g / static_cast<int>(sizeof(T));
  for (int e = tid; e < rows * gpr; e += nthr) {
    const int r = static_cast<int>((e + 0.5f) * inv_gpr);
    const int col = (e - r * gpr) * eg;
    const int bytes =
        max(0, min(g, (n - col) * static_cast<int>(sizeof(T))));
    copy_granule(dst + r * dp + col,
                 src + static_cast<size_t>(r) * sp + (bytes > 0 ? col : 0), g,
                 bytes);
  }
}

inline int pow2_ceil(int v) {
  int p = 1;
  while (p < v) p <<= 1;
  return p;
}

// Lets `kernel` take `bytes` of dynamic shared memory and asks for the
// largest shared-memory carveout, so as many CTAs fit an SM as the bytes
// allow.
template <typename K>
cudaError_t set_smem(K* kernel, int bytes) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributePreferredSharedMemoryCarveout,
                              cudaSharedmemCarveoutMaxShared);
}

template <typename T>
struct Args {
  const T* blocks;
  const int* col_idx;   // null: identity block columns (K = 1)
  const int* n_valid;   // null: every slot is real
  const T* x;
  const T* w;
  const T* y_in;        // optional
  T* y;
  int nbr, K, B, Fi, Fo;
  int sr, sj;           // strides of a block's element (r, j): (B, 1) or
                        // (1, B) for the transposed read
};

// ---------------------------------------------------------------------------
// wide kernel
// ---------------------------------------------------------------------------

constexpr int kWThreads = 256;
constexpr int kMT = 128;                    // rows of a chunk tile
constexpr int kFT = 16;                     // columns of a Fo tile
constexpr int kWStages = 3;
constexpr int kCopyRows = kWThreads / 8;    // rows per copy pass (8 granules)
constexpr int kCopyPasses = kMT / kCopyRows;
constexpr int kMaxPY = 64 * kFT / kWThreads;  // Y outputs a thread, B <= 64
constexpr int kWOnceBytes = 64 * 1024;

struct WideCfg {
  int gx, kt, xp, nkt;   // X granule bytes, tile columns, smem pitch, tiles
  int mb;                // blocks per chunk (128 / B)
  int gw, ga;            // W and block granule bytes
  int w_once;            // W stripe staged whole
  int x_bytes, a_bytes, stage_bytes;
  float inv_gw;          // 1 / (W granules per row)
};

template <typename T>
__global__ void __launch_bounds__(kWThreads, 2)
    bell_fused_wide_kernel(const Args<T> p, const WideCfg c) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int kSz = sizeof(T);
  const int t = threadIdx.x;
  const int B = p.B, Fi = p.Fi, BB = p.B * p.B;
  const bool diag = p.col_idx == nullptr;
  const int n0 = blockIdx.y * kFT;
  const int fw = min(kFT, p.Fo - n0);
  // bell: the block row and its real blocks; diagonal: the first block row
  // and the number of rows (one block each) of this CTA
  int row, kn;
  if (diag) {
    row = blockIdx.x * c.mb;
    kn = min(c.mb, p.nbr - row);
  } else {
    row = blockIdx.x;
    kn = p.n_valid != nullptr ? min(p.n_valid[row], p.K) : p.K;
  }
  const int nchunk = diag ? 1 : (kn + c.mb - 1) / c.mb;
  const int nsteps = nchunk * c.nkt;
  T* w_all = reinterpret_cast<T*>(smem + kWStages * c.stage_bytes);

  // W rows [k0, k0 + rows) x columns [n0, n0 + 16), zero past Fi and Fo
  const int w_gpr = kFT * kSz / c.gw;
  auto stage_w = [&](T* dst, int k0, int rows) {
    const int ew = c.gw / kSz;
    for (int e = t; e < rows * w_gpr; e += kWThreads) {
      const int r = static_cast<int>((e + 0.5f) * c.inv_gw);
      const int n = (e - r * w_gpr) * ew;
      const int k = k0 + r;
      const int bytes =
          k < Fi ? max(0, min(c.gw, (p.Fo - n0 - n) * kSz)) : 0;
      copy_granule(dst + r * kFT + n,
                   p.w + (bytes > 0 ? static_cast<size_t>(k) * p.Fo + n0 + n
                                    : 0),
                   c.gw, bytes);
    }
  };

  // X copies: thread t moves granule gi of rows rg + 32 q of each tile;
  // the issue cursor (chunk, tile, ring slot) advances one step a call
  const int gi = t & 7, rg = t >> 3;
  const int eg = c.gx / kSz;
  int i_ch = 0, i_kt = 0, i_slot = 0, cur = -1;
  unsigned valid = 0;
  size_t xoff[kCopyPasses];
#pragma unroll
  for (int q = 0; q < kCopyPasses; ++q) xoff[q] = 0;

  auto issue = [&]() {
    if (i_ch < nchunk) {
      unsigned char* st = smem + i_slot * c.stage_bytes;
      const int kw = diag ? kn : min(c.mb, kn - i_ch * c.mb);
      if (i_ch != cur) {  // source rows of this chunk's granules
        cur = i_ch;
        valid = 0;
#pragma unroll
        for (int q = 0; q < kCopyPasses; ++q) {
          const int m = rg + kCopyRows * q;
          const int b = m / B;
          if (b < kw) {
            valid |= 1u << q;
            const int src =
                diag ? row + b
                     : p.col_idx[static_cast<size_t>(row) * p.K +
                                 i_ch * c.mb + b];
            xoff[q] = (static_cast<size_t>(src) * B + (m - b * B)) *
                      static_cast<size_t>(Fi);
          }
        }
      }
      T* sx = reinterpret_cast<T*>(st);
      const int col = i_kt * c.kt + gi * eg;
      const int bytes = max(0, min(c.gx, (Fi - col) * kSz));
#pragma unroll
      for (int q = 0; q < kCopyPasses; ++q)
        if (valid >> q & 1u)
          copy_granule(sx + (rg + kCopyRows * q) * c.xp + gi * eg,
                       p.x + xoff[q] + (bytes > 0 ? col : 0), c.gx, bytes);
      if (!c.w_once)
        stage_w(reinterpret_cast<T*>(st + c.x_bytes + c.a_bytes),
                i_kt * c.kt, c.kt);
      if (i_kt == c.nkt - 1) {  // the chunk's blocks: one contiguous run
        const T* a = p.blocks + (static_cast<size_t>(row) * p.K +
                                 (diag ? 0 : i_ch * c.mb)) * BB;
        T* sa = reinterpret_cast<T*>(st + c.x_bytes);
        const int ea = c.ga / kSz;
        const int n = kw * BB / ea;
        for (int e = t; e < n; e += kWThreads)
          copy_granule(sa + e * ea, a + e * ea, c.ga, c.ga);
      }
      if (++i_kt == c.nkt) {
        i_kt = 0;
        ++i_ch;
      }
      if (++i_slot == kWStages) i_slot = 0;
    }
    cp_commit();
  };

  // the block row's Y outputs o = t + 256 p: (o / 16, o % 16) (bell only)
  const int py = (B * kFT + kWThreads - 1) / kWThreads;
  float yacc[kMaxPY];
#pragma unroll
  for (int pp = 0; pp < kMaxPY; ++pp) {
    const int o = t + kWThreads * pp;
    const int r = o >> 4, cc = o & 15;
    yacc[pp] = 0.f;
    if (!diag && pp < py && r < B && cc < fw && p.y_in != nullptr)
      yacc[pp] = to_f32(
          p.y_in[(static_cast<size_t>(row) * B + r) * p.Fo + n0 + cc]);
  }

  if (c.w_once) stage_w(w_all, 0, (Fi + 3) & ~3);  // joins group 0
  for (int s = 0; s < kWStages - 1; ++s) issue();

  // warp group kg (warps 4 kg..4 kg + 3) takes half of each tile's columns;
  // within it, thread tl keeps H rows tl / 4 + 32 j, columns 4 (tl % 4)..
  const int kg = t >> 7, tl = t & 127;
  const int tn = tl & 3, tm = tl >> 2;
  const int half = c.kt / 2;
  float h[4][4];
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int n = 0; n < 4; ++n) h[j][n] = 0.f;

  int ch = 0, kt = 0, slot = 0;
  for (int s = 0; s < nsteps; ++s) {
    cp_wait<kWStages - 2>();
    __syncthreads();
    issue();
    unsigned char* st = smem + slot * c.stage_bytes;
    const T* xs = reinterpret_cast<const T*>(st) + tm * c.xp;
    const T* ws = (c.w_once ? w_all + kt * c.kt * kFT
                            : reinterpret_cast<const T*>(st + c.x_bytes +
                                                         c.a_bytes)) +
                  4 * tn;
    const int kw4 = (min(c.kt, Fi - kt * c.kt) + 3) & ~3;
    const int k_end = min(kw4, (kg + 1) * half);
#pragma unroll 2
    for (int kk = kg * half; kk < k_end; kk += 4) {
      float wv[4][4];
#pragma unroll
      for (int q = 0; q < 4; ++q) ld4(ws + (kk + q) * kFT, wv[q]);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float xv[4];
        ld4(xs + 32 * j * c.xp + kk, xv);
#pragma unroll
        for (int q = 0; q < 4; ++q)
#pragma unroll
          for (int n = 0; n < 4; ++n) h[j][n] = fmaf(xv[q], wv[q][n], h[j][n]);
      }
    }
    if (++slot == kWStages) slot = 0;
    if (++kt != c.nkt) continue;
    kt = 0;

    // the chunk is transformed: each group's half of H to shared memory
    // over the spent X tile, then apply the chunk's blocks to H0 + H1
    __syncthreads();
    float* hs = reinterpret_cast<float*>(st);
    float* hmine = hs + kg * kMT * kFT;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      *reinterpret_cast<float4*>(hmine + (tm + 32 * j) * kFT + 4 * tn) =
          make_float4(h[j][0], h[j][1], h[j][2], h[j][3]);
#pragma unroll
      for (int n = 0; n < 4; ++n) h[j][n] = 0.f;
    }
    __syncthreads();
    const float* h1 = hs + kMT * kFT;
    const T* as = reinterpret_cast<const T*>(st + c.x_bytes);
    const int kw = diag ? kn : min(c.mb, kn - ch * c.mb);
    if (diag) {
      // each block to its own row: Y[row + b] = A_b H_b (+ Y_in)
      for (int pp = 0; pp < kMT * kFT / kWThreads; ++pp) {
        const int o = t + kWThreads * pp;
        const int m = o >> 4, cc = o & 15;
        const int b = m / B, r = m - b * B;
        if (b >= kw || cc >= fw) continue;
        const T* ab = as + b * BB + r * p.sr;
        const int hb = b * B * kFT + cc;
        const size_t yo =
            (static_cast<size_t>(row + b) * B + r) * p.Fo + n0 + cc;
        float acc = p.y_in != nullptr ? to_f32(p.y_in[yo]) : 0.f;
        for (int j = 0; j < B; ++j)
          acc = fmaf(to_f32(ab[j * p.sj]), hs[hb + j * kFT] + h1[hb + j * kFT],
                     acc);
        p.y[yo] = from_f32<T>(acc);
      }
    } else {
#pragma unroll
      for (int pp = 0; pp < kMaxPY; ++pp) {
        const int o = t + kWThreads * pp;
        const int r = o >> 4, cc = o & 15;
        if (pp >= py || r >= B) continue;
        float acc = yacc[pp];
        for (int b = 0; b < kw; ++b) {
          const T* ab = as + b * BB + r * p.sr;
          const int hb = b * B * kFT + cc;
#pragma unroll 4
          for (int j = 0; j < B; ++j)
            acc = fmaf(to_f32(ab[j * p.sj]),
                       hs[hb + j * kFT] + h1[hb + j * kFT], acc);
        }
        yacc[pp] = acc;
      }
    }
    ++ch;
  }
  cp_wait<0>();

  if (!diag) {
#pragma unroll
    for (int pp = 0; pp < kMaxPY; ++pp) {
      const int o = t + kWThreads * pp;
      const int r = o >> 4, cc = o & 15;
      if (pp < py && r < B && cc < fw)
        p.y[(static_cast<size_t>(row) * B + r) * p.Fo + n0 + cc] =
            from_f32<T>(yacc[pp]);
    }
  }
}

template <typename T>
cudaError_t launch_wide(const Args<T>& p, cudaStream_t stream) {
  constexpr int sz = sizeof(T);
  WideCfg c;
  c.gx = granule(static_cast<long long>(p.Fi) * sz, p.x);
  c.kt = 8 * c.gx / sz;
  c.xp = c.kt + 16 / sz;
  c.nkt = (p.Fi + c.kt - 1) / c.kt;
  c.mb = kMT / p.B;
  c.gw = granule(static_cast<long long>(p.Fo) * sz, p.w);
  c.inv_gw = 1.f / static_cast<float>(kFT * sz / c.gw);
  c.ga = granule(static_cast<long long>(p.B) * p.B * sz, p.blocks);
  const int w_rows = (p.Fi + 3) & ~3;
  c.w_once = w_rows * kFT * sz <= kWOnceBytes;
  // the X tile, later the two halves of H
  c.x_bytes = align16(max(kMT * c.xp * sz, 2 * kMT * kFT * 4));
  c.a_bytes = align16(c.mb * p.B * p.B * sz);
  c.stage_bytes =
      c.x_bytes + c.a_bytes + (c.w_once ? 0 : align16(c.kt * kFT * sz));
  const int smem =
      kWStages * c.stage_bytes + (c.w_once ? align16(w_rows * kFT * sz) : 0);
  const cudaError_t err = set_smem(bell_fused_wide_kernel<T>, smem);
  if (err != cudaSuccess) return err;
  const int n_items = p.col_idx == nullptr ? (p.nbr + c.mb - 1) / c.mb : p.nbr;
  const dim3 grid(n_items, (p.Fo + kFT - 1) / kFT);
  bell_fused_wide_kernel<T><<<grid, kWThreads, smem, stream>>>(p, c);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// narrow kernel
// ---------------------------------------------------------------------------

constexpr int kNThreads = 256;
constexpr int kNWarps = kNThreads / 32;
constexpr int kNStages = 3;
constexpr int kNMaxB = 32, kNMaxFi = 32, kNMaxFo = 64;
constexpr int kNSmem = 96 * 1024;

struct NarrowCfg {
  int nw;              // warps per CTA: rpc rows of wpr warps
  int rpc, wpr;        // block rows per CTA, warps sharing a row's blocks
  int fop;             // Fo rounded up to 4: pitch of W and H (floats)
  int npairs, lp;      // (row, 4-column) outputs of a block; lanes per pair
  int ap, xp;          // shared row pitches of A and X (elements)
  int ga, gx, a_gpr, x_gpr;
  float inv_a_gpr, inv_x_gpr;
  int w_bytes, a_bytes, x_bytes, warp_bytes;
};

template <typename T, int PL>
__global__ void __launch_bounds__(kNThreads)
    bell_fused_narrow_kernel(const Args<T> p, const NarrowCfg c) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int B = p.B, Fi = p.Fi, Fo = p.Fo;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int fip = (Fi + 3) & ~3, bp = (B + 3) & ~3;
  const bool diag = p.col_idx == nullptr;
  const bool trans = p.sj != 1;
  float* w_s = reinterpret_cast<float*>(smem);    // (fip, fop)
  const int stage_bytes = c.a_bytes + c.x_bytes;
  unsigned char* mine = smem + c.w_bytes + warp * c.warp_bytes;
  float* h_s = reinterpret_cast<float*>(mine + kNStages * stage_bytes);
  // warp wk of a row's wpr warps takes its blocks k = wk (mod wpr)
  const int wk = warp % c.wpr;
  const int item = blockIdx.x * c.rpc + warp / c.wpr;
  const bool active = warp < c.nw && item < p.nbr;
  const int kn = !active ? 0
                 : diag  ? 1
                 : p.n_valid != nullptr ? min(p.n_valid[item], p.K)
                                        : p.K;
  const int my = max(0, (kn - wk + c.wpr - 1) / c.wpr);

  // block kk's column is loaded one issue ahead, off the copy's path
  auto col_of = [&](int kk) {
    return kk >= my ? 0
           : diag   ? item
                    : p.col_idx[static_cast<size_t>(item) * p.K + wk +
                                kk * c.wpr];
  };
  int next_src = col_of(0);
  auto issue = [&](int kk) {
    if (kk < my) {
      const int k = wk + kk * c.wpr;
      unsigned char* st = mine + (kk % kNStages) * stage_bytes;
      const int src = next_src;
      next_src = col_of(kk + 1);
      copy_rows(reinterpret_cast<T*>(st), c.ap,
                p.blocks + (static_cast<size_t>(item) * p.K + k) * B * B, B,
                B, B, c.a_gpr, c.inv_a_gpr, c.ga, lane, 32);
      copy_rows(reinterpret_cast<T*>(st + c.a_bytes), c.xp,
                p.x + static_cast<size_t>(src) * B * Fi, Fi, Fi, B, c.x_gpr,
                c.inv_x_gpr, c.gx, lane, 32);
    }
    cp_commit();
  };
  for (int k = 0; k < kNStages - 1; ++k) issue(k);

  // W as float32, zero past Fi and Fo; rows B..bp of A (every stage) and H
  // stay zero, so 4-wide reads past B add nothing
  for (int e = t; e < fip * c.fop; e += kNThreads) {
    const int f = e / c.fop, n = e - f * c.fop;
    w_s[e] = f < Fi && n < Fo ? to_f32(p.w[static_cast<size_t>(f) * Fo + n])
                              : 0.f;
  }
  if (warp < c.nw) {
    for (int e = lane; e < (bp - B) * c.fop; e += 32) h_s[B * c.fop + e] = 0.f;
    for (int s = 0; s < kNStages; ++s) {
      T* sa = reinterpret_cast<T*>(mine + s * stage_bytes);
      for (int e = lane; e < (bp - B) * c.ap; e += 32)
        sa[B * c.ap + e] = from_f32<T>(0.f);
    }
  }
  __syncthreads();

  // the lane's (row, column group) pairs and its share of Fi and B
  const int ncg = c.fop / 4;
  const int part = c.lp > 1 ? lane / c.npairs : 0;
  int pr[PL], pc[PL];
  float y4[PL][4];
#pragma unroll
  for (int u = 0; u < PL; ++u) {
    const int pi = c.lp > 1 ? (u == 0 ? lane % c.npairs : c.npairs)
                            : lane + 32 * u;
    pr[u] = pi < c.npairs ? pi / ncg : B;   // B: no pair
    pc[u] = pi < c.npairs ? pi - pr[u] * ncg : 0;
#pragma unroll
    for (int n = 0; n < 4; ++n) {
      const int col = 4 * pc[u] + n;
      y4[u][n] = 0.f;
      if (active && wk == 0 && part == 0 && pr[u] < B && col < Fo &&
          p.y_in != nullptr)
        y4[u][n] = to_f32(
            p.y_in[(static_cast<size_t>(item) * B + pr[u]) * Fo + col]);
    }
  }

  for (int kk = 0; kk < my; ++kk) {
    cp_wait<kNStages - 2>();
    __syncwarp();
    issue(kk + kNStages - 1);
    const unsigned char* st = mine + (kk % kNStages) * stage_bytes;
    const T* sa = reinterpret_cast<const T*>(st);
    const T* sx = reinterpret_cast<const T*>(st + c.a_bytes);
    // H_k = X_k W: rows of this lane's pairs, its share of Fi
#pragma unroll
    for (int u = 0; u < PL; ++u) {
      if (pr[u] >= B) continue;   // uniform where lanes share pairs
      float h4[4] = {0.f, 0.f, 0.f, 0.f};
      const T* xr = sx + pr[u] * c.xp;
      for (int f = 4 * part; f < fip; f += 4 * c.lp) {
        float xv[4];
        ld4(xr + f, xv);
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const float4 w4 = *reinterpret_cast<const float4*>(
              w_s + (f + q) * c.fop + 4 * pc[u]);
          h4[0] = fmaf(xv[q], w4.x, h4[0]);
          h4[1] = fmaf(xv[q], w4.y, h4[1]);
          h4[2] = fmaf(xv[q], w4.z, h4[2]);
          h4[3] = fmaf(xv[q], w4.w, h4[3]);
        }
      }
      if (c.lp > 1)   // every lane has a pair: the butterfly is uniform
        for (int o = c.npairs; o < 32; o <<= 1)
#pragma unroll
          for (int n = 0; n < 4; ++n)
            h4[n] += __shfl_xor_sync(0xffffffffu, h4[n], o);
      if (part == 0)
        *reinterpret_cast<float4*>(h_s + pr[u] * c.fop + 4 * pc[u]) =
            make_float4(h4[0], h4[1], h4[2], h4[3]);
    }
    __syncwarp();
    // Y += A_k H_k: this lane's share of the block's columns j
#pragma unroll
    for (int u = 0; u < PL; ++u) {
      if (pr[u] >= B) continue;
      const int r = pr[u];
      for (int j = 4 * part; j < bp; j += 4 * c.lp) {
        float a4[4];
        if (trans) {
#pragma unroll
          for (int q = 0; q < 4; ++q) a4[q] = to_f32(sa[(j + q) * c.ap + r]);
        } else {
          ld4(sa + r * c.ap + j, a4);
        }
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const float4 h = *reinterpret_cast<const float4*>(
              h_s + (j + q) * c.fop + 4 * pc[u]);
          y4[u][0] = fmaf(a4[q], h.x, y4[u][0]);
          y4[u][1] = fmaf(a4[q], h.y, y4[u][1]);
          y4[u][2] = fmaf(a4[q], h.z, y4[u][2]);
          y4[u][3] = fmaf(a4[q], h.w, y4[u][3]);
        }
      }
    }
    __syncwarp();
  }
  cp_wait<0>();

  if (c.lp > 1) {
    for (int o = c.npairs; o < 32; o <<= 1)
#pragma unroll
      for (int n = 0; n < 4; ++n)
        y4[0][n] += __shfl_xor_sync(0xffffffffu, y4[0][n], o);
  }
  if (c.wpr > 1) {
    // the row's warps add their pieces in warp order, through the spent
    // stages of each warp
    float* piece = reinterpret_cast<float*>(mine) + lane * 4 * PL;
    if (warp < c.nw) {
#pragma unroll
      for (int u = 0; u < PL; ++u)
        *reinterpret_cast<float4*>(piece + 4 * u) =
            make_float4(y4[u][0], y4[u][1], y4[u][2], y4[u][3]);
    }
    __syncthreads();
    if (wk != 0 || warp >= c.nw) return;
    for (int w2 = 1; w2 < c.wpr; ++w2) {
      const float* other = reinterpret_cast<const float*>(
                               smem + c.w_bytes + (warp + w2) * c.warp_bytes) +
                           lane * 4 * PL;
#pragma unroll
      for (int u = 0; u < PL; ++u)
#pragma unroll
        for (int n = 0; n < 4; ++n) y4[u][n] += other[4 * u + n];
    }
  }
  if (!active || part != 0) return;
#pragma unroll
  for (int u = 0; u < PL; ++u) {
    if (pr[u] >= B) continue;
#pragma unroll
    for (int n = 0; n < 4; ++n) {
      const int col = 4 * pc[u] + n;
      if (col < Fo)
        p.y[(static_cast<size_t>(item) * B + pr[u]) * Fo + col] =
            from_f32<T>(y4[u][n]);
    }
  }
}

template <typename T, int PL>
cudaError_t launch_narrow_pl(const Args<T>& p, const NarrowCfg& c, int smem,
                             cudaStream_t stream) {
  const cudaError_t err = set_smem(bell_fused_narrow_kernel<T, PL>, smem);
  if (err != cudaSuccess) return err;
  bell_fused_narrow_kernel<T, PL>
      <<<(p.nbr + c.rpc - 1) / c.rpc, kNThreads, smem, stream>>>(p, c);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_narrow(const Args<T>& p, cudaStream_t stream) {
  constexpr int sz = sizeof(T);
  const int fip = (p.Fi + 3) & ~3, bp = (p.B + 3) & ~3;
  NarrowCfg c;
  c.fop = (p.Fo + 3) & ~3;
  c.ga = granule(static_cast<long long>(p.B) * sz, p.blocks);
  c.gx = granule(static_cast<long long>(p.Fi) * sz, p.x);
  const int a_cols = (bp * sz + c.ga - 1) / c.ga * c.ga / sz;
  const int x_cols = (fip * sz + c.gx - 1) / c.gx * c.gx / sz;
  c.ap = a_cols + 16 / sz;
  c.xp = x_cols + 16 / sz;
  c.a_gpr = a_cols * sz / c.ga;
  c.x_gpr = x_cols * sz / c.gx;
  c.inv_a_gpr = 1.f / static_cast<float>(c.a_gpr);
  c.inv_x_gpr = 1.f / static_cast<float>(c.x_gpr);
  c.w_bytes = align16(fip * c.fop * 4);
  c.a_bytes = align16(bp * c.ap * sz);
  c.x_bytes = align16(p.B * c.xp * sz);
  c.npairs = p.B * c.fop / 4;
  const bool pow2 = (c.npairs & (c.npairs - 1)) == 0;
  c.lp = c.npairs < 32 && pow2 ? 32 / c.npairs : 1;
  const int per = c.lp > 1 ? 1 : (c.npairs + 31) / 32;
  // a warp's stages also hold its 32 lanes' pieces of Y at the end
  c.warp_bytes = align16(max(kNStages * (c.a_bytes + c.x_bytes),
                             32 * 4 * pow2_ceil(per) * 4) +
                         bp * c.fop * 4);
  const int fit = max(1, min(kNWarps, (kNSmem - c.w_bytes) / c.warp_bytes));
  // the blocked-ELL form splits each row's blocks over the CTA's warps, so
  // the longest row (83 blocks on pubmed) is not one warp's critical path;
  // the diagonal form (one block a row) gives each warp its own row
  c.wpr = p.col_idx != nullptr ? fit : 1;
  c.rpc = fit / c.wpr;
  c.nw = c.rpc * c.wpr;
  const int smem = c.w_bytes + c.nw * c.warp_bytes;
  return per <= 1   ? launch_narrow_pl<T, 1>(p, c, smem, stream)
         : per <= 2 ? launch_narrow_pl<T, 2>(p, c, smem, stream)
         : per <= 4 ? launch_narrow_pl<T, 4>(p, c, smem, stream)
         : per <= 8 ? launch_narrow_pl<T, 8>(p, c, smem, stream)
                    : launch_narrow_pl<T, 16>(p, c, smem, stream);
}

template <typename T>
cudaError_t launch(const void* blocks, const int* col_idx, const int* n_valid,
                   const void* x, const void* w, const void* y_in, void* y,
                   int nbr, int K, int B, int Fi, int Fo, int transpose,
                   cudaStream_t stream) {
  Args<T> p;
  p.blocks = static_cast<const T*>(blocks);
  p.col_idx = col_idx;
  p.n_valid = n_valid;
  p.x = static_cast<const T*>(x);
  p.w = static_cast<const T*>(w);
  p.y_in = static_cast<const T*>(y_in);
  p.y = static_cast<T*>(y);
  p.nbr = nbr;
  p.K = K;
  p.B = B;
  p.Fi = Fi;
  p.Fo = Fo;
  p.sr = transpose ? 1 : B;
  p.sj = transpose ? B : 1;
  if (B <= kNMaxB && Fi <= kNMaxFi && Fo <= kNMaxFo)
    return launch_narrow(p, stream);
  return launch_wide(p, stream);
}

}  // namespace

// Launches on `stream`; returns the cudaError_t of the launch (0 = success).
// blocks (nbr, K, B, B), col_idx (nbr, K) int32 or null (identity block
// columns, K = 1), n_valid (nbr,) int32 or null, x (n_cols, Fi), w (Fi, Fo),
// y and y_in (nbr*B, Fo) with y_in optional; all contiguous, of the element
// type `dtype` (0 = float32, 1 = bfloat16).  col_idx entries must name block
// columns of x.  transpose != 0 reads each stored block transposed.
extern "C" int bell_spmm_fused_launch(const void* blocks, const void* col_idx,
                                      const void* n_valid, const void* x,
                                      const void* w, const void* y_in,
                                      void* y, int nbr, int K, int B, int Fi,
                                      int Fo, int transpose, int dtype,
                                      void* stream) {
  if (nbr <= 0 || Fo <= 0) return 0;
  if (B < 1 || B > 64 || K < 1 || Fi < 1 || (col_idx == nullptr && K != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* ci = static_cast<const int*>(col_idx);
  const auto* nv = static_cast<const int*>(n_valid);
  switch (dtype) {
    case repro_torch::kFloat32:
      return static_cast<int>(launch<float>(blocks, ci, nv, x, w, y_in, y,
                                            nbr, K, B, Fi, Fo, transpose, s));
    case repro_torch::kBFloat16:
      return static_cast<int>(launch<__nv_bfloat16>(
          blocks, ci, nv, x, w, y_in, y, nbr, K, B, Fi, Fo, transpose, s));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" const char* bell_spmm_fused_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
