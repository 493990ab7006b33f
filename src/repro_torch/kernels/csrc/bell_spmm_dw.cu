// Weight gradient of the fused kernels on Hopper:
//   dW = X^T (A^T G) = sum_i X_i^T (sum_{k < K_i} At[i, k] G[col_t[i, k]]),
// a reduction of every block row into one (Fi, Fo) float32 result.
//
// Replaces the Pallas TPU kernel repro/kernels/bell_spmm_fused.py
// (bell_spmm_dw, _dw_kernel).  It runs over the transpose payload (At =
// the stored blocks of A^T), so no (n, F) intermediate is written.  The
// diagonal tier reuses it with K = 1, identity block columns (col_idx null)
// and the transposed-read flag over its own blocks (repro/kernels/ops.py
// _bd_dw_impl), so no transposed copy of the blocks is made either.
//
// Design.  On the TPU the block rows are sequential grid steps that add into
// one VMEM accumulator.  On Hopper, CTAs run in no order and nothing carries
// across them, and float atomics would make the sum's order, and so its
// bits, change from run to run.  So the reduction has two phases:
//   1. one CTA of 256 threads per (split, 512-column Fi tile, 16-column Fo
//      tile); split s owns the fixed block rows [s * rows_per, (s + 1) *
//      rows_per), a constant of the wrapper, never derived from the card.
//      The CTA is a split-K product X_run^T Z_run over those rows:
//      a. Z_i = sum_k At[i, k] G[col_t[i, k]] for all its rows into shared
//         memory, once per row.  Each warp streams stored blocks and their
//         gathered G slices through its own 7-stage cp.async ring (of the
//         blocked-ELL form the slots k = w (mod 8) of every row, of the
//         diagonal form the rows i = w (mod 8)), the next block's column
//         loaded one block ahead.  A lane keeps a 2-row x 4-column piece of
//         Z_i (6 vector loads for 32 FMAs); at a row's end the warps'
//         pieces are summed in warp order through shared memory.
//      b. X_run^T Z_run: the run's rows of X come through a 3-stage ring
//         (13 rows a stage at Fi = 500), whose first two stages are issued
//         behind phase a's first blocks, so X is in flight while Z is
//         formed.  A thread owns 2 x 4 rows of dW by 4 columns (32 float32
//         outputs at Fi = 500, Fo = 16, where one CTA covers all of Fi) and
//         reads X and Z as 16-byte vectors: 32 FMAs for 3 vector loads.
//         Where the tile has fewer outputs than threads (Fi = 16, Fo = 3),
//         the threads split the rows and sum their pieces in a fixed order.
//      The CTA writes its partial to a workspace, 16 bytes a store;
//   2. dw_reduce.cuh (shared with tcgnn_spmm_dw.cu) sums the splits'
//      partials in split order.
// Every sum is taken in a fixed order, so the result is the same bits on
// every run, on any card.  The float32 path is float32 FMAs on the CUDA
// cores; bfloat16 inputs are widened as they are read from shared memory.
//
// Bound.  Each stored block of At, the X rows and the gathered G slices are
// read once and dW written once: at the main path's first layer (62826
// stored blocks, B = 16, Fi = 500, Fo = 16) about 105 MB, bound by bytes
// (0.0314 ms); over the diagonal (1233 blocks) 41 MB (0.0125 ms), nearly
// all of it X.  At 10 rows a split the main path's 1233 block rows make
// 124 CTAs, one wave over the 132 SMs, with 4 MB of partials.  Over the
// transpose payload phase a, 62826 blocks streamed by 8 warps an SM,
// takes most of the time.
//
// Limits.  B <= 64, any Fi >= 1 and Fo >= 1, K >= 1 (K = 1 when col_idx is
// null), rows_per * B * 64 B of Z in shared memory; at B = 16 and 10 rows a
// split the CTA takes 223 KB of shared memory (float32, Fi = 500).
#include <cstdint>
#include <type_traits>

#include "cp_async.cuh"
#include "dtype.cuh"
#include "dw_reduce.cuh"

namespace {

using repro_torch::align16;
using repro_torch::copy_rows;
using repro_torch::cp_commit;
using repro_torch::cp_wait;
using repro_torch::granule;
using repro_torch::ld4;
using repro_torch::to_f32;

inline int pow2_ceil(int v) {
  int p = 1;
  while (p < v) p <<= 1;
  return p;
}

// ---------------------------------------------------------------------------
// phase 1: one partial dW per (split, Fi tile, Fo tile)
// ---------------------------------------------------------------------------

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kFiT = 512;      // Fi columns of a CTA
constexpr int kFoT = 16;       // Fo columns of a CTA
constexpr int kAStages = 7;    // per-warp ring of phase a
constexpr int kXStages = 3;    // CTA ring of phase b
constexpr int kABytes = 132 * 1024;  // phase-a rings, about
constexpr int kXBytes = 34 * 1024;   // one phase-b stage, at most
constexpr int kMaxSmem = 227 * 1024;

struct Cfg {
  int rows_per;           // block rows per split
  int pw;                 // warps of phase a
  int npairs, lp;         // (row pair, 4-column) pieces of Z_i; lanes per
                          // piece
  int ap;                 // shared pitch of a block's rows (elements)
  int ga, gg, gx;         // granule bytes: block rows, G rows, X rows
  int a_gpr, g_gpr, x_gpr;  // granules per staged row
  float inv_a_gpr, inv_g_gpr, inv_x_gpr;
  int a_bytes, stage_bytes, warp_bytes;   // one phase-a stage: block, G
  int x_rows, xp, x_stage;  // X rows per stage, pitch (elements), bytes
  int agu, cgu, rs;       // phase-b layout: 4-row and 4-column groups of
                          // dW, row splits
  int vec_out;            // rows of the partial allow 16-byte stores
  int z_off, kn_off, a_off, red_off, x_off;
};

template <typename T, int PL>
__global__ void __launch_bounds__(kThreads)
    bell_dw_partial_kernel(const T* __restrict__ blocks,
                      const int* __restrict__ col_idx,
                      const int* __restrict__ n_valid,
                      const T* __restrict__ x, const T* __restrict__ g,
                      float* __restrict__ partial, int nbr, int K, int B,
                      int Fi, int Fo, int transpose, const Cfg c) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int split = blockIdx.x;
  const int fi0 = blockIdx.y * kFiT, fo0 = blockIdx.z * kFoT;
  const int fiw = min(kFiT, Fi - fi0), fow = min(kFoT, Fo - fo0);
  const int bp = (B + 3) & ~3;
  const bool diag = col_idx == nullptr;
  const int row0 = split * c.rows_per;
  const int row_end = min(nbr, row0 + c.rows_per);
  const int n_rows = (row_end - row0) * B;   // rows of X in this split
  float* z_s = reinterpret_cast<float*>(smem + c.z_off);   // (n_rows, 16)
  float* red = reinterpret_cast<float*>(smem + c.red_off);
  int* kn_s = reinterpret_cast<int*>(smem + c.kn_off);   // the rows' K_i
  unsigned char* x_ring = smem + c.x_off;

  // b's X stream: stage s holds rows [s x_rows, (s + 1) x_rows); in flight
  // while Z is formed
  const int n_xsteps = (n_rows + c.x_rows - 1) / c.x_rows;
  auto issue_x = [&](int s) {
    if (s < n_xsteps)
      copy_rows(reinterpret_cast<T*>(x_ring + (s % kXStages) * c.x_stage),
                c.xp,
                x + (static_cast<size_t>(row0) * B + s * c.x_rows) * Fi + fi0,
                Fi, fiw, min(c.x_rows, n_rows - s * c.x_rows), c.x_gpr,
                c.inv_x_gpr, c.gx, t, kThreads);
    cp_commit();
  };

  // a. Z_i = A_i^T G of every row i, rows without a block left at 0.  Warp
  // w < pw streams blocks through its own ring: of the blocked-ELL form the
  // slots k = w (mod pw) of every row, summed over the warps in warp order
  // at the row's end; of the diagonal form the rows i = w (mod pw).
  for (int e = t; e < n_rows * kFoT; e += kThreads) z_s[e] = 0.f;
  for (int r = t; r < row_end - row0; r += kThreads)
    kn_s[r] = diag ? 1
              : n_valid != nullptr ? min(n_valid[row0 + r], K)
                                   : K;
  const bool streams = warp < c.pw;
  unsigned char* mine = smem + c.a_off + warp * c.warp_bytes;
  if (streams) {   // rows B..bp of every stage's block and G stay zero
    for (int st = 0; st < kAStages; ++st) {
      T* sa = reinterpret_cast<T*>(mine + st * c.stage_bytes);
      T* sg = reinterpret_cast<T*>(mine + st * c.stage_bytes + c.a_bytes);
      for (int e = lane; e < (bp - B) * c.ap; e += 32)
        sa[B * c.ap + e] = repro_torch::from_f32<T>(0.f);
      for (int e = lane; e < (bp - B) * kFoT; e += 32)
        sg[B * kFoT + e] = repro_torch::from_f32<T>(0.f);
    }
  }
  __syncthreads();
  auto kn_of = [&](int r) { return kn_s[r - row0]; };
  // this warp's blocks of row r: its slots k = w (mod pw) (diagonal form:
  // the row's one block if the row is its own)
  auto mine_in = [&](int r) {
    return !streams ? 0
           : diag   ? ((r - row0) % c.pw == warp ? 1 : 0)
                    : max(0, (kn_of(r) - warp + c.pw - 1) / c.pw);
  };
  // issue cursor: row, index of this warp's block there, and that block's
  // column, loaded one block ahead so its latency is not on the copy's path
  int ir = row0, it = 0, next_src = 0;
  auto fetch = [&]() {
    while (ir < row_end && mine_in(ir) == 0) ++ir;
    if (ir < row_end)
      next_src = diag ? ir
                      : col_idx[static_cast<size_t>(ir) * K + warp +
                                it * c.pw];
  };
  auto issue_a = [&](int s) {
    if (ir < row_end) {
      unsigned char* st = mine + (s % kAStages) * c.stage_bytes;
      const int k = diag ? 0 : warp + it * c.pw;
      const int src = next_src;
      copy_rows(reinterpret_cast<T*>(st), c.ap,
                blocks + (static_cast<size_t>(ir) * K + k) * B * B, B, B, B,
                c.a_gpr, c.inv_a_gpr, c.ga, lane, 32);
      copy_rows(reinterpret_cast<T*>(st + c.a_bytes), kFoT,
                g + static_cast<size_t>(src) * B * Fo + fo0, Fo, fow, B,
                c.g_gpr, c.inv_g_gpr, c.gg, lane, 32);
      if (++it >= mine_in(ir)) {
        it = 0;
        ++ir;
      }
      fetch();
    }
    cp_commit();
  };

  // phase a's first blocks are committed before b's first X stages, so the
  // first waits below need not wait for X
  fetch();
  for (int s = 0; s < kAStages - 1; ++s) issue_a(s);
  for (int s = 0; s < kXStages - 1; ++s) issue_x(s);

  // lane pieces (rows 2 rp and 2 rp + 1, columns 4 c4..) of Z_i, and the
  // lane's share of j
  const int ncg = (min(kFoT, Fo) + 3) / 4;
  const int part = c.lp > 1 ? lane / c.npairs : 0;
  int pr[PL], pc[PL];
#pragma unroll
  for (int u = 0; u < PL; ++u) {
    const int pi = c.lp > 1 ? (u == 0 ? lane % c.npairs : c.npairs)
                            : lane + 32 * u;
    pr[u] = pi < c.npairs ? pi / ncg : B;   // B: no piece
    pc[u] = pi < c.npairs ? pi - pr[u] * ncg : 0;
  }
  float z4[PL][2][4];
#pragma unroll
  for (int u = 0; u < PL; ++u)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int n = 0; n < 4; ++n) z4[u][h][n] = 0.f;

  int consumed = 0;
  auto consume = [&]() {   // adds this warp's next staged block to z4
    if (consumed < kAStages - 1)   // X's first stages are younger
      cp_wait<kAStages - 2 + kXStages - 1>();
    else
      cp_wait<kAStages - 2>();
    __syncwarp();
    issue_a(consumed + kAStages - 1);
    const unsigned char* st = mine + (consumed % kAStages) * c.stage_bytes;
    const T* sa = reinterpret_cast<const T*>(st);
    const T* sg = reinterpret_cast<const T*>(st + c.a_bytes);
#pragma unroll
    for (int u = 0; u < PL; ++u) {
      if (pr[u] >= B) continue;
      const int r = 2 * pr[u];   // rows r, r + 1 (< bp: pad rows are 0)
      for (int j = 4 * part; j < bp; j += 4 * c.lp) {
        float a4[2][4];
        if (transpose) {
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            a4[0][q] = to_f32(sa[(j + q) * c.ap + r]);
            a4[1][q] = to_f32(sa[(j + q) * c.ap + r + 1]);
          }
        } else {
          ld4(sa + r * c.ap + j, a4[0]);
          ld4(sa + (r + 1) * c.ap + j, a4[1]);
        }
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          float g4[4];
          ld4(sg + (j + q) * kFoT + 4 * pc[u], g4);
#pragma unroll
          for (int h = 0; h < 2; ++h)
#pragma unroll
            for (int n = 0; n < 4; ++n)
              z4[u][h][n] = fmaf(a4[h][q], g4[n], z4[u][h][n]);
        }
      }
    }
    __syncwarp();
    ++consumed;
  };
  auto fold = [&]() {   // the lanes sharing a piece add their shares
    if (c.lp > 1)
      for (int o = c.npairs; o < 32; o <<= 1)
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int n = 0; n < 4; ++n)
            z4[0][h][n] += __shfl_xor_sync(0xffffffffu, z4[0][h][n], o);
  };
  // the piece's rows of Z_i (local row i) into dst (rows of 16 floats)
  auto put = [&](float* dst) {
#pragma unroll
    for (int u = 0; u < PL; ++u) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = 2 * pr[u] + h;
        if (pr[u] < B && r < B && part == 0)
          *reinterpret_cast<float4*>(dst + r * kFoT + 4 * pc[u]) =
              make_float4(z4[u][h][0], z4[u][h][1], z4[u][h][2],
                          z4[u][h][3]);
#pragma unroll
        for (int n = 0; n < 4; ++n) z4[u][h][n] = 0.f;
      }
    }
  };

  if (diag) {
    for (int r = row0 + warp; streams && r < row_end; r += c.pw) {
      consume();
      fold();
      put(z_s + (r - row0) * B * kFoT);
    }
  } else {
    for (int r = row0; r < row_end; ++r) {
      const int kn = kn_of(r);
      if (kn == 0) continue;   // uniform
      for (int m = mine_in(r); m > 0; --m) consume();
      fold();
      if (streams) put(red + warp * B * kFoT);
      __syncthreads();
      for (int o = t; o < B * 4 * ncg; o += kThreads) {
        const int rr = o / (4 * ncg), col = o - rr * 4 * ncg;
        float acc = 0.f;
        for (int w2 = 0; w2 < c.pw; ++w2)
          acc += red[(w2 * B + rr) * kFoT + col];
        z_s[((r - row0) * B + rr) * kFoT + col] = acc;
      }
      __syncthreads();
    }
  }
  cp_wait<0>();
  __syncthreads();

  // b. partial = X_run^T Z_run; thread t owns rows 4 (ag + v agu) + q of
  // the tile (v < 2, q < 4) by columns 4 cgb + n, over rows u = rs (mod RS)
  const int tb = c.cgu * c.agu;
  const int cgb = t % c.cgu, ag = (t / c.cgu) % c.agu, rs = t / tb;
  float acc[2][4][4];
#pragma unroll
  for (int v = 0; v < 2; ++v)
#pragma unroll
    for (int q = 0; q < 4; ++q)
#pragma unroll
      for (int n = 0; n < 4; ++n) acc[v][q][n] = 0.f;
  for (int s = 0; s < n_xsteps; ++s) {
    cp_wait<kXStages - 2>();
    __syncthreads();
    issue_x(s + kXStages - 1);
    const T* xs =
        reinterpret_cast<const T*>(x_ring + (s % kXStages) * c.x_stage);
    const float* zs = z_s + s * c.x_rows * kFoT + 4 * cgb;
    const int rows = min(c.x_rows, n_rows - s * c.x_rows);
#pragma unroll 2
    for (int u = rs; u < rows; u += c.rs) {
      const float4 zv = *reinterpret_cast<const float4*>(zs + u * kFoT);
      const float zn[4] = {zv.x, zv.y, zv.z, zv.w};
#pragma unroll
      for (int v = 0; v < 2; ++v) {
        float xv[4];
        ld4(xs + u * c.xp + 4 * (ag + v * c.agu), xv);
#pragma unroll
        for (int q = 0; q < 4; ++q)
#pragma unroll
          for (int n = 0; n < 4; ++n)
            acc[v][q][n] = fmaf(xv[q], zn[n], acc[v][q][n]);
      }
    }
  }
  cp_wait<0>();

  float* out = partial + static_cast<size_t>(split) * Fi * Fo;
  auto store = [&](int tile_b, int vi, float val) {
    const int cgo = tile_b % c.cgu, ago = tile_b / c.cgu;
    const int a = 4 * (ago + (vi >> 4) * c.agu) + ((vi >> 2) & 3);
    const int col = 4 * cgo + (vi & 3);
    if (a < fiw && col < fow)
      out[static_cast<size_t>(fi0 + a) * Fo + fo0 + col] = val;
  };
  if (c.rs == 1) {
    // 4 columns a store where the row of dW allows 16-byte stores
    const bool vec = c.vec_out && 4 * cgb + 4 <= fow;
#pragma unroll
    for (int v = 0; v < 2; ++v)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int a = 4 * (ag + v * c.agu) + q;
        if (vec && a < fiw) {
          *reinterpret_cast<float4*>(
              out + static_cast<size_t>(fi0 + a) * Fo + fo0 + 4 * cgb) =
              make_float4(acc[v][q][0], acc[v][q][1], acc[v][q][2],
                          acc[v][q][3]);
          continue;
        }
#pragma unroll
        for (int n = 0; n < 4; ++n) store(t, v * 16 + q * 4 + n, acc[v][q][n]);
      }
    return;
  }
  // row splits: sum their pieces in split order through shared memory
  __syncthreads();
  float* buf = reinterpret_cast<float*>(smem + c.a_off);   // 32 KB
#pragma unroll
  for (int v = 0; v < 2; ++v)
#pragma unroll
    for (int q = 0; q < 4; ++q)
      *reinterpret_cast<float4*>(buf + t * 32 + v * 16 + q * 4) =
          make_float4(acc[v][q][0], acc[v][q][1], acc[v][q][2], acc[v][q][3]);
  __syncthreads();
  for (int o = t; o < tb * 32; o += kThreads) {
    float val = 0.f;
    for (int k2 = 0; k2 < c.rs; ++k2) val += buf[k2 * tb * 32 + o];
    store(o >> 5, o & 31, val);
  }
}

template <typename T, int PL>
cudaError_t launch_pl(const void* blocks, const int* col_idx,
                      const int* n_valid, const void* x, const void* g,
                      float* partial, int nbr, int K, int B, int Fi, int Fo,
                      int transpose, const Cfg& c, int n_split, int smem,
                      cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      bell_dw_partial_kernel<T, PL>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(n_split, (Fi + kFiT - 1) / kFiT, (Fo + kFoT - 1) / kFoT);
  bell_dw_partial_kernel<T, PL><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(blocks), col_idx, n_valid,
      static_cast<const T*>(x), static_cast<const T*>(g), partial, nbr, K, B,
      Fi, Fo, transpose, c);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const void* blocks, const int* col_idx, const int* n_valid,
                   const void* x, const void* g, float* partial, float* dw,
                   int nbr, int K, int B, int Fi, int Fo, int rows_per,
                   int transpose, cudaStream_t stream) {
  constexpr int sz = sizeof(T);
  const int n_split = (nbr + rows_per - 1) / rows_per;
  if (n_split > 0) {
    Cfg c;
    c.rows_per = rows_per;
    const int bp = (B + 3) & ~3;
    const int fow = min(kFoT, Fo), fiw = min(kFiT, Fi);
    c.ga = granule(static_cast<long long>(B) * sz, blocks);
    c.gg = granule(static_cast<long long>(Fo) * sz, g);
    c.gx = granule(static_cast<long long>(Fi) * sz, x);
    const int a_cols = (bp * sz + c.ga - 1) / c.ga * c.ga / sz;
    c.ap = a_cols + 16 / sz;
    c.a_gpr = a_cols * sz / c.ga;
    c.g_gpr = (fow * sz + c.gg - 1) / c.gg;
    c.inv_a_gpr = 1.f / static_cast<float>(c.a_gpr);
    c.inv_g_gpr = 1.f / static_cast<float>(c.g_gpr);
    c.x_gpr = (fiw * sz + c.gx - 1) / c.gx;
    c.inv_x_gpr = 1.f / static_cast<float>(c.x_gpr);
    c.a_bytes = align16(bp * c.ap * sz);
    c.stage_bytes = c.a_bytes + align16(bp * kFoT * sz);
    c.warp_bytes = kAStages * c.stage_bytes;
    c.pw = max(1, min(kWarps, kABytes / c.warp_bytes));
    c.npairs = (B + 1) / 2 * ((fow + 3) / 4);
    const bool pow2 = (c.npairs & (c.npairs - 1)) == 0;
    c.lp = c.npairs < 32 && pow2 ? 32 / c.npairs : 1;
    const int per = c.lp > 1 ? 1 : (c.npairs + 31) / 32;
    c.agu = pow2_ceil((fiw + 7) / 8);
    c.cgu = pow2_ceil((fow + 3) / 4);
    c.rs = kThreads / (c.agu * c.cgu);
    c.xp = 8 * c.agu + 16 / sz;
    c.vec_out = Fo % 4 == 0 && reinterpret_cast<uintptr_t>(partial) % 16 == 0;
    // Z and the rows' K_i; the phase-a rings and the row sums of Z, which
    // (once phase b is done) hold the row splits' 32-float pieces; the X
    // ring
    c.z_off = 0;
    c.kn_off = align16(rows_per * B * kFoT * 4);
    c.a_off = c.kn_off + align16(rows_per * 4);
    const int red_bytes = c.pw * B * kFoT * 4;
    const int a_ring =
        max(c.pw * c.warp_bytes, kThreads * 32 * 4 - red_bytes);
    c.red_off = c.a_off + a_ring;
    c.x_off = c.red_off + align16(red_bytes);
    const int x_room = min(kXBytes, (kMaxSmem - c.x_off) / kXStages);
    c.x_rows = min(rows_per * B, max(1, x_room / (c.xp * sz)));
    c.x_stage = align16(c.x_rows * c.xp * sz);
    const int smem = c.x_off + kXStages * c.x_stage;
    if (smem > kMaxSmem) return cudaErrorInvalidValue;
    auto go = [&](auto kernel_pl) {
      return launch_pl<T, decltype(kernel_pl)::value>(
          blocks, col_idx, n_valid, x, g, partial, nbr, K, B, Fi, Fo,
          transpose, c, n_split, smem, stream);
    };
    const cudaError_t err =
        per <= 1   ? go(std::integral_constant<int, 1>{})
        : per <= 2 ? go(std::integral_constant<int, 2>{})
        : per <= 4 ? go(std::integral_constant<int, 4>{})
                   : go(std::integral_constant<int, 8>{});
    if (err != cudaSuccess) return err;
  }
  return repro_torch::launch_dw_reduce(partial, dw, n_split, Fi * Fo, stream);
}

}  // namespace

// Launches on `stream`; returns the cudaError_t of the launch (0 = success).
// blocks (nbr, K, B, B) of the transpose payload, col_idx (nbr, K) int32 or
// null (identity block columns, K = 1), n_valid (nbr,) int32 or null,
// x (nbr*B, Fi), g (n_cols, Fo), all of the element type `dtype`
// (0 = float32, 1 = bfloat16); partial (ceil(nbr / rows_per), Fi, Fo) and
// dw (Fi, Fo) float32.  All contiguous.  transpose != 0 reads each stored
// block transposed.
extern "C" int bell_spmm_dw_launch(const void* blocks, const void* col_idx,
                                   const void* n_valid, const void* x,
                                   const void* g, void* partial, void* dw,
                                   int nbr, int K, int B, int Fi, int Fo,
                                   int rows_per, int transpose, int dtype,
                                   void* stream) {
  if (Fi <= 0 || Fo <= 0) return 0;
  if (B < 1 || B > 64 || K < 1 || nbr < 0 || rows_per < 1 ||
      (col_idx == nullptr && K != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* ci = static_cast<const int*>(col_idx);
  const auto* nv = static_cast<const int*>(n_valid);
  auto* ps = static_cast<float*>(partial);
  auto* out = static_cast<float*>(dw);
  switch (dtype) {
    case repro_torch::kFloat32:
      return static_cast<int>(launch<float>(blocks, ci, nv, x, g, ps, out,
                                            nbr, K, B, Fi, Fo, rows_per,
                                            transpose, s));
    case repro_torch::kBFloat16:
      return static_cast<int>(launch<__nv_bfloat16>(
          blocks, ci, nv, x, g, ps, out, nbr, K, B, Fi, Fo, rows_per,
          transpose, s));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" const char* bell_spmm_dw_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
