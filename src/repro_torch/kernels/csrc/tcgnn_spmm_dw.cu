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
//   1. one CTA of 512 threads per (split, 512-column Fi tile, 16-column Fo
//      tile); split s owns the fixed block rows [s * rows_per, (s + 1) *
//      rows_per), a constant of the wrapper, never derived from the card.
//      The first three stages of X's rows are issued first (below), then
//      the CTA counts the real slots of all its rows in one pass of
//      batched float4 loads (tcgnn_real.cuh: one past the last tile column
//      with a non-zero).
//      a. Z_i = tiles_t[i] G[gather_idx_t[i]] (B, 16) for each of its rows
//         into shared memory, once per row (one CTA covers all of Fi up to
//         512).  Warp w takes the rows i = w (mod 10), so each of the main
//         path's 10 rows has its own warp, and walks only the real slots,
//         32 a stage, through its own 3-stage cp.async ring: the (B, 32)
//         tile slice and the 32 gathered rows of G, whose indices are loaded
//         two stages ahead (lane l holds slot l's) and passed by shuffle as
//         the copies are issued.  A lane keeps a 2-row x 4-column piece of
//         Z_i in registers (6 vector loads for 32 FMAs; at Fo = 3 four lanes
//         split a piece's slots and add their shares by shuffle).  One warp
//         forms a whole row, so no sum crosses warps here.
//      b. X_run^T Z_run: the run's rows of X (contiguous) come through a
//         6-stage ring, three stages of their own and three over phase a's
//         rings once Z is formed.  A thread owns 2 x 4 rows of dW by 4
//         columns and every other row of the run, and reads X and Z as
//         16-byte vectors: 32 FMAs for 3 loads.  The two halves of the run
//         (more where the tile has fewer outputs, as at Fi = 16, Fo = 3) are
//         summed in a fixed order through shared memory.
//      The CTA writes its partial to a workspace, 16 bytes a store;
//   2. dw_reduce.cuh sums the splits' partials in split order.
// float32 products are float32 FMAs on the CUDA cores; bfloat16 X and G are
// copied as they are and widened as they are read from shared memory.
// Skipping the padded slots changes the result only where a row of G that
// a padding slot names holds an infinity or a NaN (tcgnn_real.cuh).
//
// Bound.  At pubmed's transpose tier (nbr = 1233, B = 16, C = 128, 79356
// of 157824 slots real) and layer 1's widths (Fi = 500, Fo = 16) the
// function reads 10.1 MB of tiles_t, the 39.5 MB of X and G's rows, and
// writes dW: about 51.5 MB, bound by bytes (0.0154 ms).  The kernel also
// reads each tile twice (to count, then the real part from L2), gathers
// 5.1 MB of G rows from L2 and moves 124 splits x 32 KB of partials out and
// back.  At 10 rows a split the 1233 block rows make 124 CTAs, one wave
// over the 132 SMs, each streaming its 320 KB of X (4, 8 and 16 rows a
// split were slower).  On an NVIDIA H100 80GB HBM3 at 700 W
// (tools/port_kernels_bench.py, L2 flushed) it takes 0.050 ms at 500x16
// and 0.023 at 16x3 (x.T @ bmm(tiles_t, g[gather_idx_t]): 0.146 and
// 0.045).  Phase b's stream of X takes most of the time at 500x16, the
// count of real slots and phase a less; twice the threads a CTA did not
// shorten phase b.
//
// Limits.  B <= 64, any C, Fi, Fo >= 1.  Shared memory: Z (rows_per * B
// rows of 16 floats), the phase-a rings (at most 136 KB: fewer warps
// stream at large B) and the X ring's own stages, at most 34 KB each; 223
// KB at B = 16, 10 rows a split, Fi = 500 float32.
#include <cstdint>
#include <type_traits>

#include "cp_async.cuh"
#include "dtype.cuh"
#include "dw_reduce.cuh"
#include "tcgnn_real.cuh"

namespace {

using repro_torch::align16;
using repro_torch::copy_granule;
using repro_torch::copy_rows;
using repro_torch::cp_commit;
using repro_torch::cp_wait;
using repro_torch::granule;
using repro_torch::ld4;
using repro_torch::real_slots_rows;

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kFiT = 512;      // Fi columns of a CTA
constexpr int kFoT = 16;       // Fo columns of a CTA
constexpr int kCS = 32;        // slots a phase-a stage (one a lane)
constexpr int kTP = kCS + 4;   // pitch of a staged tile slice (floats)
constexpr int kAStages = 3;    // per-warp ring of phase a
constexpr int kXOwn = 3;       // CTA ring of phase b: stages of their own,
constexpr int kXStages = 6;    // then stages over phase a's rings
constexpr int kABytes = 136 * 1024;  // phase-a rings, at most
constexpr int kXBytes = 34 * 1024;   // one phase-b stage, at most
constexpr int kMaxSmem = 227 * 1024;

inline int pow2_ceil(int v) {
  int p = 1;
  while (p < v) p <<= 1;
  return p;
}

struct Cfg {
  int rows_per;           // block rows per split
  int pw;                 // warps of phase a
  int nrp, ncg, npieces;  // row pairs, 4-column groups, pieces of Z_i
  int lp;                 // lanes per piece (they split the slots)
  int gt, gg, gx;         // granule bytes: tile rows, G rows, X rows
  int t_gpr, g_gpr, x_gpr;  // granules per staged row
  float inv_t_gpr, inv_x_gpr;
  int vec;                // the tiles can be read as float4
  int t_bytes, stage_bytes, warp_bytes;   // one phase-a stage: tile, G
  int x_rows, xp, x_stage;  // X rows per stage, pitch (elements), bytes
  int n_off;              // the rows' counts of real slots
  int agu, cgu, rs;       // phase-b layout: 4-row and 4-column groups of
                          // dW, row splits
  int vec_out;            // rows of the partial allow 16-byte stores
  int z_off, meta_off, a_off, x_off;
};

template <typename T, int PL>
__global__ void __launch_bounds__(kThreads)
    tcgnn_dw_partial_kernel(const float* __restrict__ tiles,
                      const int* __restrict__ gather_idx,
                      const T* __restrict__ x, const T* __restrict__ g,
                      float* __restrict__ partial, int nbr, int B, int C,
                      int Fi, int Fo, const Cfg c) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int split = blockIdx.x;
  const int fi0 = blockIdx.y * kFiT, fo0 = blockIdx.z * kFoT;
  const int fiw = min(kFiT, Fi - fi0), fow = min(kFoT, Fo - fo0);
  const int row0 = split * c.rows_per;
  const int n_brows = min(nbr, row0 + c.rows_per) - row0;
  const int n_rows = n_brows * B;          // rows of X in this split
  float* z_s = reinterpret_cast<float*>(smem + c.z_off);   // (n_rows, 16)
  int4* meta = reinterpret_cast<int4*>(smem + c.meta_off);  // a stage's row
  int* n_s = reinterpret_cast<int*>(smem + c.n_off);

  // b's X stream: stage s holds rows [s x_rows, (s + 1) x_rows); the first
  // kXOwn stages are in flight while the rows are counted and Z is formed,
  // in a region of their own; the later slots lie over phase a's rings
  const int n_xsteps = (n_rows + c.x_rows - 1) / c.x_rows;
  auto x_slot = [&](int s) {
    const int k = s % kXStages;
    return smem + (k < kXOwn ? c.x_off + k * c.x_stage
                             : c.a_off + (k - kXOwn) * c.x_stage);
  };
  auto issue_x = [&](int s) {
    if (s < n_xsteps)
      copy_rows(reinterpret_cast<T*>(x_slot(s)), c.xp,
                x + (static_cast<size_t>(row0) * B + s * c.x_rows) * Fi + fi0,
                Fi, fiw, min(c.x_rows, n_rows - s * c.x_rows), c.x_gpr,
                c.inv_x_gpr, c.gx, t, kThreads);
    cp_commit();
  };

  // rows without a real slot keep Z_i = 0; what the phase-a copies never
  // write (rows and columns past B and Fo) stays zero
  for (int e = t; e < n_rows * kFoT; e += kThreads) z_s[e] = 0.f;
  const bool streams = warp < c.pw;
  unsigned char* mine = smem + c.a_off + warp * c.warp_bytes;
  if (streams)
    for (int e = lane; e < c.warp_bytes / 16; e += 32)
      reinterpret_cast<uint4*>(mine)[e] = make_uint4(0, 0, 0, 0);
  auto t_row = [&](int r) {
    return tiles + (static_cast<size_t>(row0) + r) * B * C;
  };
  // X's first stages go first: the count below reads with plain loads, and
  // every wait of phase a finds them older than its own stages
  for (int s = 0; s < kXOwn; ++s) issue_x(s);
  // every row's count of real slots, in one pass of the CTA (it syncs)
  real_slots_rows(t_row(0), n_brows, B, C, c.vec != 0, n_s);

  // a. this warp's stages: the real slots of its rows i = w (mod pw), 32 a
  // stage.  Cursor (ir, ic): split-local row and first slot of the next
  // stage to issue, (jr, jc) the one after; their gather indices (lane l:
  // slot ic + l, jc + l) are loaded two stages ahead of their copies
  auto skip = [&](int& r, int& cc) {   // to the next row with slots left
    while (r < n_brows && cc >= n_s[r]) {
      r += c.pw;
      cc = 0;
    }
  };
  auto load_gi = [&](int r, int cc) {
    return r < n_brows && cc + lane < n_s[r]
               ? __ldg(gather_idx + (static_cast<size_t>(row0) + r) * C + cc +
                       lane)
               : 0;
  };
  int ir = streams ? warp : n_brows, ic = 0;
  skip(ir, ic);
  int jr = ir, jc = ic + kCS;
  skip(jr, jc);
  int gnext = load_gi(ir, ic), gafter = load_gi(jr, jc);
  int issued = 0;
  auto issue_a = [&]() {
    if (ir < n_brows) {
      unsigned char* st = mine + (issued % kAStages) * c.stage_bytes;
      const int n_cur = n_s[ir];
      const int cw = min(kCS, n_cur - ic);
      copy_rows(reinterpret_cast<float*>(st), kTP, t_row(ir) + ic, C, cw, B,
                c.t_gpr, c.inv_t_gpr, c.gt, lane, 32);
      T* sg = reinterpret_cast<T*>(st + c.t_bytes);
      const int eg = c.gg / static_cast<int>(sizeof(T));
      for (int e0 = 0; e0 < kCS * c.g_gpr; e0 += 32) {   // uniform trips
        const int e = e0 + lane;
        const int j = e / c.g_gpr;
        const int src = __shfl_sync(0xffffffffu, gnext, j & 31);
        const int col = (e - j * c.g_gpr) * eg;
        const int bytes =
            j < cw ? max(0, min(c.gg, (fow - col) * static_cast<int>(
                                                       sizeof(T))))
                   : 0;
        if (e < kCS * c.g_gpr)
          copy_granule(sg + j * kFoT + col,
                       g + (bytes > 0 ? static_cast<size_t>(src) * Fo + fo0 +
                                            col
                                      : 0),
                       c.gg, bytes);
      }
      if (lane == 0)
        meta[warp * kAStages + issued % kAStages] =
            make_int4(ir, cw, ic + kCS >= n_cur, 0);
      ++issued;
      ir = jr;
      ic = jc;
      gnext = gafter;
      jc += kCS;
      skip(jr, jc);
      gafter = load_gi(jr, jc);
    }
    cp_commit();
  };

  for (int s = 0; s < kAStages - 1; ++s) issue_a();

  // lane pieces: rows pr and pr + nrp, columns 4 pc .. 4 pc + 3 of Z_i (pr
  // = nrp: no piece); with lp lanes a piece, lane share `part` takes the
  // slots j = 4 part + 4 lp m .. + 3
  const int part = c.lp > 1 ? lane / c.npieces : 0;
  int pr[PL], pc[PL];
#pragma unroll
  for (int u = 0; u < PL; ++u) {
    const int pi = c.lp > 1 ? lane % c.npieces : lane + 32 * u;
    pr[u] = pi < c.npieces ? pi / c.ncg : c.nrp;
    pc[u] = pi < c.npieces ? pi - pr[u] * c.ncg : 0;
  }
  float z4[PL][2][4];
#pragma unroll
  for (int u = 0; u < PL; ++u)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int n = 0; n < 4; ++n) z4[u][h][n] = 0.f;

  for (int consumed = 0; consumed < issued; ++consumed) {
    cp_wait<kAStages - 2>();
    __syncwarp();
    const int slot = consumed % kAStages;
    const int4 m = meta[warp * kAStages + slot];
    issue_a();
    const unsigned char* st = mine + slot * c.stage_bytes;
    const float* ts = reinterpret_cast<const float*>(st);
    const T* gs = reinterpret_cast<const T*>(st + c.t_bytes);
    const int cs4 = (m.y + 3) & ~3;
#pragma unroll
    for (int u = 0; u < PL; ++u) {
      if (pr[u] >= c.nrp) continue;
      const float* a0 = ts + pr[u] * kTP;
      const float* a1 = a0 + c.nrp * kTP;
      const T* gc = gs + 4 * pc[u];
#pragma unroll 2
      for (int j = 4 * part; j < cs4; j += 4 * c.lp) {
        float a4[2][4];
        ld4(a0 + j, a4[0]);
        ld4(a1 + j, a4[1]);
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          float g4[4];
          ld4(gc + (j + q) * kFoT, g4);
#pragma unroll
          for (int h = 0; h < 2; ++h)
#pragma unroll
            for (int n = 0; n < 4; ++n)
              z4[u][h][n] = fmaf(a4[h][q], g4[n], z4[u][h][n]);
        }
      }
    }
    if (m.z) {   // the row's last stage: Z_i to shared memory
      if (c.lp > 1)
        for (int o = c.npieces; o < 32; o <<= 1)
#pragma unroll
          for (int h = 0; h < 2; ++h)
#pragma unroll
            for (int n = 0; n < 4; ++n)
              z4[0][h][n] += __shfl_xor_sync(0xffffffffu, z4[0][h][n], o);
#pragma unroll
      for (int u = 0; u < PL; ++u) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = pr[u] + h * c.nrp;
          if (pr[u] < c.nrp && r < B && part == 0)
            *reinterpret_cast<float4*>(z_s + (m.x * B + r) * kFoT +
                                       4 * pc[u]) =
                make_float4(z4[u][h][0], z4[u][h][1], z4[u][h][2],
                            z4[u][h][3]);
#pragma unroll
          for (int n = 0; n < 4; ++n) z4[u][h][n] = 0.f;
        }
      }
    }
    __syncwarp();
  }
  cp_wait<0>();
  __syncthreads();
  for (int s = kXOwn; s < kXStages - 1; ++s) issue_x(s);   // over a's rings

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
    const T* xs = reinterpret_cast<const T*>(x_slot(s));
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

  // the row splits' pieces, summed in split order through shared memory
  // (over phase a's rings): a thread adds 4 columns of one row of the tile
  // and stores them, 16 bytes a store where the row of dW allows
  __syncthreads();
  float* buf = reinterpret_cast<float*>(smem + c.a_off);   // kThreads x 32
#pragma unroll
  for (int v = 0; v < 2; ++v)
#pragma unroll
    for (int q = 0; q < 4; ++q)
      *reinterpret_cast<float4*>(buf + t * 32 + v * 16 + q * 4) =
          make_float4(acc[v][q][0], acc[v][q][1], acc[v][q][2], acc[v][q][3]);
  __syncthreads();
  float* out = partial + static_cast<size_t>(split) * Fi * Fo;
  for (int o = t; o < tb * 8; o += kThreads) {
    const int tile_b = o >> 3, v = (o >> 2) & 1, q = o & 3;
    float4 sum = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int k2 = 0; k2 < c.rs; ++k2) {
      const float4 p4 = *reinterpret_cast<const float4*>(
          buf + (k2 * tb + tile_b) * 32 + v * 16 + q * 4);
      sum.x += p4.x;
      sum.y += p4.y;
      sum.z += p4.z;
      sum.w += p4.w;
    }
    const int a = 4 * (tile_b / c.cgu + v * c.agu) + q;
    const int col = 4 * (tile_b % c.cgu);
    if (a >= fiw || col >= fow) continue;
    float* dst = out + static_cast<size_t>(fi0 + a) * Fo + fo0 + col;
    if (c.vec_out && col + 4 <= fow) {
      *reinterpret_cast<float4*>(dst) = sum;
    } else {
      const float e4[4] = {sum.x, sum.y, sum.z, sum.w};
      for (int n = 0; n < 4 && col + n < fow; ++n) dst[n] = e4[n];
    }
  }
}

template <typename T>
cudaError_t launch(const float* tiles, const int* gather_idx, const void* x,
                   const void* g, float* partial, float* dw, int nbr, int B,
                   int C, int Fi, int Fo, int rows_per, cudaStream_t stream) {
  constexpr int sz = sizeof(T);
  const int n_split = (nbr + rows_per - 1) / rows_per;
  if (n_split > 0) {
    Cfg c;
    c.rows_per = rows_per;
    const int fow = min(kFoT, Fo), fiw = min(kFiT, Fi);
    c.nrp = (B + 1) / 2;
    c.ncg = (fow + 3) / 4;
    c.npieces = c.nrp * c.ncg;
    const bool pow2 = (c.npieces & (c.npieces - 1)) == 0;
    c.lp = c.npieces < 32 && pow2 ? 32 / c.npieces : 1;
    const int per = c.lp > 1 ? 1 : (c.npieces + 31) / 32;
    c.vec = C % 4 == 0 && reinterpret_cast<uintptr_t>(tiles) % 16 == 0;
    c.gt = granule(static_cast<long long>(C) * 4, tiles);
    c.gg = granule(static_cast<long long>(Fo) * sz, g);
    c.gx = granule(static_cast<long long>(Fi) * sz, x);
    c.t_gpr = kCS * 4 / c.gt;
    c.g_gpr = (fow * sz + c.gg - 1) / c.gg;
    c.x_gpr = (fiw * sz + c.gx - 1) / c.gx;
    c.inv_t_gpr = 1.f / static_cast<float>(c.t_gpr);
    c.inv_x_gpr = 1.f / static_cast<float>(c.x_gpr);
    c.t_bytes = align16(2 * c.nrp * kTP * 4);
    c.stage_bytes = c.t_bytes + align16(kCS * kFoT * sz);
    c.warp_bytes = kAStages * c.stage_bytes;
    c.pw = max(1, min(min(kWarps, rows_per), kABytes / c.warp_bytes));
    c.agu = pow2_ceil((fiw + 7) / 8);
    c.cgu = pow2_ceil((fow + 3) / 4);
    c.rs = kThreads / (c.agu * c.cgu);   // >= 2: agu <= 64, cgu <= 4
    c.xp = 8 * c.agu + 16 / sz;
    c.vec_out = Fo % 4 == 0 && reinterpret_cast<uintptr_t>(partial) % 16 == 0;
    // Z, the stages' rows, the phase-a rings (which, once phase b is done,
    // hold the row splits' 32-float pieces) and the X ring
    c.z_off = 0;
    c.meta_off = align16(rows_per * B * kFoT * 4);
    c.n_off = c.meta_off + align16(kWarps * kAStages * 16);
    c.a_off = c.n_off + align16(rows_per * 4);
    const int a_ring = max(c.pw * c.warp_bytes, kThreads * 32 * 4);
    c.x_off = c.a_off + a_ring;
    // kXOwn X stages fit the room left, the others the phase-a rings
    const int x_room = min(min(kXBytes, (kMaxSmem - c.x_off) / kXOwn),
                           a_ring / (kXStages - kXOwn));
    c.x_rows = min(rows_per * B, max(1, x_room / (c.xp * sz)));
    c.x_stage = align16(c.x_rows * c.xp * sz);
    const int smem = c.x_off + kXOwn * c.x_stage;
    if (c.x_stage * (kXStages - kXOwn) > a_ring)
      return cudaErrorInvalidValue;
    if (smem > kMaxSmem) return cudaErrorInvalidValue;
    auto go = [&](auto pl) -> cudaError_t {
      constexpr int kPL = decltype(pl)::value;
      cudaError_t err = cudaFuncSetAttribute(
          tcgnn_dw_partial_kernel<T, kPL>,
          cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      if (err != cudaSuccess) return err;
      const dim3 grid(n_split, (Fi + kFiT - 1) / kFiT, (Fo + kFoT - 1) / kFoT);
      tcgnn_dw_partial_kernel<T, kPL><<<grid, kThreads, smem, stream>>>(
          tiles, gather_idx, static_cast<const T*>(x),
          static_cast<const T*>(g), partial, nbr, B, C, Fi, Fo, c);
      return cudaGetLastError();
    };
    const cudaError_t err = per <= 1   ? go(std::integral_constant<int, 1>{})
                            : per <= 2 ? go(std::integral_constant<int, 2>{})
                                       : go(std::integral_constant<int, 4>{});
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
