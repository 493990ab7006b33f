// Dual-weight block-diagonal transform+aggregate on Hopper (SAGE's epilogue):
//   Y_b = A_b (X_b W) + X_b W_self (+ Y_in_b)   for every diagonal block b.
//
// Replaces the Pallas TPU kernel repro/kernels/block_diag_spmm_fused.py
// (block_diag_spmm_dual, _kernel_dual / _kernel_dual_acc).  As on the TPU,
// the diagonal tier's row block is its own source block, so both transforms
// come from one on-chip copy of the block's rows of X: H = X_b W stays on
// chip, and the self term S = X_b W_self is added straight into the output.
// Neither H nor S reaches device memory.
//
// Bound.  The function reads X, both weights and the blocks once and writes
// Y once, and does 4 n Fi Fo + 2 nb B B Fo flops.  At the main path's first
// SAGE layer (n = 19728, B = 16, Fi = 500, Fo = 16) that is about 42 MB and
// 0.64 GFLOP: 12.6 us of HBM against 9.6 us of float32 FMA, so bytes bound it
// by a small margin and the arithmetic is close behind: a kernel near its
// bound must stream X at full rate and keep the arithmetic units busy at the
// same time.  At the second layer (Fi = 16, Fo = 3) the 2.8 MB take 0.8 us,
// below the cost of one launch: there only latency counts.
//
// What the first design lost (0.0463 ms at 500x16, 0.0101 at 16x3 on an
// H100 at 700 W).  A CTA took 32 rows and restaged both weights for them:
// 617 CTAs read 39.5 MB of weights from L2, as many bytes as X.  Register
// fetch caps held a chunk to 32 columns of Fi (16 chunks, two barriers
// each), a thread's 1 x 4 tile of H and S cost 6 shared loads per 32 FMAs,
// and at 16x3 a CTA was 24 threads.
//
// Design.  The launch picks one of three kernels from the shape.
//  - Slab (Fo = 16, rows of X and the weights on 16-byte boundaries, B <=
//    32, two slabs and the weights in shared memory: layer 1).  One
//    persistent CTA of 16 warps an SM stages W and W_self once (two bulk
//    copies, 32 KB each at Fi = 500 float32) and walks row tiles of 32 rows
//    (32 / B diagonal blocks), tile i, i + grid, ...: 617 tiles over 132
//    CTAs at pubmed.  A tile's rows of X are one contiguous run (64 KB), so
//    bulk copies (TMA, 8 KB pieces) bring it and its blocks into one of two
//    slots on an mbarrier while the other slot is multiplied.  The warps are
//    2 m-tiles x 8 groups of Fi; each forms its 16 rows of [H | S] = X_b [W
//    | W_self] over its k-steps on the tensor cores (mma.sync m16n8k8,
//    float32 split into TF32 high and low parts, three MMAs a product:
//    mma_tf32.cuh; bfloat16 is exact in TF32).  The slab's pitch is Fi,
//    which at Fi = 500 puts an A fragment's 8 rows in distinct banks.  The
//    groups' partial sums then meet over the spent slab, are added in group
//    order (the same bits every run), and each thread applies the tile's
//    block to H, adds S (and Y_in, read ahead) and writes Y.
//  - Sliced (the other wide shapes).  The same warps and products, with X
//    streamed through a ring of up to 8 cp.async stages of 64 columns of
//    Fi, and the weights staged once where they fit, else a slice a stage.
//  - Narrow (Fi <= 32 and Fo <= 32: layer 2 and SAGE's 3-to-16 case).  A
//    warp owns a diagonal block; its block, its rows of X and of Y_in and
//    the CTA's weights are read once into shared memory as float32, the
//    block and X at odd pitches so a row group's lanes read distinct banks;
//    each lane forms H and S for its (row, column) pairs, then Y = A_b H + S
//    (+ Y_in): one load phase and two short loops.
//
// Measured (H100 80GB HBM3, 700 W, tools/port_kernels_bench.py): 0.033 ms
// at 500x16, 2.6 times the bound, and 0.0065 ms at 16x3, where one launch
// of a PyTorch fill of one float takes 0.0012 ms timed the same way.
// Phase timestamps taken while tuning: in the first tensor-core version the
// threads that issued the cp.async copies stalled as long as the products
// took, one after the other, which the bulk copies removed; the slab
// kernel's tiles now wait on their arithmetic and partial sums more than
// on the slab copies.
//
// Limits.  B <= 64, any Fi >= 1 and Fo >= 1.  Shared memory, slab: two
// slots of (32 x Fi + 8 elements, the blocks) and both weights, 192 KB at
// Fi = 500 float32; sliced: its ring (at least 2 stages) and the weights or
// their slices; narrow: the weights and, per warp, a block, its rows of X
// and Y_in, H and S, within 96 KB.
#include <cstdint>

#include "cp_async.cuh"
#include "dtype.cuh"
#include "mma_tf32.cuh"

namespace {

using repro_torch::align16;
using repro_torch::bulk_copy;
using repro_torch::copy_granule;
using repro_torch::copy_tile;
using repro_torch::cp_commit;
using repro_torch::cp_wait;
using repro_torch::from_f32;
using repro_torch::granule;
using repro_torch::mbar_expect_tx;
using repro_torch::mbar_init;
using repro_torch::mbar_wait;
using repro_torch::mma_3xtf32;
using repro_torch::mma_tf32;
using repro_torch::split_tf32;
using repro_torch::to_f32;

template <typename T>
struct Args {
  const T* blocks;
  const T* x;
  const T* w;
  const T* ws;
  const T* y_in;   // optional
  T* y;
  int nb, B, Fi, Fo;
};

// Lets `kernel` take `bytes` of dynamic shared memory, with the largest
// shared-memory carveout.
template <typename K>
cudaError_t set_smem(K* kernel, int bytes) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributePreferredSharedMemoryCarveout,
                              cudaSharedmemCarveoutMaxShared);
}

// ---------------------------------------------------------------------------
// shared by the wide kernels
// ---------------------------------------------------------------------------

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kFT = 16;          // Fo columns a CTA: H and S are 4 n-tiles
constexpr int kRP = 40;          // rows of the partial sums: H at 0, S at 16

int device_attr(cudaDeviceAttr attr) {
  int dev = 0, v = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&v, attr, dev) != cudaSuccess)
    return 0;
  return v;
}

// One k-step (8 columns of Fi) of a warp's 16 rows of [H | S]: the A
// fragment from X at xs (row pitch xp, column kk), the B fragments from the
// (k, 16) stripes of W and W_self at wb and sb (row kk), into acc[n] (n 0, 1
// H, n 2, 3 S).
template <typename T>
__device__ __forceinline__ void dual_kstep(float (&acc)[4][4], const T* xs,
                                           int xp, const T* wb, const T* sb,
                                           int kk, int g, int tq) {
  const float a0 = to_f32(xs[kk]), a1 = to_f32(xs[8 * xp + kk]);
  const float a2 = to_f32(xs[kk + 4]), a3 = to_f32(xs[8 * xp + kk + 4]);
  const T* wk = wb + (kk + tq) * kFT + g;
  const T* sk = sb + (kk + tq) * kFT + g;
  float b[4][2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    b[h][0] = to_f32(wk[8 * h]);
    b[h][1] = to_f32(wk[4 * kFT + 8 * h]);
    b[2 + h][0] = to_f32(sk[8 * h]);
    b[2 + h][1] = to_f32(sk[4 * kFT + 8 * h]);
  }
  if constexpr (sizeof(T) == 4) {
    uint32_t ah[4], al[4];
    split_tf32(a0, ah[0], al[0]);
    split_tf32(a1, ah[1], al[1]);
    split_tf32(a2, ah[2], al[2]);
    split_tf32(a3, ah[3], al[3]);
#pragma unroll
    for (int n = 0; n < 4; ++n) {
      uint32_t b0h, b0l, b1h, b1l;
      split_tf32(b[n][0], b0h, b0l);
      split_tf32(b[n][1], b1h, b1l);
      mma_3xtf32(acc[n], ah, al, b0h, b1h, b0l, b1l);
    }
  } else {   // bfloat16 operands are exact in TF32
    const uint32_t a[4] = {__float_as_uint(a0), __float_as_uint(a1),
                           __float_as_uint(a2), __float_as_uint(a3)};
#pragma unroll
    for (int n = 0; n < 4; ++n)
      mma_tf32(acc[n], a, __float_as_uint(b[n][0]),
               __float_as_uint(b[n][1]));
  }
}

// The end of a row tile: the warps' partial [H | S] (acc, rows 16 mw + g
// (+ 8) of column group kg) meet in red (kKG groups x rows x 40 floats) and
// are summed in group order; then Y = A_b H + S (+ Y_in, read ahead into
// yin) for the tile's R rows, A_b from as (rows x B).  Clears acc.
template <typename T, int kKG, int kRowsCap, int kThr>
__device__ __forceinline__ void dual_tile_end(
    float (&acc)[4][4], float* red, const T* as, const float* yin,
    const Args<T>& p, int b0, int R, int f0, int fw, int mw, int kg, int t,
    int g, int tq) {
  constexpr int kPer = kRowsCap * kFT / kThr;
  const int B = p.B;
  float* mine = red + (kg * kRowsCap + 16 * mw + g) * kRP + 2 * tq;
#pragma unroll
  for (int n = 0; n < 4; ++n) {
    *reinterpret_cast<float2*>(mine + 8 * n) =
        make_float2(acc[n][0], acc[n][1]);
    *reinterpret_cast<float2*>(mine + 8 * kRP + 8 * n) =
        make_float2(acc[n][2], acc[n][3]);
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  }
  __syncthreads();
  for (int e = t; e < R * 8; e += kThr) {
    const int o = (e >> 3) * kRP + 4 * (e & 7);
    float4 a = *reinterpret_cast<const float4*>(red + o);
#pragma unroll
    for (int q = 1; q < kKG; ++q) {
      const float4 b = *reinterpret_cast<const float4*>(
          red + q * kRowsCap * kRP + o);
      a.x += b.x;
      a.y += b.y;
      a.z += b.z;
      a.w += b.w;
    }
    *reinterpret_cast<float4*>(red + o) = a;
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int o = t + kThr * i, r = o >> 4, cc = o & 15;
    if (r >= R || cc >= fw) continue;
    const T* ar = as + r * B;
    const float* hb = red + (r / B) * B * kRP + cc;
    // four partial sums, added in a fixed order
    float q0 = 0.f, q1 = 0.f, q2 = 0.f, q3 = 0.f;
    int j = 0;
    for (; j + 4 <= B; j += 4) {
      q0 = fmaf(to_f32(ar[j]), hb[j * kRP], q0);
      q1 = fmaf(to_f32(ar[j + 1]), hb[(j + 1) * kRP], q1);
      q2 = fmaf(to_f32(ar[j + 2]), hb[(j + 2) * kRP], q2);
      q3 = fmaf(to_f32(ar[j + 3]), hb[(j + 3) * kRP], q3);
    }
    for (; j < B; ++j) q0 = fmaf(to_f32(ar[j]), hb[j * kRP], q0);
    const float y =
        red[r * kRP + kFT + cc] + ((q0 + q1) + (q2 + q3)) + yin[i];
    p.y[(static_cast<size_t>(b0) * B + r) * p.Fo + f0 + cc] = from_f32<T>(y);
  }
}

// Y_in of a thread's outputs o = t + kThr i (row o / 16, column o % 16) of
// the tile at block b0, or zeros.
template <int kThr, typename T, int kPer>
__device__ __forceinline__ void read_yin(float (&yin)[kPer], const Args<T>& p,
                                         int b0, int R, int f0, int fw,
                                         int t) {
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int o = t + kThr * i, r = o >> 4, cc = o & 15;
    yin[i] = p.y_in != nullptr && r < R && cc < fw
                 ? to_f32(p.y_in[(static_cast<size_t>(b0) * p.B + r) * p.Fo +
                                 f0 + cc])
                 : 0.f;
  }
}

// ---------------------------------------------------------------------------
// slab kernel (the main path: Fo = 16, rows of X and the weights on 16-byte
// boundaries, two slabs and the weights fit shared memory)
// ---------------------------------------------------------------------------

constexpr int kSlabRows = 32;       // rows a tile (32 / B diagonal blocks)
constexpr int kSlabThreads = 512;   // 2 m-tiles x 8 column groups of Fi

struct SlabCfg {
  int bpc, n_tiles;
  int nks;            // k-steps of Fi: ceil(Fi / 8)
  int w_rows;         // 8 nks
  int slab_bytes;     // a slot's X slab (32 rows of Fi, 8 elements of pad),
                      // and the tile's partial sums once it is spent
  int slot_bytes;     // the slab and the tile's blocks
  int w_bytes;        // one weight stripe
};

template <typename T>
__global__ void __launch_bounds__(kSlabThreads, 1)
    block_diag_dual_slab_kernel(const Args<T> p, const SlabCfg c) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ uint64_t full[3];     // the two slots', then the weights'
  constexpr int kSz = sizeof(T);
  constexpr int kKG = kSlabThreads / 64;   // column groups of 2 m-tiles
  constexpr int kPer = kSlabRows * kFT / kSlabThreads;
  const int t = threadIdx.x, warp = t >> 5, lane = t & 31;
  const int g = lane >> 2, tq = lane & 3;
  const int B = p.B, Fi = p.Fi;
  const int mw = warp & 1, kg = warp >> 1;
  T* w_s = reinterpret_cast<T*>(smem + 2 * c.slot_bytes);
  T* ws_s = reinterpret_cast<T*>(smem + 2 * c.slot_bytes + c.w_bytes);

  const int n_my = (c.n_tiles - 1 - blockIdx.x) / gridDim.x + 1;
  // tile m of this CTA into slot m % 2: its rows of X (one contiguous run,
  // in pieces of at most 8 KB so the copy engine keeps several in flight)
  // and its blocks by bulk copies; the 8 elements past the rows read as
  // zeros (the last k-step reads up to 7 past Fi)
  auto issue = [&](int m) {
    if (m >= n_my) return;
    unsigned char* st = smem + (m & 1) * c.slot_bytes;
    const int b0 = (blockIdx.x + m * gridDim.x) * c.bpc;
    const int R = min(c.bpc, p.nb - b0) * B;
    T* sx = reinterpret_cast<T*>(st);
#pragma unroll
    for (int e = 0; e < 8; ++e) sx[R * Fi + e] = from_f32<T>(0.f);
    mbar_expect_tx(&full[m & 1], R * (Fi + B) * kSz);
    const auto* src = reinterpret_cast<const unsigned char*>(
        p.x + static_cast<size_t>(b0) * B * Fi);
    const int n_bytes = R * Fi * kSz;
    for (int off = 0; off < n_bytes; off += 8192)
      bulk_copy(st + off, src + off, min(8192, n_bytes - off), &full[m & 1]);
    bulk_copy(st + c.slab_bytes, p.blocks + static_cast<size_t>(b0) * B * B,
              R * B * kSz, &full[m & 1]);
  };
  if (t == 0) {
    for (int i = 0; i < 3; ++i) mbar_init(&full[i], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    // W and W_self (Fo = 16: each one contiguous run), then the first two
    // tiles
    mbar_expect_tx(&full[2], 2 * Fi * kFT * kSz);
    bulk_copy(w_s, p.w, Fi * kFT * kSz, &full[2]);
    bulk_copy(ws_s, p.ws, Fi * kFT * kSz, &full[2]);
    issue(0);
    issue(1);
  }
  for (int e = Fi * kFT + t; e < c.w_rows * kFT; e += kSlabThreads)
    w_s[e] = ws_s[e] = from_f32<T>(0.f);
  __syncthreads();
  mbar_wait(&full[2], 0);

  // this warp's k-steps: group kg of the nks
  const int q = (c.nks + kKG - 1) / kKG;
  const int k_lo = kg * q, k_hi = min(c.nks, k_lo + q);
  float acc[4][4];
#pragma unroll
  for (int n = 0; n < 4; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  float yin[kPer];

  for (int m = 0; m < n_my; ++m) {
    const unsigned char* st = smem + (m & 1) * c.slot_bytes;
    const int b0 = (blockIdx.x + m * gridDim.x) * c.bpc;
    const int R = min(c.bpc, p.nb - b0) * B;
    read_yin<kSlabThreads>(yin, p, b0, R, 0, kFT, t);
    mbar_wait(&full[m & 1], (m >> 1) & 1);
    const T* xs = reinterpret_cast<const T*>(st) + (16 * mw + g) * Fi + tq;
#pragma unroll 2
    for (int ks = k_lo; ks < k_hi; ++ks)
      dual_kstep(acc, xs, Fi, w_s, ws_s, 8 * ks, g, tq);
    // the partial sums go over the spent slab
    __syncthreads();
    dual_tile_end<T, kKG, kSlabRows, kSlabThreads>(
        acc, reinterpret_cast<float*>(smem + (m & 1) * c.slot_bytes),
        reinterpret_cast<const T*>(st + c.slab_bytes), yin, p, b0, R, 0, kFT,
        mw, kg, t, g, tq);
    __syncthreads();   // the slot is free
    if (t == 0) issue(m + 2);
  }
}

// Whether the slab kernel takes these operands; fills its launch shape.
template <typename T>
bool slab_cfg(const Args<T>& p, int max_smem, SlabCfg* c, int* smem) {
  constexpr int sz = sizeof(T);
  auto al16 = [](const void* q) {
    return reinterpret_cast<uintptr_t>(q) % 16 == 0;
  };
  if (p.B > kSlabRows || p.Fo != kFT || (p.Fi * sz) % 16 != 0 ||
      (p.B * p.B * sz) % 16 != 0 || !al16(p.x) || !al16(p.w) ||
      !al16(p.ws) || !al16(p.blocks))
    return false;
  c->bpc = kSlabRows / p.B;
  c->n_tiles = (p.nb + c->bpc - 1) / c->bpc;
  c->nks = (p.Fi + 7) / 8;
  c->w_rows = 8 * c->nks;
  const int red_bytes = kSlabThreads / 64 * kSlabRows * kRP * 4;
  c->slab_bytes = align16((kSlabRows * p.Fi + 8) * sz);
  if (c->slab_bytes < red_bytes) c->slab_bytes = red_bytes;
  c->slot_bytes = c->slab_bytes + align16(kSlabRows * p.B * sz);
  c->w_bytes = align16(c->w_rows * kFT * sz);
  *smem = 2 * c->slot_bytes + 2 * c->w_bytes;
  return *smem <= max_smem;
}

template <typename T>
cudaError_t launch_slab(const Args<T>& p, const SlabCfg& c, int smem,
                        cudaStream_t stream) {
  const cudaError_t err = set_smem(block_diag_dual_slab_kernel<T>, smem);
  if (err != cudaSuccess) return err;
  int gx = device_attr(cudaDevAttrMultiProcessorCount);
  if (gx > c.n_tiles) gx = c.n_tiles;
  block_diag_dual_slab_kernel<T><<<gx, kSlabThreads, smem, stream>>>(p, c);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// sliced kernel (every other wide shape)
// ---------------------------------------------------------------------------

constexpr int kKC = 64;          // Fi columns a ring stage
constexpr int kMaxStages = 8;

// row pitch of a stage's X slice: 16 bytes of padding put the 8 rows of an
// A fragment in distinct banks
template <typename T>
__host__ __device__ constexpr int x_pitch() {
  return kKC + 16 / static_cast<int>(sizeof(T));
}

struct WideCfg {
  int bpc;           // blocks a row tile
  int n_tiles;
  int nkc;           // ring stages a tile: ceil(Fi / 64)
  int stages;        // ring depth
  int w_once;        // the weight stripes are staged once per CTA
  int w_rows;        // their rows (nkc * 64)
  int gx, gw, ga;    // cp.async granules of X, the weights and the blocks
  int x_bytes, a_bytes, stage_bytes, w_bytes;
};

// Waits until at most n (< kMaxStages) copy groups are in flight.
__device__ __forceinline__ void cp_wait_n(int n) {
  switch (n) {
    case 0: cp_wait<0>(); break;
    case 1: cp_wait<1>(); break;
    case 2: cp_wait<2>(); break;
    case 3: cp_wait<3>(); break;
    case 4: cp_wait<4>(); break;
    case 5: cp_wait<5>(); break;
    default: cp_wait<6>(); break;
  }
}

// kMW: 16-row m-tiles a row tile (2: 32 rows; 4: one block of up to 64
// rows); the 8 warps are kMW m-tiles x 8 / kMW groups of a stage's columns
template <typename T, int kMW>
__global__ void __launch_bounds__(kThreads, 1)
    block_diag_dual_wide_kernel(const Args<T> p, const WideCfg c) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int kSz = sizeof(T);
  constexpr int kXp = x_pitch<T>();
  constexpr int kKG = kWarps / kMW;        // column groups
  constexpr int kKS = kKC / 8 / kKG;       // k-steps a warp a stage
  constexpr int kRowsCap = 16 * kMW;
  constexpr int kPer = kRowsCap * kFT / kThreads;
  const int t = threadIdx.x, warp = t >> 5, lane = t & 31;
  const int g = lane >> 2, tq = lane & 3;
  const int B = p.B, Fi = p.Fi, Fo = p.Fo;
  const int f0 = blockIdx.y * kFT;
  const int fw = min(kFT, Fo - f0);
  const int mw = warp % kMW, kg = warp / kMW;
  // the (w_rows, 16) stripes of W and W_self, if once, and the partial sums
  T* w_s = reinterpret_cast<T*>(smem + c.stages * c.stage_bytes);
  T* ws_s = w_s + c.w_rows * kFT;
  float* red = reinterpret_cast<float*>(smem + c.stages * c.stage_bytes +
                                        c.w_bytes);   // (kKG, rows cap, 40)

  // rows [k0, k0 + n) of both stripes into dst and dst_s (pitch 16), zeros
  // past Fi and Fo
  const int w_gpr = kFT * kSz / c.gw;
  auto stage_w = [&](T* dst, T* dst_s, int k0, int n) {
    const int ew = c.gw / kSz;
    for (int e = t; e < n * 2 * w_gpr; e += kThreads) {
      const int r = e / (2 * w_gpr);
      const int rem = e - r * 2 * w_gpr;
      const int which = rem >= w_gpr;
      const int col = (rem - which * w_gpr) * ew;
      const int k = k0 + r;
      const int bytes = k < Fi ? max(0, min(c.gw, (fw - col) * kSz)) : 0;
      const T* src = which ? p.ws : p.w;
      copy_granule((which ? dst_s : dst) + r * kFT + col,
                   src + (bytes > 0 ? static_cast<size_t>(k) * Fo + f0 + col
                                    : 0),
                   c.gw, bytes);
    }
  };

  const int n_my = (c.n_tiles - 1 - blockIdx.x) / gridDim.x + 1;
  const int nsteps = n_my * c.nkc;
  if (c.w_once) stage_w(w_s, ws_s, 0, c.w_rows);   // joins the first group

  // the issue cursor: step i is slice i % nkc of this CTA's tile i / nkc
  int i_step = 0, i_kc = 0, i_tile = blockIdx.x, i_slot = 0;
  auto issue = [&]() {
    if (i_step < nsteps) {
      unsigned char* st = smem + i_slot * c.stage_bytes;
      const int b0 = i_tile * c.bpc;
      const int R = min(c.bpc, p.nb - b0) * B;
      const int k0 = i_kc * kKC;
      copy_tile<kXp>(reinterpret_cast<T*>(st),
                     p.x + static_cast<size_t>(b0) * B * Fi + k0, Fi,
                     min(kKC, Fi - k0), R, R, c.gx, t, kThreads);
      if (!c.w_once) {
        T* wst = reinterpret_cast<T*>(st + c.x_bytes + c.a_bytes);
        stage_w(wst, wst + kKC * kFT, k0, kKC);
      }
      if (i_kc == c.nkc - 1) {   // the tile's blocks: one contiguous run
        T* sa = reinterpret_cast<T*>(st + c.x_bytes);
        const T* a = p.blocks + static_cast<size_t>(b0) * B * B;
        const int ea = c.ga / kSz;
        for (int e = t; e < R * B / ea; e += kThreads)
          copy_granule(sa + e * ea, a + e * ea, c.ga, c.ga);
      }
      ++i_step;
      if (++i_slot == c.stages) i_slot = 0;
      if (++i_kc == c.nkc) {
        i_kc = 0;
        i_tile += gridDim.x;
      }
    }
    cp_commit();
  };
  for (int s = 0; s < c.stages - 1; ++s) issue();

  float acc[4][4];
#pragma unroll
  for (int n = 0; n < 4; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  float yin[kPer];

  int kc = 0, tile = blockIdx.x, slot = 0;
  for (int s = 0; s < nsteps; ++s) {
    cp_wait_n(c.stages - 2);
    __syncthreads();
    issue();
    const unsigned char* st = smem + slot * c.stage_bytes;
    if (++slot == c.stages) slot = 0;
    const int b0 = tile * c.bpc;
    const int R = min(c.bpc, p.nb - b0) * B;
    if (kc == c.nkc - 1) read_yin<kThreads>(yin, p, b0, R, f0, fw, t);
    const int k0 = kc * kKC;
    const int kv = min(kKC, Fi - k0);   // the slice's columns; zeros past
    const T* xs = reinterpret_cast<const T*>(st) + (16 * mw + g) * kXp + tq;
    const T* wb = c.w_once ? w_s + k0 * kFT
                           : reinterpret_cast<const T*>(st + c.x_bytes +
                                                        c.a_bytes);
    const T* sb = c.w_once ? ws_s + k0 * kFT : wb + kKC * kFT;
#pragma unroll
    for (int ks = 0; ks < kKS; ++ks) {
      const int kk = (kg * kKS + ks) * 8;
      if (kk < kv) dual_kstep(acc, xs, kXp, wb, sb, kk, g, tq);
    }
    if (++kc != c.nkc) continue;
    kc = 0;
    tile += gridDim.x;
    dual_tile_end<T, kKG, kRowsCap, kThreads>(
        acc, red, reinterpret_cast<const T*>(st + c.x_bytes), yin, p, b0, R,
        f0, fw, mw, kg, t, g, tq);
  }
  cp_wait<0>();
}

template <typename T, int kMW>
cudaError_t launch_wide(const Args<T>& p, int max_smem, cudaStream_t stream) {
  constexpr int sz = sizeof(T);
  constexpr int kRowsCap = 16 * kMW;
  WideCfg c;
  c.bpc = p.B <= 32 ? 32 / p.B : 1;
  c.n_tiles = (p.nb + c.bpc - 1) / c.bpc;
  c.nkc = (p.Fi + kKC - 1) / kKC;
  c.w_rows = c.nkc * kKC;
  c.gx = granule(static_cast<long long>(p.Fi) * sz, p.x);
  const int gw = granule(static_cast<long long>(p.Fo) * sz, p.w);
  const int gws = granule(static_cast<long long>(p.Fo) * sz, p.ws);
  c.gw = gw < gws ? gw : gws;
  c.ga = granule(static_cast<long long>(p.B) * p.B * sz, p.blocks);
  c.x_bytes = align16(kRowsCap * x_pitch<T>() * sz);
  c.a_bytes = align16(c.bpc * p.B * p.B * sz);
  const int red_bytes = kWarps / kMW * kRowsCap * kRP * 4;
  // the deepest ring (at least 3 stages) beside the weight stripes staged
  // once; else each stage carries a (64, 16) slice of both
  const int base = c.x_bytes + c.a_bytes;
  c.w_bytes = 2 * align16(c.w_rows * kFT * sz);
  c.stage_bytes = base;
  c.stages = (max_smem - c.w_bytes - red_bytes) / base;
  c.w_once = c.stages >= 3;
  if (!c.w_once) {
    c.w_bytes = 0;
    c.stage_bytes = base + 2 * align16(kKC * kFT * sz);
    c.stages = (max_smem - red_bytes) / c.stage_bytes;
  }
  if (c.stages > kMaxStages) c.stages = kMaxStages;
  if (c.stages < 2) return cudaErrorInvalidValue;
  const int smem = c.stages * c.stage_bytes + c.w_bytes + red_bytes;
  const cudaError_t err =
      set_smem(block_diag_dual_wide_kernel<T, kMW>, smem);
  if (err != cudaSuccess) return err;
  // one CTA an SM for each Fo tile, at most one a row tile
  const int n_ft = (p.Fo + kFT - 1) / kFT;
  int gx = device_attr(cudaDevAttrMultiProcessorCount) / n_ft;
  if (gx < 1) gx = 1;
  if (gx > c.n_tiles) gx = c.n_tiles;
  block_diag_dual_wide_kernel<T, kMW>
      <<<dim3(gx, n_ft), kThreads, smem, stream>>>(p, c);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// narrow kernel
// ---------------------------------------------------------------------------

constexpr int kNarrowMaxFi = 32;
constexpr int kNarrowMaxFo = 32;
constexpr int kNarrowWarps = 8;
constexpr int kNarrowSmem = 96 * 1024;

struct NarrowCfg {
  int nw;            // warps (diagonal blocks) a CTA
  int rb;            // row groups a warp: pow2 >= min(B, 32)
  int ap, xp;        // odd row pitches of the block and of X: B | 1, Fi | 1
  int warp_floats;   // a warp's shared floats
};

// A warp a diagonal block.  Its block, rows of X and of Y_in, H and S sit
// in shared memory as float32, the block and X at odd pitches, so the lanes
// of a row group read distinct banks; the weights are read by every lane
// of a column at once (a broadcast).
template <typename T>
__global__ void __launch_bounds__(kNarrowWarps * 32)
    block_diag_dual_narrow_kernel(const Args<T> p, const NarrowCfg c) {
  extern __shared__ __align__(16) float fsm[];
  const int t = threadIdx.x, warp = t >> 5, lane = t & 31;
  const int B = p.B, Fi = p.Fi, Fo = p.Fo;
  const int nwt = c.nw * 32;
  float* w_s = fsm;                        // (Fi, Fo)
  float* ws_s = w_s + Fi * Fo;             // (Fi, Fo)
  float* base = ws_s + Fi * Fo + warp * c.warp_floats;
  float* a_s = base;                       // (B, ap)
  float* x_s = a_s + B * c.ap;             // (B, xp)
  float* h_s = x_s + B * c.xp;             // (B, Fo)
  float* s_s = h_s + B * Fo;               // (B, Fo)
  float* yi_s = s_s + B * Fo;              // (B, Fo)
  const int b = blockIdx.x * c.nw + warp;
  const bool live = b < p.nb;

  // every operand as float32 into shared memory, 8 loads in flight a lane
  for (int e = t; e < Fi * Fo; e += nwt) {
    w_s[e] = to_f32(__ldg(p.w + e));
    ws_s[e] = to_f32(__ldg(p.ws + e));
  }
  if (live) {
    const T* ab = p.blocks + static_cast<size_t>(b) * B * B;
    const T* xb = p.x + static_cast<size_t>(b) * B * Fi;
#pragma unroll 8
    for (int e = lane; e < B * B; e += 32) {
      const int r = e / B;
      a_s[e + r * (c.ap - B)] = to_f32(__ldg(ab + e));
    }
#pragma unroll 8
    for (int e = lane; e < B * Fi; e += 32) {
      const int r = e / Fi;
      x_s[e + r * (c.xp - Fi)] = to_f32(__ldg(xb + e));
    }
    if (p.y_in != nullptr) {
      const T* yb = p.y_in + static_cast<size_t>(b) * B * Fo;
#pragma unroll 4
      for (int e = lane; e < B * Fo; e += 32) yi_s[e] = to_f32(__ldg(yb + e));
    }
  }
  __syncthreads();
  if (!live) return;

  // lane = (column group, row group): rows rg, rg + rb, ..., columns cg,
  // cg + 32 / rb, ...
  const int rg = lane & (c.rb - 1), cg = lane / c.rb, nc = 32 / c.rb;
  for (int r = rg; r < B; r += c.rb) {
    const float* xr = x_s + r * c.xp;
    for (int col = cg; col < Fo; col += nc) {
      float hv = 0.f, sv = 0.f;
#pragma unroll 4
      for (int k = 0; k < Fi; ++k) {
        hv = fmaf(xr[k], w_s[k * Fo + col], hv);
        sv = fmaf(xr[k], ws_s[k * Fo + col], sv);
      }
      h_s[r * Fo + col] = hv;
      s_s[r * Fo + col] = sv;
    }
  }
  __syncwarp();
  const size_t y0 = static_cast<size_t>(b) * B * Fo;
  for (int r = rg; r < B; r += c.rb) {
    const float* ar = a_s + r * c.ap;
    for (int col = cg; col < Fo; col += nc) {
      float acc = s_s[r * Fo + col];
      if (p.y_in != nullptr) acc += yi_s[r * Fo + col];
      float q0 = 0.f, q1 = 0.f;
      int j = 0;
      for (; j + 2 <= B; j += 2) {
        q0 = fmaf(ar[j], h_s[j * Fo + col], q0);
        q1 = fmaf(ar[j + 1], h_s[(j + 1) * Fo + col], q1);
      }
      if (j < B) q0 = fmaf(ar[j], h_s[j * Fo + col], q0);
      p.y[y0 + r * Fo + col] = from_f32<T>(acc + (q0 + q1));
    }
  }
}

// Whether the narrow kernel takes these widths; fills its launch shape.
template <typename T>
bool narrow_cfg(const Args<T>& p, NarrowCfg* c) {
  if (p.Fi > kNarrowMaxFi || p.Fo > kNarrowMaxFo) return false;
  c->rb = 1;
  while (c->rb < p.B && c->rb < 32) c->rb <<= 1;
  c->ap = p.B | 1;
  c->xp = p.Fi | 1;
  c->warp_floats = (p.B * c->ap + p.B * c->xp + 3 * p.B * p.Fo + 3) & ~3;
  const int w_floats = 2 * p.Fi * p.Fo;
  c->nw = (kNarrowSmem / 4 - w_floats) / c->warp_floats;
  if (c->nw > kNarrowWarps) c->nw = kNarrowWarps;
  return c->nw >= 1;
}

template <typename T>
cudaError_t launch_narrow(const Args<T>& p, const NarrowCfg& c,
                          cudaStream_t stream) {
  const int smem = (2 * p.Fi * p.Fo + c.nw * c.warp_floats) * 4;
  const cudaError_t err = set_smem(block_diag_dual_narrow_kernel<T>, smem);
  if (err != cudaSuccess) return err;
  block_diag_dual_narrow_kernel<T>
      <<<(p.nb + c.nw - 1) / c.nw, c.nw * 32, smem, stream>>>(p, c);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const Args<T>& p, cudaStream_t stream) {
  NarrowCfg nc;
  if (narrow_cfg(p, &nc)) return launch_narrow(p, nc, stream);
  const int max_smem = device_attr(cudaDevAttrMaxSharedMemoryPerBlockOptin);
  SlabCfg sc;
  int smem = 0;
  if (slab_cfg(p, max_smem, &sc, &smem))
    return launch_slab(p, sc, smem, stream);
  return p.B <= 32 ? launch_wide<T, 2>(p, max_smem, stream)
                   : launch_wide<T, 4>(p, max_smem, stream);
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
    case repro_torch::kFloat32: {
      using T = float;
      const Args<T> p{static_cast<const T*>(blocks), static_cast<const T*>(x),
                      static_cast<const T*>(w), static_cast<const T*>(w_self),
                      static_cast<const T*>(y_in), static_cast<T*>(y),
                      nb, B, Fi, Fo};
      return static_cast<int>(launch(p, s));
    }
    case repro_torch::kBFloat16: {
      using T = __nv_bfloat16;
      const Args<T> p{static_cast<const T*>(blocks), static_cast<const T*>(x),
                      static_cast<const T*>(w), static_cast<const T*>(w_self),
                      static_cast<const T*>(y_in), static_cast<T*>(y),
                      nb, B, Fi, Fo};
      return static_cast<int>(launch(p, s));
    }
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" const char* block_diag_spmm_dual_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
