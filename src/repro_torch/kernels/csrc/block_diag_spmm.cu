// Block-diagonal SpMM on Hopper: Y = blockdiag(A_1 .. A_nb) X (+ Y_in), or
// with the transposed-read flag Y = blockdiag(A_1^T .. A_nb^T) X (+ Y_in).
//
// Replaces the Pallas TPU kernel repro/kernels/block_diag_spmm.py
// (block_diag_spmm, _kernel / _kernel_acc): the intra-community tier of the
// AdaptGear decomposition, one dense (B, B) adjacency block per community.
//
// Bound.  Every input element is read once and every output written once;
// the arithmetic (2 nb B^2 F flops) is nothing beside the bytes.  At the
// main path's shapes (pubmed: nb = 1233 blocks of B = 16, 19728 rows) the
// forward at F = 16 moves 3.8 MB (1.1 us at 3.35 TB/s) and at F = 3 1.7 MB
// (0.5 us): less than a wave of loads can keep in flight, so the kernel is
// bound by latency, and a design near its bound must ask for all of its
// bytes at once, in wide requests, and spend few instructions after they
// land.  Tensor cores would not help: float32 inputs keep full float32
// products, and the products take 0.15 us of the CUDA cores.
//
// What the first design lost (0.0050 ms at F = 16 and 0.0048 at F = 3 on
// an H100 at 700 W).  A 256-thread CTA per (block, 64 columns): 1233 CTAs
// in two waves, each a chain of 4-byte loads, a barrier, the products and
// 4-byte stores; the transposed read gathered the block 64 bytes apart.
//
// Design.  A block's rows of X are one contiguous run of B * F elements,
// whatever F is (1 KB at F = 16, 192 bytes at F = 3), and so are its block
// (B * B), its rows of Y and of Y_in.  Every run is read and written as
// 16-byte vectors (4 float32 or 8 bfloat16 values), with 2- or 4-byte
// elements at an edge where the run's start or end is not on a 16-byte
// boundary; there is no route by F.
//  - Warp kernel (B <= 32 and F <= 64: the main path, forward and
//    backward).  A warp owns a block, 4 warps a CTA, so pubmed's 1233
//    blocks are one resident wave on 132 SMs.  B = 8, 16 and 32 are
//    compiled as constants (the products unroll fully), other B at run
//    time.  Each lane issues its loads of the block, X and Y_in (up to 4
//    vectors of each a round; one round at the main path's shapes) before
//    it uses any, then widens them to float32 in the warp's own shared
//    staging: the block at a pitch of round4(B) + 4 floats (distinct banks
//    for the 8 rows a warp instruction reads), transposed there for the
//    transposed read, so that read costs the same bytes as the plain one.
//    After a __syncwarp (no CTA barrier) each lane owns 16-byte pieces of
//    Y and forms their values as float32 FMA chains over j in a fixed
//    order (the same bits on every call, and whichever of the 4-wide or
//    the element path forms a value): where F % 4 == 0 a quad of outputs
//    reads a 16-byte vector of X and of the block's row per 4 products.
//  - Tile kernel (B > 32 or F > 64).  A 256-thread CTA per (block, 64
//    columns), with the same staging, products and 16-byte stores; a
//    tile's rows of X, Y_in and Y are B runs of up to 64 elements F apart
//    (one run where the tile spans all of F), cut into slots (a vector or
//    an edge element) that the threads share, 8 loads in flight a thread.
//  - Y_in may be a full (nb * B, F) array (row stride F) or one row of F
//    values repeated (row stride 0: the GCN bias, as bias.expand(n, F)
//    gives, read as F values instead of an (n, F) copy).
//
// Measured (H100 80GB HBM3 at 700 W, CUDA graph, L2 flushed;
// tools/port_kernels_bench.py, chip_smoke.py): about 0.004 ms at F = 16
// and at F = 3 for the forward, the transposed read and the bias row
// alike, where the first design took 0.0054 and 0.0045 in turns, and one
// elementwise pass over the forward's bytes at F = 16 (torch.add of the
// blocks and X) takes 0.0029-0.0037 ms and one launch 0.0010-0.0012 timed
// the same way: what is left is one round of cold loads and the launch,
// not the bytes.  While tuning, variants that kept no product, or formed
// two rows of a lane's columns at a time (half the shared reads), showed
// that the products cost a few tenths of a microsecond after the loads
// land and that halving their shared reads did not show through the
// spread, so the simpler product stays.
//
// Limits.  B <= 64, any F >= 1.  Shared memory, warp kernel: per warp the
// block (B x (round4(B) + 4) floats), its rows of X and of Y_in, 84 KB a
// CTA at B = 32, F = 64; tile kernel: the block and two 64-column tiles, 49
// KB at B = 64.
#include <cstdint>

#include "dtype.cuh"

namespace {

using repro_torch::from_f32;
using repro_torch::Vec16;

constexpr int kWarpMaxB = 32;
constexpr int kWarpMaxF = 64;
constexpr int kWarpsPerCta = 4;
constexpr int kRound = 4;       // vectors of each run a lane loads a round
constexpr int kTileThreads = 256;
constexpr int kTileF = 64;      // columns a tile-kernel CTA takes
constexpr int kSlots = 8;       // slots a tile-kernel thread loads a round
constexpr int kDefaultSmem = 48 * 1024;

template <typename T>
struct Args {
  const T* blocks;
  const T* x;
  const T* y_in;  // optional
  T* y;
  int nb, B, F;
  int yin_ld;     // Y_in's row stride: F, or 0 for one repeated row
};

// ---------------------------------------------------------------------------
// runs, loads and stores
// ---------------------------------------------------------------------------

// Elements of a run at p before its first 16-byte boundary.
template <typename T>
__device__ __forceinline__ int head_of(const T* p, int len) {
  const int mis =
      static_cast<int>((reinterpret_cast<uintptr_t>(p) & 15) / sizeof(T));
  return mis == 0 ? 0 : min(len, Vec16<T>::kN - mis);
}

// A contiguous run of len elements at p: `head` elements before its first
// 16-byte boundary, then `nvec` 16-byte vectors, then the tail; `nscal`
// edge elements (head and tail, at most 2V - 2) in all.
template <typename T>
struct Run {
  const T* p;
  int head, nvec, nscal;
  __device__ __forceinline__ Run(const T* p_, int len) : p(p_) {
    head = head_of(p_, len);
    nvec = (len - head) / Vec16<T>::kN;
    nscal = len - nvec * Vec16<T>::kN;
  }
  // first element of vector k, and the element of edge slot j
  __device__ __forceinline__ int vec(int k) const {
    return head + k * Vec16<T>::kN;
  }
  __device__ __forceinline__ int edge(int j) const {
    return j < head ? j : head + nvec * Vec16<T>::kN + (j - head);
  }
};

// The raw bits of a vector (width V) or of one element (width 1).
template <typename T>
__device__ __forceinline__ uint4 load_raw(const T* p, int width) {
  uint4 v = make_uint4(0u, 0u, 0u, 0u);
  if (width == Vec16<T>::kN) {
    v = __ldg(reinterpret_cast<const uint4*>(p));
  } else if constexpr (sizeof(T) == 4) {
    v.x = __ldg(reinterpret_cast<const unsigned*>(p));
  } else {
    v.x = __ldg(reinterpret_cast<const unsigned short*>(p));
  }
  return v;
}

// Element t of raw bits as float32 (bfloat16 widens exactly).
template <typename T>
__device__ __forceinline__ float widen(const uint4& v, int t) {
  const unsigned w[4] = {v.x, v.y, v.z, v.w};
  if constexpr (sizeof(T) == 4) {
    return __uint_as_float(w[t]);
  } else {
    const unsigned u = w[t >> 1];
    return __uint_as_float((t & 1) ? (u & 0xffff0000u) : (u << 16));
  }
}

template <typename T>
__device__ __forceinline__ void store_vec(T* p, const float* v) {
  if constexpr (sizeof(T) == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
    uint4 u;
    unsigned* w = reinterpret_cast<unsigned*>(&u);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const __nv_bfloat162 h = __floats2bfloat162_rn(v[2 * k], v[2 * k + 1]);
      w[k] = *reinterpret_cast<const unsigned*>(&h);
    }
    *reinterpret_cast<uint4*>(p) = u;
  }
}

// Element e of a block (row-major, B x B) into its staging at pitch P,
// transposed for the transposed read.
template <bool kTrans>
__device__ __forceinline__ void put_block(float* a_s, int B, int P, int e,
                                          float v) {
  const int r = e / B, c = e - r * B;
  a_s[kTrans ? c * P + r : r * P + c] = v;
}

// ---------------------------------------------------------------------------
// staging layout and products
// ---------------------------------------------------------------------------

__host__ __device__ __forceinline__ constexpr int round4(int n) {
  return (n + 3) & ~3;
}
__host__ __device__ __forceinline__ constexpr int block_pitch(int B) {
  return round4(B) + 4;
}
// X's staging pitch for a tile of fw of F columns: F where the tile spans
// all of F (its rows are one run), else fw rounded up to 4.
__host__ __device__ __forceinline__ int x_pitch(int fw, int F) {
  return fw == F ? F : round4(fw);
}
// Floats of shared staging one block (or tile) of width fw takes.
__host__ __device__ __forceinline__ int staged_floats(int B, int fw, int F,
                                                      bool y_in, int yin_ld) {
  const int xp = x_pitch(fw, F);
  return B * block_pitch(B) + round4(B * xp) +
         (y_in ? round4(yin_ld == 0 ? fw : B * xp) : 0);
}

// The staged operands of one block (or tile): the block's rows at pitch P
// (already transposed for the transposed read), X at pitch xp, Y_in at
// pitch yp (0: one repeated row) or none.
struct Staged {
  const float* a;
  const float* x;
  const float* yi;  // null without Y_in
  int P, xp, yp, B;
};

// Y[r, c] = sum_j A[r, j] X[j, c] (+ Y_in[r, c]): one float32 FMA chain
// over j = 0 .. B-1, then Y_in + the sum, as out4 forms it.  kB: B as a
// constant, or 0 to read it from s.
template <int kB>
__device__ __forceinline__ float out1(const Staged& s, int r, int c) {
  const int B = kB > 0 ? kB : s.B;
  const float* ar = s.a + r * s.P;
  const float* xc = s.x + c;
  float acc = 0.f;
  int j = 0;
#pragma unroll
  for (; j + 4 <= B; j += 4) {
    const float4 a = *reinterpret_cast<const float4*>(ar + j);
    acc = fmaf(a.x, xc[j * s.xp], acc);
    acc = fmaf(a.y, xc[(j + 1) * s.xp], acc);
    acc = fmaf(a.z, xc[(j + 2) * s.xp], acc);
    acc = fmaf(a.w, xc[(j + 3) * s.xp], acc);
  }
  for (; j < B; ++j) acc = fmaf(ar[j], xc[j * s.xp], acc);
  return s.yi != nullptr ? s.yi[r * s.yp + c] + acc : acc;
}

// Y[r, c .. c+3], with c % 4 == 0 and xp % 4 == 0: the same chains as out1,
// reading 16-byte vectors of X, the block's row and Y_in.
template <int kB>
__device__ __forceinline__ float4 out4(const Staged& s, int r, int c) {
  const int B = kB > 0 ? kB : s.B;
  const float* ar = s.a + r * s.P;
  const float* xc = s.x + c;
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  const auto step = [&](float a, int j) {
    const float4 v = *reinterpret_cast<const float4*>(xc + j * s.xp);
    acc.x = fmaf(a, v.x, acc.x);
    acc.y = fmaf(a, v.y, acc.y);
    acc.z = fmaf(a, v.z, acc.z);
    acc.w = fmaf(a, v.w, acc.w);
  };
  int j = 0;
#pragma unroll
  for (; j + 4 <= B; j += 4) {
    const float4 a = *reinterpret_cast<const float4*>(ar + j);
    step(a.x, j);
    step(a.y, j + 1);
    step(a.z, j + 2);
    step(a.w, j + 3);
  }
  for (; j < B; ++j) step(ar[j], j);
  if (s.yi != nullptr) {
    const float4 v = *reinterpret_cast<const float4*>(s.yi + r * s.yp + c);
    acc = make_float4(v.x + acc.x, v.y + acc.y, v.z + acc.z, v.w + acc.w);
  }
  return acc;
}

// Four outputs from element e of a tile fw columns wide (Y[e / fw, e %
// fw] ..), as one quad where they share a row and a 16-byte boundary.
template <int kB>
__device__ __forceinline__ void out_quad(const Staged& s, int e, int fw,
                                         float* v) {
  const int r = e / fw, c = e - r * fw;
  if (s.xp % 4 == 0 && c % 4 == 0 && c + 4 <= fw) {
    const float4 o = out4<kB>(s, r, c);
    v[0] = o.x;
    v[1] = o.y;
    v[2] = o.z;
    v[3] = o.w;
  } else {
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      const int rt = (e + t) / fw;
      v[t] = out1<kB>(s, rt, e + t - rt * fw);
    }
  }
}

// ---------------------------------------------------------------------------
// warp kernel: a warp a block (B <= 32, F <= 64)
// ---------------------------------------------------------------------------

template <typename T, int kB, bool kTrans>
__global__ void __launch_bounds__(kWarpsPerCta * 32)
    block_diag_kernel_warp(const Args<T> p, int warp_floats) {
  extern __shared__ __align__(16) float smem[];
  constexpr int V = Vec16<T>::kN;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int blk = blockIdx.x * kWarpsPerCta + warp;
  if (blk >= p.nb) return;
  const int B = kB > 0 ? kB : p.B, F = p.F;
  const int P = block_pitch(B);
  const long long row0 = static_cast<long long>(blk) * B;
  float* a_s = smem + warp * warp_floats;
  float* x_s = a_s + B * P;
  float* y_s = x_s + round4(B * F);

  const Run<T> ra(p.blocks + row0 * B, B * B);
  const Run<T> rx(p.x + row0 * F, B * F);
  const bool y_in = p.y_in != nullptr;
  const Run<T> ry(y_in ? p.y_in + row0 * p.yin_ld : p.x,
                  y_in ? (p.yin_ld == 0 ? F : B * F) : 0);

  // every load of a round issued before any is used; round 0 also takes
  // each run's edge elements (fewer than 32 a run)
  const int nv = max(ra.nvec, max(rx.nvec, ry.nvec));
  for (int k0 = 0; k0 == 0 || k0 < nv; k0 += 32 * kRound) {
    uint4 va[kRound], vx[kRound], vy[kRound];
#pragma unroll
    for (int i = 0; i < kRound; ++i) {
      const int k = k0 + 32 * i + lane;
      if (k < ra.nvec) va[i] = load_raw(ra.p + ra.vec(k), V);
      if (k < rx.nvec) vx[i] = load_raw(rx.p + rx.vec(k), V);
      if (k < ry.nvec) vy[i] = load_raw(ry.p + ry.vec(k), V);
    }
    uint4 ea = {}, ex = {}, ey = {};
    if (k0 == 0) {
      if (lane < ra.nscal) ea = load_raw(ra.p + ra.edge(lane), 1);
      if (lane < rx.nscal) ex = load_raw(rx.p + rx.edge(lane), 1);
      if (lane < ry.nscal) ey = load_raw(ry.p + ry.edge(lane), 1);
    }
#pragma unroll
    for (int i = 0; i < kRound; ++i) {
      const int k = k0 + 32 * i + lane;
      if (k < ra.nvec) {
#pragma unroll
        for (int t = 0; t < V; ++t)
          put_block<kTrans>(a_s, B, P, ra.vec(k) + t, widen<T>(va[i], t));
      }
      if (k < rx.nvec) {
#pragma unroll
        for (int t = 0; t < V; ++t) x_s[rx.vec(k) + t] = widen<T>(vx[i], t);
      }
      if (k < ry.nvec) {
#pragma unroll
        for (int t = 0; t < V; ++t) y_s[ry.vec(k) + t] = widen<T>(vy[i], t);
      }
    }
    if (k0 == 0) {
      if (lane < ra.nscal)
        put_block<kTrans>(a_s, B, P, ra.edge(lane), widen<T>(ea, 0));
      if (lane < rx.nscal) x_s[rx.edge(lane)] = widen<T>(ex, 0);
      if (lane < ry.nscal) y_s[ry.edge(lane)] = widen<T>(ey, 0);
    }
  }
  __syncwarp();

  const Staged s{a_s, x_s, y_in ? y_s : nullptr, P, F,
                 p.yin_ld == 0 ? 0 : F, B};
  T* yb = p.y + row0 * F;
  const Run<T> ro(yb, B * F);
  for (int k = lane; k < ro.nvec; k += 32) {
    float v[V];
#pragma unroll
    for (int u = 0; u < V; u += 4) out_quad<kB>(s, ro.vec(k) + u, F, v + u);
    store_vec(yb + ro.vec(k), v);
  }
  if (lane < ro.nscal) {
    const int e = ro.edge(lane), r = e / F;
    yb[e] = from_f32<T>(out1<kB>(s, r, e - r * F));
  }
}

// ---------------------------------------------------------------------------
// tile kernel: a CTA a (block, 64 columns) (B > 32 or F > 64)
// ---------------------------------------------------------------------------

// `rows` runs of `len` elements `ld` apart in device memory, staged as
// float32 at dst[r * dp + c] (the block: see stage).
template <typename T>
struct Seg {
  const T* src;
  int rows, len;
  long long ld;
  float* dst;
  int dp;
};

// A run of len elements is cut into at most len / V vectors and at most
// min(len, 2V - 2) edge elements; a slot is one of either.
template <typename T>
__device__ __forceinline__ int slots_per_run(int len) {
  return len / Vec16<T>::kN + min(len, 2 * Vec16<T>::kN - 2);
}

// First element and width (V: a vector, 1: an edge element, 0: none) of
// slot i of the run of len elements at p.
template <typename T>
__device__ __forceinline__ int slot_at(const T* p, int len, int i,
                                       int* width) {
  const Run<T> run(p, len);
  const int vmax = len / Vec16<T>::kN;
  if (i < vmax) {
    *width = i < run.nvec ? Vec16<T>::kN : 0;
    return run.vec(i);
  }
  *width = i - vmax < run.nscal ? 1 : 0;
  return run.edge(i - vmax);
}

template <typename T>
__device__ __forceinline__ Seg<T> pick(int k, const Seg<T>& s0,
                                       const Seg<T>& s1, const Seg<T>& s2) {
  return k == 0 ? s0 : (k == 1 ? s1 : s2);
}

// Stages three segments into shared memory as float32: s0 is the block (one
// run of B * B), placed by put_block; s1 and s2 at their dst.  Thread tid
// of nthr takes every nthr-th slot; it issues the loads of up to kSlots
// slots before it widens and stores any of them.
template <typename T, bool kTrans>
__device__ __forceinline__ void stage(const Seg<T>& s0, const Seg<T>& s1,
                                      const Seg<T>& s2, int B, int P, int tid,
                                      int nthr) {
  const int n0 = s0.rows * slots_per_run<T>(s0.len);
  const int n01 = n0 + s1.rows * slots_per_run<T>(s1.len);
  const int total = n01 + s2.rows * slots_per_run<T>(s2.len);
  for (int base = tid; base < total; base += kSlots * nthr) {
    uint4 raw[kSlots];
    int seg[kSlots], pos[kSlots], width[kSlots];
#pragma unroll
    for (int k = 0; k < kSlots; ++k) {
      const int q = base + k * nthr;
      width[k] = 0;
      seg[k] = 0;
      pos[k] = 0;
      raw[k] = make_uint4(0u, 0u, 0u, 0u);
      if (q < total) {
        const int sid = q < n0 ? 0 : (q < n01 ? 1 : 2);
        const Seg<T> s = pick(sid, s0, s1, s2);
        const int qs = q - (sid == 0 ? 0 : (sid == 1 ? n0 : n01));
        const int spr = slots_per_run<T>(s.len);
        const int row = s.rows == 1 ? 0 : qs / spr;
        const T* p = s.src + static_cast<long long>(row) * s.ld;
        const int c = slot_at(p, s.len, qs - row * spr, &width[k]);
        if (width[k]) raw[k] = load_raw(p + c, width[k]);
        seg[k] = sid;
        pos[k] = row * s.dp + c;
      }
    }
#pragma unroll
    for (int k = 0; k < kSlots; ++k) {
#pragma unroll
      for (int t = 0; t < Vec16<T>::kN; ++t) {
        if (t >= width[k]) continue;
        const float v = widen<T>(raw[k], t);
        if (seg[k] == 0)
          put_block<kTrans>(s0.dst, B, P, pos[k] + t, v);
        else
          (seg[k] == 1 ? s1.dst : s2.dst)[pos[k] + t] = v;
      }
    }
  }
}

template <typename T, bool kTrans>
__global__ void __launch_bounds__(kTileThreads)
    block_diag_kernel_tile(const Args<T> p) {
  extern __shared__ __align__(16) float smem[];
  constexpr int V = Vec16<T>::kN;
  const int tid = threadIdx.x, blk = blockIdx.x;
  const int f0 = blockIdx.y * kTileF;
  const int B = p.B, F = p.F, fw = min(kTileF, F - f0);
  const int P = block_pitch(B);
  // a tile spanning all of F: the block's rows are one run of B * F
  const bool flat = fw == F;
  const int xp = x_pitch(fw, F);
  const long long row0 = static_cast<long long>(blk) * B;
  float* a_s = smem;
  float* x_s = a_s + B * P;
  float* y_s = x_s + round4(B * xp);
  const Seg<T> a{p.blocks + row0 * B, 1, B * B, 0, a_s, 0};
  const long long off = row0 * F + f0;
  const Seg<T> xs = flat ? Seg<T>{p.x + off, 1, B * F, 0, x_s, 0}
                         : Seg<T>{p.x + off, B, fw, F, x_s, xp};
  Seg<T> ys{p.x, 0, 0, 0, y_s, 0};  // no rows: no Y_in
  int yp = 0;
  if (p.y_in != nullptr) {
    if (p.yin_ld == 0) {
      ys = Seg<T>{p.y_in + f0, 1, fw, 0, y_s, 0};
    } else {
      ys = flat ? Seg<T>{p.y_in + off, 1, B * F, 0, y_s, 0}
                : Seg<T>{p.y_in + off, B, fw, F, y_s, xp};
      yp = xp;
    }
  }
  stage<T, kTrans>(a, xs, ys, B, P, tid, kTileThreads);
  __syncthreads();

  const Staged s{a_s, x_s, p.y_in != nullptr ? y_s : nullptr, P, xp, yp, B};
  const int rows = flat ? 1 : B, len = flat ? B * F : fw;
  const int spr = slots_per_run<T>(len);
  for (int q = tid; q < rows * spr; q += kTileThreads) {
    const int row = rows == 1 ? 0 : q / spr;
    T* yr = p.y + off + static_cast<long long>(row) * F;
    int width;
    const int c0 = slot_at(yr, len, q - row * spr, &width);
    const int e0 = row * len + c0;  // element e of the tile: Y[e / fw, e % fw]
    if (width == V) {
      float v[V];
#pragma unroll
      for (int u = 0; u < V; u += 4) out_quad<0>(s, e0 + u, fw, v + u);
      store_vec(yr + c0, v);
    } else if (width == 1) {
      const int r = e0 / fw;
      yr[c0] = from_f32<T>(out1<0>(s, r, e0 - r * fw));
    }
  }
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

template <typename K>
cudaError_t allow_smem(K* kernel, int bytes) {
  if (bytes <= kDefaultSmem) return cudaSuccess;
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

template <typename T, int kB, bool kTrans>
cudaError_t launch_warp(const Args<T>& p, cudaStream_t stream) {
  const int floats =
      staged_floats(p.B, p.F, p.F, p.y_in != nullptr, p.yin_ld);
  const int smem = kWarpsPerCta * floats * 4;
  const cudaError_t err =
      allow_smem(block_diag_kernel_warp<T, kB, kTrans>, smem);
  if (err != cudaSuccess) return err;
  block_diag_kernel_warp<T, kB, kTrans>
      <<<(p.nb + kWarpsPerCta - 1) / kWarpsPerCta, kWarpsPerCta * 32, smem,
         stream>>>(p, floats);
  return cudaGetLastError();
}

template <typename T, bool kTrans>
cudaError_t launch(const Args<T>& p, cudaStream_t stream) {
  if (p.B <= kWarpMaxB && p.F <= kWarpMaxF) {
    switch (p.B) {
      case 8:
        return launch_warp<T, 8, kTrans>(p, stream);
      case 16:
        return launch_warp<T, 16, kTrans>(p, stream);
      case 32:
        return launch_warp<T, 32, kTrans>(p, stream);
      default:
        return launch_warp<T, 0, kTrans>(p, stream);
    }
  }
  const int fw = p.F < kTileF ? p.F : kTileF;
  const int smem =
      staged_floats(p.B, fw, p.F, p.y_in != nullptr, p.yin_ld) * 4;
  const cudaError_t err =
      allow_smem(block_diag_kernel_tile<T, kTrans>, smem);
  if (err != cudaSuccess) return err;
  block_diag_kernel_tile<T, kTrans>
      <<<dim3(p.nb, (p.F + kTileF - 1) / kTileF), kTileThreads, smem,
         stream>>>(p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_typed(const void* blocks, const void* x, const void* y_in,
                         void* y, int nb, int B, int F, int yin_ld,
                         int transpose, cudaStream_t stream) {
  const Args<T> p{static_cast<const T*>(blocks), static_cast<const T*>(x),
                  static_cast<const T*>(y_in), static_cast<T*>(y), nb, B, F,
                  yin_ld};
  return transpose ? launch<T, true>(p, stream) : launch<T, false>(p, stream);
}

}  // namespace

// Launches on `stream`; returns the cudaError_t of the launch (0 = success).
// blocks (nb, B, B), x and y (nb*B, F), all contiguous; y_in null, or
// (nb*B, F) with row stride y_in_ld: F (contiguous) or 0 (one row of F
// values repeated); every operand of the element type `dtype` (0 =
// float32, 1 = bfloat16).  transpose != 0 multiplies by each block's
// transpose.
extern "C" int block_diag_spmm_launch(const void* blocks, const void* x,
                                      const void* y_in, void* y, int nb,
                                      int B, int F, int y_in_ld,
                                      int transpose, int dtype,
                                      void* stream) {
  if (nb <= 0 || F <= 0) return 0;
  if (B < 1 || B > 64) return static_cast<int>(cudaErrorInvalidValue);
  if (y_in != nullptr && y_in_ld != 0 && y_in_ld != F)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case repro_torch::kFloat32:
      return static_cast<int>(launch_typed<float>(blocks, x, y_in, y, nb, B,
                                                  F, y_in_ld, transpose, s));
    case repro_torch::kBFloat16:
      return static_cast<int>(launch_typed<__nv_bfloat16>(
          blocks, x, y_in, y, nb, B, F, y_in_ld, transpose, s));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" const char* block_diag_spmm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
