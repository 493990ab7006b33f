// Flash (blockwise-softmax) attention on Hopper: O = softmax(Q K^T * scale,
// causal from the top left) V with grouped-query heads.
//
// Replaces the Pallas TPU kernel repro/kernels/flash_attention.py
// (flash_attention, _kernel): q (B, Hq, Sq, d), k (B, Hkv, Skv, d),
// v (B, Hkv, Skv, dv) -> o (B, Hq, Sq, dv) in q's type; query head h reads
// kv head h / (Hq / Hkv); a causal query row q_pos keeps the keys with
// k_pos <= q_pos (positions counted from 0 in both, as the Pallas kernel
// masks); the output is acc / max(l, 1e-30).  Running max, sum and
// accumulator are float32, whatever the input type.
//
// Both paths below turn the Pallas grid's sequential KV axis into a loop
// inside one CTA per (b * Hq + h, 64-row query tile): the CTA stages each
// 64-key K and V tile in turn in shared memory, so the (Sq, Skv) score
// matrix never reaches device memory.  KV tiles that lie wholly above the
// causal diagonal are not visited (their contribution is exactly zero);
// query tiles run heaviest first.  Inputs are read once per query tile (K
// and V once per 64 query rows, mostly from L2) and the output written
// once.
//
// Bound on this card: the score and P V products are 4 Sq Skv d
// operations per head (halved by causality), far above the bytes moved
// (Q, K, V, O once each), so the work is bound by operations.
//
// bfloat16 with d = dv in {32, 64, 128} and 16-byte aligned operands: the
// tensor-core path (flash_mma_kernel).  Four warps each own 16 query rows;
// a warp keeps its Q rows as mma.sync m16n8k16 A fragments in registers,
// forms S = Q K^T (float32 accumulators, K fragments by ldmatrix from rows
// padded by 8 elements, which keeps ldmatrix conflict-free), keeps each
// row's max and sum in the 4 lanes that share it, rounds P to bfloat16 in
// registers as the A fragments of P V (the accumulator layout of two n8
// tiles is the A layout of one k16 step) and accumulates O in float32
// registers, with V fragments by ldmatrix.trans.
//
// Every other case (float32, which must keep float32 products; other head
// dims; d != dv, as MLA's 192/128): the CUDA-core path (flash_kernel).
// Thread (ty, tx) of a 16 x 16 layout owns query rows ty + 16 i (i < 4):
// it forms the scores of keys tx + 16 j (j < 4) with float4 reads of Q and
// K rows staged as float32 (row stride d + 4 floats keeps the eight rows
// that a quarter-warp reads in distinct banks), reduces each row's max over
// the 16 lanes that share it, writes P into the shared memory K occupied,
// and accumulates its rows x (dv columns tx * 4 + 64 m + 0..3) of P V as
// float32 FMAs (67 TFLOP/s on this card, against 989 for bf16 mma).
//
// Limits.  1 <= d, dv <= 256; the CUDA-core path's shared memory is
// 64 (d + 4) + max(64 (d + 4), 64 * 68) + 64 * 64 ceil(dv / 64) floats, at
// most 194 KB (d = dv = 256), 98 KB at d = dv = 128 (two CTAs per SM); the
// tensor-core path's 3 * 64 * (d + 8) bf16, 52 KB at d = 128.  Any Sq,
// Skv >= 1; Hq a multiple of Hkv.
#include <cstdint>

#include "dtype.cuh"

namespace {

using repro_torch::from_f32;
using repro_torch::to_f32;

constexpr int kThreads = 256;   // 16 x 16
constexpr int kBQ = 64;         // query rows per CTA
constexpr int kBK = 64;         // keys per KV tile
constexpr int kPs = kBK + 4;    // row stride of the P tile (floats)
constexpr int kMaxD = 256;
constexpr float kNegInf = -1e30f;   // the reference's mask value

__host__ __device__ constexpr int round4(int x) { return (x + 3) & ~3; }

// Row stride (floats) of the staged Q and K tiles.
__host__ __device__ constexpr int qk_stride(int d) { return round4(d) + 4; }

// Floats of shared memory for head dims d, dv (P reuses K's region).
__host__ __device__ constexpr int smem_floats(int d, int dvp) {
  return kBQ * qk_stride(d) +
         (kBK * qk_stride(d) > kBQ * kPs ? kBK * qk_stride(d) : kBQ * kPs) +
         kBK * dvp;
}

// Copies `rows` rows of `cols` contiguous elements from `src` into float32
// rows of stride `stride` at `dst`; columns [cols, cols_cap) and rows
// [rows, rows_cap) become zero.  `vec`: cols fills whole 16-byte vectors
// and src is 16-byte aligned, so rows are read 16 bytes per thread.
template <typename T>
__device__ __forceinline__ void stage(float* __restrict__ dst, int stride,
                                      const T* __restrict__ src, int rows,
                                      int rows_cap, int cols, int cols_cap,
                                      bool vec) {
  const int tid = threadIdx.x;
  if (vec) {
    constexpr int kN = repro_torch::Vec16<T>::kN;
    const int per_row = cols / kN;
    const int n = rows * per_row;
    for (int i = tid; i < n; i += kThreads) {
      const int r = i / per_row;
      const int c = (i - r * per_row) * kN;
      float buf[kN];
      repro_torch::Vec16<T>::load(src + static_cast<size_t>(r) * cols + c,
                                  buf);
      float* out = dst + r * stride + c;
#pragma unroll
      for (int e = 0; e < kN; e += 4)
        *reinterpret_cast<float4*>(out + e) =
            make_float4(buf[e], buf[e + 1], buf[e + 2], buf[e + 3]);
    }
    const int pad = cols_cap - cols;
    for (int i = tid; i < rows * pad; i += kThreads) {
      const int r = i / pad;
      dst[r * stride + cols + (i - r * pad)] = 0.f;
    }
    for (int i = tid; i < (rows_cap - rows) * cols_cap; i += kThreads) {
      const int r = i / cols_cap;
      dst[(rows + r) * stride + (i - r * cols_cap)] = 0.f;
    }
  } else {
    for (int i = tid; i < rows_cap * cols_cap; i += kThreads) {
      const int r = i / cols_cap;
      const int c = i - r * cols_cap;
      dst[r * stride + c] =
          (r < rows && c < cols)
              ? to_f32(src[static_cast<size_t>(r) * cols + c])
              : 0.f;
    }
  }
}

// NV: ceil(dv / 64), the 64-column groups of the output a thread covers.
template <typename T, int NV>
__global__ void __launch_bounds__(kThreads)
    flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o, int Hq, int Hkv,
                 int Sq, int Skv, int d, int dv, int causal, float scale,
                 int vec_qk, int vec_v) {
  constexpr int kDvp = NV * 64;
  extern __shared__ __align__(16) float smem[];
  const int qs = qk_stride(d);
  const int dp = round4(d);
  float* q_s = smem;                                  // (kBQ, qs)
  float* k_s = q_s + kBQ * qs;                        // (kBK, qs)
  float* p_s = k_s;                                   // (kBQ, kPs), after S
  float* v_s = k_s + (kBK * qs > kBQ * kPs ? kBK * qs : kBQ * kPs);

  const int bh = blockIdx.x;
  const int b = bh / Hq;
  const int kvh = b * Hkv + (bh - b * Hq) / (Hq / Hkv);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBQ;
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;

  const T* kg = k + static_cast<size_t>(kvh) * Skv * d;
  const T* vg = v + static_cast<size_t>(kvh) * Skv * dv;
  stage(q_s, qs, q + (static_cast<size_t>(bh) * Sq + q0) * d,
        min(kBQ, Sq - q0), kBQ, d, dp, vec_qk != 0);

  float m[4], l[4], acc[4][NV][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int n = 0; n < NV; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][n][e] = 0.f;
  }

  int n_tiles = (Skv + kBK - 1) / kBK;
  if (causal) {
    // tiles starting past the tile's last query row are wholly masked
    const int live = (q0 + kBQ - 1) / kBK + 1;
    n_tiles = live < n_tiles ? live : n_tiles;
  }
  for (int t = 0; t < n_tiles; ++t) {
    const int kv0 = t * kBK;
    const int rows = min(kBK, Skv - kv0);
    __syncthreads();   // the previous tile's P and V are no longer read
    stage(k_s, qs, kg + static_cast<size_t>(kv0) * d, rows, kBK, d, dp,
          vec_qk != 0);
    stage(v_s, kDvp, vg + static_cast<size_t>(kv0) * dv, rows, kBK, dv,
          kDvp, vec_v != 0);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
    for (int kk = 0; kk < dp; kk += 4) {
      float4 a[4], c[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        a[i] = *reinterpret_cast<const float4*>(q_s + (ty + 16 * i) * qs + kk);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        c[j] = *reinterpret_cast<const float4*>(k_s + (tx + 16 * j) * qs + kk);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float x = s[i][j];
          x = fmaf(a[i].x, c[j].x, x);
          x = fmaf(a[i].y, c[j].y, x);
          x = fmaf(a[i].z, c[j].z, x);
          x = fmaf(a[i].w, c[j].w, x);
          s[i][j] = x;
        }
    }

    // scale, mask, and the online-softmax update of each owned row
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int q_pos = q0 + ty + 16 * i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int k_pos = kv0 + tx + 16 * j;
        float x = s[i][j] * scale;
        if (k_pos >= Skv || (causal && q_pos < k_pos)) x = kNegInf;
        s[i][j] = x;
        mx = fmaxf(mx, x);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = expf(s[i][j] - m_new);
        sum += s[i][j];
      }
      l[i] = l[i] * alpha + sum;   // this lane's share of the row sum
      m[i] = m_new;
#pragma unroll
      for (int n = 0; n < NV; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][n][e] *= alpha;
    }
    __syncthreads();   // every thread has read K: P may take its place
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        p_s[(ty + 16 * i) * kPs + tx + 16 * j] = s[i][j];
    __syncthreads();

    const int jmax = round4(rows);   // P is zero beyond the tile's keys
    for (int j = 0; j < jmax; j += 4) {
      float4 p[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        p[i] = *reinterpret_cast<const float4*>(p_s + (ty + 16 * i) * kPs + j);
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
#pragma unroll
        for (int n = 0; n < NV; ++n) {
          const float4 w = *reinterpret_cast<const float4*>(
              v_s + (j + jj) * kDvp + n * 64 + tx * 4);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float pij = jj == 0   ? p[i].x
                              : jj == 1 ? p[i].y
                              : jj == 2 ? p[i].z
                                        : p[i].w;
            acc[i][n][0] = fmaf(pij, w.x, acc[i][n][0]);
            acc[i][n][1] = fmaf(pij, w.y, acc[i][n][1]);
            acc[i][n][2] = fmaf(pij, w.z, acc[i][n][2]);
            acc[i][n][3] = fmaf(pij, w.w, acc[i][n][3]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float lt = l[i];
#pragma unroll
    for (int off = 8; off > 0; off >>= 1)
      lt += __shfl_xor_sync(0xffffffffu, lt, off);
    const float den = fmaxf(lt, 1e-30f);
    const int row = q0 + ty + 16 * i;
    if (row >= Sq) continue;
    T* out = o + (static_cast<size_t>(bh) * Sq + row) * dv;
#pragma unroll
    for (int n = 0; n < NV; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = n * 64 + tx * 4 + e;
        if (col < dv) out[col] = from_f32<T>(acc[i][n][e] / den);
      }
  }
}

// ---------------------------------------------------------------------------
// tensor-core path: bfloat16, d = dv in {32, 64, 128}
// ---------------------------------------------------------------------------

constexpr int kMmaThreads = 128;   // 4 warps x 16 query rows

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  const auto a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  const auto a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

// d += a b for one m16n8k16 tile: bfloat16 operands, float32 accumulators
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Copies `rows` rows of D contiguous bf16 into rows of stride D + 8 at
// `dst`, 16 bytes per thread; rows [rows, 64) become zero.
template <int D>
__device__ __forceinline__ void stage_bf16(__nv_bfloat16* __restrict__ dst,
                                           const __nv_bfloat16* __restrict__ src,
                                           int rows) {
  constexpr int kPerRow = D / 8;
  for (int i = threadIdx.x; i < kBK * kPerRow; i += kMmaThreads) {
    const int r = i / kPerRow;
    const int c = (i - r * kPerRow) * 8;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (r < rows)
      val = __ldg(reinterpret_cast<const uint4*>(
          src + static_cast<size_t>(r) * D + c));
    *reinterpret_cast<uint4*>(dst + r * (D + 8) + c) = val;
  }
}

template <int D>
__global__ void __launch_bounds__(kMmaThreads)
    flash_mma_kernel(const __nv_bfloat16* __restrict__ q,
                     const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v,
                     __nv_bfloat16* __restrict__ o, int Hq, int Hkv, int Sq,
                     int Skv, int causal, float scale) {
  constexpr int kStr = D + 8;                 // bf16 row stride in shared
  constexpr float kLog2e = 1.4426950408889634f;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  auto* q_s = reinterpret_cast<__nv_bfloat16*>(smem_raw);   // (64, kStr)
  __nv_bfloat16* k_s = q_s + kBQ * kStr;                    // (64, kStr)
  __nv_bfloat16* v_s = k_s + kBK * kStr;                    // (64, kStr)

  const int bh = blockIdx.x;
  const int b = bh / Hq;
  const int kvh = b * Hkv + (bh - b * Hq) / (Hq / Hkv);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBQ;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;      // fragment row (and row + 8)
  const int c = lane & 3;       // fragment column pair
  const __nv_bfloat16* kg = k + static_cast<size_t>(kvh) * Skv * D;
  const __nv_bfloat16* vg = v + static_cast<size_t>(kvh) * Skv * D;

  stage_bf16<D>(q_s, q + (static_cast<size_t>(bh) * Sq + q0) * D,
                min(kBQ, Sq - q0));
  __syncthreads();
  // this warp's 16 query rows as A fragments, one per 16 columns of d
  uint32_t qf[D / 16][4];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    ldmatrix_x4(qf[kk], q_s + (warp * 16 + (lane & 7) + 8 * ((lane >> 3) & 1))
                                  * kStr + kk * 16 + 8 * (lane >> 4));

  float acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  const float scale2 = scale * kLog2e;   // exp(x) = exp2(x log2(e))

  int n_tiles = (Skv + kBK - 1) / kBK;
  if (causal) {
    const int live = (q0 + kBQ - 1) / kBK + 1;
    n_tiles = live < n_tiles ? live : n_tiles;
  }
  for (int t = 0; t < n_tiles; ++t) {
    const int kv0 = t * kBK;
    const int rows = min(kBK, Skv - kv0);
    __syncthreads();   // every warp is done with the previous K and V
    stage_bf16<D>(k_s, kg + static_cast<size_t>(kv0) * D, rows);
    stage_bf16<D>(v_s, vg + static_cast<size_t>(kv0) * D, rows);
    __syncthreads();

    // S = Q K^T: 8 n-tiles of 8 keys
    float s[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int np = 0; np < 4; ++np)
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        uint32_t bf[4];
        ldmatrix_x4(bf, k_s + (np * 16 + (lane & 7) + 8 * (lane >> 4)) * kStr
                            + kk * 16 + 8 * ((lane >> 3) & 1));
        mma_bf16(s[2 * np], qf[kk], bf[0], bf[1]);
        mma_bf16(s[2 * np + 1], qf[kk], bf[2], bf[3]);
      }

    // scale, mask, online softmax of rows g (h = 0) and g + 8 (h = 1)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int q_pos = q0 + warp * 16 + g + 8 * h;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int k_pos = kv0 + 8 * j + 2 * c + e;
          float x = s[j][2 * h + e] * scale2;
          if (k_pos >= Skv || (causal && q_pos < k_pos)) x = kNegInf;
          s[j][2 * h + e] = x;
          mx = fmaxf(mx, x);
        }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[h], mx);
      const float alpha = exp2f(m[h] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float p = exp2f(s[j][2 * h + e] - m_new);
          s[j][2 * h + e] = p;
          sum += p;
        }
      l[h] = l[h] * alpha + sum;   // this lane's share of the row sum
      m[h] = m_new;
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        acc[n][2 * h] *= alpha;
        acc[n][2 * h + 1] *= alpha;
      }
    }

    // O += P V: P's accumulators are the A fragments of 4 k16 steps
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint32_t a[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                             pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                             pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                             pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int np = 0; np < D / 16; ++np) {
        uint32_t bf[4];
        ldmatrix_x4_trans(bf, v_s + (kk * 16 + (lane & 7)
                                     + 8 * ((lane >> 3) & 1)) * kStr
                                  + np * 16 + 8 * (lane >> 4));
        mma_bf16(acc[2 * np], a, bf[0], bf[1]);
        mma_bf16(acc[2 * np + 1], a, bf[2], bf[3]);
      }
    }
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float lt = l[h];
    lt += __shfl_xor_sync(0xffffffffu, lt, 1);
    lt += __shfl_xor_sync(0xffffffffu, lt, 2);
    const float den = fmaxf(lt, 1e-30f);
    const int row = q0 + warp * 16 + g + 8 * h;
    if (row >= Sq) continue;
    __nv_bfloat16* out = o + (static_cast<size_t>(bh) * Sq + row) * D;
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      *reinterpret_cast<__nv_bfloat162*>(out + 8 * n + 2 * c) =
          __floats2bfloat162_rn(acc[n][2 * h] / den, acc[n][2 * h + 1] / den);
  }
}

template <int D>
cudaError_t launch_mma(const void* q, const void* k, const void* v, void* o,
                       int B, int Hq, int Hkv, int Sq, int Skv, int causal,
                       float scale, cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(3 * kBQ * (D + 8)) *
                      sizeof(__nv_bfloat16);
  static size_t allowed = 48 * 1024;   // as in launch_nv
  if (smem > allowed) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_mma_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    allowed = smem;
  }
  const dim3 grid(B * Hq, (Sq + kBQ - 1) / kBQ);
  flash_mma_kernel<D><<<grid, kMmaThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o),
      Hq, Hkv, Sq, Skv, causal, scale);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

template <typename T, int NV>
cudaError_t launch_nv(const void* q, const void* k, const void* v, void* o,
                      int B, int Hq, int Hkv, int Sq, int Skv, int d, int dv,
                      int causal, float scale, cudaStream_t stream) {
  const size_t smem =
      static_cast<size_t>(smem_floats(d, NV * 64)) * sizeof(float);
  // raised once per instantiation to the largest request seen (never
  // while a stream is being captured: the first call comes before)
  static size_t allowed = 48 * 1024;
  if (smem > allowed) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_kernel<T, NV>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    allowed = smem;
  }
  const int vec_qk =
      (d * sizeof(T)) % 16 == 0 && aligned16(q) && aligned16(k);
  const int vec_v = (dv * sizeof(T)) % 16 == 0 && aligned16(v);
  const dim3 grid(B * Hq, (Sq + kBQ - 1) / kBQ);
  flash_kernel<T, NV><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), Hq, Hkv, Sq, Skv, d, dv,
      causal, scale, vec_qk, vec_v);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int B, int Hq, int Hkv, int Sq, int Skv, int d, int dv,
                   int causal, float scale, cudaStream_t stream) {
  if constexpr (sizeof(T) == 2) {   // bfloat16: the tensor-core path
    if (d == dv && aligned16(q) && aligned16(k) && aligned16(v) &&
        aligned16(o)) {
      if (d == 32)
        return launch_mma<32>(q, k, v, o, B, Hq, Hkv, Sq, Skv, causal, scale,
                              stream);
      if (d == 64)
        return launch_mma<64>(q, k, v, o, B, Hq, Hkv, Sq, Skv, causal, scale,
                              stream);
      if (d == 128)
        return launch_mma<128>(q, k, v, o, B, Hq, Hkv, Sq, Skv, causal,
                               scale, stream);
    }
  }
  switch ((dv + 63) / 64) {
    case 1:
      return launch_nv<T, 1>(q, k, v, o, B, Hq, Hkv, Sq, Skv, d, dv, causal,
                             scale, stream);
    case 2:
      return launch_nv<T, 2>(q, k, v, o, B, Hq, Hkv, Sq, Skv, d, dv, causal,
                             scale, stream);
    case 3:
      return launch_nv<T, 3>(q, k, v, o, B, Hq, Hkv, Sq, Skv, d, dv, causal,
                             scale, stream);
    default:
      return launch_nv<T, 4>(q, k, v, o, B, Hq, Hkv, Sq, Skv, d, dv, causal,
                             scale, stream);
  }
}

}  // namespace

// Launches on `stream`; returns the cudaError_t of the launch (0 = success).
// q (B, Hq, Sq, d), k (B, Hkv, Skv, d), v (B, Hkv, Skv, dv) and o
// (B, Hq, Sq, dv), all contiguous, of the element type `dtype` (0 =
// float32, 1 = bfloat16).  causal != 0 keeps k_pos <= q_pos.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* o, int B, int Hq,
                                      int Hkv, int Sq, int Skv, int d, int dv,
                                      int causal, float scale, int dtype,
                                      void* stream) {
  if (B <= 0 || Hq <= 0 || Sq <= 0) return 0;
  if (Hkv <= 0 || Hq % Hkv != 0 || Skv <= 0 || d < 1 || d > kMaxD ||
      dv < 1 || dv > kMaxD)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case repro_torch::kFloat32:
      return static_cast<int>(launch<float>(q, k, v, o, B, Hq, Hkv, Sq, Skv,
                                            d, dv, causal, scale, s));
    case repro_torch::kBFloat16:
      return static_cast<int>(launch<__nv_bfloat16>(
          q, k, v, o, B, Hq, Hkv, Sq, Skv, d, dv, causal, scale, s));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" const char* flash_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
