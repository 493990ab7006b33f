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
// inside one CTA per (b * Hq + h, query tile), so the (Sq, Skv) score
// matrix never reaches device memory.  KV tiles that lie wholly above the
// causal diagonal are not visited (their contribution is exactly zero);
// query tiles run heaviest first.  K and V are read once per query tile,
// mostly from L2, Q once and the output written once.
//
// Bound on this card: the score and P V products are 4 Sq Skv d
// operations per head (halved by causality), far above the bytes moved
// (Q, K, V, O once each), so the work is bound by operations: 17.2 GFLOP,
// 0.0174 ms at the bfloat16 tensor-core peak, at InternLM2's prefill
// (4, 16, 8, 1024, 128).
//
// bfloat16 with d = dv in {32, 64, 128} and 16-byte aligned operands: the
// tensor-core path (flash_wgmma_kernel), built on what only Hopper has.  A
// CTA of two warpgroups owns 128 query rows, 64 a warpgroup.  TMA copies
// its Q once, and K and V in tiles of 128 keys into a ring of 3 stages (4
// below d = 128) that both warpgroups read, each copy completing on an
// mbarrier, in the swizzled layout that wgmma reads (128-byte swizzle,
// 64-byte at d = 32); rows past Sq or Skv arrive as zeros.  A warpgroup
// forms S = Q K^T by wgmma m64n128k16 from shared memory, takes the online
// softmax on the accumulator registers (exp2, 4-lane row reductions,
// float32 running max and sum; the mask only on the diagonal tile and the
// ragged last tile), rounds P to bfloat16 in registers and adds P V by
// wgmma with P as the register operand and V read MN-major through its
// descriptor.  The loop is software-pipelined: tile t's S is issued with
// tile t - 1's P V, and tile t's softmax runs while that P V is on the
// tensor cores.  No warp is set aside to produce: a ninth warp puts three
// warps on one SM sub-partition, which caps every thread at 168
// registers (the compiler does not give the consumers what setmaxnreg
// frees), and the pipelined loop needs 198, so with a producer warp it
// spilled and ran 38 % slower.  Instead the later of the two warpgroups to
// finish with a stage issues its refill, three tiles ahead.  On an H100 at
// 700 W (tools/port_kernels_bench.py) it takes 0.056 ms at InternLM2's
// prefill, where PyTorch's scaled_dot_product_attention takes 0.048 ms, and
// 0.144 ms, as fast as SDPA, at (1, 16, 8, 4096, 128); at 1024 tokens a
// CTA has 4.5 tiles on average, and each CTA's pipeline fill and drain is
// what keeps it behind.
//
// Every other case (float32, which must keep float32 products; other head
// dims; d != dv, as MLA's 192/128): the CUDA-core path (flash_kernel), one
// CTA per 64 query rows staging 64-key K and V tiles in turn.  Thread
// (ty, tx) of a 16 x 16 layout owns query rows ty + 16 i (i < 4):
// it forms the scores of keys tx + 16 j (j < 4) with float4 reads of Q and
// K rows staged as float32 (row stride d + 4 floats keeps the eight rows
// that a quarter-warp reads in distinct banks), reduces each row's max over
// the 16 lanes that share it, writes P into the shared memory K occupied,
// and accumulates its rows x (dv columns tx * 4 + 64 m + 0..3) of P V as
// float32 FMAs (67 TFLOP/s on this card, against 989 for bf16 wgmma).
//
// Limits.  1 <= d, dv <= 256; the CUDA-core path's shared memory is
// 64 (d + 4) + max(64 (d + 4), 64 * 68) + 64 * 64 ceil(dv / 64) floats, at
// most 194 KB (d = dv = 256), 98 KB at d = dv = 128 (two CTAs per SM); the
// tensor-core path's 128 d bfloat16 values for Q and 256 d a stage, 225 KB
// at d = 128 (one CTA per SM).  Any Sq, Skv >= 1; Hq a multiple of Hkv.
#include <cuda.h>

#include <cstdint>

#include "cp_async.cuh"
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
// tensor-core path: bfloat16, d = dv in {32, 64, 128}; wgmma fed by TMA
// ---------------------------------------------------------------------------

namespace wg {

constexpr int kBM = 128;           // query rows per CTA: 2 warpgroups x 64
constexpr int kBN = 128;           // keys per K/V tile
constexpr int kThreads = 256;      // two consumer warpgroups
constexpr float kLog2e = 1.4426950408889634f;

// Shared-memory layout of one head dim D.  Q, K and V tiles arrive by TMA
// in the canonical swizzled layout wgmma reads: rows of kSW bytes (D / kNP
// elements), 8-row atoms of 8 kSW bytes with the 16-byte chunks of row r
// XOR-ed with r % 8, and kNP column panels one after the other.
template <int D>
struct Cfg {
  static constexpr int kSW = D >= 64 ? 128 : 64;       // swizzle span, bytes
  static constexpr int kPW = kSW / 2;                   // elements a panel row
  static constexpr int kNP = D / kPW;                   // panels
  static constexpr uint64_t kMode = kSW == 128 ? 1 : 2; // descriptor swizzle
  static constexpr int kStages = D == 128 ? 3 : 4;      // K/V ring depth
  static constexpr int kQBytes = 64 * D * 2;            // one warpgroup's Q
  static constexpr int kTileBytes = kBN * D * 2;        // one K or V tile
  static constexpr int kBarOff = 2 * kQBytes + 2 * kStages * kTileBytes;
  // 1 KB of slack aligns the tiles to the 1024-byte swizzle atom
  static constexpr int kSmem = 1024 + kBarOff + 8 * (1 + 2 * kStages);
};

using repro_torch::mbar_expect_tx;
using repro_torch::mbar_init;
using repro_torch::mbar_wait;
using repro_torch::smem_u32;

// One TMA box of a 3-D tensor map into shared memory, completing on `bar`.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int c0, int c1,
                                         int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1), "r"(c2)
      : "memory");
}

// wgmma shared-memory matrix descriptor: start address, leading and
// stride byte offsets (16-byte units) and the swizzle mode.
__device__ __forceinline__ uint64_t mdesc(const void* p, uint32_t lbo,
                                          uint32_t sbo, uint64_t mode) {
  return static_cast<uint64_t>((smem_u32(p) & 0x3FFFF) >> 4) |
         static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16 |
         static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32 | mode << 62;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// Waits until at most N committed wgmma groups are still running.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Keeps the compiler from moving reads or writes of r across a wgmma
// issue or wait (it sees only the asm statements' operands).
__device__ __forceinline__ void pin(float& r) {
  asm volatile("" : "+f"(r)::"memory");
}
__device__ __forceinline__ void pin(uint32_t& r) {
  asm volatile("" : "+r"(r)::"memory");
}

// d (+)= a b: m64n128k16, A and B from shared memory (K-major)
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t a,
                                              uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(scale_d));
}

// d += a b: m64n32k16, A (bfloat16 fragments) from registers, B from
// shared memory MN-major (transposed)
__device__ __forceinline__ void wgmma_rs_n32(float (&d)[16],
                                              const uint32_t (&a)[4],
                                              uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// d += a b: m64n64k16, A (bfloat16 fragments) from registers, B from
// shared memory MN-major (transposed)
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                              const uint32_t (&a)[4],
                                              uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// d += a b: m64n128k16, A (bfloat16 fragments) from registers, B from
// shared memory MN-major (transposed)
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64],
                                              const uint32_t (&a)[4],
                                              uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2],
                                         const uint32_t (&a)[4], uint64_t b) {
  if constexpr (N == 32) wgmma_rs_n32(d, a, b);
  if constexpr (N == 64) wgmma_rs_n64(d, a, b);
  if constexpr (N == 128) wgmma_rs_n128(d, a, b);
}

// Scales a tile's scores by scale2 (log2 e folded in), masks them where
// `kMask` (keys past Skv; above the diagonal under causal), and takes the
// online-softmax step of the thread's two rows: s becomes P, m and l (this
// thread's share of each row sum) move on, and alpha receives the factor
// by which each row's accumulator must be rescaled.  Score i of the
// thread is row r0 + 8 ((i / 2) % 2), key kv0 + 8 (i / 4) + 2 c + i % 2
// (the wgmma accumulator layout).
template <bool kMask>
__device__ __forceinline__ void softmax_step(float (&s)[kBN / 2],
                                             float (&m)[2], float (&l)[2],
                                             float (&alpha)[2], float scale2,
                                             int r0, int kv0, int c, int Skv,
                                             int causal) {
  float mx[2] = {kNegInf, kNegInf};
#pragma unroll
  for (int i = 0; i < kBN / 2; ++i) {
    float x = s[i] * scale2;
    if constexpr (kMask) {
      const int k_pos = kv0 + 8 * (i / 4) + 2 * c + (i & 1);
      const int q_pos = r0 + 8 * ((i >> 1) & 1);
      if (k_pos >= Skv || (causal && k_pos > q_pos)) x = kNegInf;
    }
    s[i] = x;
    mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], x);
  }
  float sum[2] = {0.f, 0.f};
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
    const float m_new = fmaxf(m[h], mx[h]);
    alpha[h] = exp2f(m[h] - m_new);
    m[h] = m_new;
  }
#pragma unroll
  for (int i = 0; i < kBN / 2; ++i) {
    const int h = (i >> 1) & 1;
    const float p = exp2f(s[i] - m[h]);
    s[i] = p;
    sum[h] += p;
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) l[h] = l[h] * alpha[h] + sum[h];
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
    flash_wgmma_kernel(const __grid_constant__ CUtensorMap map_q,
                       const __grid_constant__ CUtensorMap map_k,
                       const __grid_constant__ CUtensorMap map_v,
                       __nv_bfloat16* __restrict__ o, int Hq, int Hkv,
                       int Sq, int Skv, int causal, float scale) {
  using C = Cfg<D>;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* base = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t{1023});
  unsigned char* q_s = base;                       // 2 x (64 rows, D)
  unsigned char* kv_s = base + 2 * C::kQBytes;     // stages x (K tile, V tile)
  auto* bars = reinterpret_cast<uint64_t*>(base + C::kBarOff);
  uint64_t* bar_q = bars;
  uint64_t* bar_k = bars + 1;
  uint64_t* bar_v = bar_k + C::kStages;
  __shared__ int s_done[C::kStages];   // warpgroups done with a stage

  const int bh = blockIdx.x;
  const int b = bh / Hq;
  const int kvh = b * Hkv + (bh - b * Hq) / (Hq / Hkv);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBM;   // heaviest first
  int n_tiles = (Skv + kBN - 1) / kBN;
  if (causal) {
    // tiles starting past the CTA's last query row are wholly masked
    const int live = (q0 + kBM - 1) / kBN + 1;
    n_tiles = live < n_tiles ? live : n_tiles;
  }

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < C::kStages; ++s) {
      mbar_init(bar_k + s, 1);
      mbar_init(bar_v + s, 1);
      s_done[s] = 0;
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wgi = threadIdx.x / 128;
  // K and V of tile t into ring stage t % kStages, completing on its
  // barriers
  auto load_tile = [&](int t) {
    const int st = t % C::kStages;
    unsigned char* k_t = kv_s + 2 * st * C::kTileBytes;
    unsigned char* v_t = k_t + C::kTileBytes;
    mbar_expect_tx(bar_k + st, C::kTileBytes);
    for (int p = 0; p < C::kNP; ++p)
      tma_load(k_t + p * kBN * C::kSW, &map_k, bar_k + st, p * C::kPW,
               t * kBN, kvh);
    mbar_expect_tx(bar_v + st, C::kTileBytes);
    for (int p = 0; p < C::kNP; ++p)
      tma_load(v_t + p * kBN * C::kSW, &map_v, bar_v + st, p * C::kPW,
               t * kBN, kvh);
  };
  if (threadIdx.x == 0) {
    mbar_expect_tx(bar_q, 2 * C::kQBytes);
    for (int w = 0; w < 2; ++w)
      for (int p = 0; p < C::kNP; ++p)
        tma_load(q_s + w * C::kQBytes + p * 64 * C::kSW, &map_q, bar_q,
                 p * C::kPW, q0 + 64 * w, bh);
    for (int t = 0; t < C::kStages && t < n_tiles; ++t) load_tile(t);
  }
  // warpgroup wgi owns query rows q0 + 64 wgi .. + 63
  const int tw = threadIdx.x & 127;
  const int lane = tw & 31;
  const int c = lane & 3;
  const int r0 = q0 + 64 * wgi + 16 * (tw >> 5) + (lane >> 2);
  const int q0w = q0 + 64 * wgi;
  const float scale2 = scale * kLog2e;   // exp(x) = exp2(x log2 e)
  const unsigned char* q_w = q_s + wgi * C::kQBytes;

  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f}, alpha[2];
  float s[kBN / 2];              // scores, then P, of the newest tile
  uint32_t pa[kBN / 16][4];      // P of the tile whose P V is in flight

  // S = Q K^T of tile t: both K-major, a k16 step is 32 bytes into a
  // panel row
  auto issue_s = [&](int t) {
    const unsigned char* k_t = kv_s + 2 * (t % C::kStages) * C::kTileBytes;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const int p = kk * 16 / C::kPW, off = (kk * 16 % C::kPW) * 2;
      wgmma_ss_n128(s,
                    mdesc(q_w + p * 64 * C::kSW + off, 16, 8 * C::kSW,
                          C::kMode),
                    mdesc(k_t + p * kBN * C::kSW + off, 16, 8 * C::kSW,
                          C::kMode),
                    kk > 0);
    }
    wgmma_commit();
  };
  // O += P V of tile t: V (keys, D) is MN-major; a k16 step is 16 key
  // rows, panels of D are kBN rows apart
  auto issue_pv = [&](int t) {
    const unsigned char* v_t =
        kv_s + (2 * (t % C::kStages) + 1) * C::kTileBytes;
#pragma unroll
    for (int kk = 0; kk < kBN / 16; ++kk)
      wgmma_rs<D>(acc, pa[kk],
                  mdesc(v_t + kk * 16 * C::kSW, kBN * C::kSW, 8 * C::kSW,
                        C::kMode));
    wgmma_commit();
  };
  // the softmax of tile t (its S complete), masked only on the
  // diagonal tile (causal) and the ragged last tile
  auto softmax = [&](int t) {
#pragma unroll
    for (int i = 0; i < kBN / 2; ++i) pin(s[i]);
    const int kv0 = t * kBN;
    if (kv0 + kBN > Skv || (causal && kv0 + kBN - 1 > q0w))
      softmax_step<true>(s, m, l, alpha, scale2, r0, kv0, c, Skv, causal);
    else
      softmax_step<false>(s, m, l, alpha, scale2, r0, kv0, c, Skv, causal);
  };
  // P to bfloat16 in registers: two n8 accumulator blocks are the A
  // fragment of one k16 step
  auto pack_p = [&]() {
#pragma unroll
    for (int kk = 0; kk < kBN / 16; ++kk) {
      pa[kk][0] = pack_bf16(s[8 * kk + 0], s[8 * kk + 1]);
      pa[kk][1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
      pa[kk][2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
      pa[kk][3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
    }
  };
  // the P V of tile t is complete: its stage may refill
  auto retire_pv = [&](int t) {
#pragma unroll
    for (int i = 0; i < D / 2; ++i) pin(acc[i]);
#pragma unroll
    for (int kk = 0; kk < kBN / 16; ++kk)
#pragma unroll
      for (int e = 0; e < 4; ++e) pin(pa[kk][e]);
    // the later of the two warpgroups done with the stage refills it
    if (tw == 0) {
      __threadfence_block();
      if (atomicAdd(s_done + t % C::kStages, 1) == 1) {
        s_done[t % C::kStages] = 0;
        if (t + C::kStages < n_tiles) load_tile(t + C::kStages);
      }
    }
  };
  auto ready = [&](uint64_t* bar, int t) {
    mbar_wait(bar + t % C::kStages, (t / C::kStages) & 1);
  };

  // Software pipeline: tile t's S = Q K^T is issued together with tile
  // t - 1's P V, and its softmax runs while that P V is on the tensor
  // cores; O is rescaled once the P V is done.
  mbar_wait(bar_q, 0);
  ready(bar_k, 0);
  wgmma_fence();
  issue_s(0);
  wgmma_wait<0>();
  softmax(0);
  pack_p();
  for (int t = 1; t < n_tiles; ++t) {
    ready(bar_k, t);
    wgmma_fence();
    issue_s(t);
    ready(bar_v, t - 1);
    issue_pv(t - 1);
    wgmma_wait<1>();             // S of tile t
    softmax(t);
    wgmma_wait<0>();             // P V of tile t - 1
    retire_pv(t - 1);
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] *= alpha[(i >> 1) & 1];
    pack_p();
  }
  ready(bar_v, n_tiles - 1);
  wgmma_fence();
  issue_pv(n_tiles - 1);
  wgmma_wait<0>();
  retire_pv(n_tiles - 1);

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float lt = l[h];
    lt += __shfl_xor_sync(0xffffffffu, lt, 1);
    lt += __shfl_xor_sync(0xffffffffu, lt, 2);
    const float inv = 1.f / fmaxf(lt, 1e-30f);
    const int row = r0 + 8 * h;
    if (row >= Sq) continue;
    __nv_bfloat16* out = o + (static_cast<size_t>(bh) * Sq + row) * D;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(out + 8 * j + 2 * c) =
          __floats2bfloat162_rn(acc[4 * j + 2 * h] * inv,
                                acc[4 * j + 2 * h + 1] * inv);
  }
}

// cuTensorMapEncodeTiled, reached through the runtime so that the library
// needs no link against libcuda
using EncodeFn = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                              void*, const cuuint64_t*, const cuuint64_t*,
                              const cuuint32_t*, const cuuint32_t*,
                              CUtensorMapInterleave, CUtensorMapSwizzle,
                              CUtensorMapL2promotion,
                              CUtensorMapFloatOOBfill);

EncodeFn encode_fn() {
  static EncodeFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                         cudaEnableDefault, &q) ==
            cudaSuccess &&
        q == cudaDriverEntryPointSuccess)
#else
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &q) == cudaSuccess &&
        q == cudaDriverEntryPointSuccess)
#endif
      fn = reinterpret_cast<EncodeFn>(p);
  }
  return fn;
}

// The (BH, S, D) bfloat16 tensor at `ptr` as a 3-D TMA map of boxes
// (1, rows, kPW): rows past S read as zeros.
template <int D>
cudaError_t tensor_map(CUtensorMap* map, const void* ptr, int BH, int S,
                       int rows) {
  using C = Cfg<D>;
  const EncodeFn fn = encode_fn();
  if (fn == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(D),
                              static_cast<cuuint64_t>(S),
                              static_cast<cuuint64_t>(BH)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(D) * 2,
                                 static_cast<cuuint64_t>(S) * D * 2};
  const cuuint32_t box[3] = {static_cast<cuuint32_t>(C::kPW),
                             static_cast<cuuint32_t>(rows), 1};
  const cuuint32_t one[3] = {1, 1, 1};
  const CUresult r = fn(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr), dims,
      strides, box, one, CU_TENSOR_MAP_INTERLEAVE_NONE,
      C::kSW == 128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int B, int Hq, int Hkv, int Sq, int Skv, int causal,
                   float scale, cudaStream_t stream) {
  using C = Cfg<D>;
  CUtensorMap mq, mk, mv;
  cudaError_t err = tensor_map<D>(&mq, q, B * Hq, Sq, 64);
  if (err == cudaSuccess) err = tensor_map<D>(&mk, k, B * Hkv, Skv, kBN);
  if (err == cudaSuccess) err = tensor_map<D>(&mv, v, B * Hkv, Skv, kBN);
  if (err != cudaSuccess) return err;
  static bool raised = false;   // before any capture: the first call is eager
  if (!raised) {
    err = cudaFuncSetAttribute(flash_wgmma_kernel<D>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               C::kSmem);
    if (err != cudaSuccess) return err;
    raised = true;
  }
  const dim3 grid(B * Hq, (Sq + kBM - 1) / kBM);
  flash_wgmma_kernel<D><<<grid, kThreads, C::kSmem, stream>>>(
      mq, mk, mv, static_cast<__nv_bfloat16*>(o), Hq, Hkv, Sq, Skv, causal,
      scale);
  return cudaGetLastError();
}

}  // namespace wg

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
        return wg::launch<32>(q, k, v, o, B, Hq, Hkv, Sq, Skv, causal, scale,
                              stream);
      if (d == 64)
        return wg::launch<64>(q, k, v, o, B, Hq, Hkv, Sq, Skv, causal, scale,
                              stream);
      if (d == 128)
        return wg::launch<128>(q, k, v, o, B, Hq, Hkv, Sq, Skv, causal,
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
