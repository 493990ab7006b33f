// Fused column-condensed transform+aggregate on Hopper:
//   Y[i*B + r] = sum_{s < C} tiles[i, r, s] (X[gather_idx[i, s]] W) (+ Y_in).
//
// Replaces the Pallas TPU kernel repro/kernels/tcgnn_tile.py
// (tcgnn_spmm_fused, _fmv_kernel / _fmv_kernel_acc).  As on the TPU, H =
// X W never reaches device memory, and each condensed slot transforms its
// gathered row of X once per block row that names it.  Unlike the TPU
// path, the kernel gathers the rows of X itself: the (nbr, C, Fi) stripe
// XLA writes there (316 MB at pubmed's Fi = 500) is never formed.  The
// backward pass dX = A^T (dY W^T) is this kernel over the transpose
// payload with W^T.
//
// Real slots.  A block row's slots past the last one whose tile column
// holds a non-zero in any of its B rows add nothing, so neither kernel
// gathers or transforms them: each CTA first reads its (B, C) tile and
// takes that count itself (tcgnn_real.cuh; the payload carries none;
// coo_to_tcgnn ranks a row's columns densest first, so its padding is a
// suffix, but any all-zero suffix is skipped).  At pubmed's inter tier that is 79463 of
// the 157824 slots.  Skipping an all-zero column changes the result only
// where its gathered row of X holds an infinity or a NaN (0 * inf is NaN
// in the plain version, nothing here).
//
// Design.  The launch picks one of two kernels from the widths.
//  - Wide (32 <= Fi <= 1024, rows of X and W that allow copies of 4 bytes
//    or more: layer 1): a CTA of 256 threads owns one block row and one
//    16-column tile of Fo.  It walks the real slots in chunks of 64.  The
//    gathered rows of a chunk stream through a 4-stage cp.async ring, 32
//    columns of Fi a stage (copies of 16, 8 or 4 bytes, whatever the row
//    pitch and base allow: 16 for float32 at Fi = 500, 8 for its 1000-byte
//    bfloat16 rows), so three stages are in flight while one is
//    multiplied.  The (Fi, 16) stripe of W (32 KB at Fi = 500) joins the
//    first stage's copies; the tile (read as float4 to count the real
//    slots) and the first chunk's gather indices are read at the same
//    time, and each later chunk's indices a chunk ahead.  The four 64-thread
//    groups each take 8 of a stage's 32 columns; a thread keeps a 4-slot x
//    4-column micro-tile of H in registers and reads X and W as vectors (64
//    FMAs for 8 vector loads).  After a chunk's last stage the four partial
//    H go to shared memory and are summed, and each thread applies the
//    chunk's (B, 64) tile slice, staged with that last stage, to its
//    outputs of Y, kept in registers across chunks.  The hardware hands the
//    row CTAs to SMs as they free up (2 an SM), which balances rows of 0 to
//    128 real slots.
//  - Narrow (everything else: layer 2 and its dX pass): per block row and
//    Fo tile of at most 64 columns, the CTA walks the real slots in chunks
//    of cs; for each chunk it stages the gathered (cs, kc) slice of X and,
//    unless Fi fits in one chunk, the (kc, ft) slice of W as float32 in
//    shared memory, forms H, then adds tiles @ H to the outputs each thread
//    keeps in registers.
// The float32 path is float32 FMAs on the CUDA cores (TF32 would break the
// float32 gate at Fi = 500); bfloat16 inputs are widened to float32 as
// they are read from shared memory.
//
// Bound.  At pubmed's inter tier (nbr = 1233, B = 16, C = 128) and layer
// 1's widths (Fi = 500, Fo = 16) the function reads 10.1 MB of tiles, the
// 39.5 MB of X (every source row is named by some real slot) and W, and
// writes Y: about 51.5 MB, so it is bound by bytes (0.0154 ms).  The
// per-slot transform gathers 79463 rows of 2000 bytes, 159 MB, mostly
// from L2, and does 2 x 79463 x 500 x 16 = 1.27 GFLOP (0.019 ms at the
// float32 rate).  On an H100 at 700 W (tools/port_kernels_bench.py) the
// wide kernel takes 0.116 ms there, against 0.151 ms for
// torch.bmm(tiles, (x @ w)[gather_idx]): the same with L2 warm, 0.030 ms
// at Fi = 32 and 0.047 ms at Fi = 128.  So about 0.03 ms is each CTA's
// chain of dependent reads before its first multiply (tile and indices,
// then the first rows of X), which two CTAs an SM hide only in part, and
// the rest the gather, at about 1.9 TB/s.
//
// Limits.  B <= 64, any C, Fi, Fo >= 1.  Shared memory, wide: 4 stages of
// (64 x (32 + 16 B) X elements and B x 68 tile floats), the W stripe and 16
// KB of partial H: 103 KB at B = 16, Fi = 500 float32.  Narrow:
// B*cs + cs*(kc+1) + kc*ft + cs*ft floats <= 48 KB.
#include <cstdint>

#include "cp_async.cuh"
#include "dtype.cuh"
#include "tcgnn_real.cuh"

namespace {

using repro_torch::align16;
using repro_torch::copy_granule;
using repro_torch::cp_commit;
using repro_torch::cp_wait;
using repro_torch::from_f32;
using repro_torch::granule;
using repro_torch::ld4;
using repro_torch::real_slots;
using repro_torch::to_f32;

constexpr int kThreads = 256;

// ---------------------------------------------------------------------------
// shared pieces
// ---------------------------------------------------------------------------

template <typename T>
struct Args {
  const float* tiles;
  const int* gather_idx;
  const T* x;
  const T* w;
  const T* y_in;   // optional
  T* y;
  int nbr, B, C, Fi, Fo;
};

// ---------------------------------------------------------------------------
// wide kernel
// ---------------------------------------------------------------------------

constexpr int kCS = 64;                       // slots a chunk
constexpr int kKT = 32;                       // Fi columns a ring stage
constexpr int kFT = 16;                       // Fo columns a CTA
constexpr int kStages = 4;
constexpr int kTP = kCS + 4;                  // pitch of the tile slice
constexpr int kMaxPY = 64 * kFT / kThreads;   // Y outputs a thread, B <= 64
constexpr int kWideMinFi = 32;
constexpr int kWideMaxFi = 1024;              // W stripe <= 64 KB

// row pitch of a stage's X slice: 16 bytes of padding keep the 8 rows a
// quarter-warp reads in distinct banks
template <typename T>
__host__ __device__ constexpr int x_pitch() {
  return kKT + 16 / static_cast<int>(sizeof(T));
}

struct WideCfg {
  int nkt;           // ring stages a chunk: ceil(Fi / 32)
  int w_rows;        // rows of the staged W stripe (nkt * 32)
  int x_bytes;       // a stage's X slice; its tile slice follows
  int stage_bytes;
  int gt;            // tile copy granule (16 or 4 bytes)
  int gw;            // W copy granule (16, 8 or 4 bytes)
  int vec;           // the tiles can be read as float4
};

// G: the X copy granule in bytes (16, 8 or 4)
template <typename T, int G>
__global__ void __launch_bounds__(kThreads, 2)
    tcgnn_fused_wide_kernel(const Args<T> p, const WideCfg c) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int s_n;
  constexpr int kSz = sizeof(T);
  constexpr int kE = G / kSz;                    // elements a granule
  constexpr int kGpr = kKT / kE;                 // granules a stage row
  constexpr int kPass = kCS * kGpr / kThreads;   // granules a thread
  constexpr int kXp = x_pitch<T>();
  const int t = threadIdx.x;
  const int B = p.B, C = p.C, Fi = p.Fi, Fo = p.Fo;
  const int row = blockIdx.x;
  const int n0 = blockIdx.y * kFT;
  const int fw = min(kFT, Fo - n0);
  const float* t_row = p.tiles + static_cast<size_t>(row) * B * C;
  const int* g_row = p.gather_idx + static_cast<size_t>(row) * C;
  auto* w_s = reinterpret_cast<T*>(smem + kStages * c.stage_bytes);
  auto* h_s = reinterpret_cast<float*>(         // 4 x (64 slots, 16)
      smem + kStages * c.stage_bytes + align16(c.w_rows * kFT * kSz));

  // the block row's Y outputs o = t + 256 pp: (o / 16, o % 16)
  float yacc[kMaxPY];
#pragma unroll
  for (int pp = 0; pp < kMaxPY; ++pp) {
    const int o = t + kThreads * pp;
    const int r = o >> 4, cc = o & 15;
    yacc[pp] = 0.f;
    if (p.y_in != nullptr && r < B && cc < fw)
      yacc[pp] = to_f32(
          p.y_in[(static_cast<size_t>(row) * B + r) * Fo + n0 + cc]);
  }
  // the W stripe, zero past Fi and Fo, joins the first copy group
  {
    const int ew = c.gw / kSz, gpr = kFT / ew;
    for (int e = t; e < c.w_rows * gpr; e += kThreads) {
      const int k = e / gpr, n = (e - k * gpr) * ew;
      const int bytes = k < Fi ? max(0, min(c.gw, (fw - n) * kSz)) : 0;
      copy_granule(w_s + k * kFT + n,
                   p.w + (bytes > 0 ? static_cast<size_t>(k) * Fo + n0 + n
                                    : 0),
                   c.gw, bytes);
    }
  }
  // X copies: thread t moves granules t + 256 q of each stage, rows
  // (t + 256 q) / kGpr, whose gather indices are read a chunk ahead; the
  // issue cursor advances one stage a call
  int gnext[kPass];
  auto fetch_rows = [&](int c0) {
#pragma unroll
    for (int q = 0; q < kPass; ++q) {
      const int m = c0 + (t + kThreads * q) / kGpr;
      gnext[q] = m < C ? __ldg(g_row + m) : 0;
    }
  };
  fetch_rows(0);
  const int n_real = real_slots(t_row, B, C, c.vec, &s_n);
  const int nchunk = (n_real + kCS - 1) / kCS;
  const int nsteps = nchunk * c.nkt;

  int i_ch = 0, i_kt = 0, i_slot = 0;
  unsigned valid = 0;
  size_t xoff[kPass];
#pragma unroll
  for (int q = 0; q < kPass; ++q) xoff[q] = 0;
  auto issue = [&]() {
    if (i_ch < nchunk) {
      unsigned char* st = smem + i_slot * c.stage_bytes;
      const int c0 = i_ch * kCS;
      if (i_kt == 0) {   // this chunk's source rows; the next chunk's
        valid = 0;
#pragma unroll
        for (int q = 0; q < kPass; ++q) {
          const int m = (t + kThreads * q) / kGpr;
          if (c0 + m < n_real) {
            valid |= 1u << q;
            xoff[q] = static_cast<size_t>(gnext[q]) * Fi;
          }
        }
        if (i_ch + 1 < nchunk) fetch_rows(c0 + kCS);
      }
      T* sx = reinterpret_cast<T*>(st);
#pragma unroll
      for (int q = 0; q < kPass; ++q) {
        if (!(valid >> q & 1u)) continue;
        const int e = t + kThreads * q;
        const int m = e / kGpr, gg = e % kGpr;
        const int col = i_kt * kKT + gg * kE;
        const int bytes = max(0, min(G, (Fi - col) * kSz));
        copy_granule(sx + m * kXp + gg * kE,
                     p.x + xoff[q] + (bytes > 0 ? col : 0), G, bytes);
      }
      if (i_kt == c.nkt - 1) {   // the chunk's (B, 64) tile slice
        auto* stt = reinterpret_cast<float*>(st + c.x_bytes);
        const int et = c.gt / 4, gpr = kCS / et;
        for (int e = t; e < B * gpr; e += kThreads) {
          const int r = e / gpr;
          const int col = (e - r * gpr) * et;
          const int bytes = max(0, min(c.gt, (C - c0 - col) * 4));
          copy_granule(stt + r * kTP + col,
                       t_row + static_cast<size_t>(r) * C +
                           (bytes > 0 ? c0 + col : 0),
                       c.gt, bytes);
        }
      }
      if (++i_kt == c.nkt) {
        i_kt = 0;
        ++i_ch;
      }
      if (++i_slot == kStages) i_slot = 0;
    }
    cp_commit();
  };
  for (int s = 0; s < kStages - 1; ++s) issue();

  // group kg (warps 2 kg, 2 kg + 1) takes columns 8 kg .. 8 kg + 7 of each
  // stage; thread tl keeps H slots tm + 16 j, columns 4 tn .. 4 tn + 3
  const int kg = t >> 6, tl = t & 63;
  const int tm = tl >> 2, tn = tl & 3;
  float h[4][4];
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int n = 0; n < 4; ++n) h[j][n] = 0.f;

  int ch = 0, kt = 0, slot = 0;
  for (int s = 0; s < nsteps; ++s) {
    cp_wait<kStages - 2>();
    __syncthreads();
    issue();
    unsigned char* st = smem + slot * c.stage_bytes;
    const T* xs = reinterpret_cast<const T*>(st) + tm * kXp + 8 * kg;
    const T* ws = w_s + (kt * kKT + 8 * kg) * kFT + 4 * tn;
#pragma unroll
    for (int kk = 0; kk < 8; kk += 4) {
      float wv[4][4];
#pragma unroll
      for (int q = 0; q < 4; ++q) ld4(ws + (kk + q) * kFT, wv[q]);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float xv[4];
        ld4(xs + 16 * j * kXp + kk, xv);
#pragma unroll
        for (int q = 0; q < 4; ++q)
#pragma unroll
          for (int n = 0; n < 4; ++n) h[j][n] = fmaf(xv[q], wv[q][n], h[j][n]);
      }
    }
    if (++slot == kStages) slot = 0;
    if (++kt != c.nkt) continue;
    kt = 0;

    // the chunk is transformed: sum the four groups' partial H in shared
    // memory, then apply the chunk's tile slice to it
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      *reinterpret_cast<float4*>(h_s + kg * kCS * kFT + (tm + 16 * j) * kFT +
                                 4 * tn) =
          make_float4(h[j][0], h[j][1], h[j][2], h[j][3]);
#pragma unroll
      for (int n = 0; n < 4; ++n) h[j][n] = 0.f;
    }
    __syncthreads();
    {
      auto* hv = reinterpret_cast<float4*>(h_s);
      float4 a = hv[t];
#pragma unroll
      for (int g = 1; g < 4; ++g) {
        const float4 b = hv[t + g * kCS * kFT / 4];
        a.x += b.x;
        a.y += b.y;
        a.z += b.z;
        a.w += b.w;
      }
      hv[t] = a;
    }
    __syncthreads();
    const auto* ts = reinterpret_cast<const float*>(st + c.x_bytes);
    const int cw = min(kCS, n_real - ch * kCS);
#pragma unroll
    for (int pp = 0; pp < kMaxPY; ++pp) {
      const int o = t + kThreads * pp;
      const int r = o >> 4, cc = o & 15;
      if (r >= B) continue;
      const float* tr = ts + r * kTP;
      float acc = yacc[pp];
#pragma unroll 4
      for (int j = 0; j < cw; ++j) acc = fmaf(tr[j], h_s[j * kFT + cc], acc);
      yacc[pp] = acc;
    }
    ++ch;
  }
  cp_wait<0>();

#pragma unroll
  for (int pp = 0; pp < kMaxPY; ++pp) {
    const int o = t + kThreads * pp;
    const int r = o >> 4, cc = o & 15;
    if (r < B && cc < fw)
      p.y[(static_cast<size_t>(row) * B + r) * Fo + n0 + cc] =
          from_f32<T>(yacc[pp]);
  }
}

template <typename T, int G>
cudaError_t launch_wide(const Args<T>& p, cudaStream_t stream) {
  WideCfg c;
  c.nkt = (p.Fi + kKT - 1) / kKT;
  c.w_rows = c.nkt * kKT;
  c.x_bytes = align16(kCS * x_pitch<T>() * static_cast<int>(sizeof(T)));
  c.stage_bytes = c.x_bytes + align16(p.B * kTP * 4);
  c.gt = granule(static_cast<long long>(p.C) * 4, p.tiles) == 16 ? 16 : 4;
  c.vec = c.gt == 16;
  c.gw = granule(static_cast<long long>(p.Fo) * sizeof(T), p.w);
  const int smem = kStages * c.stage_bytes +
                   align16(c.w_rows * kFT * static_cast<int>(sizeof(T))) +
                   4 * kCS * kFT * 4;
  cudaError_t err = cudaFuncSetAttribute(
      tcgnn_fused_wide_kernel<T, G>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(tcgnn_fused_wide_kernel<T, G>,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return err;
  const dim3 grid(p.nbr, (p.Fo + kFT - 1) / kFT);
  tcgnn_fused_wide_kernel<T, G><<<grid, kThreads, smem, stream>>>(p, c);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// narrow kernel
// ---------------------------------------------------------------------------

constexpr int kMaxFt = 64;
constexpr int kMaxChunk = 64;                 // Fi columns per chunk
constexpr int kSmemFloats = 48 * 1024 / 4;    // 48 KB of float32

// kOut: outputs per thread, enough for both the (cs, ft) H chunk and the
// (B, ft) output tile, as a power of two.
template <typename T, int kOut>
__global__ void __launch_bounds__(kThreads)
    tcgnn_fused_narrow_kernel(const Args<T> p, int ft, int cs, int kc) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int s_n;
  const int B = p.B, C = p.C, Fi = p.Fi, Fo = p.Fo;
  const int xs = kc + 1;             // padded row stride: no bank conflicts
  auto* t_s = reinterpret_cast<float*>(smem);   // (B, cs)
  float* x_s = t_s + B * cs;         // (cs, kc + 1)
  float* w_s = x_s + cs * xs;        // (kc, ft)
  float* h_s = w_s + kc * ft;        // (cs, ft)

  const int i = blockIdx.x;          // block row
  const int f0 = blockIdx.y * ft;
  const int fw = min(ft, Fo - f0);
  const int n_out = B * fw;
  const size_t row0 = static_cast<size_t>(i) * B;
  const float* t_row = p.tiles + row0 * C;
  const int* g_row = p.gather_idx + static_cast<size_t>(i) * C;
  const bool w_once = Fi <= kc;      // one chunk: stage W once per CTA

  float acc[kOut];
#pragma unroll
  for (int q = 0; q < kOut; ++q) {
    const int o = threadIdx.x + q * kThreads;
    acc[q] = 0.f;
    if (p.y_in != nullptr && o < n_out) {
      const int r = o / fw;
      acc[q] = to_f32(p.y_in[(row0 + r) * Fo + f0 + (o - r * fw)]);
    }
  }
  if (w_once) {
    for (int e = threadIdx.x; e < Fi * fw; e += kThreads) {
      const int j = e / fw;
      const int c = e - j * fw;
      w_s[j * ft + c] = to_f32(p.w[static_cast<size_t>(j) * Fo + f0 + c]);
    }
  }
  const int n_real = real_slots(
      t_row, B, C,
      C % 4 == 0 && (reinterpret_cast<uintptr_t>(p.tiles) & 15) == 0, &s_n);

  for (int c0 = 0; c0 < n_real; c0 += cs) {
    const int cw = min(cs, n_real - c0);
    const int n_h = cw * fw;
    for (int e = threadIdx.x; e < B * cw; e += kThreads) {
      const int r = e / cw;
      const int s = e - r * cw;
      t_s[r * cs + s] = t_row[static_cast<size_t>(r) * C + c0 + s];
    }

    float h[kOut];
#pragma unroll
    for (int q = 0; q < kOut; ++q) h[q] = 0.f;
    for (int k0 = 0; k0 < Fi; k0 += kc) {
      const int kw = min(kc, Fi - k0);
      for (int e = threadIdx.x; e < cw * kw; e += kThreads) {
        const int s = e / kw;
        const int j = e - s * kw;
        const size_t src = static_cast<size_t>(__ldg(g_row + c0 + s));
        x_s[s * xs + j] = to_f32(p.x[src * Fi + k0 + j]);
      }
      if (!w_once) {
        for (int e = threadIdx.x; e < kw * fw; e += kThreads) {
          const int j = e / fw;
          const int c = e - j * fw;
          w_s[j * ft + c] =
              to_f32(p.w[static_cast<size_t>(k0 + j) * Fo + f0 + c]);
        }
      }
      __syncthreads();
#pragma unroll
      for (int q = 0; q < kOut; ++q) {
        const int o = threadIdx.x + q * kThreads;
        if (o < n_h) {
          const int s = o / fw;
          const int c = o - s * fw;
          const float* xr = x_s + s * xs;
          float v = h[q];
#pragma unroll 8
          for (int j = 0; j < kw; ++j) v = fmaf(xr[j], w_s[j * ft + c], v);
          h[q] = v;
        }
      }
      __syncthreads();
    }

#pragma unroll
    for (int q = 0; q < kOut; ++q) {
      const int o = threadIdx.x + q * kThreads;
      if (o < n_h) {
        const int s = o / fw;
        h_s[s * ft + (o - s * fw)] = h[q];
      }
    }
    __syncthreads();
#pragma unroll
    for (int q = 0; q < kOut; ++q) {
      const int o = threadIdx.x + q * kThreads;
      if (o < n_out) {
        const int r = o / fw;
        const int c = o - r * fw;
        const float* tr = t_s + r * cs;
        float v = acc[q];
#pragma unroll 8
        for (int j = 0; j < cw; ++j) v = fmaf(tr[j], h_s[j * ft + c], v);
        acc[q] = v;
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int q = 0; q < kOut; ++q) {
    const int o = threadIdx.x + q * kThreads;
    if (o < n_out) {
      const int r = o / fw;
      p.y[(row0 + r) * Fo + f0 + (o - r * fw)] = from_f32<T>(acc[q]);
    }
  }
}

template <typename T>
cudaError_t launch_narrow(const Args<T>& p, cudaStream_t stream) {
  const int ft = p.Fo < kMaxFt ? p.Fo : kMaxFt;
  int cs = 4096 / ft;                // H chunk of at most 4096 outputs
  if (cs > 64) cs = 64;
  if (cs > p.C) cs = p.C;
  int kc = (kSmemFloats - p.B * cs - cs - cs * ft) / (cs + ft);
  if (kc > kMaxChunk) kc = kMaxChunk;
  if (kc > p.Fi) kc = p.Fi;
  if (kc < 1) return cudaErrorInvalidValue;
  const dim3 grid(p.nbr, (p.Fo + ft - 1) / ft);
  const size_t smem =
      static_cast<size_t>(p.B * cs + cs * (kc + 1) + kc * ft + cs * ft) *
      sizeof(float);
  const int n_max = (p.B > cs ? p.B : cs) * ft;
  const int per = (n_max + kThreads - 1) / kThreads;
  auto kernel = per <= 1   ? tcgnn_fused_narrow_kernel<T, 1>
                : per <= 2 ? tcgnn_fused_narrow_kernel<T, 2>
                : per <= 4 ? tcgnn_fused_narrow_kernel<T, 4>
                : per <= 8 ? tcgnn_fused_narrow_kernel<T, 8>
                           : tcgnn_fused_narrow_kernel<T, 16>;
  kernel<<<grid, kThreads, smem, stream>>>(p, ft, cs, kc);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const Args<T>& p, cudaStream_t stream) {
  // the wide kernel copies X rows and the W stripe 4 bytes at a time or
  // more: bfloat16 rows of odd pitch take the narrow one
  if (p.Fi >= kWideMinFi && p.Fi <= kWideMaxFi &&
      granule(static_cast<long long>(p.Fo) * sizeof(T), p.w) >= 4) {
    switch (granule(static_cast<long long>(p.Fi) * sizeof(T), p.x)) {
      case 16:
        return launch_wide<T, 16>(p, stream);
      case 8:
        return launch_wide<T, 8>(p, stream);
      case 4:
        return launch_wide<T, 4>(p, stream);
      default:   // bfloat16 rows of odd pitch
        break;
    }
  }
  return launch_narrow(p, stream);
}

}  // namespace

// Launches on `stream`; returns the cudaError_t of the launch (0 = success).
// tiles (nbr, B, C) float32, gather_idx (nbr, C) int32 rows of x,
// x (n_cols, Fi), w (Fi, Fo), y and y_in (nbr*B, Fo) with y_in optional, of
// the element type `dtype` (0 = float32, 1 = bfloat16); all contiguous.
extern "C" int tcgnn_spmm_fused_launch(const void* tiles,
                                       const void* gather_idx, const void* x,
                                       const void* w, const void* y_in,
                                       void* y, int nbr, int B, int C, int Fi,
                                       int Fo, int dtype, void* stream) {
  if (nbr <= 0 || Fo <= 0) return 0;
  if (B < 1 || B > 64 || C < 1 || Fi < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* t = static_cast<const float*>(tiles);
  const auto* gi = static_cast<const int*>(gather_idx);
  switch (dtype) {
    case repro_torch::kFloat32: {
      using T = float;
      const Args<T> p{t, gi, static_cast<const T*>(x),
                      static_cast<const T*>(w), static_cast<const T*>(y_in),
                      static_cast<T*>(y), nbr, B, C, Fi, Fo};
      return static_cast<int>(launch(p, s));
    }
    case repro_torch::kBFloat16: {
      using T = __nv_bfloat16;
      const Args<T> p{t, gi, static_cast<const T*>(x),
                      static_cast<const T*>(w), static_cast<const T*>(y_in),
                      static_cast<T*>(y), nbr, B, C, Fi, Fo};
      return static_cast<int>(launch(p, s));
    }
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" const char* tcgnn_spmm_fused_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
