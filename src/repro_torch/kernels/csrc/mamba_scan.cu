// Selective SSM scan (Mamba) on Hopper, forward, from a zero state:
//   h_t = exp(dt_t A) h_{t-1} + dt_t B_t x_t ;   y_t = C_t . h_t + D x_t
//
// Replaces the Pallas TPU kernel src/repro/kernels/mamba_scan.py:59
// (mamba_scan, _kernel): x (B, T, di) in the model type, dt (B, T, di)
// post-softplus, B and C (B, T, ds), A (di, ds), D (di,) all float32 ->
// y (B, T, di) in x's type.  The state and every product are float32.
//
// The Pallas kernel walks a sequential grid of T / chunk steps per
// (b, d_tile) with the (d_tile, ds) state in VMEM, and inside a chunk runs
// an associative scan over (chunk, d_tile, ds) tensors.  Here the loop over
// T runs in order with the state in registers, so the rounding follows the
// sequential oracle (ref.mamba_ssm) rather than the in-chunk scan.
// exp(dt A) <= 1 since A < 0 and dt > 0, so nothing grows past the state's
// own size.
//
// Bound on this card.  x, dt and y in float32 are read or written once,
// B, C, A and D read once: 403.7 MB at (4, 1024, 8192, 16), 0.1205 ms at
// 3.35 TB/s; mamba_scan_flops counts 4.29 GFLOP, 0.064 ms on the float32
// CUDA cores, so the bound is bytes.  Two issue limits sit near it: each
// state element needs one exp, and the SFU (MUFU) returns 16 a clock per
// SM: 537 M exps at either timed shape take 0.128 ms at 1.98 GHz; and
// about 7 warp instructions per 32 state elements (the exp's argument, the
// exp, dt B x, the update, the C product, a share of the loads and of the
// sum over lanes) take about as long on the four schedulers.
//
// Design.  G adjacent lanes share a channel, each holding ds / G of its
// states (ds padded to 2, 4, 8 or 16; a padded slot gets A = 0 and B = C
// = 0, so it stays 0), and walk T in order.  Chunks of kTC = 16 steps of
// x, dt (16 x channels) and B, C (16 x ds) stream through a ring in shared
// memory, S - 1 chunks ahead, one CTA barrier a chunk.  Each lane keeps its
// share of y_t for the chunk's 16 steps in registers (lane 0's carries
// D x_t); log2(G) rounds of shuffles then leave lane g with the full sums
// of steps G i + g, which it stores.  exp(dt A) is ex2.approx(dt * (A
// log2 e)), one MUFU instruction, with A log2 e formed once per channel.
// The launch picks the shape (launch_ds).  The copies were the limit: with
// 16-byte cp.async the loads alone ran at about 1.4 TB/s at batch 4, so
// there one warp issues bulk copies (cp.async.bulk, the TMA: a 256-byte
// row of x and of dt each, and the chunk's B and C) completing on the
// slot's mbarrier.
// Limits.  1 <= ds <= 16; any B <= 65535, T, di >= 0; 50 KB of shared
// memory a CTA at batch 4, 160 KB at batch 1.
#include <algorithm>
#include <cstdint>

#include "cp_async.cuh"
#include "dtype.cuh"

namespace {

using repro_torch::bulk_copy;
using repro_torch::copy_tile;
using repro_torch::cp_commit;
using repro_torch::cp_wait;
using repro_torch::mbar_expect_tx;
using repro_torch::mbar_init;
using repro_torch::mbar_wait;
using repro_torch::from_f32;
using repro_torch::to_f32;

constexpr int kTC = 16;          // steps staged per chunk
constexpr int kMaxDs = 16;
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// G adjacent lanes share a channel, each holding DS / G of its states; a
// CTA of NT threads owns NT / G channels
template <int DS, int G, int NT>
struct Split {
  static constexpr int kSpl = DS / G;            // states a lane holds
  static constexpr int kNch = NT / G;            // channels a CTA owns
};

template <int N>
struct FVec;
template <>
struct FVec<2> {
  __device__ __forceinline__ static void load(const float* p, float* v) {
    const float2 t = *reinterpret_cast<const float2*>(p);
    v[0] = t.x;
    v[1] = t.y;
  }
};
template <>
struct FVec<4> {
  __device__ __forceinline__ static void load(const float* p, float* v) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    v[0] = t.x;
    v[1] = t.y;
    v[2] = t.z;
    v[3] = t.w;
  }
};
template <>
struct FVec<8> {
  __device__ __forceinline__ static void load(const float* p, float* v) {
    FVec<4>::load(p, v);
    FVec<4>::load(p + 4, v + 4);
  }
};

// a CTA's ring of S chunks of x, dt (kTC x channels) and B, C (kTC x ds),
// and the mbarriers of the bulk copies
template <typename E, int DS, int G, int NT, int S>
struct Ring {
  static constexpr int kNch = Split<DS, G, NT>::kNch;
  struct alignas(16) Chunk {
    E x[kTC][kNch];
    float dt[kTC][kNch];
    float b[kTC][DS], c[kTC][DS];
  } slot[S];
  uint64_t full[S];
};

// One round of the sum over a channel's lanes: of the first N partial sums
// (steps 2 i and 2 i + 1, partners M lanes apart), the lane with bit M
// keeps the odd ones and adds its partner's, so part[i] ends as a sum over
// both lanes.
template <int M, int N>
__device__ __forceinline__ void fold(float (&part)[kTC], int g) {
  static_assert(N % 2 == 0, "a round halves an even count");
  const bool hi = (g & M) != 0;
#pragma unroll
  for (int i = 0; i < N / 2; ++i) {
    const float keep = hi ? part[2 * i + 1] : part[2 * i];
    const float send = hi ? part[2 * i] : part[2 * i + 1];
    part[i] = keep + __shfl_xor_sync(0xffffffffu, send, M);
  }
}

// granules of a tile of kTC rows of dp elements at granule g
template <typename X>
__device__ __forceinline__ int granules(int dp, int g) {
  return kTC * dp * static_cast<int>(sizeof(X)) / g;
}

template <typename E, int DS, int G, int NT, int S, int MINB, bool BULK>
__global__ void __launch_bounds__(NT, MINB)
    mamba_scan_kernel(const E* __restrict__ x, const float* __restrict__ dt,
                      const float* __restrict__ bc,
                      const float* __restrict__ cc,
                      const float* __restrict__ a_mat,
                      const float* __restrict__ d_vec, E* __restrict__ y,
                      int T, int di, int ds, int gx, int gdt, int gbc) {
  constexpr int SPL = Split<DS, G, NT>::kSpl;
  constexpr int NCH = Split<DS, G, NT>::kNch;
  extern __shared__ __align__(16) unsigned char smem_bytes[];
  auto& ring = *reinterpret_cast<Ring<E, DS, G, NT, S>*>(smem_bytes);

  const int tid = threadIdx.x;
  const int g = tid % G;                   // state group: adjacent lanes
  const int cl = tid / G;                  // channel in the CTA
  const int d0 = blockIdx.x * NCH;
  const int d = d0 + cl;
  const int nd = min(NCH, di - d0);
  const bool live = d < di;
  const int64_t row0 = static_cast<int64_t>(blockIdx.y) * T;  // (b, t = 0)

  float a2[SPL], h[SPL];
#pragma unroll
  for (int s = 0; s < SPL; ++s) {
    const int sg = g * SPL + s;
    a2[s] = (live && sg < ds)
                ? a_mat[static_cast<int64_t>(d) * ds + sg] * kLog2e
                : 0.f;
    h[s] = 0.f;
  }
  const float dd = (live && g == 0) ? d_vec[d] : 0.f;
  const int n_chunks = (T + kTC - 1) / kTC;
  // each tile's copies start where the previous tile's left off, so every
  // thread issues about the same number
  const int r_dt = granules<E>(NCH, gx) % NT;
  const int r_b = (r_dt + granules<float>(NCH, gdt)) % NT;
  const int r_c = (r_b + granules<float>(DS, gbc)) % NT;
  auto rot = [&](int r) { return (tid + NT - r) % NT; };

  // copies of chunk c into its slot.  BULK: warp 0 issues one bulk copy a
  // row of x and of dt and one for the chunk's B and C, all completing on
  // the slot's mbarrier (rows past T are not copied: their steps are not
  // stored).  Otherwise: cp.async granules, one commit group per call
  // (empty past the end), so cp_wait<S - 2> means "chunk c landed"; steps
  // past T and channels past di read as zeros.
  auto stage = [&](int c) {
    if constexpr (BULK) {
      if (c >= n_chunks || tid >= 32) return;
      auto& k = ring.slot[c % S];
      uint64_t* bar = &ring.full[c % S];
      const int t0 = c * kTC, valid = min(kTC, T - t0);
      const int64_t r = row0 + t0;
      constexpr int kRow = NCH * static_cast<int>(sizeof(E));
      if (tid == 0)
        mbar_expect_tx(bar, valid * (kRow + NCH * 4 + 2 * DS * 4));
      __syncwarp();
      const int j = tid & (kTC - 1);
      if (j < valid) {
        if (tid < kTC)
          bulk_copy(&k.x[j][0], x + (r + j) * di + d0, kRow, bar);
        else
          bulk_copy(&k.dt[j][0], dt + (r + j) * di + d0, NCH * 4, bar);
      }
      if (tid == 0) bulk_copy(&k.b[0][0], bc + r * DS, valid * DS * 4, bar);
      if (tid == 1) bulk_copy(&k.c[0][0], cc + r * DS, valid * DS * 4, bar);
    } else {
      if (c < n_chunks) {
        auto& k = ring.slot[c % S];
        const int t0 = c * kTC, valid = min(kTC, T - t0);
        const int64_t r = row0 + t0;
        copy_tile<NCH>(&k.x[0][0], x + r * di + d0, di, nd, kTC, valid, gx,
                       tid, NT);
        copy_tile<NCH>(&k.dt[0][0], dt + r * di + d0, di, nd, kTC, valid,
                       gdt, rot(r_dt), NT);
        copy_tile<DS>(&k.b[0][0], bc + r * ds, ds, ds, kTC, valid, gbc,
                      rot(r_b), NT);
        copy_tile<DS>(&k.c[0][0], cc + r * ds, ds, ds, kTC, valid, gbc,
                      rot(r_c), NT);
      }
      cp_commit();
    }
  };

  if constexpr (BULK) {
    if (tid == 0) {
      for (int i = 0; i < S; ++i) mbar_init(&ring.full[i], 1);
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();
  }
  for (int c = 0; c < S - 1; ++c) stage(c);
  for (int c = 0; c < n_chunks; ++c) {
    if constexpr (BULK)
      mbar_wait(&ring.full[c % S], (c / S) & 1);
    else
      cp_wait<S - 2>();
    // chunk c is visible, and every thread is done with chunk c - 1, so
    // its slot may take chunk c + S - 1
    __syncthreads();
    stage(c + S - 1);
    const auto& k = ring.slot[c % S];
    // this lane's share of y_t for each step (group 0's carries D x_t);
    // steps past T read x = dt = 0: exp(0) = 1 and no input, so h holds
    float part[kTC];
#pragma unroll
    for (int j = 0; j < kTC; ++j) {
      const float xv = to_f32(k.x[j][cl]);
      const float dv = k.dt[j][cl];
      const float dx = dv * xv;
      float bv[SPL], cv[SPL];
      FVec<SPL>::load(&k.b[j][g * SPL], bv);
      FVec<SPL>::load(&k.c[j][g * SPL], cv);
      float acc = dd * xv;
#pragma unroll
      for (int s = 0; s < SPL; ++s) {
        h[s] = fmaf(ex2(dv * a2[s]), h[s], dx * bv[s]);
        acc = fmaf(h[s], cv[s], acc);
      }
      part[j] = acc;
    }
    // add the G lanes' shares: each round halves the steps a lane keeps,
    // so lane g ends with the sums of steps G i + g
    if constexpr (G >= 2) fold<1, kTC>(part, g);
    if constexpr (G >= 4) fold<2, kTC / 2>(part, g);
    const int t0 = c * kTC;
#pragma unroll
    for (int i = 0; i < kTC / G; ++i) {
      const int t = G * i + g;
      if (live && t0 + t < T)
        y[(row0 + t0 + t) * di + d] = from_f32<E>(part[i]);
    }
  }
}

template <typename E, int DS, int G, int NT, int S, int MINB, bool BULK_OK>
cudaError_t launch_s(const void* x, const void* dt, const void* bc,
                     const void* cc, const void* a, const void* d, void* y,
                     int B, int T, int di, int ds, cudaStream_t stream) {
  using repro_torch::granule;
  constexpr int NCH = Split<DS, G, NT>::kNch;
  constexpr int bytes = sizeof(Ring<E, DS, G, NT, S>);
  const int gx = granule(static_cast<long long>(di) * sizeof(E), x);
  const int gdt = granule(static_cast<long long>(di) * 4, dt);
  const int gbc = std::min(granule(static_cast<long long>(ds) * 4, bc),
                           granule(static_cast<long long>(ds) * 4, cc));
  // whole 16-byte-aligned rows of channels, 256 bytes or more of x, and of
  // B, C: bulk copies, where the launch shape takes them
  const bool bulk = BULK_OK && ds == DS && di % NCH == 0 && gx == 16 &&
                    gdt == 16 && gbc == 16 && NCH * sizeof(E) >= 256;
  auto kernel = mamba_scan_kernel<E, DS, G, NT, S, MINB, false>;
  if constexpr (BULK_OK)
    if (bulk) kernel = mamba_scan_kernel<E, DS, G, NT, S, MINB, true>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((di + NCH - 1) / NCH, B);
  kernel<<<grid, NT, bytes, stream>>>(
      static_cast<const E*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(bc), static_cast<const float*>(cc),
      static_cast<const float*>(a), static_cast<const float*>(d),
      static_cast<E*>(y), T, di, ds, gx, gdt, gbc);
  return cudaGetLastError();
}

// The split of a channel's states, the CTA and the ring follow the grid,
// at 64 channels a CTA.  With many channels (batch 4 at ds = 16) two lanes
// hold 8 states each, 128 threads a CTA, 4 CTAs an SM (128 registers a
// thread), and a 5-slot ring of bulk copies (256-byte rows of float32 x)
// keeps 4 chunks (40 KB) in flight per CTA.  Where the grid gives an SM
// one such CTA or less (batch 1), four lanes hold 4 states each, 256
// threads a CTA (8 warps an SM to hide latency), and a 16-slot ring keeps
// 15 chunks, 240 steps, in flight by cp.async, which ran faster there
// than the bulk copies (0.38 against 0.50 ms on the H100).  ds < 16 (not
// on the model's path) takes 4 states a lane, 128 threads, cp.async and a
// 4-slot ring.
template <typename E, int DS>
cudaError_t launch_ds(const void* x, const void* dt, const void* bc,
                      const void* cc, const void* a, const void* d, void* y,
                      int B, int T, int di, int ds, cudaStream_t stream) {
  if constexpr (DS == kMaxDs) {
    int dev = 0, sms = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                   dev);
    if (err != cudaSuccess) return err;
    if (static_cast<long long>(B) * ((di + 63) / 64) <= sms)
      return launch_s<E, DS, 4, 256, 16, 1, false>(x, dt, bc, cc, a, d, y, B,
                                                   T, di, ds, stream);
    return launch_s<E, DS, 2, 128, 5, 4, true>(x, dt, bc, cc, a, d, y, B, T,
                                               di, ds, stream);
  } else {
    constexpr int G = DS < 4 ? 1 : DS / 4;
    return launch_s<E, DS, G, 128, 4, 4, false>(x, dt, bc, cc, a, d, y, B,
                                                T, di, ds, stream);
  }
}

template <typename E>
cudaError_t launch(const void* x, const void* dt, const void* bc,
                   const void* cc, const void* a, const void* d, void* y,
                   int B, int T, int di, int ds, cudaStream_t stream) {
  if (ds <= 2)
    return launch_ds<E, 2>(x, dt, bc, cc, a, d, y, B, T, di, ds, stream);
  if (ds <= 4)
    return launch_ds<E, 4>(x, dt, bc, cc, a, d, y, B, T, di, ds, stream);
  if (ds <= 8)
    return launch_ds<E, 8>(x, dt, bc, cc, a, d, y, B, T, di, ds, stream);
  return launch_ds<E, 16>(x, dt, bc, cc, a, d, y, B, T, di, ds, stream);
}

}  // namespace

// Launches on `stream`; returns the cudaError_t of the launch (0 = success).
// x, y (B, T, di) contiguous, of the element type `dtype` (0 = float32,
// 1 = bfloat16); dt (B, T, di), bc and cc (B, T, ds), a (di, ds) and d (di,)
// contiguous float32.
extern "C" int mamba_scan_launch(const void* x, const void* dt,
                                 const void* bc, const void* cc,
                                 const void* a, const void* d, void* y,
                                 int B, int T, int di, int ds, int dtype,
                                 void* stream) {
  if (B < 0 || T < 0 || di < 0 || ds < 1 || ds > kMaxDs || B > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0 || T == 0 || di == 0) return 0;
  const auto s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case repro_torch::kFloat32:
      return static_cast<int>(
          launch<float>(x, dt, bc, cc, a, d, y, B, T, di, ds, s));
    case repro_torch::kBFloat16:
      return static_cast<int>(
          launch<__nv_bfloat16>(x, dt, bc, cc, a, d, y, B, T, di, ds, s));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" const char* mamba_scan_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
