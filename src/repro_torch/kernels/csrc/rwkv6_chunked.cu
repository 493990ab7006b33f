// RWKV-6 (Finch) linear recurrence on Hopper, forward, from a zero state:
//   S_t = diag(w_t) S_{t-1} + k_t^T v_t
//   o_t = r_t (S_{t-1} + diag(u) k_t^T v_t)
//
// Replaces the Pallas TPU kernel src/repro/kernels/rwkv6_chunked.py:127
// (rwkv6_chunked_pallas, _pallas_kernel): r, k, v (B, H, T, dh) in the model
// type, w (B, H, T, dh) and u (H, dh) float32 -> o (B, H, T, dh) in r's type.
//
// Math.  Over chunks of kL = 16 steps (the caller's chunk only fixes its
// T % chunk precondition), with W_t = prod_{s<t} w_s and P = prod_s w_s
// inside the chunk:
//   pairs:  A[t][j] = sum_d r_t[d] k_j[d] prod_{j<s<t} w_s[d]  (j < t),
//           A[t][t] = sum_d r_t[d] u[d] k_t[d],
//   output: o_t = sum_{j<=t} A[t][j] v_j + (r_t W_t) S,
//   carry:  S' = P (x) S + sum_j (k_j prod_{s>j} w_s)^T v_j.
// The Pallas kernel factors the pair decay at the chunk start as
// e^{c_{t-1}} e^{-c_j}, which overflows float32 once a chunk's summed
// log-decay passes ~88 (at the model's floor, log w = -1.5, NaN at its
// chunk 128).  Here the chunk is 16 steps, and the factored form,
// prod_{j<s<t} w_s = W_t * (prod_{s>j} w_s) / P, is taken only where every
// column's P is at least 2^-100 (any w >= 0.0130, so at the model's floor,
// P >= e^-24, always); a chunk with a smaller P forms each factor as 2 to
// the sum of log2 w over the steps strictly between j and t (log2 w
// clamped at -126), never above 1.  No input in [0, 1] overflows; both
// forms are checked at the floor, at w within 2e-9 of 1 and at log w = -20.
//
// Precision.  With w near 1 the state only grows: after 4096 steps |S| is
// about 64 and |o| reaches 3000, where the reference's float32 tolerance
// (atol 5e-4) asks for about 1e-7 of |o|.  A float32 state rounded at every
// chunk drifts past that (3.6x the tolerance against a float64 oracle on
// the card), so the state, its increment, the pair terms and every output
// sum are float64, on the tensor cores (DMMA, mma.m16n8k8.f64); the decays
// are float32 running products and the operands float32 values.
//
// Bound on this card.  r, k, v and o in bfloat16 and w in float32 are read
// and written once: 12 bytes per element, 201 MB at (4, 64, 1024, 64),
// 0.060 ms at 3.35 TB/s (float32 r, k, v, o: 20 bytes, 0.100 ms).
// rwkv6_flops at kL counts 4.83 GFLOP: 0.072 ms on the float32 CUDA cores,
// so the bound is bytes.  The kernel itself does 160 K float64
// multiply-adds per chunk and head on DMMA (the state term, the
// increment, the intra sums, the pair terms), 0.080 ms at 67 TFLOP/s over
// 256 heads x 64 chunks, and its chunks run in order: at batch 1 a head's
// 256 chunks are one CTA's serial work.
//
// Design.  One CTA owns a head (b, h) and walks its chunks in order, so
// the decays and pair terms are formed once per head.  Its warps split by
// role:
//   state warps (dh / 16): warp w keeps S^T rows e in [16 w, 16 w + 16)
//     (all d) in registers as the accumulator tiles of mma.m16n8k8.f64
//     (dh / 8 tiles, 32 doubles a thread at dh = 64).  Taking a d block's
//     k index as d = 8 nt + 2 q and 8 nt + 2 q + 1, those tiles are also
//     the A fragments of o^T = S^T Rd^T, so per chunk, in registers,
//       o^T = V^T A^T + S^T Rd^T,   S^T <- P (x) S^T + V^T Kd,
//     the increment accumulating onto the state: the carry needs no
//     barrier and no exchange.
//   prep warps: a chunk ahead of the state warps, the decays (each thread
//     a column: W_t r_t, P, the reverse products, the log2 sums), then the
//     pair terms (one 16 x 16 x dh DMMA product and 16 diagonal dots, or
//     the log2 form) into a double-buffered A.
// Copies run two chunks ahead (16-byte cp.async into a 3-slot ring; rows
// padded 16 bytes so the pair loads of different rows spread over the
// banks).  One CTA barrier per chunk, and a prep-only barrier (bar.red, or
// of the "P < 2^-100" flags) between the decays and the pair terms.  rd,
// kd and A are stored with row pitches that put each fragment load on each
// bank pair at most twice.  At dh = 64: 4 state warps and, where the grid
// fills two CTAs an SM (256 heads: 84 KB of shared memory in bfloat16,
// 102 KB in float32, 168 registers), 2 prep warps; where it leaves SMs at
// one CTA (batch 1, 64 heads), 4 prep warps that split the forward and
// reverse decays, and no register cap.
//
// Limits.  1 <= dh <= 64 (compiled for dh padded to 16, 32 or 64, the
// padding masked: r = k = v = 0, w = 1); any T >= 0.
#include <algorithm>
#include <cstdint>

#include "cp_async.cuh"
#include "dtype.cuh"

namespace {

using repro_torch::copy_tile;
using repro_torch::cp_commit;
using repro_torch::cp_wait;
using repro_torch::from_f32;
using repro_torch::ld4;
using repro_torch::to_f32;

constexpr int kL = 16;           // steps per chunk
constexpr int kMaxDh = 64;
constexpr int kRing = 3;         // chunk slots of the copy ring
constexpr int kAS = 20;          // row pitch (doubles) of A
constexpr int kDPI = 16;         // columns d of a pair item
constexpr int kPairs = kL * (kL + 1) / 2;

template <int DH, int NPW>
struct Cfg {
  static constexpr int kStateWarps = DH / 16;    // 16 state columns each
  static constexpr int kPrepWarps = NPW;
  static constexpr int kThreads = 32 * (kStateWarps + kPrepWarps);
  static constexpr int kPrep = 32 * kPrepWarps;  // prep threads
  static constexpr int kKT = DH / 8;             // 8-blocks of d
  static constexpr int kNQ = DH / kDPI;          // lanes (items) a pair
  static constexpr int kPW = 32 / kNQ;           // pairs a prep warp takes
  static constexpr int kDiagParts = kPrep / kL;  // lanes a diagonal term
  static constexpr int kDiagD = DH / kDiagParts; // columns d of each
};

// the (t, j) of each pair, the 16 diagonal ones first, then j < t row by
// row
struct PairTable {
  unsigned char t[kPairs], j[kPairs];
};
constexpr PairTable make_pairs() {
  PairTable p{};
  int n = 0;
  for (int i = 0; i < kL; ++i, ++n) p.t[n] = p.j[n] = i;
  for (int t = 1; t < kL; ++t)
    for (int j = 0; j < t; ++j, ++n) {
      p.t[n] = t;
      p.j[n] = j;
    }
  return p;
}
__constant__ PairTable kPairTable = make_pairs();

template <typename E, int DH>
struct Smem {
  static constexpr int kRP = DH + 8;             // row pitch of rd and kd
  static constexpr int kEP = DH + 16 / static_cast<int>(sizeof(E));
  double rd[2][kL][kRP];         // r_t prod_{s<t} w_s
  double kd[2][kL][kRP];         // k_j prod_{s>j} w_s
  double at[2][kL][kAS];         // A[t][j]; 0 for j > t
  double p64[2][DH];             // prod_s w_s over the chunk
  double ip64[2][DH];            // its inverse
  float cexc[kL][DH + 4];        // c_{t-1}
  float cinc[kL][DH + 4];        // c_t
  float u[DH];
  struct alignas(16) Raw {       // rows padded by 16 bytes
    E r[kL][kEP], k[kL][kEP], v[kL][kEP];
    float w[kL][DH + 4];
  } raw[kRing];
};

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float lg2(float x) {
  float y;
  asm("lg2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// c += a b on a 16 x 8 x 8 float64 tile (g = lane / 4, q = lane % 4):
// a = A[g, g + 8, g, g + 8][q, q, q + 4, q + 4], b = B[q, q + 4][g],
// c = C[g, g, g + 8, g + 8][2 q, 2 q + 1, 2 q, 2 q + 1]
__device__ __forceinline__ void dmma(double (&c)[4], const double (&a)[4],
                                     double b0, double b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f64.f64.f64.f64 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+d"(c[0]), "+d"(c[1]), "+d"(c[2]), "+d"(c[3])
      : "d"(a[0]), "d"(a[1]), "d"(a[2]), "d"(a[3]), "d"(b0), "d"(b1));
}

template <typename E, int DH, int NPW, int MINB>
__global__ void __launch_bounds__(Cfg<DH, NPW>::kThreads, MINB)
    rwkv6_kernel(const E* __restrict__ r, const E* __restrict__ k,
                 const E* __restrict__ v, const float* __restrict__ w,
                 const float* __restrict__ u, E* __restrict__ o, int H,
                 int T, int dh, int ge, int gw) {
  using C = Cfg<DH, NPW>;
  using M = Smem<E, DH>;
  constexpr int NT = C::kThreads, KT = C::kKT, EP = M::kEP;
  extern __shared__ __align__(16) unsigned char smem_bytes[];
  auto& sm = *reinterpret_cast<M*>(smem_bytes);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gq = lane >> 2, qq = lane & 3;   // fragment row, column pair
  const bool prep = warp >= C::kStateWarps;
  const int bh = blockIdx.x;
  const int64_t base = static_cast<int64_t>(bh) * T * dh;
  const int n_chunks = (T + kL - 1) / kL;

  for (int i = tid; i < DH; i += NT)
    sm.u[i] = i < dh ? u[(bh % H) * dh + i] : 0.f;
  for (int i = tid; i < 2 * kL * kAS; i += NT) (&sm.at[0][0][0])[i] = 0.0;

  // copies of chunk c into its slot, one commit group per call (empty past
  // the end); steps past T and columns past dh read as zeros.  Each tile's
  // granules start where the previous tile's left off.
  const int n_e = kL * EP * static_cast<int>(sizeof(E)) / ge;
  auto rot = [&](int m) { return (tid + NT - (m % NT)) % NT; };
  auto stage = [&](int c) {
    if (c < n_chunks) {
      auto& s = sm.raw[c % kRing];
      const int t0 = c * kL, valid = min(kL, T - t0);
      const int64_t off = base + static_cast<int64_t>(t0) * dh;
      copy_tile<EP>(&s.r[0][0], r + off, dh, dh, kL, valid, ge, tid, NT);
      copy_tile<EP>(&s.k[0][0], k + off, dh, dh, kL, valid, ge, rot(n_e),
                    NT);
      copy_tile<EP>(&s.v[0][0], v + off, dh, dh, kL, valid, ge,
                    rot(2 * n_e), NT);
      copy_tile<DH + 4>(&s.w[0][0], w + off, dh, dh, kL, valid, gw,
                        rot(3 * n_e), NT);
    }
    cp_commit();
  };

  // --- prep warps: what does not need the state, a chunk ahead ----------
  const int pt = tid - 32 * C::kStateWarps;  // prep thread
  const int pw = pt >> 5;                    // prep warp

  // the decays of chunk c: prep thread d < DH walks column d forward (r
  // decayed to the chunk start, the log2 sums, the chunk's decay P) and,
  // unless there are 2 DH prep threads and thread DH + d does it,
  // backward (k decayed to the chunk end); steps past T and columns past
  // dh decay by w = 1.  Returns whether P < 2^-100 in this column.
  auto decays = [&](int c) {
    const auto& s = sm.raw[c % kRing];
    const int pb = c & 1, steps = min(kL, T - c * kL);
    constexpr bool kSplit = C::kPrep >= 2 * DH;  // backward on other threads
    const int d = kSplit && pt >= DH ? pt - DH : pt;
    const bool col = d < dh;
    bool unsafe = false;
    if (pt < DH) {
      float p = 1.f, cum = 0.f;
#pragma unroll
      for (int t = 0; t < kL; ++t) {
        const float wt = (col && t < steps) ? s.w[t][d] : 1.f;
        sm.rd[pb][t][d] = static_cast<double>(to_f32(s.r[t][d]) * p);
        sm.cexc[t][d] = cum;
        cum += fmaxf(lg2(wt), -126.f);
        sm.cinc[t][d] = cum;
        p *= wt;
      }
      sm.p64[pb][d] = static_cast<double>(p);
      sm.ip64[pb][d] = 1.0 / static_cast<double>(p);
      unsafe = !(p >= 0x1p-100f);
    }
    if (kSplit ? (pt >= DH && pt < 2 * DH) : pt < DH) {
      float q = 1.f;
#pragma unroll
      for (int j = kL - 1; j >= 0; --j) {
        sm.kd[pb][j][d] = static_cast<double>(to_f32(s.k[j][d]) * q);
        q *= (col && j < steps) ? s.w[j][d] : 1.f;
      }
    }
    return unsafe;
  };

  // the prep warps' own barrier (the state warps do not wait on it), with
  // an "or" of a flag over the prep threads
  auto prep_or = [&](bool flag) {
    int any;
    asm volatile(
        "{\n\t.reg .pred p, q;\n\t"
        "setp.ne.s32 q, %1, 0;\n\t"
        "bar.red.or.pred p, 1, %2, q;\n\t"
        "selp.s32 %0, 1, 0, p;\n\t}"
        : "=r"(any)
        : "r"(static_cast<int>(flag)), "r"(C::kPrep));
    return any != 0;
  };

  // the pair terms of chunk c.  Where every column's chunk decay P is at
  // least 2^-100, A[t][j] = sum_d rd[t][d] kd[j][d] / P[d] (j < t), the
  // product r_t k_j prod_{j<s<t} w_s factored at the chunk start, which
  // no factor overflows: a 16 x 16 x dh float64 product on the tensor
  // cores (j tile tn on prep warp tn % kPrepWarps), then the diagonal
  // sum_d r_t u k_t on all prep threads.  Otherwise (w far below the
  // model's floor) each factor is 2^{c_{t-1} - c_j} <= 1 from the log2 sums,
  // a prep warp taking kPW pairs at a time, lane (part, pair) summing kDPI
  // columns d, the parts kPW lanes apart added up by shuffles.
  auto pairs = [&](int c, bool exact) {
    const auto& s = sm.raw[c % kRing];
    const int pb = c & 1;
    if (!exact) {
#pragma unroll
      for (int tn = 0; tn < 2; ++tn) {
        if (pw != tn % C::kPrepWarps) continue;
        double acc[4] = {0.0, 0.0, 0.0, 0.0};
#pragma unroll
        for (int ks = 0; ks < KT; ++ks) {
          const int d = 8 * ks + qq;
          const double a[4] = {sm.rd[pb][gq][d], sm.rd[pb][gq + 8][d],
                               sm.rd[pb][gq][d + 4],
                               sm.rd[pb][gq + 8][d + 4]};
          dmma(acc, a, sm.kd[pb][8 * tn + gq][d] * sm.ip64[pb][d],
               sm.kd[pb][8 * tn + gq][d + 4] * sm.ip64[pb][d + 4]);
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int t = gq + 8 * (i >> 1), j = 8 * tn + 2 * qq + (i & 1);
          if (j < t) sm.at[pb][t][j] = acc[i];
        }
      }
      const int t = pt / C::kDiagParts;
      const int d0 = (pt % C::kDiagParts) * C::kDiagD;
      float acc = 0.f;
#pragma unroll
      for (int dd = 0; dd < C::kDiagD; dd += 4) {
        float rv[4], kv[4];
        ld4(&s.r[t][d0 + dd], rv);
        ld4(&s.k[t][d0 + dd], kv);
        const float4 uv = *reinterpret_cast<const float4*>(&sm.u[d0 + dd]);
        acc = fmaf(rv[0] * uv.x, kv[0], acc);
        acc = fmaf(rv[1] * uv.y, kv[1], acc);
        acc = fmaf(rv[2] * uv.z, kv[2], acc);
        acc = fmaf(rv[3] * uv.w, kv[3], acc);
      }
#pragma unroll
      for (int m = 1; m < C::kDiagParts; m <<= 1)
        acc += __shfl_xor_sync(0xffffffffu, acc, m);
      if (d0 == 0) sm.at[pb][t][t] = static_cast<double>(acc);
      return;
    }
    const int part = lane / C::kPW, d0 = part * kDPI;
    constexpr int kRounds = (kPairs + C::kPW - 1) / C::kPW;
    for (int wi = pw; wi < kRounds; wi += C::kPrepWarps) {
      const int pi = wi * C::kPW + lane % C::kPW;
      const bool own = pi < kPairs;
      const int t = kPairTable.t[own ? pi : 0];
      const int j = kPairTable.j[own ? pi : 0];
      float acc[4] = {0.f, 0.f, 0.f, 0.f};
      if (t == j) {
#pragma unroll
        for (int dd = 0; dd < kDPI; dd += 4) {
          float rv[4], kv[4];
          ld4(&s.r[t][d0 + dd], rv);
          ld4(&s.k[t][d0 + dd], kv);
          const float4 uv = *reinterpret_cast<const float4*>(&sm.u[d0 + dd]);
          acc[0] = fmaf(rv[0] * uv.x, kv[0], acc[0]);
          acc[1] = fmaf(rv[1] * uv.y, kv[1], acc[1]);
          acc[2] = fmaf(rv[2] * uv.z, kv[2], acc[2]);
          acc[3] = fmaf(rv[3] * uv.w, kv[3], acc[3]);
        }
      } else {
#pragma unroll
        for (int dd = 0; dd < kDPI; dd += 4) {
          float rv[4], kv[4];
          ld4(&s.r[t][d0 + dd], rv);
          ld4(&s.k[j][d0 + dd], kv);
          const float4 ce =
              *reinterpret_cast<const float4*>(&sm.cexc[t][d0 + dd]);
          const float4 ci =
              *reinterpret_cast<const float4*>(&sm.cinc[j][d0 + dd]);
          acc[0] = fmaf(rv[0] * ex2(ce.x - ci.x), kv[0], acc[0]);
          acc[1] = fmaf(rv[1] * ex2(ce.y - ci.y), kv[1], acc[1]);
          acc[2] = fmaf(rv[2] * ex2(ce.z - ci.z), kv[2], acc[2]);
          acc[3] = fmaf(rv[3] * ex2(ce.w - ci.w), kv[3], acc[3]);
        }
      }
      float a = (acc[0] + acc[1]) + (acc[2] + acc[3]);
#pragma unroll
      for (int m = C::kPW; m < 32; m <<= 1)
        a += __shfl_xor_sync(0xffffffffu, a, m);
      if (own && part == 0) sm.at[pb][t][j] = static_cast<double>(a);
    }
  };

  // --- state warps: S^T rows e in [16 warp, 16 warp + 16) --------------
  // s_t[nt] is the accumulator tile of S^T over d in [8 nt, 8 nt + 8):
  // (e0, 2 qq), (e0, 2 qq + 1), (e0 + 8, 2 qq), (e0 + 8, 2 qq + 1) with
  // e0 = 16 warp + gq
  const int e0 = 16 * warp + gq;
  double s_t[KT][4];
#pragma unroll
  for (int nt = 0; nt < KT; ++nt)
#pragma unroll
    for (int i = 0; i < 4; ++i) s_t[nt][i] = 0.0;

  // V^T A fragments of chunk c for the j block kk
  auto v_frags = [&](int c, double (&av)[2][4]) {
    const auto& s = sm.raw[c % kRing];
#pragma unroll
    for (int kk = 0; kk < 2; ++kk) {
      const int j = 8 * kk + qq;
      av[kk][0] = to_f32(s.v[j][e0]);
      av[kk][1] = to_f32(s.v[j][e0 + 8]);
      av[kk][2] = to_f32(s.v[j + 4][e0]);
      av[kk][3] = to_f32(s.v[j + 4][e0 + 8]);
    }
  };

  // o of chunk c: o^T = V^T A^T + S^T Rd^T in float64 (the k index of a
  // d block taken as d = 8 nt + 2 qq and 8 nt + 2 qq + 1, so S^T's tiles
  // are the A fragments), then one rounding; then S^T <- P (x) S^T +
  // V^T Kd, the increment accumulated onto the state
  auto state = [&](int c) {
    const int pb = c & 1, t0 = c * kL;
    double av[2][4];
    v_frags(c, av);
#pragma unroll
    for (int tn = 0; tn < 2; ++tn) {
      double acc[4] = {0.0, 0.0, 0.0, 0.0};
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {
        const double* ar = &sm.at[pb][8 * tn + gq][8 * kk + qq];
        dmma(acc, av[kk], ar[0], ar[4]);
      }
#pragma unroll
      for (int nt = 0; nt < KT; ++nt) {
        const double sa[4] = {s_t[nt][0], s_t[nt][2], s_t[nt][1],
                              s_t[nt][3]};
        const double2 b = *reinterpret_cast<const double2*>(
            &sm.rd[pb][8 * tn + gq][8 * nt + 2 * qq]);
        dmma(acc, sa, b.x, b.y);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int t = 8 * tn + 2 * qq + (i & 1);
        const int e = e0 + 8 * (i >> 1);
        if (t0 + t < T && e < dh)
          o[base + static_cast<int64_t>(t0 + t) * dh + e] =
              from_f32<E>(static_cast<float>(acc[i]));
      }
    }
#pragma unroll
    for (int nt = 0; nt < KT; ++nt) {
      const double2 p2 =
          *reinterpret_cast<const double2*>(&sm.p64[pb][8 * nt + 2 * qq]);
      s_t[nt][0] *= p2.x;
      s_t[nt][1] *= p2.y;
      s_t[nt][2] *= p2.x;
      s_t[nt][3] *= p2.y;
    }
#pragma unroll
    for (int kk = 0; kk < 2; ++kk)
#pragma unroll
      for (int nt = 0; nt < KT; ++nt)
        dmma(s_t[nt], av[kk], sm.kd[pb][8 * kk + qq][8 * nt + gq],
             sm.kd[pb][8 * kk + qq + 4][8 * nt + gq]);
  };

  stage(0);
  stage(1);
  cp_wait<1>();
  __syncthreads();
  if (prep) pairs(0, prep_or(decays(0)));
  for (int c = 0; c < n_chunks; ++c) {
    cp_wait<0>();      // chunk c + 1 landed
    // the state warps are done with chunk c - 1 and the prep warps with
    // chunk c, whose buffers the other side may now read or overwrite
    __syncthreads();
    stage(c + 2);
    if (!prep) {
      state(c);
    } else if (c + 1 < n_chunks) {
      // the barrier of prep_or also makes the decays visible to pairs
      pairs(c + 1, prep_or(decays(c + 1)));
    }
  }
}

template <typename E, int DH, int NPW, int MINB>
cudaError_t launch_cfg(const void* r, const void* k, const void* v,
                       const void* w, const void* u, void* o, int B, int H,
                       int T, int dh, cudaStream_t stream) {
  using repro_torch::granule;
  const long long pitch = static_cast<long long>(dh) * sizeof(E);
  const int ge = std::min(granule(pitch, r),
                          std::min(granule(pitch, k), granule(pitch, v)));
  const int gw = granule(static_cast<long long>(dh) * 4, w);
  constexpr int bytes = sizeof(Smem<E, DH>);
  const auto kernel = rwkv6_kernel<E, DH, NPW, MINB>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  kernel<<<static_cast<unsigned>(B * H), Cfg<DH, NPW>::kThreads, bytes,
           stream>>>(static_cast<const E*>(r), static_cast<const E*>(k),
                     static_cast<const E*>(v), static_cast<const float*>(w),
                     static_cast<const float*>(u), static_cast<E*>(o), H, T,
                     dh, ge, gw);
  return cudaGetLastError();
}

// One CTA a head.  dh = 64 takes 4 state warps and, where the grid fills
// two CTAs an SM, 2 prep warps (168 registers a thread); where it leaves
// SMs at one CTA (batch 1), 4 prep warps that split the forward and
// backward decays, and no register cap.
template <typename E>
cudaError_t launch(const void* r, const void* k, const void* v,
                   const void* w, const void* u, void* o, int B, int H,
                   int T, int dh, cudaStream_t stream) {
  if (static_cast<int64_t>(B) * H > 0x7fffffff) return cudaErrorInvalidValue;
  if (dh <= 16)
    return launch_cfg<E, 16, 1, 2>(r, k, v, w, u, o, B, H, T, dh, stream);
  if (dh <= 32)
    return launch_cfg<E, 32, 1, 2>(r, k, v, w, u, o, B, H, T, dh, stream);
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  if (static_cast<int64_t>(B) * H <= sms)
    return launch_cfg<E, 64, 4, 1>(r, k, v, w, u, o, B, H, T, dh, stream);
  return launch_cfg<E, 64, 2, 2>(r, k, v, w, u, o, B, H, T, dh, stream);
}

}  // namespace

// Launches on `stream`; returns the cudaError_t of the launch (0 = success).
// r, k, v, o (B, H, T, dh) contiguous, of the element type `dtype` (0 =
// float32, 1 = bfloat16); w (B, H, T, dh) and u (H, dh) contiguous float32.
extern "C" int rwkv6_chunked_launch(const void* r, const void* k,
                                    const void* v, const void* w,
                                    const void* u, void* o, int B, int H,
                                    int T, int dh, int dtype, void* stream) {
  if (B < 0 || H < 0 || T < 0 || dh < 1 || dh > kMaxDh)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0 || H == 0 || T == 0) return 0;
  const auto s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case repro_torch::kFloat32:
      return static_cast<int>(
          launch<float>(r, k, v, w, u, o, B, H, T, dh, s));
    case repro_torch::kBFloat16:
      return static_cast<int>(
          launch<__nv_bfloat16>(r, k, v, w, u, o, B, H, T, dh, s));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" const char* rwkv6_chunked_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
