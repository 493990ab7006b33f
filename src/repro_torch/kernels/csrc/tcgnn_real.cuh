// The real slots of a column-condensed block row, shared by the kernels that
// walk them (tcgnn_spmm.cu: one row a warp; tcgnn_spmm_fused.cu: one row a
// CTA; tcgnn_spmm_dw.cu: a run of rows a CTA).
//
// A block row's slots past the last one whose tile column holds a non-zero
// in any of its B rows add nothing, so those kernels gather and multiply
// only the slots before it.  The payload carries no count; coo_to_tcgnn
// ranks a row's columns densest first, so its padding is a suffix, but any
// all-zero suffix is skipped.  Skipping an all-zero column changes the
// result only where a row it names (of X, or of G in the weight gradient)
// holds an infinity or a NaN: 0 * inf is NaN in the plain version, nothing
// here.  A NaN in the tile counts as a non-zero.
#pragma once

#include <cuda_runtime.h>

namespace repro_torch {

// One past the last non-zero of the 4 columns in v (0 if none).
__device__ __forceinline__ int last_nonzero4(float4 v) {
  return v.w != 0.f ? 4 : v.z != 0.f ? 3 : v.y != 0.f ? 2 : v.x != 0.f ? 1 : 0;
}

// Whether the tile column at col (B rows, pitch C) holds a non-zero.
__device__ __forceinline__ bool column_nonzero(const float* __restrict__ col,
                                               int B, int C) {
  bool nz = false;
#pragma unroll 8
  for (int r = 0; r < B; ++r) nz |= col[static_cast<size_t>(r) * C] != 0.f;
  return nz;
}

// One past the last non-zero column among the parts of the (B, C) tile at
// t_row that thread tid of nthr reads (0 if none): with vec (C % 4 == 0 and
// t_row 16-byte aligned) the float4s tid, tid + nthr, ...; otherwise the
// columns tid, tid + nthr, ..., each over its B rows.
__device__ __forceinline__ int real_slots_part(const float* __restrict__ t_row,
                                               int B, int C, bool vec, int tid,
                                               int nthr) {
  int last = 0;
  if (vec) {
    const int c4 = C / 4;
#pragma unroll 4
    for (int e = tid; e < B * c4; e += nthr) {
      const int k =
          last_nonzero4(__ldg(reinterpret_cast<const float4*>(t_row) + e));
      if (k) last = max(last, (e - e / c4 * c4) * 4 + k);
    }
  } else {
    for (int s = tid; s < C; s += nthr)
      if (column_nonzero(t_row + s, B, C)) last = s + 1;
  }
  return last;
}

// The block row's count of real slots, taken by one warp from its tile
// staged in shared memory (B rows of pitch floats, 16-byte aligned, zeros
// past the tile's C columns; cols4 = ceil(C / 4) <= 32): lane j reads float4
// column group j of every row.  Every lane calls it and gets the count.
__device__ __forceinline__ int staged_real_slots(const float* t_s, int B,
                                                 int pitch, int cols4,
                                                 int lane) {
  int k = 0;
  if (lane < cols4) {
#pragma unroll 4
    for (int r = 0; r < B; ++r)
      k = max(k, last_nonzero4(*reinterpret_cast<const float4*>(
                     t_s + r * pitch + 4 * lane)));
  }
  return __reduce_max_sync(0xffffffffu, k ? 4 * lane + k : 0);
}

// The block row's count of real slots, taken by the whole CTA.  Every
// thread calls it; s_n is a shared int.
__device__ __forceinline__ int real_slots(const float* __restrict__ t_row,
                                          int B, int C, bool vec, int* s_n) {
  if (threadIdx.x == 0) *s_n = 0;
  __syncthreads();
  int last = real_slots_part(t_row, B, C, vec, threadIdx.x, blockDim.x);
  last = __reduce_max_sync(0xffffffffu, last);
  if ((threadIdx.x & 31) == 0 && last > 0) atomicMax(s_n, last);
  __syncthreads();
  return *s_n;
}

// The counts of real slots of n_rows consecutive block rows at t (each a
// (B, C) tile) into the shared ints s_n[0 .. n_rows), taken by the whole
// CTA in one pass: a thread has eight float4 loads in flight at once, and
// keeps a running maximum for the row it is in, so it adds to s_n only
// when its row changes.  Every thread calls it.
__device__ __forceinline__ void real_slots_rows(const float* __restrict__ t,
                                                int n_rows, int B, int C,
                                                bool vec, int* s_n) {
  for (int r = threadIdx.x; r < n_rows; r += blockDim.x) s_n[r] = 0;
  __syncthreads();
  int row = 0, last = 0;   // this thread's row and its last non-zero column
  auto note = [&](int r, int s) {
    if (r != row) {
      if (last > 0) atomicMax(s_n + row, last);
      row = r;
      last = 0;
    }
    last = max(last, s);
  };
  if (vec) {
    const int c4 = C / 4, per_row = B * c4, total = n_rows * per_row;
    const auto* t4 = reinterpret_cast<const float4*>(t);
    for (int e0 = threadIdx.x; e0 < total; e0 += 8 * blockDim.x) {
      float4 v[8];
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const int e = e0 + u * blockDim.x;
        v[u] = e < total ? __ldg(t4 + e) : make_float4(0.f, 0.f, 0.f, 0.f);
      }
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const int e = e0 + u * blockDim.x;
        const int k = last_nonzero4(v[u]);
        if (k) note(e / per_row, e % c4 * 4 + k);
      }
    }
  } else {
    for (int e = threadIdx.x; e < n_rows * C; e += blockDim.x) {
      const int r = e / C, s = e - r * C;
      if (column_nonzero(t + static_cast<size_t>(r) * B * C + s, B, C))
        note(r, s + 1);
    }
  }
  if (last > 0) atomicMax(s_n + row, last);
  __syncthreads();
}

}  // namespace repro_torch
