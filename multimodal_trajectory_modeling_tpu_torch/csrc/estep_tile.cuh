// Device code shared by the dense E-step kernels K8, K14 (estep_assign.cu)
// and K12, K13 (estep_logliks.cu): a block's rows of one missingness
// pattern in a shared-memory tile, one column per thread (the tile load
// serves both types), and, in float64, every thread's quadratic form
// r^T M r against one (D, D) matrix staged through shared memory in
// strips of kJC columns (float32 takes estep_mma.cuh's tensor cores).
//
// Shared memory of a block, in this order (the strip first, so that its
// rows are 16-byte aligned for vector loads): the strip (D x kJC), the
// staged mean row (D), the tile (D x ld, ld = blockDim.x + 1: the odd
// leading dimension keeps a row-major load, which writes down a tile
// column, free of bank conflicts), then the caller's own tail.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "markov_common.cuh"

namespace mtm {

constexpr int kJC = 16;
constexpr size_t kMaxSmem = 232448;  // a block's dynamic shared memory

template <typename T>
inline size_t tile_smem_bytes(int D, int BN, size_t tail) {
  return sizeof(T) * ((size_t)D * kJC + D + (size_t)D * (BN + 1)) + tail;
}

// The largest of 256, 128, 64 and 32 threads whose shared memory fits a
// block, or -1 if none does.
template <typename T>
inline int tile_block(int D, size_t tail) {
  for (int BN = 256; BN >= 32; BN /= 2)
    if (tile_smem_bytes<T>(D, BN, tail) <= kMaxSmem) return BN;
  return -1;
}

// Loads kJC consecutive values of a 16-byte-aligned shared-memory row.
__device__ __forceinline__ void load_row(const float* p, float (&r)[kJC]) {
  const float4* q = reinterpret_cast<const float4*>(p);
#pragma unroll
  for (int i = 0; i < kJC / 4; ++i) {
    const float4 v = q[i];
    r[4 * i] = v.x;
    r[4 * i + 1] = v.y;
    r[4 * i + 2] = v.z;
    r[4 * i + 3] = v.w;
  }
}

__device__ __forceinline__ void load_row(const double* p, double (&r)[kJC]) {
  const double2* q = reinterpret_cast<const double2*>(p);
#pragma unroll
  for (int i = 0; i < kJC / 2; ++i) {
    const double2 v = q[i];
    r[2 * i] = v.x;
    r[2 * i + 1] = v.y;
  }
}

// Loads `cnt` rows of the row-major batch v (n, D) into the tile: column
// r holds row src(r) = rows ? rows[first + r] : first + r, columns past
// cnt hold 0.  Consecutive threads read consecutive elements of a row, so
// the load is coalesced on a sorted batch and reads one run of D values a
// row when gathered.  RAW keeps non-finite values, else they become 0.
// The caller synchronizes before the tile is read.
template <typename T, bool RAW>
__device__ void load_tile_rows(T* s_v, int ld, const T* __restrict__ v,
                               const int64_t* __restrict__ rows,
                               int64_t first, int cnt, int D) {
  const int total = (int)blockDim.x * D;
  for (int e = threadIdx.x; e < total; e += blockDim.x) {
    const int r = e / D, k = e - r * D;
    T x = T(0);
    if (r < cnt) x = v[(rows ? rows[first + r] : first + r) * D + k];
    s_v[k * ld + r] = (RAW || isfinite(x)) ? x : T(0);
  }
}

// The residual of one coordinate: RAW tiles hold v as it is and m is the
// cluster mean (where(isfinite(v), v - m, 0)); the other tiles hold v with
// non-finite values as 0 and m is the mean masked by the pattern.
template <typename T, bool RAW>
__device__ __forceinline__ T residual(T x, T m) {
  if (RAW) return isfinite(x) ? x - m : T(0);
  return x - m;
}

// q = r^T M r for this thread's tile column, M (D, D) row-major and the
// mean row `mrow` (D) in device memory.  Every thread of the block calls
// it: M and the mean row pass through shared memory between barriers (the
// first barrier also publishes a tile loaded just before).  Per strip of
// kJC columns each thread keeps y_j = sum_k r_k M[k, j] in registers (one
// residual and one broadcast strip row from shared memory per k), then
// q += r_j y_j; IEEE fused multiply-adds in T, never TF32.
template <typename T, bool RAW>
__device__ T quad_form(const T* s_v, int ld, T* s_m, T* s_mp,
                       const T* __restrict__ M, const T* __restrict__ mrow,
                       int D) {
  const int tid = threadIdx.x, BN = blockDim.x;
  T q = T(0);
  for (int j0 = 0; j0 < D; j0 += kJC) {
    __syncthreads();  // the previous strip and mean row are no longer read
    if (j0 == 0)
      for (int k = tid; k < D; k += BN) s_mp[k] = mrow[k];
    for (int e = tid; e < D * kJC; e += BN) {
      const int k = e / kJC, j = j0 + e % kJC;
      s_m[e] = j < D ? M[(size_t)k * D + j] : T(0);
    }
    __syncthreads();
    T y[kJC];
#pragma unroll
    for (int jj = 0; jj < kJC; ++jj) y[jj] = T(0);
    for (int k = 0; k < D; ++k) {
      const T r = residual<T, RAW>(s_v[k * ld + tid], s_mp[k]);
      T row[kJC];
      load_row(s_m + k * kJC, row);
#pragma unroll
      for (int jj = 0; jj < kJC; ++jj) y[jj] = fused_ma(r, row[jj], y[jj]);
    }
#pragma unroll
    for (int jj = 0; jj < kJC; ++jj) {
      const int j = j0 + jj;
      if (j < D) q = fused_ma(residual<T, RAW>(s_v[j * ld + tid], s_mp[j]), y[jj], q);
    }
  }
  return q;
}

}  // namespace mtm
