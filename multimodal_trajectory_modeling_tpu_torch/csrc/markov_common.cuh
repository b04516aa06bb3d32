// Device code shared by the Markov EM kernels: the statistic types, the
// scalar helpers, the fixed-order block sum and statistics sum, and the
// per-instance ACC-row build of the packed batch.
//
// The ACC-row build is the feature definition of the JAX package's
// ops/pallas_markov.py:_packed_acc_build, one row at a time: K2
// (markov_features.cu) writes the referenced rows out as Φ, and float64
// K4a and K4b (markov_em_multi.cuh) build the same rows into shared memory
// and score them there, so Φ never reaches device memory; float32 K4b
// (markov_em_packed_mma.cu) and float32 K4a (markov_em_packed_one.cu)
// build them from a u tile in shared memory with the same terms in the
// same order (markov_packed_tile.cuh:acc_row_tile), and float32 K2 stores
// them from such a tile straight to Φ; float32 K2 and K4a build the
// shapes with a compile-time table a step at a time from registers
// (markov_step_rows.cuh).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace mtm {

// statistic types: in-block shared/partial (S) and across-block total (G);
// under int16 Φ the statistics are integer sums (kExact), whose value does
// not depend on the order of the additions, so a block may add them with
// shared-memory atomics.  Float statistics go through ordered_add.
template <typename PhiT, typename WT>
struct Acc {
  using S = WT;
  using G = WT;
  static constexpr bool kExact = false;
};
template <typename WT>
struct Acc<int16_t, WT> {
  using S = int;
  using G = long long;
  static constexpr bool kExact = true;
};

// Row stride of a block's (Fcp, C) statistics in shared memory: C, or for
// float statistics an odd stride, so that ordered_add's threads (one per
// row) hit distinct banks.
template <bool EXACT>
__host__ __device__ inline int stat_cols(int C) {
  return EXACT ? C : (C | 1);
}

template <typename V>
__device__ __forceinline__ bool is_nan(V v) {
  return v != v;
}

__device__ __forceinline__ float fused_ma(float a, float b, float c) {
  return fmaf(a, b, c);
}
__device__ __forceinline__ double fused_ma(double a, double b, double c) {
  return fma(a, b, c);
}

// A product and a sum each rounded on its own: the compiler may not fuse
// them into one multiply-add, so a kernel's sums equal plain torch's.
__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }


// Sum over the block in a fixed order (shuffle tree, then warps in
// order); the result is valid in thread 0.  `red` holds one V per warp;
// the closing barrier lets the caller reuse it at once.
template <typename V>
__device__ V block_sum(V v, V* red) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  V tot = V(0);
  if (threadIdx.x == 0)
    for (int w = 0; w < (int)(blockDim.x >> 5); ++w) tot += red[w];
  __syncthreads();
  return tot;
}

// The sum of part[b · stride] over the blocks b < nblocks in a fixed
// order, in type A (V's own by default), valid in lane 0: lane k sums
// blocks k, k + 32, ... in order, then a fixed shuffle tree.  One warp an
// output of a partials' reduce.
template <typename V, typename A = V>
__device__ __forceinline__ A warp_total(const V* __restrict__ part, int64_t stride, int64_t nblocks) {
  A a = A(0);
  for (int64_t b = threadIdx.x & 31; b < nblocks; b += 32) a += static_cast<A>(part[b * stride]);
  for (int o = 16; o > 0; o >>= 1) a += __shfl_down_sync(0xffffffffu, a, o);
  return a;
}

// A kernel's dynamic shared-memory limit, raised on each device only when
// a launch needs more than it was last set to: one static SmemLimit per
// kernel instantiation, so the attribute is set once, not on every call.
struct SmemLimit {
  static constexpr int kDevices = 64;
  std::atomic<int> bytes[kDevices] = {};

  template <class Kernel>
  cudaError_t raise(Kernel kernel, size_t smem) {
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return err;
    if (dev < kDevices && (int)smem <= bytes[dev].load(std::memory_order_relaxed)) return cudaSuccess;
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err == cudaSuccess && dev < kDevices) {
      int cur = bytes[dev].load(std::memory_order_relaxed);
      while ((int)smem > cur && !bytes[dev].compare_exchange_weak(cur, (int)smem)) {
      }
    }
    return err;
  }
};

// Adds one tile of nj instances to float statistics in a fixed order, so
// that they are the same bit for bit from run to run: thread f owns row f
// of acc (element (f, c) at acc[f * cs + c]) and adds the tile's columns
// j = 0, 1, ..., nj - 1 in turn.  Column j goes to cluster na[j], or
// nowhere if na[j] < 0; its element f is col[f * fstride + j].  Call it
// between two barriers: the first publishes na (and the tile), the second
// keeps them until every row is done.
template <typename SAcc, typename PhiT>
__device__ __forceinline__ void ordered_add(SAcc* acc, int cs, const int* na,
                                            int nj, const PhiT* col,
                                            int64_t fstride, int Fcp) {
  for (int f = threadIdx.x; f < Fcp; f += blockDim.x) {
    const PhiT* row = col + f * fstride;
    SAcc* a = acc + (size_t)f * cs;
    for (int j = 0; j < nj; ++j) {
      const int c = na[j];
      if (c >= 0) a[c] += static_cast<SAcc>(row[j]);
    }
  }
}

// ACC row kinds (ops/markov_kernels.py:_acc_row_table builds the table)
enum RowKind {
  ROW_A = 0,
  ROW_B = 1,
  ROW_F0 = 2,
  ROW_AID = 3,
  ROW_AVM = 4,
  ROW_U0 = 5,
  ROW_LEN = 6,
  ROW_ONE = 7,
  ROW_ZERO = 8,
};

// One ACC row of one instance.  `ui` points at the instance's column of
// the packed batch u (T*s, n): element (row, i) is ui[row * n].
//   A  (k, r): Σ_t u[ts+r] · u[ts+r+k]       (products past T*s are 0)
//   B  (k, r): Σ_{t+1<len} u[ts+r] · u[ts+r+k]   (r + k < s)
//   F0 (k, r): u[r] · u[r+k]
//   AID (r):   Σ_t u[ts+r]
//   AVM (r):   Σ_{t+1<len} u[ts+r]
//   U0  (r):   u[r]
//   LEN, ONE, ZERO
// The JAX kernel gets the masked rows (B, AVM) by subtracting the last
// step's products; this sums them directly (equal to round-off on
// NaN-suffix data, whose steps past len are zero).
template <typename T>
__device__ __forceinline__ T acc_row(int kind, int k, int r, const T* ui,
                                     int64_t n, int len, int steps, int s) {
  const int Ts = steps * s;
  T acc = T(0);
  switch (kind) {
    case ROW_A:
      for (int t = 0; t < steps; ++t) {
        const int a = t * s + r;
        if (a + k < Ts) acc += ui[(int64_t)a * n] * ui[(int64_t)(a + k) * n];
      }
      break;
    case ROW_B:
      for (int t = 0; t + 1 < len && t < steps; ++t) {
        const int a = t * s + r;
        acc += ui[(int64_t)a * n] * ui[(int64_t)(a + k) * n];
      }
      break;
    case ROW_F0:
      acc = ui[(int64_t)r * n] * ui[(int64_t)(r + k) * n];
      break;
    case ROW_AID:
      for (int t = 0; t < steps; ++t) acc += ui[(int64_t)(t * s + r) * n];
      break;
    case ROW_AVM:
      for (int t = 0; t + 1 < len && t < steps; ++t)
        acc += ui[(int64_t)(t * s + r) * n];
      break;
    case ROW_U0:
      acc = ui[(int64_t)r * n];
      break;
    case ROW_LEN:
      acc = T(len);
      break;
    case ROW_ONE:
      acc = T(1);
      break;
    default:
      break;
  }
  return acc;
}

}  // namespace mtm
