// K15: the per-cluster Khatri-Rao statistics of the dense M step from the
// packed joint batch.
//
// Replaces the TPU kernel ops/pallas_mstep.py:mstep_stats_pallas (body
// _mstep_kernel) of the JAX package.
//
// v (n, D), D = T (d + l), each row [z_1..z_T, x_1..x_T]; assign (n,).  For
// each row i with c = assign_i in [0, C):
//   S_trans[c] += sum_{t < T-1} [z_t, z_t+1 finite] U U^T,  U = [z_t, z_t+1, 1]
//   S_meas[c]  += sum_t        [z_t, x_t finite]   U U^T,  U = [z_t, x_t, 1]
//   S_init[c]  +=              [z_1 finite]        U U^T,  U = [z_1, 1]
// where "z_t finite" means every coordinate of z_t.  The outputs keep the
// JAX layout S[j, c u + k] (u = 2d+1, d+l+1, d+1).  A row whose assignment
// lies outside [0, C) counts nowhere.
//
// Bound on the card: one read of v (320 MB at n = 1e6, D = 80: 0.096 ms)
// against the upper triangles' multiply-adds, (T-1) 66 + T 45 + 21 = 1065
// a row at T = 10, d = 5, l = 3 (2.1e9 operations, 0.032 ms at
// 67 TFLOP/s): bytes.  Design:
// - the wrapper's entry table, one row per upper-triangle entry of the
//   three sets (offset and stride of each factor in a row, the steps, the
//   finiteness rule, the place in the output), sits in shared memory;
// - a block takes a contiguous range of rows, in tiles of BR rows loaded
//   row-major and coalesced into shared memory with a ones column, each
//   row's per-step finiteness flags and its cluster.  A product is added
//   only where its rule holds, and then both factors are finite, so the
//   tile keeps the values as they are;
// - thread e owns entry e of every cluster: for each row of the tile, in
//   order, it sums the row's steps in a register and adds the sum to
//   acc[cluster, e] in shared memory: one writer per element, no atomics;
// - each block writes its acc as a partial, and a second kernel adds the
//   partials in block order and writes both triangles, so two calls give
//   the same bits (ordered_add's rule, markov_common.cuh);
// - IEEE fused multiply-adds in the input type on the CUDA cores, never
//   TF32 (the statistics subtract nearly equal moments).

#include <cuda_runtime.h>
#include <stdint.h>

#include "markov_common.cuh"

namespace {

using mtm::fused_ma;

constexpr int kEntry = 9;  // a0, sa, b0, sb, steps, rule, set, j, k
constexpr int kMaxBR = 64;
constexpr size_t kSmemBudget = 100 * 1024;  // two blocks an SM

enum Rule { TRANS = 0, MEAS = 1, INIT = 2 };

template <typename T>
size_t smem_bytes(int D, int T_, int C, int E, int BR) {
  return sizeof(T) * ((size_t)C * E + (size_t)BR * (D + 1)) +
         sizeof(int) * ((size_t)E * kEntry + BR) + (size_t)BR * 3 * T_;
}

// The rows per tile: the largest power of two up to kMaxBR whose shared
// memory fits the budget, or -1.
template <typename T>
int tile_rows(int D, int T_, int C, int E) {
  for (int BR = kMaxBR; BR >= 1; BR /= 2)
    if (smem_bytes<T>(D, T_, C, E, BR) <= kSmemBudget) return BR;
  return -1;
}

template <typename T>
__global__ void stats_kernel(const T* __restrict__ v,        // (n, D)
                             const int* __restrict__ assign,  // (n,)
                             const int* __restrict__ entries, // (E, kEntry)
                             T* __restrict__ part,            // (blocks, C, E)
                             int64_t n, int64_t per_block, int T_, int d,
                             int l, int C, int E, int BR) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int D = T_ * (d + l), W = D + 1;
  T* s_acc = reinterpret_cast<T*>(smem);          // C x E
  T* s_u = s_acc + (size_t)C * E;                 // BR x W
  int* s_ent = reinterpret_cast<int*>(s_u + (size_t)BR * W);  // E x kEntry
  int* s_c = s_ent + (size_t)E * kEntry;          // BR
  unsigned char* s_ok = reinterpret_cast<unsigned char*>(s_c + BR);  // BR x 3 x T

  const int tid = threadIdx.x, bd = blockDim.x;
  for (int e = tid; e < E * kEntry; e += bd) s_ent[e] = entries[e];
  for (int e = tid; e < C * E; e += bd) s_acc[e] = T(0);
  const int64_t r_lo = (int64_t)blockIdx.x * per_block;
  const int64_t r_hi = r_lo + per_block < n ? r_lo + per_block : n;

  for (int64_t t0 = r_lo; t0 < r_hi; t0 += BR) {
    const int cnt = r_hi - t0 < BR ? (int)(r_hi - t0) : BR;
    __syncthreads();  // the previous tile is no longer read
    for (int e = tid; e < cnt * D; e += bd) {
      const int r = e / D, k = e - r * D;
      s_u[r * W + k] = v[(t0 + r) * D + k];
    }
    for (int r = tid; r < cnt; r += bd) {
      s_u[r * W + D] = T(1);
      const int a = assign[t0 + r];
      s_c[r] = (a >= 0 && a < C) ? a : -1;
    }
    __syncthreads();
    // per row and step: z_t finite (zf), x_t finite (xf), and the rules
    for (int e = tid; e < cnt * T_; e += bd) {
      const int r = e / T_, t = e - r * T_;
      const T* u = s_u + r * W;
      bool zf = true, xf = true, zn = true;
      for (int j = 0; j < d; ++j) zf = zf && isfinite(u[t * d + j]);
      for (int j = 0; j < l; ++j) xf = xf && isfinite(u[T_ * d + t * l + j]);
      if (t + 1 < T_)
        for (int j = 0; j < d; ++j) zn = zn && isfinite(u[(t + 1) * d + j]);
      unsigned char* ok = s_ok + (size_t)r * 3 * T_;
      ok[TRANS * T_ + t] = zf && zn && t + 1 < T_;
      ok[MEAS * T_ + t] = zf && xf;
      ok[INIT * T_ + t] = zf && t == 0;
    }
    __syncthreads();
    for (int e = tid; e < E; e += bd) {
      const int* en = s_ent + e * kEntry;
      const int a0 = en[0], sa = en[1], b0 = en[2], sb = en[3];
      const int steps = en[4], rule = en[5];
      for (int r = 0; r < cnt; ++r) {
        const int c = s_c[r];
        if (c < 0) continue;
        const T* u = s_u + r * W;
        const unsigned char* ok = s_ok + ((size_t)r * 3 + rule) * T_;
        T s = T(0);
        for (int t = 0; t < steps; ++t)
          if (ok[t]) s = fused_ma(u[a0 + t * sa], u[b0 + t * sb], s);
        s_acc[(size_t)c * E + e] += s;
      }
    }
  }
  __syncthreads();
  T* out = part + (size_t)blockIdx.x * C * E;
  for (int e = tid; e < C * E; e += bd) out[e] = s_acc[e];
}

// out_set[j, c u + k] = out_set[k, c u + j] = sum over the blocks, in
// order, of part[b, c, e] for the entry e = (set, j, k).
template <typename T>
__global__ void stats_reduce(const T* __restrict__ part,
                             const int* __restrict__ entries,
                             T* __restrict__ s_trans, T* __restrict__ s_meas,
                             T* __restrict__ s_init, int blocks, int d, int l,
                             int C, int E) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= C * E) return;
  const int c = idx / E, e = idx - c * E;
  T s = T(0);
  for (int b = 0; b < blocks; ++b) s += part[((size_t)b * C + c) * E + e];
  const int* en = entries + e * kEntry;
  const int set = en[6], j = en[7], k = en[8];
  T* out = set == 0 ? s_trans : set == 1 ? s_meas : s_init;
  const int u = set == 0 ? 2 * d + 1 : set == 1 ? d + l + 1 : d + 1;
  out[(size_t)j * C * u + c * u + k] = s;
  out[(size_t)k * C * u + c * u + j] = s;
}

template <typename T>
int run(const void* v, const void* assign, const void* entries, void* part,
        void* s_trans, void* s_meas, void* s_init, int64_t n,
        int64_t per_block, int blocks, int T_, int d, int l, int C, int E,
        cudaStream_t stream) {
  const int D = T_ * (d + l);
  const int BR = tile_rows<T>(D, T_, C, E);
  if (BR < 1) return -1;
  const size_t smem = smem_bytes<T>(D, T_, C, E, BR);
  auto kern = stats_kernel<T>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int threads = E >= 1024 ? 1024 : (E + 31) / 32 * 32;
  kern<<<(unsigned)blocks, threads, smem, stream>>>(
      static_cast<const T*>(v), static_cast<const int*>(assign),
      static_cast<const int*>(entries), static_cast<T*>(part), n, per_block,
      T_, d, l, C, E, BR);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int total = C * E;
  stats_reduce<T><<<(total + 255) / 256, 256, 0, stream>>>(
      static_cast<const T*>(part), static_cast<const int*>(entries),
      static_cast<T*>(s_trans), static_cast<T*>(s_meas),
      static_cast<T*>(s_init), blocks, d, l, C, E);
  return (int)cudaGetLastError();
}

}  // namespace

// The rows per tile for these shapes (kind 0 float32, 1 float64), or -1
// if the statistics of C clusters do not fit a block's shared memory.
extern "C" int mtm_mstep_stats_tile(int kind, int T, int d, int l, int C,
                                    int E) {
  const int D = T * (d + l);
  if (kind == 0) return tile_rows<float>(D, T, C, E);
  if (kind == 1) return tile_rows<double>(D, T, C, E);
  return -1;
}

// part must hold blocks * C * E elements; block b takes rows
// [b per_block, (b + 1) per_block).  Writes the three output sets whole.
// Returns a cudaError_t (0 on success), or -1 for an argument the kernel
// does not take.
extern "C" int mtm_mstep_stats(int device, int kind, const void* v,
                               const void* assign, const void* entries,
                               void* part, void* s_trans, void* s_meas,
                               void* s_init, long long n, long long per_block,
                               int blocks, int T, int d, int l, int C, int E,
                               void* stream) {
  if (n <= 0 || per_block <= 0 || blocks <= 0 || T < 1 || d < 1 || l < 1 ||
      C < 1 || E < 1)
    return -1;
  if ((long long)blocks * per_block < n) return -1;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (kind == 0)
    return run<float>(v, assign, entries, part, s_trans, s_meas, s_init,
                      (int64_t)n, (int64_t)per_block, blocks, T, d, l, C, E, s);
  if (kind == 1)
    return run<double>(v, assign, entries, part, s_trans, s_meas, s_init,
                       (int64_t)n, (int64_t)per_block, blocks, T, d, l, C, E,
                       s);
  return -1;
}
