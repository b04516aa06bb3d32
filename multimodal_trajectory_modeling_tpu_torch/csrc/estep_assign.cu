// K8: the E step of the pattern-sorted dense trainer.
//
// Replaces the TPU kernel ops/pallas_estep.py:estep_assign_pattern_sorted_t
// (body _estep_assign_kernel_t) of the JAX package.
//
// The batch v_t (D, n) is sorted by missingness pattern; every block takes
// up to blockDim.x consecutive rows of one pattern segment p, from a
// (pattern, first row, rows) table that the wrapper builds once per fit.
// Per row i and cluster c:
//   r        = v_i(NaN -> 0) - mp[p, c]        (mp: the mean, 0 where the
//                                              pattern is missing, so r is
//                                              0 at missing coordinates)
//   score_c  = c0[c, p] - 0.5 * r^T M[c, p] r  (c0 = log pi_c + const_{c,p},
//                                              M the identity-padded inverse)
//   na       = first argmax_c score_c          (jnp.argmax: NaN wins)
//   assign_i = prev_i >= 0 ? na : C
// and over the rows with prev >= 0: counts[c] = #{na == c} and
// switches = #{na != prev}.  The JAX kernel expands the quadratic form as
// v^T M v - 2 v^T M m + m^T M m; on unstandardized float32 data that
// subtracts large, nearly equal terms, so this kernel takes the residual
// form (the function of gaussian.masked_mvn_logpdf_grouped(method=
// "inverse")), at the same operation count.
//
// Bound on the card: the quadratic forms, 2 C D^2 operations per row
// (2.05e11 float32 operations at n=1e6, C=16, D=80: 3.1 ms at 67 TFLOP/s);
// v_t is read once (320 MB, 0.1 ms).  Design:
// - one thread per row.  The block's v tile (D x blockDim.x, NaN -> 0)
//   sits in shared memory, one column per thread, since D floats per
//   thread would spill from registers;
// - M[c, p] is staged in strips of kJC = 16 columns (D x 16), so that any
//   D up to 512 fits (the whole (C, D, D) set of a pattern is 409 KB at
//   D = 80).  For a strip, each thread keeps y_j = sum_k r_k M[k, j] for the
//   16 columns in registers: per k one residual and one 16-wide broadcast
//   row read from shared memory, then 16 FMAs; then q += r_j y_j;
// - IEEE FMAs on the CUDA cores in the input type (float32 or float64),
//   never TF32;
// - the argmax runs over the clusters in order as they finish; counts and
//   switches are integer sums (shared-memory atomics, then one global
//   atomic per block and cluster), so they are exact and do not depend on
//   the order of the atomics;
// - the ragged edge of a segment is masked in the kernel: no padding rows.

#include <cuda_runtime.h>
#include <stdint.h>

#include "markov_common.cuh"

namespace {

using mtm::fused_ma;
using mtm::is_nan;

constexpr int kJC = 16;
constexpr size_t kMaxSmem = 232448;  // a block's dynamic shared memory

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

template <typename T>
size_t smem_bytes(int D, int BN, int C) {
  return sizeof(T) * ((size_t)D * BN + (size_t)D * kJC + D) +
         sizeof(int) * (C + 1);
}

template <typename T>
__global__ void estep_assign_kernel(
    const T* __restrict__ vt,       // (D, n)
    const int* __restrict__ prev,   // (n,)
    const T* __restrict__ mp,       // (P, C, D) masked means
    const T* __restrict__ minv,     // (C, P, D, D)
    const T* __restrict__ c0,       // (C, P)
    const int* __restrict__ table,  // (blocks, 3): pattern, first row, rows
    int* __restrict__ assign, int* __restrict__ counts,
    int* __restrict__ switches, int64_t n, int D, int P, int C) {
  // layout: v tile (D x BN), M strip (D x kJC), mp (D), counts (C), sw
  extern __shared__ __align__(16) unsigned char smem[];
  const int BN = blockDim.x;
  T* s_v = reinterpret_cast<T*>(smem);
  T* s_m = s_v + (size_t)D * BN;
  T* s_mp = s_m + (size_t)D * kJC;
  int* s_cnt = reinterpret_cast<int*>(s_mp + D);
  int* s_sw = s_cnt + C;

  const int tid = threadIdx.x;
  const int p = table[3 * blockIdx.x];
  const int64_t i = (int64_t)table[3 * blockIdx.x + 1] + tid;
  const bool live = tid < table[3 * blockIdx.x + 2];

  // each thread's own column: no barrier needed before it reads it back
  for (int k = 0; k < D; ++k) {
    const T x = live ? vt[(int64_t)k * n + i] : T(0);
    s_v[k * BN + tid] = isfinite(x) ? x : T(0);
  }
  for (int c = tid; c < C; c += BN) s_cnt[c] = 0;
  if (tid == 0) *s_sw = 0;

  T best = T(0);
  int na = 0;
  for (int c = 0; c < C; ++c) {
    const T* M = minv + ((size_t)c * P + p) * D * D;
    const T* mpc = mp + ((size_t)p * C + c) * D;
    T q = T(0);
    for (int j0 = 0; j0 < D; j0 += kJC) {
      __syncthreads();  // the previous strip and means are no longer read
      if (j0 == 0)
        for (int k = tid; k < D; k += BN) s_mp[k] = mpc[k];
      for (int e = tid; e < D * kJC; e += BN) {
        const int k = e / kJC, j = j0 + e % kJC;
        s_m[e] = j < D ? M[(size_t)k * D + j] : T(0);
      }
      __syncthreads();
      T y[kJC];
#pragma unroll
      for (int jj = 0; jj < kJC; ++jj) y[jj] = T(0);
      for (int k = 0; k < D; ++k) {
        const T r = s_v[k * BN + tid] - s_mp[k];
        T row[kJC];
        load_row(s_m + k * kJC, row);
#pragma unroll
        for (int jj = 0; jj < kJC; ++jj) y[jj] = fused_ma(r, row[jj], y[jj]);
      }
#pragma unroll
      for (int jj = 0; jj < kJC; ++jj) {
        const int j = j0 + jj;
        if (j < D) q = fused_ma(s_v[j * BN + tid] - s_mp[j], y[jj], q);
      }
    }
    const T sc = c0[(size_t)c * P + p] - T(0.5) * q;
    if (c == 0 || sc > best || (is_nan(sc) && !is_nan(best))) {
      best = sc;
      na = c;
    }
  }

  if (live) {
    const int pv = prev[i];
    assign[i] = pv >= 0 ? na : C;
    if (pv >= 0) {
      atomicAdd(&s_cnt[na], 1);
      if (na != pv) atomicAdd(s_sw, 1);
    }
  }
  __syncthreads();
  for (int c = tid; c < C; c += BN)
    if (s_cnt[c]) atomicAdd(&counts[c], s_cnt[c]);
  if (tid == 0 && *s_sw) atomicAdd(switches, *s_sw);
}

template <typename T>
int run(const void* vt, const void* prev, const void* mp, const void* minv,
        const void* c0, const void* table, void* assign, void* counts,
        void* switches, int64_t n, int D, int P, int C, int blocks, int BN,
        cudaStream_t stream) {
  const size_t smem = smem_bytes<T>(D, BN, C);
  if (smem > kMaxSmem) return -1;
  auto kern = estep_assign_kernel<T>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kern<<<(unsigned)blocks, BN, smem, stream>>>(
      static_cast<const T*>(vt), static_cast<const int*>(prev),
      static_cast<const T*>(mp), static_cast<const T*>(minv),
      static_cast<const T*>(c0), static_cast<const int*>(table),
      static_cast<int*>(assign), static_cast<int*>(counts),
      static_cast<int*>(switches), n, D, P, C);
  return (int)cudaGetLastError();
}

}  // namespace

// The block size for row width D: the largest of 256, 128, 64 and 32
// threads whose shared memory fits a block, or -1 if none does (D up to
// 592 in float64 and 1185 in float32, so every D <= 512 the dense route
// admits); kind 0 float32, 1 float64.
extern "C" int mtm_estep_assign_block(int kind, int D, int C) {
  for (int BN = 256; BN >= 32; BN /= 2) {
    const size_t smem = kind == 0 ? smem_bytes<float>(D, BN, C)
                                  : smem_bytes<double>(D, BN, C);
    if (smem <= kMaxSmem) return BN;
  }
  return -1;
}

// kind: 0 float32, 1 float64.  counts (C,) and switches () must be zero on
// entry.  Returns a cudaError_t (0 on success), or -1 for an argument the
// kernel does not take.
extern "C" int mtm_estep_assign(int device, int kind, const void* vt,
                                const void* prev, const void* mp,
                                const void* minv, const void* c0,
                                const void* table, void* assign, void* counts,
                                void* switches, long long n, int D, int P,
                                int C, int blocks, int BN, void* stream) {
  if (n <= 0 || D <= 0 || P <= 0 || C < 1 || blocks <= 0) return -1;
  if (BN < 32 || BN > 1024 || BN % 32 != 0) return -1;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (kind == 0)
    return run<float>(vt, prev, mp, minv, c0, table, assign, counts, switches,
                      (int64_t)n, D, P, C, blocks, BN, s);
  if (kind == 1)
    return run<double>(vt, prev, mp, minv, c0, table, assign, counts, switches,
                       (int64_t)n, D, P, C, blocks, BN, s);
  return -1;
}
