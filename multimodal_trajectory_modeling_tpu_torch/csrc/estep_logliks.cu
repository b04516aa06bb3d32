// K12 and K13: the per-cluster masked-Gaussian log-likelihoods of the
// dense route.
//
// Replaces the TPU kernels ops/pallas_estep.py:estep_logliks_pallas (K12,
// body _estep_kernel: rows in any order, each under its own pattern) and
// ops/pallas_estep.py:estep_logliks_pattern_sorted (K13, body
// _estep_kernel_single_pattern: a batch sorted by pattern) of the JAX
// package.  One body for both.
//
// For row i under its pattern p and every cluster c:
//   r          = where(isfinite(v_i), v_i - mean_c, 0)
//   out[c, i]  = const[c, p] - 0.5 * r^T M[c, p] r
// with M[c, p] the inverse of the identity-padded covariance and const the
// Gaussian constant (ops/estep_kernels.py:precompute_cluster_pattern_
// inverses).  K13's rows are sorted by pattern, so a block's rows share
// one.  For K12 the wrapper sorts the row indices by pattern (a
// permutation; the rows stay where they are in v) and the kernel gathers
// the block's rows through it and writes each row's column where the row
// is: every row is computed under its own pattern only.  The JAX kernel
// computes all C·P forms of every row and selects one, the same function
// at P times the work.
//
// Bound on the card: the quadratic forms, as K8's (csrc/estep_assign.cu):
// about C (k^2 + 4k) operations for a row with k observed coordinates
// (one triangle of the symmetric form), 6.8e10 at n = 1e6, C = 16 on the
// bench's gapped data (1.0 ms at 67 TFLOP/s); v read once and (C, n)
// written once (0.38 GB, 0.11 ms).  Design: K8's tile
// and quadratic form (estep_tile.cuh), one thread per row, the block's
// rows loaded row-major and coalesced, consecutive threads on consecutive
// elements, and transposed into the tile as they are; a thread writes its
// row's C values, consecutive threads consecutive columns on a sorted
// batch.  IEEE fused multiply-adds in the input type, never TF32.

#include <cuda_runtime.h>
#include <stdint.h>

#include "estep_tile.cuh"

namespace {

template <typename T>
__global__ void estep_logliks_kernel(
    const T* __restrict__ v,           // (n, D), row-major
    const int64_t* __restrict__ rows,  // (n,) rows in pattern order, or null
    const T* __restrict__ means,       // (C, D)
    const T* __restrict__ minv,        // (C, P, D, D)
    const T* __restrict__ cst,         // (C, P)
    const int* __restrict__ table,     // (blocks, 3): pattern, first, rows
    T* __restrict__ out,               // (C, n)
    int64_t n, int D, int P, int C) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int BN = blockDim.x, ld = BN + 1;
  T* s_m = reinterpret_cast<T*>(smem);
  T* s_mp = s_m + (size_t)D * mtm::kJC;
  T* s_v = s_mp + D;

  const int tid = threadIdx.x;
  const int p = table[3 * blockIdx.x];
  const int64_t first = table[3 * blockIdx.x + 1];
  const int cnt = table[3 * blockIdx.x + 2];
  mtm::load_tile_rows<T, true>(s_v, ld, v, rows, first, cnt, D);
  const bool live = tid < cnt;
  const int64_t dst = live ? (rows ? rows[first + tid] : first + tid) : 0;

  for (int c = 0; c < C; ++c) {
    // quad_form's first barrier publishes the tile
    const T q = mtm::quad_form<T, true>(
        s_v, ld, s_m, s_mp, minv + ((size_t)c * P + p) * D * D,
        means + (size_t)c * D, D);
    if (live) out[(size_t)c * n + dst] = cst[(size_t)c * P + p] - T(0.5) * q;
  }
}

template <typename T>
int run(const void* v, const void* rows, const void* means, const void* minv,
        const void* cst, const void* table, void* out, int64_t n, int D,
        int P, int C, int blocks, int BN, cudaStream_t stream) {
  const size_t smem = mtm::tile_smem_bytes<T>(D, BN, 0);
  if (smem > mtm::kMaxSmem) return -1;
  auto kern = estep_logliks_kernel<T>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kern<<<(unsigned)blocks, BN, smem, stream>>>(
      static_cast<const T*>(v), static_cast<const int64_t*>(rows),
      static_cast<const T*>(means), static_cast<const T*>(minv),
      static_cast<const T*>(cst), static_cast<const int*>(table),
      static_cast<T*>(out), n, D, P, C);
  return (int)cudaGetLastError();
}

}  // namespace

// The block size for row width D (kind 0 float32, 1 float64), or -1 if no
// block of 32 or more threads fits.
extern "C" int mtm_estep_logliks_block(int kind, int D) {
  if (kind == 0) return mtm::tile_block<float>(D, 0);
  if (kind == 1) return mtm::tile_block<double>(D, 0);
  return -1;
}

// rows: null for a batch sorted by pattern (K13), else the (n,) int64 row
// indices in pattern order (K12); the table's first rows index it.  Writes
// out (C, n).  Returns a cudaError_t (0 on success), or -1 for an argument
// the kernel does not take.
extern "C" int mtm_estep_logliks(int device, int kind, const void* v,
                                 const void* rows, const void* means,
                                 const void* minv, const void* cst,
                                 const void* table, void* out, long long n,
                                 int D, int P, int C, int blocks, int BN,
                                 void* stream) {
  if (n <= 0 || D <= 0 || P <= 0 || C < 1 || blocks <= 0) return -1;
  if (BN < 32 || BN > 1024 || BN % 32 != 0) return -1;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (kind == 0)
    return run<float>(v, rows, means, minv, cst, table, out, (int64_t)n, D, P,
                      C, blocks, BN, s);
  if (kind == 1)
    return run<double>(v, rows, means, minv, cst, table, out, (int64_t)n, D,
                       P, C, blocks, BN, s);
  return -1;
}
