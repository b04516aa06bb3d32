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
// Bound on the card (unchanged since the first port), as K8's
// (csrc/estep_assign.cu): one triangle of the symmetric form over the k
// observed coordinates of a row, about C (k^2 + 4k) operations, 6.8e10
// at n = 1e6, C = 16 on the bench's gapped data: 1.012 ms at 67 TFLOP/s
// on the CUDA cores; v read once and (C, n) written once (0.38 GB,
// 0.11 ms).
//
// Design: the block's rows loaded row-major and coalesced, consecutive
// threads on consecutive elements, and transposed into a shared-memory
// tile.  Float32 takes K8's tensor-core quadratic forms (estep_mma.cuh:
// mma.sync m16n8k8 TF32 with a high/low split of both operands and three
// products into one float32 accumulator, over the 8x8 blocks of M on and
// above the diagonal, M staged by cp.async in column strips,
// double-buffered; q = sum r y in a fixed order); its own floor is
// 3 C D (D + 8) n TF32 operations over 495 TFLOP/s, 0.68 ms at n = 1e6,
// C = 16, D = 80 (1.24 ms for the full product).  A single TF32 product
// would err by about 2^-11 of each term, beyond the float32 tolerance of
// 2e-5 of the log-likelihood's magnitude; the split keeps about 2^-21.  A
// row whose form is not finite is recomputed by the float32 FMA chain
// (the plain version's class of NaN or Inf), and a row with no finite
// value gives exactly const.  A thread writes its row's C values, a warp
// 32 consecutive columns on a sorted batch.  Float64 keeps the CUDA-core
// body (estep_tile.cuh quad_form: IEEE FMAs over 16-column strips of M,
// one thread per row).

#include <cuda_runtime.h>
#include <stdint.h>

#include "estep_mma.cuh"
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

// The float32 body: estep_mma.cuh's tensor-core quadratic forms.
template <int NT>
__global__ void __launch_bounds__(mtm::tc::kMaxRows) estep_logliks_tc(
    const float* __restrict__ v,       // (n, D), row-major
    const int64_t* __restrict__ rows,  // (n,) rows in pattern order, or null
    const float* __restrict__ means,   // (C, D)
    const float* __restrict__ minv,    // (C, P, D, D)
    const float* __restrict__ cst,     // (C, P)
    const int* __restrict__ table,     // (blocks, 3): pattern, first, rows
    float* __restrict__ out,           // (C, n)
    int64_t n, int D, int P, int C, const mtm::tc::Plan pl, bool vec) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* s_v = reinterpret_cast<float*>(smem);
  float* s_stage = s_v + (size_t)pl.Dp * pl.ldv;

  const int p = table[3 * blockIdx.x];
  const int64_t first = table[3 * blockIdx.x + 1];
  const int cnt = table[3 * blockIdx.x + 2];
  mtm::load_tile_rows<float, true>(s_v, pl.ldv, v, rows, first, cnt, D);
  mtm::tc::zero_pad_rows(s_v, pl.ldv, D, pl.Dp);
  const int row = mtm::tc::own_row();
  const bool live = row < cnt;
  const int64_t dst = live ? (rows ? rows[first + row] : first + row) : 0;

  // the first barrier inside publishes the tile
  mtm::tc::quad_forms<true, NT>(
      s_v, s_stage, pl, D, C, vec, minv + (size_t)p * D * D,
      (size_t)P * D * D, means, [&](int c, float q) {
        if (live) out[(size_t)c * n + dst] = cst[(size_t)c * P + p] - 0.5f * q;
      });
}

int run_tc(const void* v, const void* rows, const void* means,
           const void* minv, const void* cst, const void* table, void* out,
           int64_t n, int D, int P, int C, int blocks, int BN,
           cudaStream_t stream) {
  const mtm::tc::Plan pl = mtm::tc::plan_for(D, BN, 0);
  if (pl.nbuf == 0) return -1;
  const bool vec = mtm::tc::vec_ok(D, minv, means);
  return mtm::tc::with_strip_tiles(pl.NT, [&](auto nt) {
    auto kern = estep_logliks_tc<decltype(nt)::value>;
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)pl.smem);
    if (err != cudaSuccess) return (int)err;
    kern<<<(unsigned)blocks, BN, pl.smem, stream>>>(
        static_cast<const float*>(v), static_cast<const int64_t*>(rows),
        static_cast<const float*>(means), static_cast<const float*>(minv),
        static_cast<const float*>(cst), static_cast<const int*>(table),
        static_cast<float*>(out), n, D, P, C, pl, vec);
    return (int)cudaGetLastError();
  });
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
// block of 32 or more threads fits (float32 takes every D the CUDA-core
// body took).
extern "C" int mtm_estep_logliks_block(int kind, int D) {
  if (kind == 0) return mtm::tc::plan_block(D, 0);
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
    return run_tc(v, rows, means, minv, cst, table, out, (int64_t)n, D, P, C,
                  blocks, BN, s);
  if (kind == 1)
    return run<double>(v, rows, means, minv, cst, table, out, (int64_t)n, D,
                       P, C, blocks, BN, s);
  return -1;
}
