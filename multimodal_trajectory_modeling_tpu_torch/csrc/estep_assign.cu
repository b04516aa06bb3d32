// K8 and K14: the E step of the pattern-sorted dense trainer.
//
// Replaces the TPU kernels ops/pallas_estep.py:estep_assign_pattern_sorted_t
// (K8, body _estep_assign_kernel_t: the transposed batch v_t (D, n)) and
// ops/pallas_estep.py:estep_assign_pattern_sorted (K14, body
// _estep_assign_kernel: the row-major batch v (n, D)) of the JAX package.
// One body; the two differ only in how a block loads its rows.
//
// The batch is sorted by missingness pattern; every block takes up to
// blockDim.x consecutive rows of one pattern segment p, from a (pattern,
// first row, rows) table that the wrapper builds once per fit.  Per row i
// and cluster c:
//   r        = v_i(NaN -> 0) - mp[p, c]        (mp: the mean, 0 where the
//                                              pattern is missing, so r is
//                                              0 at missing coordinates)
//   score_c  = c0[c, p] - 0.5 * r^T M[c, p] r  (c0 = log pi_c + const_{c,p},
//                                              M the identity-padded inverse)
//   na       = first argmax_c score_c          (jnp.argmax: NaN wins)
//   assign_i = prev_i >= 0 ? na : C
// and over the rows with prev >= 0: counts[c] = #{na == c} and
// switches = #{na != prev}.  The JAX kernels expand the quadratic form as
// v^T M v - 2 v^T M m + m^T M m; on unstandardized float32 data that
// subtracts large, nearly equal terms, so this kernel takes the residual
// form (the function of gaussian.masked_mvn_logpdf_grouped(method=
// "inverse")).
//
// Bound on the card (unchanged since the first port): one triangle of
// the symmetric form over the k observed coordinates of a row, about
// C (k^2 + 4k) operations, 6.8e10 at n = 1e6, C = 16 on the bench's gapped
// data: 1.012 ms at 67 TFLOP/s on the CUDA cores; v is read once (320 MB,
// 0.1 ms).
//
// Design, float32 (estep_mma.cuh): the block's rows in a shared-memory
// tile (K8 reads each thread's column of v_t, coalesced across threads;
// K14 reads the block's rows of v, consecutive threads on consecutive
// elements, and transposes them into the tile); per cluster the forms on
// the TF32 tensor cores (mma.sync m16n8k8), each operand split into a
// high and a low TF32 part and three products (lo.hi, hi.lo, hi.hi) into
// one float32 accumulator, over the 8x8 blocks of M on and above the
// diagonal (those above doubled), M staged by cp.async in column strips,
// double-buffered; q = sum r y in float32 in a fixed order.  Its own
// floor: 3 C D (D + 8) n TF32 operations over 495 TFLOP/s, 0.68 ms at
// n = 1e6, C = 16, D = 80 (the full product, both triangles, would be
// 3 x 2 C D^2 n, 1.24 ms).  A single TF32 product (r_hi M_hi) would err by
// about 2^-11 of each term, beyond the log-likelihoods' float32
// tolerance (2e-5 of their magnitude); the split keeps about 2^-21.  A
// row whose form is not finite is recomputed by the float32 FMA chain, so
// non-finite scores keep the plain version's class and a NaN still wins
// the argmax.
// Float64 keeps the CUDA-core body (estep_tile.cuh quad_form: IEEE FMAs
// over 16-column strips of M).
//
// Either way the argmax runs over the clusters in order as they finish;
// counts and switches are integer sums (shared-memory atomics, then one
// global atomic per block and cluster; global atomics directly where C is
// too large for shared memory), so they are exact and do not depend on
// the order of the atomics; the ragged edge of a segment is masked in the
// kernel: no padding rows.

#include <cuda_runtime.h>
#include <stdint.h>

#include "estep_mma.cuh"
#include "estep_tile.cuh"
#include "markov_common.cuh"

namespace {

using mtm::is_nan;

size_t tail_bytes(int C) { return sizeof(int) * (C + 1); }

template <typename T, bool ROWS>
__global__ void estep_assign_kernel(
    const T* __restrict__ v,        // K8: v_t (D, n); K14: v (n, D)
    const int* __restrict__ prev,   // (n,)
    const T* __restrict__ mp,       // (P, C, D) masked means
    const T* __restrict__ minv,     // (C, P, D, D)
    const T* __restrict__ c0,       // (C, P)
    const int* __restrict__ table,  // (blocks, 3): pattern, first row, rows
    int* __restrict__ assign, int* __restrict__ counts,
    int* __restrict__ switches, int64_t n, int D, int P, int C) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int BN = blockDim.x, ld = BN + 1;
  T* s_m = reinterpret_cast<T*>(smem);
  T* s_mp = s_m + (size_t)D * mtm::kJC;
  T* s_v = s_mp + D;
  int* s_cnt = reinterpret_cast<int*>(s_v + (size_t)D * ld);
  int* s_sw = s_cnt + C;

  const int tid = threadIdx.x;
  const int p = table[3 * blockIdx.x];
  const int64_t first = table[3 * blockIdx.x + 1];
  const int rows = table[3 * blockIdx.x + 2];
  const int64_t i = first + tid;
  const bool live = tid < rows;

  if (ROWS) {
    mtm::load_tile_rows<T, false>(s_v, ld, v, nullptr, first, rows, D);
  } else {
    for (int k = 0; k < D; ++k) {
      const T x = live ? v[(int64_t)k * n + i] : T(0);
      s_v[k * ld + tid] = isfinite(x) ? x : T(0);
    }
  }
  for (int c = tid; c < C; c += BN) s_cnt[c] = 0;
  if (tid == 0) *s_sw = 0;

  T best = T(0);
  int na = 0;
  for (int c = 0; c < C; ++c) {
    // quad_form's first barrier publishes the tile and the zeroed counts
    const T q = mtm::quad_form<T, false>(
        s_v, ld, s_m, s_mp, minv + ((size_t)c * P + p) * D * D,
        mp + ((size_t)p * C + c) * D, D);
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

// The float32 body: estep_mma.cuh's tensor-core quadratic forms.
template <bool ROWS, int NT>
__global__ void __launch_bounds__(mtm::tc::kMaxRows) estep_assign_tc(
    const float* __restrict__ v,    // K8: v_t (D, n); K14: v (n, D)
    const int* __restrict__ prev,   // (n,)
    const float* __restrict__ mp,   // (P, C, D) masked means
    const float* __restrict__ minv,  // (C, P, D, D)
    const float* __restrict__ c0,   // (C, P)
    const int* __restrict__ table,  // (blocks, 3): pattern, first row, rows
    int* __restrict__ assign, int* __restrict__ counts,
    int* __restrict__ switches, int64_t n, int D, int P, int C,
    const mtm::tc::Plan pl, bool vec) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int BN = blockDim.x, ldv = pl.ldv;
  float* s_v = reinterpret_cast<float*>(smem);
  float* s_stage = s_v + (size_t)pl.Dp * ldv;
  int* s_cnt = reinterpret_cast<int*>(
      s_stage + (size_t)pl.nbuf * ((size_t)pl.Dp + (size_t)pl.Dp * pl.ldm));
  int* s_sw = s_cnt + C;

  const int tid = threadIdx.x;
  const int p = table[3 * blockIdx.x];
  const int64_t first = table[3 * blockIdx.x + 1];
  const int rows = table[3 * blockIdx.x + 2];

  if (ROWS) {
    mtm::load_tile_rows<float, false>(s_v, ldv, v, nullptr, first, rows, D);
  } else {
    const bool live = tid < rows;
    for (int k = 0; k < D; ++k) {
      const float x = live ? v[(int64_t)k * n + first + tid] : 0.f;
      s_v[k * ldv + tid] = isfinite(x) ? x : 0.f;
    }
  }
  mtm::tc::zero_pad_rows(s_v, ldv, D, pl.Dp);
  if (pl.shared_tail) {
    for (int c = tid; c < C; c += BN) s_cnt[c] = 0;
    if (tid == 0) *s_sw = 0;
  }

  float best = 0.f;
  int na = 0;
  // the first barrier inside publishes the tile and the zeroed counts
  mtm::tc::quad_forms<false, NT>(
      s_v, s_stage, pl, D, C, vec, minv + (size_t)p * D * D,
      (size_t)P * D * D, mp + (size_t)p * C * D, [&](int c, float q) {
        const float sc = c0[(size_t)c * P + p] - 0.5f * q;
        if (c == 0 || sc > best || (is_nan(sc) && !is_nan(best))) {
          best = sc;
          na = c;
        }
      });

  const int row = mtm::tc::own_row();
  if (row < rows) {
    const int64_t i = first + row;
    const int pv = prev[i];
    assign[i] = pv >= 0 ? na : C;
    if (pv >= 0) {
      int* cnt = pl.shared_tail ? s_cnt : counts;
      int* sw = pl.shared_tail ? s_sw : switches;
      atomicAdd(&cnt[na], 1);
      if (na != pv) atomicAdd(sw, 1);
    }
  }
  if (pl.shared_tail) {
    __syncthreads();
    for (int c = tid; c < C; c += BN)
      if (s_cnt[c]) atomicAdd(&counts[c], s_cnt[c]);
    if (tid == 0 && *s_sw) atomicAdd(switches, *s_sw);
  }
}

template <bool ROWS>
int run_tc(const void* v, const void* prev, const void* mp, const void* minv,
           const void* c0, const void* table, void* assign, void* counts,
           void* switches, int64_t n, int D, int P, int C, int blocks, int BN,
           cudaStream_t stream) {
  const mtm::tc::Plan pl = mtm::tc::plan_for(D, BN, tail_bytes(C));
  if (pl.nbuf == 0) return -1;
  const bool vec = mtm::tc::vec_ok(D, minv, mp);
  return mtm::tc::with_strip_tiles(pl.NT, [&](auto nt) {
    auto kern = estep_assign_tc<ROWS, decltype(nt)::value>;
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)pl.smem);
    if (err != cudaSuccess) return (int)err;
    kern<<<(unsigned)blocks, BN, pl.smem, stream>>>(
        static_cast<const float*>(v), static_cast<const int*>(prev),
        static_cast<const float*>(mp), static_cast<const float*>(minv),
        static_cast<const float*>(c0), static_cast<const int*>(table),
        static_cast<int*>(assign), static_cast<int*>(counts),
        static_cast<int*>(switches), n, D, P, C, pl, vec);
    return (int)cudaGetLastError();
  });
}

template <typename T, bool ROWS>
int run(const void* v, const void* prev, const void* mp, const void* minv,
        const void* c0, const void* table, void* assign, void* counts,
        void* switches, int64_t n, int D, int P, int C, int blocks, int BN,
        cudaStream_t stream) {
  const size_t smem = mtm::tile_smem_bytes<T>(D, BN, tail_bytes(C));
  if (smem > mtm::kMaxSmem) return -1;
  auto kern = estep_assign_kernel<T, ROWS>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kern<<<(unsigned)blocks, BN, smem, stream>>>(
      static_cast<const T*>(v), static_cast<const int*>(prev),
      static_cast<const T*>(mp), static_cast<const T*>(minv),
      static_cast<const T*>(c0), static_cast<const int*>(table),
      static_cast<int*>(assign), static_cast<int*>(counts),
      static_cast<int*>(switches), n, D, P, C);
  return (int)cudaGetLastError();
}

template <bool ROWS>
int launch(int device, int kind, const void* v, const void* prev,
           const void* mp, const void* minv, const void* c0,
           const void* table, void* assign, void* counts, void* switches,
           long long n, int D, int P, int C, int blocks, int BN,
           void* stream) {
  if (n <= 0 || D <= 0 || P <= 0 || C < 1 || blocks <= 0) return -1;
  if (BN < 32 || BN > 1024 || BN % 32 != 0) return -1;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (kind == 0)
    return run_tc<ROWS>(v, prev, mp, minv, c0, table, assign, counts,
                        switches, (int64_t)n, D, P, C, blocks, BN, s);
  if (kind == 1)
    return run<double, ROWS>(v, prev, mp, minv, c0, table, assign, counts,
                             switches, (int64_t)n, D, P, C, blocks, BN, s);
  return -1;
}

}  // namespace

// The block size for row width D: the largest of 256, 128, 64 and 32
// threads whose shared memory fits a block, or -1 if none does (every
// D <= 512 the dense route admits fits in both types; float32 takes every
// D and C the CUDA-core body took); kind 0 float32, 1 float64.  K8 and
// K14 take the same.
extern "C" int mtm_estep_assign_block(int kind, int D, int C) {
  if (kind == 0) return mtm::tc::plan_block(D, tail_bytes(C));
  if (kind == 1) return mtm::tile_block<double>(D, tail_bytes(C));
  return -1;
}

// The float32 plan of K8/K14 (C >= 1) or K12/K13 (C == 0) at row width D:
// out = {rows a block, n tiles a strip, stage buffers, strips, dynamic
// shared memory bytes, tail in shared memory}; returns 0, or -1 if no
// plan fits.
extern "C" int mtm_estep_tc_plan(int D, int C, int* out) {
  const size_t tail = C > 0 ? tail_bytes(C) : 0;
  const int BN = mtm::tc::plan_block(D, tail);
  if (BN < 0) return -1;
  const mtm::tc::Plan pl = mtm::tc::plan_for(D, BN, tail);
  const int v[6] = {pl.BN, pl.NT, pl.nbuf, pl.strips, (int)pl.smem, pl.shared_tail};
  for (int i = 0; i < 6; ++i) out[i] = v[i];
  return 0;
}

// K8 on the transposed batch v_t (D, n).  kind: 0 float32, 1 float64.
// counts (C,) and switches () must be zero on entry.  Returns a
// cudaError_t (0 on success), or -1 for an argument the kernel does not
// take.
extern "C" int mtm_estep_assign(int device, int kind, const void* vt,
                                const void* prev, const void* mp,
                                const void* minv, const void* c0,
                                const void* table, void* assign, void* counts,
                                void* switches, long long n, int D, int P,
                                int C, int blocks, int BN, void* stream) {
  return launch<false>(device, kind, vt, prev, mp, minv, c0, table, assign,
                       counts, switches, n, D, P, C, blocks, BN, stream);
}

// K14 on the row-major batch v (n, D); otherwise mtm_estep_assign.
extern "C" int mtm_estep_assign_rows(int device, int kind, const void* v,
                                     const void* prev, const void* mp,
                                     const void* minv, const void* c0,
                                     const void* table, void* assign,
                                     void* counts, void* switches, long long n,
                                     int D, int P, int C, int blocks, int BN,
                                     void* stream) {
  return launch<true>(device, kind, v, prev, mp, minv, c0, table, assign,
                      counts, switches, n, D, P, C, blocks, BN, stream);
}
