// K1: one hard-assignment EM iteration over the materialized features Φ.
//
// Replaces the TPU kernel ops/pallas_markov.py:markov_em_from_features
// (body _markov_em_feat_kernel) of the JAX package.
//
// Per instance i (one column of Φ (Fcp, n)):
//   scores_c = Σ_f wc[c, f] · Φ[f, i]           (C of them)
//   na       = first argmax_c scores_c          (jnp.argmax semantics,
//                                                NaN counts as the max)
//     (assign_mode "prev" skips the scores: na = prev[i])
//   valid    = prev[i] >= 0
//   assign[i] = valid ? na : C
// and over the valid instances: counts[c] = #{na == c},
// switches = #{na != prev}, obj = Σ max score, and the statistics
// macc[f, c] = Σ_{na == c} Φ[f, i].
//
// Bound on the card: the Φ stream, Fcp · n · 2 bytes per iteration under
// int16 Φ (224 MB at n=1e6, Fcp=112).  Design:
// - one thread per instance; the C scores live in registers (the cluster
//   count is rounded up to a compile-time bound CB of 8, 16 or 32) and
//   are accumulated with FMAs on the CUDA cores, in the weights' type
//   (never TF32); wc sits in shared memory, transposed to (Fcp, CB) so
//   each feature row's weights are one broadcast vector read;
// - each Φ load is coalesced across the warp (consecutive instances); the
//   statistics pass rereads the thread's column, mostly from L1/L2;
// - each block covers `chunk` instances and sums its statistics in shared
//   memory.  Under int16 Φ those sums are integers, added with atomics:
//   int32 in the block (chunk · 32767 < 2^31) and int64 across blocks, so
//   the statistics are exact and independent of the order of the atomics.
//   Under wide Φ the block goes through its instances in tiles of
//   kThreads, and one thread per feature row adds the tile's columns in
//   instance order (markov_common.cuh:ordered_add, rereading Φ from
//   L1/L2);
// - there are no global atomics: every block writes its partial sums, and
//   a second kernel adds them up in block order.  With the fixed-order
//   shuffle tree of the objective, every output is the same bit for bit
//   from run to run, for int16 and for wide Φ alike.

#include <cuda_runtime.h>
#include <stdint.h>

#include "markov_common.cuh"

namespace {

using mtm::Acc;
using mtm::block_sum;
using mtm::fused_ma;
using mtm::is_nan;
using mtm::ordered_add;
using mtm::stat_cols;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

template <typename PhiT, typename WT>
size_t smem_bytes(int Fcp, int C, int cb) {
  using A = Acc<PhiT, WT>;
  return sizeof(WT) * (kWarps + (size_t)Fcp * cb) +
         sizeof(typename A::S) * (size_t)Fcp * stat_cols<A::kExact>(C) +
         sizeof(int) * (C + kWarps + (A::kExact ? 0 : kThreads));
}

template <typename PhiT, typename WT, int CB, bool ARGMAX>
__global__ void __launch_bounds__(kThreads)
    markov_em_kernel(const PhiT* __restrict__ phi,
                     const int* __restrict__ prev, const WT* __restrict__ wc,
                     int* __restrict__ assign,
                     typename Acc<PhiT, WT>::S* __restrict__ part_stats,
                     int* __restrict__ part_counts, int* __restrict__ part_sw,
                     WT* __restrict__ part_obj, int64_t n, int Fcp, int C,
                     int chunk) {
  using SAcc = typename Acc<PhiT, WT>::S;
  constexpr bool EXACT = Acc<PhiT, WT>::kExact;
  const int cb = ARGMAX ? CB : 0;
  const int cs = stat_cols<EXACT>(C);
  // layout, widest type first: red (kWarps WT), w (Fcp x cb WT),
  // acc (Fcp x cs SAcc), counts (C int), ired (kWarps int),
  // na (kThreads int, wide Φ only)
  extern __shared__ __align__(16) unsigned char smem[];
  WT* s_red = reinterpret_cast<WT*>(smem);
  WT* s_w = s_red + kWarps;
  SAcc* s_acc = reinterpret_cast<SAcc*>(s_w + (size_t)Fcp * cb);
  int* s_counts = reinterpret_cast<int*>(s_acc + (size_t)Fcp * cs);
  int* s_ired = s_counts + C;
  int* s_na = s_ired + kWarps;

  const int tid = threadIdx.x;
  if (ARGMAX) {
    for (int e = tid; e < Fcp * CB; e += kThreads) {
      const int f = e / CB, c = e % CB;
      s_w[e] = c < C ? wc[(size_t)c * Fcp + f] : WT(0);
    }
  }
  for (int e = tid; e < Fcp * cs; e += kThreads) s_acc[e] = SAcc(0);
  for (int e = tid; e < C; e += kThreads) s_counts[e] = 0;
  __syncthreads();

  const int64_t start = (int64_t)blockIdx.x * chunk;
  const int64_t end = start + chunk < n ? start + chunk : n;
  WT obj = WT(0);
  int sw = 0;
  for (int64_t i0 = start; i0 < end; i0 += kThreads) {
    const int64_t i = i0 + tid;
    int kept = -1;  // the cluster whose statistics take instance i
    if (i < end) {
      const int p = prev[i];
      const bool valid = p >= 0;
      int na = p;
      if (ARGMAX) {
        WT sc[CB];
#pragma unroll
        for (int c = 0; c < CB; ++c) sc[c] = WT(0);
        for (int f = 0; f < Fcp; ++f) {
          const WT v = static_cast<WT>(phi[(int64_t)f * n + i]);
          const WT* wf = s_w + f * CB;
#pragma unroll
          for (int c = 0; c < CB; ++c) sc[c] = fused_ma(wf[c], v, sc[c]);
        }
        WT best = sc[0];
        na = 0;
#pragma unroll
        for (int c = 1; c < CB; ++c) {
          if (c < C && (sc[c] > best || (is_nan(sc[c]) && !is_nan(best)))) {
            best = sc[c];
            na = c;
          }
        }
        if (valid) {
          obj += best;
          sw += (na != p);
        }
      }
      assign[i] = valid ? na : C;
      if (valid && na < C) {
        atomicAdd(&s_counts[na], 1);
        kept = na;
        if constexpr (EXACT) {
          for (int f = 0; f < Fcp; ++f) {
            const PhiT v = phi[(int64_t)f * n + i];
            if (v != PhiT(0)) atomicAdd(&s_acc[f * cs + na], static_cast<SAcc>(v));
          }
        }
      }
    }
    if constexpr (!EXACT) {
      s_na[tid] = kept;
      __syncthreads();
      ordered_add(s_acc, cs, s_na, kThreads, phi + i0, n, Fcp);
      __syncthreads();
    }
  }
  __syncthreads();
  const WT obj_blk = block_sum(obj, s_red);
  const int sw_blk = block_sum(sw, s_ired);

  const int64_t b = blockIdx.x;
  for (int e = tid; e < Fcp * C; e += kThreads)
    part_stats[b * Fcp * C + e] = s_acc[(e / C) * cs + e % C];
  for (int e = tid; e < C; e += kThreads) part_counts[b * C + e] = s_counts[e];
  if (tid == 0) {
    part_sw[b] = sw_blk;
    part_obj[b] = obj_blk;
  }
}

// Adds the per-block partials in block order: one thread per output.
template <typename SAcc, typename GAcc, typename WT>
__global__ void markov_em_reduce(const SAcc* __restrict__ part_stats,
                                 const int* __restrict__ part_counts,
                                 const int* __restrict__ part_sw,
                                 const WT* __restrict__ part_obj,
                                 GAcc* __restrict__ macc,
                                 int* __restrict__ counts,
                                 int* __restrict__ switches,
                                 WT* __restrict__ obj, int64_t nblocks, int FC,
                                 int C) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e < FC) {
    GAcc a = GAcc(0);
    for (int64_t b = 0; b < nblocks; ++b) a += static_cast<GAcc>(part_stats[b * FC + e]);
    macc[e] = a;
  } else if (e < FC + C) {
    const int c = e - FC;
    int a = 0;
    for (int64_t b = 0; b < nblocks; ++b) a += part_counts[b * C + c];
    counts[c] = a;
  } else if (e == FC + C) {
    int a = 0;
    for (int64_t b = 0; b < nblocks; ++b) a += part_sw[b];
    *switches = a;
  } else if (e == FC + C + 1) {
    WT a = WT(0);
    for (int64_t b = 0; b < nblocks; ++b) a += part_obj[b];
    *obj = a;
  }
}

struct EmArgs {
  const void* phi;
  const int* prev;
  const void* wc;
  int* assign;
  void* part_stats;
  int* part_counts;
  int* part_sw;
  void* part_obj;
  void* macc;
  int* counts;
  int* switches;
  void* obj;
  int64_t n;
  int Fcp;
  int C;
  int chunk;
  cudaStream_t stream;
};

template <typename PhiT, typename WT, int CB, bool ARGMAX>
int run(const EmArgs& a) {
  using SAcc = typename Acc<PhiT, WT>::S;
  using GAcc = typename Acc<PhiT, WT>::G;
  const int64_t nblocks = (a.n + a.chunk - 1) / a.chunk;
  const size_t smem = smem_bytes<PhiT, WT>(a.Fcp, a.C, ARGMAX ? CB : 0);
  auto kern = markov_em_kernel<PhiT, WT, CB, ARGMAX>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kern<<<(unsigned)nblocks, kThreads, smem, a.stream>>>(
      static_cast<const PhiT*>(a.phi), a.prev, static_cast<const WT*>(a.wc),
      a.assign, static_cast<SAcc*>(a.part_stats), a.part_counts, a.part_sw,
      static_cast<WT*>(a.part_obj), a.n, a.Fcp, a.C, a.chunk);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int FC = a.Fcp * a.C;
  const int total = FC + a.C + 2;
  markov_em_reduce<SAcc, GAcc, WT><<<(total + 255) / 256, 256, 0, a.stream>>>(
      static_cast<const SAcc*>(a.part_stats), a.part_counts, a.part_sw,
      static_cast<const WT*>(a.part_obj), static_cast<GAcc*>(a.macc),
      a.counts, a.switches, static_cast<WT*>(a.obj), nblocks, FC, a.C);
  return (int)cudaGetLastError();
}

template <typename PhiT, typename WT>
int dispatch(const EmArgs& a, bool argmax) {
  if (!argmax) return run<PhiT, WT, 8, false>(a);
  if (a.C <= 8) return run<PhiT, WT, 8, true>(a);
  if (a.C <= 16) return run<PhiT, WT, 16, true>(a);
  return run<PhiT, WT, 32, true>(a);
}

}  // namespace

// The largest cluster count the kernel takes.
extern "C" int mtm_markov_em_max_clusters() { return 32; }

// phi_kind: 0 int16, 1 float32, 2 float64; w_kind: 1 float32, 2 float64.
// Type pairs: (int16, float32), (int16, float64), (float32, float32),
// (float64, float64).  Partial buffers hold ceil(n / chunk) blocks.
// Returns a cudaError_t (0 on success), or -1 for an argument the kernel
// does not take.
extern "C" int mtm_markov_em(int device, int phi_kind, int w_kind,
                             const void* phi, const void* prev,
                             const void* wc, void* assign, void* part_stats,
                             void* part_counts, void* part_sw, void* part_obj,
                             void* macc, void* counts, void* switches,
                             void* obj, long long n, int Fcp, int C,
                             int chunk, int argmax, void* stream) {
  if (n <= 0 || Fcp <= 0 || C < 1 || C > 32 || chunk <= 0) return -1;
  if (phi_kind == 0 && chunk > 65536) return -1;  // int32 block sums
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  EmArgs a{phi,
           static_cast<const int*>(prev),
           wc,
           static_cast<int*>(assign),
           part_stats,
           static_cast<int*>(part_counts),
           static_cast<int*>(part_sw),
           part_obj,
           macc,
           static_cast<int*>(counts),
           static_cast<int*>(switches),
           obj,
           (int64_t)n,
           Fcp,
           C,
           chunk,
           static_cast<cudaStream_t>(stream)};
  const bool am = argmax != 0;
  if (phi_kind == 0 && w_kind == 1) return dispatch<int16_t, float>(a, am);
  if (phi_kind == 0 && w_kind == 2) return dispatch<int16_t, double>(a, am);
  if (phi_kind == 1 && w_kind == 1) return dispatch<float, float>(a, am);
  if (phi_kind == 2 && w_kind == 2) return dispatch<double, double>(a, am);
  return -1;
}
