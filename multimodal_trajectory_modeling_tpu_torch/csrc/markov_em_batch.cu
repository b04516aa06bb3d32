// K6, K10 and K11: hard-assignment EM passes over the raw NaN-padded batch.
//
// Replaces three TPU kernels of the JAX package (ops/pallas_markov.py),
// which compute one function of the transposed batch z_t (T*d, n), x_t
// (T*l, n) and the lengths:
// - K6  markov_em_fused_longT (bodies _markov_scores_grid_kernel and
//   _markov_stats_grid_kernel, a scores grid over (n, T), an argmax, then
//   a statistics grid): assignments, counts, switches, statistics and the
//   objective, at any T;
// - K10 markov_assign_suffix (body _markov_assign_kernel): the E step
//   alone (assignments, counts, switches);
// - K11 markov_em_fused (body _markov_em_kernel): K6's outputs from the
//   canonical weights Wg (C, F).
// The wrapper (ops/markov_kernels.py) folds K6's and K10's grouped
// weights W1, W2, W3 into the canonical (C, F) matrix by a scatter with no
// arithmetic; the fold is linear, Σ_t W·f_t = W·Σ_t f_t, so one body
// serves all three.
//
// Per instance i: its canonical Φ column (markov_longT_rows.cuh, K5's row
// build, the same bits as K5 writes), then K1's step on it
// (markov_em.cu):
//   scores_c = Σ_f wc[c, f] · Φ[f, i]   (the same FMA chain as K1's)
//   na       = the first maximum, NaN counted as the maximum (jnp.argmax);
//              assign_mode "prev" skips the scores: na = prev[i]
//   valid    = prev[i] >= 0;  assign[i] = valid ? na : C
// and over the valid instances counts, switches, obj = Σ max score and the
// statistics macc[f, c] = Σ_{na == c} Φ[f, i] (K10 skips them).
//
// The three TPU kernels differ in how they mask the transition products
// (K6 multiplies the whole z_t⊗z_{t+1} group by vm_{t+1}, K10 and K11 rely
// on NaN → 0 of a missing z_{t+1}); on suffix data, whose NaNs start at
// each instance's length, every form equals K5's g3 = z⊗(zn·vm), which
// this kernel computes.
//
// Bound on the card: bytes, z_t and x_t read once (1.03 GB at T=128,
// n=2.5e5, d=5, l=3 in float32: 0.31 ms at 3.35 TB/s); the operations,
// about 211 per (instance, step) for the build and 2·C·F per instance for
// the scores, stay below it.  Design:
// - a block takes a tile of 64 instances (32 where 64 would not fit
//   shared memory) with 3 threads per instance, one per row part of the
//   build, so the threads run along n and every load of z_t and x_t is
//   coalesced; the tile's Φ columns go to shared memory (rows padded to
//   tile + 1) and never to device memory;
// - one thread per instance then scores its column against the weights in
//   shared memory (transposed to (Fpad, CB), one broadcast read per row),
//   on the CUDA cores in the input's type (never TF32);
// - float statistics are added in a fixed order (markov_common.cuh:
//   ordered_add, one thread per feature row over the tile's columns in
//   instance order), counts with shared-memory integer atomics; each block
//   covers `chunk` instances and writes partials that a second kernel adds
//   in block order.  No global atomics, so two calls agree bit for bit.

#include <cuda_runtime.h>
#include <stdint.h>

#include "markov_common.cuh"
#include "markov_longT_rows.cuh"

namespace {

using mtm::block_sum;
using mtm::fused_ma;
using mtm::is_nan;
using mtm::kLongTMax;
using mtm::longT_rows;
using mtm::ordered_add;

constexpr int kTileMax = 64;
constexpr int kParts = 3;
constexpr size_t kMaxSmem = 232448;  // a block's shared-memory limit

template <typename T>
size_t batch_smem(int tile, int Fpad, int C, int cb, bool stats) {
  const size_t nw = kParts * tile / 32;
  return sizeof(T) * (nw + (size_t)Fpad * (tile + 1) + tile +
                      (size_t)Fpad * cb + (stats ? (size_t)Fpad * (C | 1) : 0)) +
         sizeof(int) * ((size_t)C + nw + tile);
}

template <typename T, int DM, int LM, bool FIXED, int CB, bool ARGMAX,
          bool STATS>
__global__ void __launch_bounds__(kParts* kTileMax)
    em_batch_kernel(const T* __restrict__ z, const T* __restrict__ x,
                    const int* __restrict__ lens,
                    const int* __restrict__ prev, const T* __restrict__ wc,
                    int* __restrict__ assign, T* __restrict__ part_stats,
                    int* __restrict__ part_counts, int* __restrict__ part_sw,
                    T* __restrict__ part_obj, int64_t n, int steps, int d_rt,
                    int l_rt, int Fpad, int C, int tile, int chunk) {
  const int nt = blockDim.x, nw = nt >> 5, tid = threadIdx.x;
  const int ts = tile + 1;  // the tile's row stride
  const int cs = C | 1;     // odd row stride of the statistics
  // layout, widest type first: red (nw T), tile (Fpad x ts T), obj (tile
  // T), w (Fpad x CB T, argmax only), acc (Fpad x cs T, statistics only),
  // counts (C int), ired (nw int), na (tile int)
  extern __shared__ __align__(16) unsigned char smem[];
  T* s_red = reinterpret_cast<T*>(smem);
  T* s_tile = s_red + nw;
  T* s_obj = s_tile + (size_t)Fpad * ts;
  T* s_w = s_obj + tile;
  T* s_acc = s_w + (ARGMAX ? (size_t)Fpad * CB : 0);
  int* s_counts = reinterpret_cast<int*>(s_acc + (STATS ? (size_t)Fpad * cs : 0));
  int* s_ired = s_counts + C;
  int* s_na = s_ired + nw;

  if constexpr (ARGMAX) {
    for (int e = tid; e < Fpad * CB; e += nt) {
      const int f = e / CB, c = e % CB;
      s_w[e] = c < C ? wc[(size_t)c * Fpad + f] : T(0);
    }
  }
  if constexpr (STATS) {
    for (int e = tid; e < Fpad * cs; e += nt) s_acc[e] = T(0);
  }
  for (int e = tid; e < C; e += nt) s_counts[e] = 0;
  for (int e = tid; e < tile; e += nt) s_obj[e] = T(0);
  __syncthreads();

  const int part = tid / tile, j = tid % tile;
  const int64_t start = (int64_t)blockIdx.x * chunk;
  const int64_t end = start + chunk < n ? start + chunk : n;
  int sw = 0;
  for (int64_t i0 = start; i0 < end; i0 += tile) {
    const int64_t i = i0 + j;
    if (i < end)
      longT_rows<T, DM, LM, FIXED>(part, z, x, n, i, lens[i], steps, d_rt,
                                   l_rt, Fpad, s_tile + j, ts);
    __syncthreads();
    if (tid < tile) {  // instance i = i0 + tid, its column s_tile[f * ts + tid]
      int kept = -1;
      if (i < end) {
        const int p = prev[i];
        const bool valid = p >= 0;
        int na = p;
        if constexpr (ARGMAX) {
          T sc[CB];
#pragma unroll
          for (int c = 0; c < CB; ++c) sc[c] = T(0);
          for (int f = 0; f < Fpad; ++f) {
            const T v = s_tile[f * ts + tid];
            const T* wf = s_w + f * CB;
#pragma unroll
            for (int c = 0; c < CB; ++c) sc[c] = fused_ma(wf[c], v, sc[c]);
          }
          T best = sc[0];
          na = 0;
#pragma unroll
          for (int c = 1; c < CB; ++c) {
            if (c < C && (sc[c] > best || (is_nan(sc[c]) && !is_nan(best)))) {
              best = sc[c];
              na = c;
            }
          }
          if (valid) {
            s_obj[tid] += best;
            sw += (na != p);
          }
        }
        assign[i] = valid ? na : C;
        if (valid && na < C) {
          atomicAdd(&s_counts[na], 1);
          kept = na;
        }
      }
      s_na[tid] = kept;
    }
    __syncthreads();
    if constexpr (STATS) ordered_add(s_acc, cs, s_na, tile, s_tile, ts, Fpad);
    __syncthreads();  // the next tile overwrites s_tile and s_na
  }
  const T obj_blk = block_sum(tid < tile ? s_obj[tid] : T(0), s_red);
  const int sw_blk = block_sum(sw, s_ired);

  const int64_t b = blockIdx.x;
  if constexpr (STATS) {
    for (int e = tid; e < Fpad * C; e += nt)
      part_stats[b * Fpad * C + e] = s_acc[(e / C) * cs + e % C];
  }
  for (int e = tid; e < C; e += nt) part_counts[b * C + e] = s_counts[e];
  if (tid == 0) {
    part_sw[b] = sw_blk;
    part_obj[b] = obj_blk;
  }
}

// Adds the per-block partials in block order: one thread per output (FC is
// 0 without statistics).
template <typename T>
__global__ void em_batch_reduce(const T* __restrict__ part_stats,
                                const int* __restrict__ part_counts,
                                const int* __restrict__ part_sw,
                                const T* __restrict__ part_obj,
                                T* __restrict__ macc, int* __restrict__ counts,
                                int* __restrict__ switches, T* __restrict__ obj,
                                int64_t nblocks, int FC, int C) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e < FC) {
    T a = T(0);
    for (int64_t b = 0; b < nblocks; ++b) a += part_stats[b * FC + e];
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
    T a = T(0);
    for (int64_t b = 0; b < nblocks; ++b) a += part_obj[b];
    *obj = a;
  }
}

struct BatchArgs {
  const void* z;
  const void* x;
  const int* lens;
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
  int steps;
  int d;
  int l;
  int Fpad;
  int C;
  int chunk;
  cudaStream_t stream;
};

template <typename T, int DM, int LM, bool FIXED, int CB, bool ARGMAX,
          bool STATS>
int run(const BatchArgs& a) {
  const int cb = ARGMAX ? CB : 0;
  int tile = kTileMax;
  while (tile >= 32 && batch_smem<T>(tile, a.Fpad, a.C, cb, STATS) > kMaxSmem)
    tile >>= 1;
  if (tile < 32 || a.chunk % tile != 0) return -1;
  const size_t smem = batch_smem<T>(tile, a.Fpad, a.C, cb, STATS);
  const int64_t nblocks = (a.n + a.chunk - 1) / a.chunk;
  auto kern = em_batch_kernel<T, DM, LM, FIXED, CB, ARGMAX, STATS>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kern<<<(unsigned)nblocks, kParts * tile, smem, a.stream>>>(
      static_cast<const T*>(a.z), static_cast<const T*>(a.x), a.lens, a.prev,
      static_cast<const T*>(a.wc), a.assign, static_cast<T*>(a.part_stats),
      a.part_counts, a.part_sw, static_cast<T*>(a.part_obj), a.n, a.steps,
      a.d, a.l, a.Fpad, a.C, tile, a.chunk);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int FC = STATS ? a.Fpad * a.C : 0;
  const int total = FC + a.C + 2;
  em_batch_reduce<T><<<(total + 255) / 256, 256, 0, a.stream>>>(
      static_cast<const T*>(a.part_stats), a.part_counts, a.part_sw,
      static_cast<const T*>(a.part_obj), static_cast<T*>(a.macc), a.counts,
      a.switches, static_cast<T*>(a.obj), nblocks, FC, a.C);
  return (int)cudaGetLastError();
}

template <typename T, int DM, int LM, bool FIXED>
int dispatch_mode(const BatchArgs& a, bool argmax, bool stats) {
  if (!argmax) return run<T, DM, LM, FIXED, 16, false, true>(a);
  if (a.C <= 16)
    return stats ? run<T, DM, LM, FIXED, 16, true, true>(a)
                 : run<T, DM, LM, FIXED, 16, true, false>(a);
  return stats ? run<T, DM, LM, FIXED, 32, true, true>(a)
               : run<T, DM, LM, FIXED, 32, true, false>(a);
}

template <typename T>
int dispatch(const BatchArgs& a, bool argmax, bool stats) {
  // the benchmark shape and ADNI's exactly, one instantiation for the rest
  if (a.d == 5 && a.l == 3) return dispatch_mode<T, 5, 3, true>(a, argmax, stats);
  if (a.d == 2 && a.l == 4) return dispatch_mode<T, 2, 4, true>(a, argmax, stats);
  return dispatch_mode<T, kLongTMax, kLongTMax, false>(a, argmax, stats);
}

}  // namespace

// kind: 0 float32, 1 float64 (z, x, wc, the float partials and outputs).
// wc is (C, Fpad), the canonical weights; macc (Fpad, C).  argmax = 0 is
// assign_mode "prev" (needs stats = 1); stats = 0 skips the statistics
// (part_stats and macc are then not touched).  Partial buffers hold
// ceil(n / chunk) blocks; chunk is a multiple of 64.  Returns a
// cudaError_t (0 on success), or -1 for an argument the kernel does not
// take.
extern "C" int mtm_markov_em_batch(
    int device, int kind, const void* z, const void* x, const void* lens,
    const void* prev, const void* wc, void* assign, void* part_stats,
    void* part_counts, void* part_sw, void* part_obj, void* macc,
    void* counts, void* switches, void* obj, long long n, int steps, int d,
    int l, int Fpad, int C, int chunk, int argmax, int stats, void* stream) {
  if (n <= 0 || steps <= 0 || d < 1 || l < 1 || d > kLongTMax ||
      l > kLongTMax || C < 1 || C > 32 || chunk <= 0 || chunk % 64 != 0)
    return -1;
  if (Fpad < 4 * d * d + l * l + d * l + 3 * d + l + 2) return -1;
  if (!argmax && !stats) return -1;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  BatchArgs a{z,
              x,
              static_cast<const int*>(lens),
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
              steps,
              d,
              l,
              Fpad,
              C,
              chunk,
              static_cast<cudaStream_t>(stream)};
  if (kind == 0) return dispatch<float>(a, argmax != 0, stats != 0);
  if (kind == 1) return dispatch<double>(a, argmax != 0, stats != 0);
  return -1;
}
