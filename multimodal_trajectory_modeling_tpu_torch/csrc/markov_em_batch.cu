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
// arithmetic, the same bits as K5 writes), then K1's step on it
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
// n=2.5e5, d=5, l=3 in float32: 0.31 ms at 3.35 TB/s; 0.23 ms on each
// row's steps up to its extent); the operations, about 211 per (instance,
// step) for the build and 2·C·F per instance for the scores, stay below
// it.  Design (each part answers one cause of the first port's 5× gap,
// measured by tools/k6_phase_split.py: its build was 82% of 1.6 ms):
// - a plan (ops/markov_kernels.py: each row's extent, the rows in a stable
//   order by extent, longest first; the caller permutes the batch once):
//   a tile's loop runs to its largest extent and each thread stops at its
//   own, so all-NaN steps are neither read nor built.  Without a plan
//   (extent = null) every row runs to T, with the same arithmetic;
// - the batch is staged by cp.async into a ring of shared-memory stages,
//   two steps a stage, issued two stages ahead of the build threads that
//   read them (16-byte copies where the rows are 16-byte aligned, as at
//   n = 2.5e5; 4- or 8-byte copies at a ragged n); the next tile's first
//   stages are issued as soon as this tile's build is done, so they land
//   during its scores and statistics.  Stages of one step, a deeper ring
//   at 2 blocks an SM and L2 prefetches further ahead all measured slower
//   (tools/k6_phase_split.py);
// - a tile of 64 instances (32 where 64 leaves fewer warps on an SM) with
//   3 threads per instance, one per row part of the build; the threads run
//   along n, so every copy is coalesced; the tile's Φ columns go to shared
//   memory (rows padded to tile + 1) and never to device memory;
// - every thread scores: each of an instance's three threads takes a third
//   of the clusters over the whole column, on the CUDA cores in the
//   input's type (never TF32), each cluster's FMA chain over f in K1's
//   order; the three partial argmaxes are combined in cluster order under
//   the same first-max/NaN rule;
// - float statistics in a fixed order (markov_common.cuh: ordered_add,
//   one thread a feature row over the tile's columns in instance order),
//   counts with shared-memory integer atomics.  A stable per-tile counting
//   sort by cluster with register segment sums measured no faster
//   (tools/k6_phase_split.py's `sorted_stats` build): the statistics are
//   ~4% of the kernel;
// - persistent blocks over a static schedule (block b takes tiles b, b+G,
//   ...), so there is no part-filled last wave; each block writes partials
//   that a second kernel adds in a fixed order, one warp an output (one
//   thread an output over ~1000 blocks took 0.16 ms of K10's 0.95).  No
//   float atomics, so two calls agree bit for bit.

#include <cuda_runtime.h>
#include <stdint.h>

#include "markov_common.cuh"
#include "markov_longT_rows.cuh"

namespace {

using mtm::block_sum;
using mtm::finite_or_zero;
using mtm::fused_ma;
using mtm::is_nan;
using mtm::kLongTMax;
using mtm::LongTLayout;
using mtm::ordered_add;
using mtm::RowsX;
using mtm::RowsZN;
using mtm::RowsZZ;
using mtm::warp_total;

constexpr int kParts = 3;
constexpr int kTileMax = 64;
constexpr int kWin = 2;            // steps a stage
constexpr int kMaxStages = 8;      // stages in the ring
constexpr size_t kMaxSmem = 232448;  // a block's shared-memory limit

// Blocks an SM asked of ptxas: 18 warps in float32 at the fixed shapes
// (at most 112 registers); the general shape (up to 2·64 running sums a
// thread) is left its registers.
template <typename T, bool FIXED>
struct Bounds {
  static constexpr int kMinBlocks = !FIXED ? 1 : sizeof(T) == 4 ? 3 : 2;
};

// The block's dynamic shared memory, widest type first: tile (Fpad x ts
// T), stages (ns x kWin x R x tile T), w (Fpad x 3·CP T, argmax only), acc
// (Fpad x cs T, statistics only), best (3 x tile T), obj (tile T), red (nw
// T); then ints: seg (3 x tile), na (tile), counts (C), ired (nw).  (The
// weights read through L1 instead of shared memory made the scores 6×
// slower on an H100, measured with tools/k6_phase_split.py.)
template <typename T>
size_t batch_smem(int tile, int ns, int rows, int Fpad, int C, int cp, bool argmax, bool stats) {
  const size_t nw = kParts * tile / 32;
  const size_t fl = (size_t)Fpad * (tile + 1) + (size_t)ns * kWin * rows * tile +
                    (argmax ? (size_t)Fpad * kParts * cp : 0) + (stats ? (size_t)Fpad * (C | 1) : 0) +
                    kParts * tile + tile + nw;
  const size_t in = kParts * tile + tile + C + nw;
  return sizeof(T) * fl + sizeof(int) * in;
}

// A barrier that threads may reach from different places in the code: the
// three row parts run their own step loops (warp-uniform branches), each
// waiting at its stage boundaries the same number of times.
__device__ __forceinline__ void cta_sync() { asm volatile("barrier.sync 0;\n" ::: "memory"); }

template <typename T>
__device__ __forceinline__ void cp_async(T* dst, const T* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if constexpr (sizeof(T) == 4)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src) : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(d), "l"(src) : "memory");
}
// 16 bytes: 4 float32 or 2 float64 neighbours in a row
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
// Wait until at most `pending` (0 to 5) of this thread's groups are in flight.
__device__ __forceinline__ void cp_async_wait(int pending) {
  switch (pending) {
    case 0: asm volatile("cp.async.wait_group 0;\n" ::: "memory"); break;
    case 1: asm volatile("cp.async.wait_group 1;\n" ::: "memory"); break;
    case 2: asm volatile("cp.async.wait_group 2;\n" ::: "memory"); break;
    case 3: asm volatile("cp.async.wait_group 3;\n" ::: "memory"); break;
    case 4: asm volatile("cp.async.wait_group 4;\n" ::: "memory"); break;
    default: asm volatile("cp.async.wait_group 5;\n" ::: "memory"); break;
  }
}

// The stage ring of one tile: stage k % ns holds window k, the steps
// [k·kWin, (k+1)·kWin), each step its rows() = d + l rows (z, then x) of
// the tile's columns.  At the fixed shapes d and l are constants, so the
// copies' index arithmetic is shifts and multiplications.
template <typename T, int DM, int LM, bool FIXED>
struct Ring {
  const T* __restrict__ z;
  const T* __restrict__ x;
  T* stages;
  int64_t n, i0;
  int d_rt, l_rt, tshift, ns, nj, text;  // tile = 1 << tshift; text: the tile's largest extent
  bool vec;  // rows 16-byte aligned: copies of 16 bytes (the ragged edge by element)

  __device__ __forceinline__ int d() const { return FIXED ? DM : d_rt; }
  __device__ __forceinline__ int l() const { return FIXED ? LM : l_rt; }
  __device__ __forceinline__ int rows() const { return d() + l(); }
  // step w of window k
  __device__ __forceinline__ const T* window(int k) const {
    return stages + ((size_t)(k % ns) * kWin * rows() << tshift);
  }
  __device__ __forceinline__ const T* slab(const T* win, int w) const { return win + (w * rows() << tshift); }
  // window k's copies (none past the tile's extent), then one commit; a
  // unit is 16 bytes of one row of one step (one value where the rows are
  // not aligned)
  __device__ __forceinline__ void issue(int k) const {
    constexpr int kVec = 16 / sizeof(T), kVshift = sizeof(T) == 4 ? 2 : 1;
    const int t0 = k * kWin, nsteps = text - t0 < kWin ? text - t0 : kWin;
    const int vs = vec ? kVshift : 0, ushift = tshift - vs;
    const int units = (nsteps * rows()) << ushift;
    T* dst = const_cast<T*>(window(k));
    const T* zb = z + (int64_t)t0 * d() * n + i0;
    const T* xb = x + (int64_t)t0 * l() * n + i0;
    for (int u = threadIdx.x; u < units; u += blockDim.x) {
      const int line = u >> ushift, j = (u & ((1 << ushift) - 1)) << vs;
      const int w = line / rows(), r = line - w * rows();
      const T* src = (r < d() ? zb + (int64_t)(w * d() + r) * n : xb + (int64_t)(w * l() + r - d()) * n) + j;
      T* sd = dst + (line << tshift) + j;
      if (vec && j + kVec <= nj) {
        cp_async16(sd, src);
      } else {
        for (int q = 0; q < (1 << vs) && j + q < nj; ++q) cp_async(sd + q, src + q);
      }
    }
    cp_async_commit();
  }
  // before window k: windows k and k+1 have landed for every thread, every
  // thread is done with window k - 1, whose stage then takes window
  // k + ns - 1
  __device__ __forceinline__ void enter(int k, int nwin) const {
    cp_async_wait(ns - 3);
    cta_sync();
    if (k + ns - 1 < nwin) issue(k + ns - 1);
    else cp_async_commit();
  }
  // the first ns - 1 windows of the tile
  __device__ __forceinline__ void prologue(int nwin) const {
    for (int k = 0; k < ns - 1; ++k) {
      if (k < nwin) issue(k);
      else cp_async_commit();
    }
  }
};

// The largest extent of a tile's rows (every warp computes it alone).
__device__ __forceinline__ int tile_extent(const int* __restrict__ extent, int64_t i0, int nj, int steps) {
  if (extent == nullptr) return steps;
  const int lane = threadIdx.x & 31;
  int e = 0;
  for (int j = lane; j < nj; j += 32) e = max(e, extent[i0 + j]);
  return min(__reduce_max_sync(0xffffffffu, e), steps);
}

// The first-max/NaN rule of one more candidate (jnp.argmax).
template <typename T>
__device__ __forceinline__ bool takes(T v, T best) {
  return v > best || (is_nan(v) && !is_nan(best));
}

template <typename T, int DM, int LM, bool FIXED, int CP, bool ARGMAX, bool STATS>
__global__ void __launch_bounds__(kParts* kTileMax, Bounds<T, FIXED>::kMinBlocks)
    em_batch_kernel(const T* __restrict__ z, const T* __restrict__ x,
                    const int* __restrict__ lens, const int* __restrict__ extent,
                    const int* __restrict__ prev, const T* __restrict__ wc,
                    int* __restrict__ assign, T* __restrict__ part_stats,
                    int* __restrict__ part_counts, int* __restrict__ part_sw,
                    T* __restrict__ part_obj, int64_t n, int steps, int d_rt,
                    int l_rt, int Fpad, int C, int tile, int ns) {
  const int nt = blockDim.x, nw = nt >> 5, tid = threadIdx.x;
  const LongTLayout o(FIXED ? DM : d_rt, FIXED ? LM : l_rt);
  const int rows = o.d + o.l;
  const int ts = tile + 1;  // the tile's row stride
  const int cs = C | 1;     // odd row stride of the statistics
  extern __shared__ __align__(16) unsigned char smem[];
  T* s_tile = reinterpret_cast<T*>(smem);
  T* s_stage = s_tile + (size_t)Fpad * ts;
  const int cw = kParts * CP;
  T* s_w = s_stage + (size_t)ns * kWin * rows * tile;
  T* s_acc = s_w + (ARGMAX ? (size_t)Fpad * cw : 0);
  T* s_best = s_acc + (STATS ? (size_t)Fpad * cs : 0);
  T* s_obj = s_best + kParts * tile;
  T* s_red = s_obj + tile;
  int* s_seg = reinterpret_cast<int*>(s_red + nw);
  int* s_na = s_seg + kParts * tile;
  int* s_counts = s_na + tile;
  int* s_ired = s_counts + C;

  if constexpr (ARGMAX) {  // (Fpad, 3·CP): the clusters of part p at columns p·CP..
    for (int e = tid; e < Fpad * cw; e += nt) {
      const int f = e / cw, c = e % cw;
      s_w[e] = c < C ? wc[(size_t)c * Fpad + f] : T(0);
    }
  }
  if constexpr (STATS) {
    for (int e = tid; e < Fpad * cs; e += nt) s_acc[e] = T(0);
  }
  for (int e = tid; e < C; e += nt) s_counts[e] = 0;
  for (int e = tid; e < tile; e += nt) s_obj[e] = T(0);

  const int part = tid / tile, j = tid % tile;
  const int64_t ntiles = (n + tile - 1) / tile;
  const bool vec = (n * sizeof(T)) % 16 == 0 && reinterpret_cast<uintptr_t>(z) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(x) % 16 == 0 && reinterpret_cast<uintptr_t>(s_stage) % 16 == 0;
  Ring<T, DM, LM, FIXED> ring{z, x, s_stage, n, 0, d_rt, l_rt, tile == 64 ? 6 : 5, ns, 0, 0, vec};
  auto open = [&](int64_t tl) {  // the ring on tile tl, its first windows issued
    ring.i0 = tl * tile;
    ring.nj = (int)(n - ring.i0 < tile ? n - ring.i0 : tile);
    ring.text = tile_extent(extent, ring.i0, ring.nj, steps);
    ring.prologue((ring.text + kWin - 1) / kWin);
  };
  if (blockIdx.x < ntiles) open(blockIdx.x);
  int sw = 0;
  for (int64_t tl = blockIdx.x; tl < ntiles; tl += gridDim.x) {
    const int64_t i = ring.i0 + j;
    const bool active = j < ring.nj;
    const int len = active ? lens[i] : 0;
    const int ext = active ? min(extent ? extent[i] : steps, ring.text) : 0;
    const int nwin = (ring.text + kWin - 1) / kWin;
    T* col = s_tile + j;
    auto put = [&](int row, T v) { col[row * ts] = v; };
    auto vm_at = [&](int t) { return (len > t + 1 && t < steps - 1) ? T(1) : T(0); };
    auto load_z = [&](const T* slab, T (&v)[DM]) {
#pragma unroll
      for (int a = 0; a < DM; ++a)
        if (a < o.d) v[a] = finite_or_zero(slab[a * tile + j]);
    };
    // 1. the row build, each part over its own steps
    if (part == 0) {
      RowsZZ<T, DM> r;
      for (int k = 0; k < nwin; ++k) {
        ring.enter(k, nwin);
        const T* win = ring.window(k);
#pragma unroll
        for (int w = 0; w < kWin; ++w) {
          const int t = k * kWin + w;
          if (t < ext) {
            T zc[DM];
            load_z(ring.slab(win, w), zc);
            if (w == 0 && k == 0) r.template step<true>(o, zc, vm_at(t), put);
            else r.template step<false>(o, zc, vm_at(t), put);
          }
        }
      }
      if (active) r.finish(o, ext > 0, put);
    } else if (part == 1) {
      RowsZN<T, DM> r;
      T zn[DM];
      for (int k = 0; k < nwin; ++k) {
        ring.enter(k, nwin);
        const T* win = ring.window(k);
        if (k == 0 && ext > 0) load_z(win, zn);
#pragma unroll
        for (int w = 0; w < kWin; ++w) {
          const int t = k * kWin + w;
          if (t < ext) {
            T zc[DM];
#pragma unroll
            for (int a = 0; a < DM; ++a) zc[a] = zn[a];
            if (t + 1 < ext) load_z(w + 1 < kWin ? ring.slab(win, w + 1) : ring.window(k + 1), zn);
            else {
#pragma unroll
              for (int a = 0; a < DM; ++a) zn[a] = T(0);
            }
            if (w == 0 && k == 0) r.template step<true>(o, zc, zn, vm_at(t), put);
            else r.template step<false>(o, zc, zn, vm_at(t), put);
          }
        }
      }
      if (active) r.finish(o, ext > 0, put);
    } else {
      RowsX<T, DM, LM> r;
      for (int k = 0; k < nwin; ++k) {
        ring.enter(k, nwin);
        const T* win = ring.window(k);
#pragma unroll
        for (int w = 0; w < kWin; ++w) {
          const int t = k * kWin + w;
          if (t < ext) {
            const T* slab = ring.slab(win, w);
            T zc[DM], xc[LM];
            load_z(slab, zc);
#pragma unroll
            for (int b = 0; b < LM; ++b)
              if (b < o.l) xc[b] = finite_or_zero(slab[(o.d + b) * tile + j]);
            r.step(o, zc, xc);
          }
        }
      }
      if (active) r.finish(o, len, Fpad, put);
    }
    cp_async_wait(0);
    cta_sync();  // the tile's columns are built; the ring is free
    if (tl + gridDim.x < ntiles) open(tl + gridDim.x);

    // 2. scores: part p takes clusters p·CP .. p·CP + CP - 1
    if constexpr (ARGMAX) {
      T best = T(0);
      int idx = -1;
      if (active) {
        T sc[CP];
#pragma unroll
        for (int c = 0; c < CP; ++c) sc[c] = T(0);
        const T* wp = s_w + part * CP;
#pragma unroll 4
        for (int f = 0; f < Fpad; ++f) {
          const T v = s_tile[f * ts + j];
          const T* wf = wp + f * cw;
#pragma unroll
          for (int c = 0; c < CP; ++c) sc[c] = fused_ma(wf[c], v, sc[c]);
        }
#pragma unroll
        for (int c = 0; c < CP; ++c) {
          if (part * CP + c < C && (idx < 0 || takes(sc[c], best))) {
            best = sc[c];
            idx = part * CP + c;
          }
        }
      }
      s_best[part * tile + j] = best;
      s_seg[part * tile + j] = idx;
      cta_sync();
    }
    if (tid < tile) {  // instance i = i0 + tid
      int kept = -1;
      if (active) {
        const int p = prev[i];
        const bool valid = p >= 0;
        int na = p;
        if constexpr (ARGMAX) {
          T best = s_best[j];
          na = s_seg[j];
#pragma unroll
          for (int q = 1; q < kParts; ++q) {
            const int c = s_seg[q * tile + j];
            const T v = s_best[q * tile + j];
            if (c >= 0 && takes(v, best)) {
              best = v;
              na = c;
            }
          }
          if (valid) {
            s_obj[j] += best;
            sw += (na != p);
          }
        }
        assign[i] = valid ? na : C;
        if (valid && na < C) {
          atomicAdd(&s_counts[na], 1);
          kept = na;
        }
      }
      s_na[j] = kept;
    }
    // 3. statistics, one thread a feature row over the tile's columns in
    // order (markov_common.cuh)
    if constexpr (STATS) {
      cta_sync();
      ordered_add(s_acc, cs, s_na, tile, s_tile, ts, Fpad);
    }
    cta_sync();  // the next tile overwrites the columns and s_na
  }
  cp_async_wait(0);
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

// Adds the per-block partials in a fixed order: one warp per output
// (markov_common.cuh:warp_total; FC is 0 without statistics).
template <typename T>
__global__ void em_batch_reduce(const T* __restrict__ part_stats,
                                const int* __restrict__ part_counts,
                                const int* __restrict__ part_sw,
                                const T* __restrict__ part_obj,
                                T* __restrict__ macc, int* __restrict__ counts,
                                int* __restrict__ switches, T* __restrict__ obj,
                                int64_t nblocks, int FC, int C) {
  const int e = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const bool first = (threadIdx.x & 31) == 0;
  if (e < FC) {
    const T a = warp_total(part_stats + e, FC, nblocks);
    if (first) macc[e] = a;
  } else if (e < FC + C) {
    const int a = warp_total(part_counts + (e - FC), C, nblocks);
    if (first) counts[e - FC] = a;
  } else if (e == FC + C) {
    const int a = warp_total(part_sw, 1, nblocks);
    if (first) *switches = a;
  } else if (e == FC + C + 1) {
    const T a = warp_total(part_obj, 1, nblocks);
    if (first) *obj = a;
  }
}

struct BatchArgs {
  const void* z;
  const void* x;
  const int* lens;
  const int* extent;
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
  int tile;
  int ns;
  int grid;
  cudaStream_t stream;
};

// The launch a shape takes: {tile, threads, smem bytes, blocks an SM,
// stages, SMs}; the tile and stage count that put the most warps on an SM
// (ties: the larger tile, then more stages).
struct Config {
  int tile, threads, smem, blocks, ns, sms;
};

template <typename T, int DM, int LM, bool FIXED, int CP, bool ARGMAX, bool STATS>
int config(int d, int l, int Fpad, int C, Config* out) {
  auto kern = em_batch_kernel<T, DM, LM, FIXED, CP, ARGMAX, STATS>;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kMaxSmem);
  if (err != cudaSuccess) return (int)err;
  Config best{0, 0, 0, 0, 0, sms};
  for (int tile = kTileMax; tile >= 32; tile >>= 1) {
    for (int ns = kMaxStages; ns >= 3; --ns) {
      const size_t smem = batch_smem<T>(tile, ns, d + l, Fpad, C, CP, ARGMAX, STATS);
      if (smem > kMaxSmem) continue;
      int blocks = 0;
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kern, kParts * tile, smem);
      if (err != cudaSuccess) return (int)err;
      if (blocks * tile > best.blocks * best.tile)
        best = Config{tile, kParts * tile, (int)smem, blocks, ns, sms};
    }
  }
  if (best.blocks == 0) return -1;
  *out = best;
  return 0;
}

template <typename T, int DM, int LM, bool FIXED, int CP, bool ARGMAX, bool STATS>
int run(const BatchArgs& a) {
  const size_t smem = batch_smem<T>(a.tile, a.ns, a.d + a.l, a.Fpad, a.C, CP, ARGMAX, STATS);
  if ((a.tile != 32 && a.tile != 64) || a.ns < 3 || a.ns > kMaxStages || smem > kMaxSmem || a.grid < 1) return -1;
  auto kern = em_batch_kernel<T, DM, LM, FIXED, CP, ARGMAX, STATS>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kern<<<(unsigned)a.grid, kParts * a.tile, smem, a.stream>>>(
      static_cast<const T*>(a.z), static_cast<const T*>(a.x), a.lens, a.extent, a.prev,
      static_cast<const T*>(a.wc), a.assign, static_cast<T*>(a.part_stats),
      a.part_counts, a.part_sw, static_cast<T*>(a.part_obj), a.n, a.steps,
      a.d, a.l, a.Fpad, a.C, a.tile, a.ns);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int FC = STATS ? a.Fpad * a.C : 0;
  const int total = FC + a.C + 2;  // outputs, one warp each
  em_batch_reduce<T><<<(total + 7) / 8, 256, 0, a.stream>>>(
      static_cast<const T*>(a.part_stats), a.part_counts, a.part_sw,
      static_cast<const T*>(a.part_obj), static_cast<T*>(a.macc), a.counts,
      a.switches, static_cast<T*>(a.obj), a.grid, FC, a.C);
  return (int)cudaGetLastError();
}

// One body per (type, shape, clusters a part, mode): Op is run or config.
template <typename T, int DM, int LM, bool FIXED, class Op>
int dispatch_mode(int C, bool argmax, bool stats, Op op) {
  if (!argmax) return op.template go<T, DM, LM, FIXED, 6, false, true>();
  if (C <= 3 * 6)
    return stats ? op.template go<T, DM, LM, FIXED, 6, true, true>() : op.template go<T, DM, LM, FIXED, 6, true, false>();
  return stats ? op.template go<T, DM, LM, FIXED, 11, true, true>() : op.template go<T, DM, LM, FIXED, 11, true, false>();
}

template <typename T, class Op>
int dispatch(int d, int l, int C, bool argmax, bool stats, Op op) {
  // the benchmark shape and ADNI's exactly, one instantiation for the rest
  if (d == 5 && l == 3) return dispatch_mode<T, 5, 3, true>(C, argmax, stats, op);
  if (d == 2 && l == 4) return dispatch_mode<T, 2, 4, true>(C, argmax, stats, op);
  return dispatch_mode<T, kLongTMax, kLongTMax, false>(C, argmax, stats, op);
}

struct RunOp {
  const BatchArgs& a;
  template <typename T, int DM, int LM, bool FIXED, int CP, bool ARGMAX, bool STATS>
  int go() const { return run<T, DM, LM, FIXED, CP, ARGMAX, STATS>(a); }
};

struct ConfigOp {
  int d, l, Fpad, C;
  Config* out;
  template <typename T, int DM, int LM, bool FIXED, int CP, bool ARGMAX, bool STATS>
  int go() const { return config<T, DM, LM, FIXED, CP, ARGMAX, STATS>(d, l, Fpad, C, out); }
};

bool args_ok(int d, int l, int Fpad, int C, int argmax, int stats) {
  return d >= 1 && l >= 1 && d <= kLongTMax && l <= kLongTMax && C >= 1 && C <= 32 &&
         Fpad >= 4 * d * d + l * l + d * l + 3 * d + l + 2 && (argmax || stats);
}

}  // namespace

// The launch of a shape on the current device: out = {tile, threads, smem
// bytes, blocks an SM, stages, SMs}.  The caller sizes the partial
// buffers for grid = min(ceil(n / tile), blocks · SMs) blocks.  Returns a
// cudaError_t (0 on success), or -1 for arguments the kernel does not
// take.
extern "C" int mtm_markov_em_batch_config(int kind, int d, int l, int Fpad, int C, int argmax, int stats,
                                          void* out) {
  if (!args_ok(d, l, Fpad, C, argmax, stats)) return -1;
  Config cfg{};
  const ConfigOp op{d, l, Fpad, C, &cfg};
  int rc = -1;
  if (kind == 0) rc = dispatch<float>(d, l, C, argmax != 0, stats != 0, op);
  if (kind == 1) rc = dispatch<double>(d, l, C, argmax != 0, stats != 0, op);
  if (rc == 0) {
    int* o = static_cast<int*>(out);
    o[0] = cfg.tile, o[1] = cfg.threads, o[2] = cfg.smem, o[3] = cfg.blocks, o[4] = cfg.ns, o[5] = cfg.sms;
  }
  return rc;
}

// kind: 0 float32, 1 float64 (z, x, wc, the float partials and outputs).
// wc is (C, Fpad), the canonical weights; macc (Fpad, C).  extent: null
// (every row runs to T), or each row's extent (1 + its last step with a
// value that is not NaN), so that the row stops there.  argmax = 0 is
// assign_mode "prev" (needs stats = 1); stats = 0 skips the statistics
// (part_stats and macc are then not touched).  tile, ns and grid come from
// mtm_markov_em_batch_config; the partial buffers hold grid blocks.
// Returns a cudaError_t (0 on success), or -1 for an argument the kernel
// does not take.
extern "C" int mtm_markov_em_batch(
    int device, int kind, const void* z, const void* x, const void* lens, const void* extent,
    const void* prev, const void* wc, void* assign, void* part_stats,
    void* part_counts, void* part_sw, void* part_obj, void* macc,
    void* counts, void* switches, void* obj, long long n, int steps, int d,
    int l, int Fpad, int C, int tile, int ns, int grid, int argmax, int stats, void* stream) {
  if (n <= 0 || steps <= 0 || !args_ok(d, l, Fpad, C, argmax, stats)) return -1;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const BatchArgs a{z,
                    x,
                    static_cast<const int*>(lens),
                    static_cast<const int*>(extent),
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
                    tile,
                    ns,
                    grid,
                    static_cast<cudaStream_t>(stream)};
  const RunOp op{a};
  if (kind == 0) return dispatch<float>(d, l, C, argmax != 0, stats != 0, op);
  if (kind == 1) return dispatch<double>(d, l, C, argmax != 0, stats != 0, op);
  return -1;
}
