// K1 under int16 Φ: one hard-assignment EM iteration over the materialized
// features, Φ read once into shared memory, the statistics on the integer
// tensor cores.
//
// Replaces the TPU kernel ops/pallas_markov.py:markov_em_from_features
// (body _markov_em_feat_kernel) of the JAX package for int16 Φ with float32
// or float64 weights; markov_em.cu keeps wide Φ, and the int16 shapes whose
// block does not fit here (ops/markov_kernels.py:k1_plan sends them there).
// The function is markov_em.cu's: per instance i (one column of Φ (Fcp, n))
//   scores_c = Σ_f wc[c, f] · Φ[f, i]   (C of them, K1's FMA chain)
//   na       = the first maximum, NaN counted as the maximum (jnp.argmax);
//              assign_mode "prev" skips the scores: na = prev[i]
//   assign   = prev[i] >= 0 ? na : C
// and over the valid instances counts, switches, the objective Σ best and
// the statistics macc[f, c] = Σ_{na == c} Φ[f, i], exact in int64.  All
// five outputs equal markov_em.cu's bit for bit: the same FMA chain, the
// statistics integer sums (order-free), the objective in its order.
//
// What it replaces: markov_em.cu's int16 body read each instance's Φ
// column from device memory one 2-byte load a row (64 bytes a warp load,
// nothing staged), added the column into the block's statistics with up to
// Fcp shared-memory atomics an instance (serialized when a warp's
// instances share a cluster, as they do once EM converges), rereading the
// column from L1/L2, and reduced its ⌈n / 1024⌉ partials with one thread
// an output: 0.65-0.68 ms of device time at n = 1e6, Fcp = 112, C = 16
// (0.84 with every instance in one cluster), 0.14-0.15 of it the reduce,
// on an NVIDIA H100 80GB HBM3 at 700 W (tools/k1_phase_split.py).
//
// What bounds it on the card: the Φ stream, 2 · Fcp · n bytes (224 MB at
// n = 1e6, Fcp = 112: 0.067 ms at 3.35 TB/s); the score FMAs, C · Fcp an
// instance on the CUDA cores (1.8e9 at C = 16: 0.054 ms at 33.5 TFMA/s),
// about 1.5 issued instructions each.  The two overlap here.  On that card
// this body takes 0.21 ms and the reduce 0.015 at that shape, the same
// with every instance in one cluster; alone, the copies take 0.08, the
// scores 0.14-0.15 and the statistics 0.04 (tools/k1_phase_split.py).
//
// Design:
// - persistent blocks (the grid is the SMs times the blocks an SM that
//   shared memory and registers allow, and at least enough that a block
//   takes at most 65536 instances) walk the tiles b, b + G, ... of kNT =
//   128 instances; a tile is the Fcp int16 rows × 128 columns (256
//   contiguous bytes a row), copied by cp.async into a ring of two slots
//   (16 bytes a copy where n % 8 == 0 and Φ is 16-byte aligned, 4 where n is
//   even, otherwise plain loads, 16 in flight a thread), the next tile's
//   copies issued before this tile's scores; the tile's 16-byte chunks are XOR-swizzled by row
//   (markov_int16_tile.cuh), so the fragment loads of the statistics and
//   the score reads hit distinct banks.  At the bench shape a block holds
//   72 KB, so three blocks share an SM and one block's barriers, copies
//   and statistics overlap another's scores;
// - scores: two threads half a warp apart take two neighbouring instances
//   of the tile, each half of the clusters, their scores in registers,
//   K1's chain over f in the weights' type (never TF32) on the int16 value
//   converted exactly (2^23 + 2^15 magic); the weights (Fcp, CB) sit in
//   shared memory, each row's share read as 16-byte vectors, one per half
//   warp; each thread takes the first maximum of its half (NaN counted as
//   the maximum), and one shuffle combines the halves in cluster order,
//   which is K1's argmax over all.  Measured no faster (the same card):
//   one instance and all its clusters a thread, the two threads of an
//   instance pair neighbouring lanes;
// - statistics: macc += Φ_tile · onehot(na) by mma.sync m16n8k32 on Φ's
//   byte planes (hi = Φ >> 8 as s8, lo = Φ & 0xFF as u8, split from the
//   staged tile straight into A fragments) against the u8 one-hot of the
//   tile's assignments; warp w owns the 16-row m-tiles w, w + 4, ..., two
//   at a time with their product chains interleaved, and adds 256 · hi +
//   lo into its own rows of the block's int32 sums in shared memory: no
//   atomics, exact for up to 65536 instances a block;
//   counts from popcounts of the one-hot, switches counted by each thread;
// - the objective: each instance's best score (0 for an invalid one) goes
//   to a scratch row of n values; the reduce sums it in markov_em.cu's
//   order (per 1024-instance chunk, slot j the instances j, j + 256, ... in
//   order, block_sum's shuffle tree and warp order), and one thread adds
//   the chunks in order;
// - the reduce: one warp an output over the persistent blocks' partials
//   (markov_common.cuh:warp_total, int64 for the statistics), one warp a
//   chunk of the objective, then one block for the chunks' sum.
// A ring of one slot (the next tile's copies after the statistics; four
// blocks an SM) measured 2% faster at n = 1e6 and 13% faster at odd n; the
// ring keeps two, so that a tile's copies are in flight during the tile
// before it (k1_plan takes one only where two do not fit).

#include <cuda_runtime.h>
#include <stdint.h>

#include "markov_common.cuh"
#include "markov_int16_tile.cuh"

namespace {

using namespace mtm::i16;
using mtm::is_nan;

constexpr int kNT = 128;                 // instances of a tile
constexpr int kIpt = 2;                  // instances a thread scores
constexpr int kSplit = kIpt;             // threads of an instance group, each scoring a share of the clusters
constexpr int kPartStride = 16;          // lanes between the threads of a group
constexpr int kMG = 2;                   // m-tiles whose products a warp interleaves
constexpr int kThreads = kNT / kIpt * kSplit;  // threads of a block
constexpr int kLoads = 16;               // plain loads in flight a thread (odd n)
constexpr int kWarps = kThreads / 32;
constexpr int kKS = kNT / 32;            // k = 32 steps of a tile's tensor-core product
constexpr int kObjSlots = 256;           // markov_em.cu's block: the objective's slots
constexpr int kMaxBlockInstances = 65536;  // int32 block sums stay exact
constexpr size_t kMaxSmem = 232448;      // a block's shared-memory limit

// Shared memory of a block, widest type first: the weights (Fcp, CB) WT
// under argmax, the ring of Φ tiles (ring, Fcp, kNT) int16, the statistics
// (Fcp, CB) int32, the block sum's scratch (32 int), the tile's assignments
// (kNT bytes).  ops/markov_kernels.py:k1_smem is the same sum.
size_t one_smem(int Fcp, int cb, size_t wsize, int ring, bool argmax) {
  return (argmax ? wsize * Fcp * cb : 0) + 2 * (size_t)ring * Fcp * kNT + 4 * (size_t)Fcp * cb + 4 * 32 + kNT;
}

template <typename WT, int CB, bool ARGMAX>
__global__ void __launch_bounds__(kThreads)
    em_one_kernel(const int16_t* __restrict__ phi, const int* __restrict__ prev, const WT* __restrict__ wc,
                  int* __restrict__ assign, WT* __restrict__ obj_inst, int* __restrict__ part_stats,
                  int* __restrict__ part_counts, int* __restrict__ part_sw, int64_t n, int Fcp, int C, int ring,
                  int copy) {
  constexpr int NNT = CB / 8;  // n = 8 tiles of the clusters
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tq = lane & 3;
  const int64_t ntiles = (n + kNT - 1) / kNT, G = gridDim.x;
  const int Ms = (Fcp + 15) >> 4;  // m = 16 tiles of Φ's rows
  const int tile_elems = Fcp * kNT;

  extern __shared__ __align__(16) unsigned char smem[];
  WT* s_w = reinterpret_cast<WT*>(smem);
  int16_t* s_tile = reinterpret_cast<int16_t*>(s_w + (ARGMAX ? (size_t)Fcp * CB : 0));
  int* s_acc = reinterpret_cast<int*>(s_tile + (size_t)ring * tile_elems);
  int* s_ired = s_acc + (size_t)Fcp * CB;
  unsigned char* s_na = reinterpret_cast<unsigned char*>(s_ired + 32);

  if constexpr (ARGMAX) {
    for (int e = tid; e < Fcp * CB; e += kThreads) {
      const int f = e / CB, c = e % CB;
      s_w[e] = c < C ? wc[(int64_t)c * Fcp + f] : WT(0);
    }
  }
  for (int e = tid; e < Fcp * CB; e += kThreads) s_acc[e] = 0;

  // tile `tile`'s rows into ring slot `slot`, zero past n; the caller
  // commits the group
  auto issue = [&](int64_t tile, int slot) {
    const int64_t i0 = tile * kNT;
    int16_t* dst = s_tile + slot * tile_elems;
    if (copy == 16) {
      for (int e = tid; e < Fcp * (kNT / 8); e += kThreads) {
        const int f = e / (kNT / 8), q = e % (kNT / 8);
        const int64_t i = i0 + q * 8;
        const bool in = i < n;  // n % 8 == 0: eight instances all in or all out
        cp_async16(dst + f * kNT + ((q ^ ((f & 3) << 1)) << 3), in ? phi + (int64_t)f * n + i : phi, in ? 16 : 0);
      }
    } else if (copy == 4) {
      for (int e = tid; e < Fcp * (kNT / 2); e += kThreads) {
        const int f = e / (kNT / 2), j = 2 * (e % (kNT / 2));
        const int64_t i = i0 + j;
        const bool in = i < n;  // n even: two instances all in or all out
        cp_async4(dst + f * kNT + tile_col(f, j), in ? phi + (int64_t)f * n + i : phi, in ? 4 : 0);
      }
    } else {  // thread j loads column j of kLoads rows at a time, then stores them
      const int j = tid % kNT;
      const int64_t i = i0 + j;
      for (int f0 = tid / kNT; f0 < Fcp; f0 += kLoads * (kThreads / kNT)) {
        int16_t v[kLoads];
#pragma unroll
        for (int u = 0; u < kLoads; ++u) {
          const int f = f0 + u * (kThreads / kNT);
          v[u] = f < Fcp && i < n ? phi[(int64_t)f * n + i] : int16_t(0);
        }
#pragma unroll
        for (int u = 0; u < kLoads; ++u) {
          const int f = f0 + u * (kThreads / kNT);
          if (f < Fcp) dst[f * kNT + tile_col(f, j)] = v[u];
        }
      }
    }
  };

  int sw = 0;  // this thread's switches
  // the kSplit neighbouring threads of group g take the kIpt instances from
  // g · kIpt of the tile at i0, thread `part` of them the clusters part ·
  // CH, ...: scores (K1's FMA chain), then the first maximum (NaN counted
  // as the maximum) of each share, and the shares' results combined in
  // cluster order by shuffles, which gives the first maximum over all;
  // part 0 writes the assignment, objective entry and switch, and the
  // cluster each instance adds to the statistics (0xFF for none) into s_na
  auto score_tile = [&](const int16_t* tile, int64_t i0) {
    constexpr int CH = CB / kSplit;  // clusters a thread scores
    const int part = tid / kPartStride % kSplit;
    const int j0 = (tid / (kPartStride * kSplit) * kPartStride + tid % kPartStride) * kIpt;
    int p[kIpt], na[kIpt];
    WT best[kIpt];
#pragma unroll
    for (int u = 0; u < kIpt; ++u) {
      const int64_t i = i0 + j0 + u;
      p[u] = part == 0 && i < n ? prev[i] : -1;
      na[u] = p[u];
    }
    if constexpr (ARGMAX) {
      const int c0 = part * CH;
      WT sc[kIpt][CH];
#pragma unroll
      for (int u = 0; u < kIpt; ++u)
#pragma unroll
        for (int c = 0; c < CH; ++c) sc[u][c] = WT(0);
      score_rows<WT, CH, kIpt, kNT, CB>(sc, s_w + c0, tile, Fcp, j0);
#pragma unroll
      for (int u = 0; u < kIpt; ++u) {
        best[u] = sc[u][0];
        na[u] = c0;
#pragma unroll
        for (int c = 1; c < CH; ++c) {
          if (c0 + c < C && (sc[u][c] > best[u] || (is_nan(sc[u][c]) && !is_nan(best[u])))) {
            best[u] = sc[u][c];
            na[u] = c0 + c;
          }
        }
        bool has = c0 < C;  // the share holds a cluster
#pragma unroll
        for (int s = 1; s < kSplit; s <<= 1) {
          const WT ob = __shfl_xor_sync(0xffffffffu, best[u], s * kPartStride);
          const int on = __shfl_xor_sync(0xffffffffu, na[u], s * kPartStride);
          const bool oh = __shfl_xor_sync(0xffffffffu, (int)has, s * kPartStride) != 0;
          const bool lower = !(part & s);  // this thread's share holds the lower clusters
          const WT lb = lower ? best[u] : ob, hb = lower ? ob : best[u];
          const int ln = lower ? na[u] : on, hn = lower ? on : na[u];
          const bool lh = lower ? has : oh, hh = lower ? oh : has;
          const bool hi = !lh || (hh && !is_nan(lb) && (is_nan(hb) || hb > lb));
          best[u] = hi ? hb : lb;
          na[u] = hi ? hn : ln;
          has = lh || hh;
        }
      }
    }
    if (part == 0) {
#pragma unroll
      for (int u = 0; u < kIpt; ++u) {
        const int64_t i = i0 + j0 + u;
        if constexpr (ARGMAX) {
          if (i < n) obj_inst[i] = p[u] >= 0 ? best[u] : WT(0);
          sw += p[u] >= 0 && na[u] != p[u];
        } else {
          na[u] = p[u];
        }
        if (i < n) assign[i] = p[u] >= 0 ? na[u] : C;
        s_na[j0 + u] = p[u] >= 0 && na[u] < C ? (unsigned char)na[u] : (unsigned char)0xFF;
      }
    }
  };

  // warp 0: lane (g, tq)'s share of cluster nt · 8 + g's count
  int cnt[NNT];
#pragma unroll
  for (int nt = 0; nt < NNT; ++nt) cnt[nt] = 0;
  // the tile's statistics on the tensor cores: the one-hot B fragments of
  // s_na, then each of the warp's m-tiles, its A fragments split from the
  // tile into byte planes, its sums added to the warp's own rows of s_acc
  auto stats_tile = [&](const int16_t* tile) {
    if (warp >= Ms) return;  // uniform over the warp
    unsigned b[kKS][NNT][2];
#pragma unroll
    for (int ks = 0; ks < kKS; ++ks) {
      const unsigned x0 = *reinterpret_cast<const unsigned*>(s_na + ks * 32 + tq * 4);
      const unsigned x1 = *reinterpret_cast<const unsigned*>(s_na + ks * 32 + 16 + tq * 4);
#pragma unroll
      for (int nt = 0; nt < NNT; ++nt) {
        b[ks][nt][0] = onehot4(x0, nt * 8 + g);
        b[ks][nt][1] = onehot4(x1, nt * 8 + g);
      }
    }
    if (warp == 0) {  // counts: one bit per one-hot byte
#pragma unroll
      for (int nt = 0; nt < NNT; ++nt)
#pragma unroll
        for (int ks = 0; ks < kKS; ++ks) cnt[nt] += __popc(b[ks][nt][0]) + __popc(b[ks][nt][1]);
    }
    for (int m0 = warp; m0 < Ms; m0 += kMG * kWarps) {  // kMG m-tiles at a time, their chains interleaved
      int hi[kMG][NNT][4], lo[kMG][NNT][4];
#pragma unroll
      for (int x = 0; x < kMG; ++x)
#pragma unroll
        for (int nt = 0; nt < NNT; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) hi[x][nt][e] = lo[x][nt][e] = 0;
#pragma unroll
      for (int ks = 0; ks < kKS; ++ks) {
        const int j0 = ks * 32 + tq * 4, j1 = j0 + 16;
#pragma unroll
        for (int x = 0; x < kMG; ++x) {
          const int f0 = (m0 + x * kWarps) * 16 + g, f1 = f0 + 8;
          unsigned ah[4] = {0u, 0u, 0u, 0u}, al[4] = {0u, 0u, 0u, 0u};
          if (f0 < Fcp) {
            split4(tile + f0 * kNT + tile_col(f0, j0), &ah[0], &al[0]);
            split4(tile + f0 * kNT + tile_col(f0, j1), &ah[2], &al[2]);
          }
          if (f1 < Fcp) {
            split4(tile + f1 * kNT + tile_col(f1, j0), &ah[1], &al[1]);
            split4(tile + f1 * kNT + tile_col(f1, j1), &ah[3], &al[3]);
          }
#pragma unroll
          for (int nt = 0; nt < NNT; ++nt) {
            mma_s8u8(hi[x][nt], ah, b[ks][nt]);
            mma_u8u8(lo[x][nt], al, b[ks][nt]);
          }
        }
      }
#pragma unroll
      for (int x = 0; x < kMG; ++x) {
        const int f0 = (m0 + x * kWarps) * 16 + g, f1 = f0 + 8;
#pragma unroll
        for (int nt = 0; nt < NNT; ++nt) {
          const int c = nt * 8 + tq * 2;
          if (f0 < Fcp) {
            s_acc[f0 * CB + c] += hi[x][nt][0] * 256 + lo[x][nt][0];
            s_acc[f0 * CB + c + 1] += hi[x][nt][1] * 256 + lo[x][nt][1];
          }
          if (f1 < Fcp) {
            s_acc[f1 * CB + c] += hi[x][nt][2] * 256 + lo[x][nt][2];
            s_acc[f1 * CB + c + 1] += hi[x][nt][3] * 256 + lo[x][nt][3];
          }
        }
      }
    }
  };

  issue(blockIdx.x, 0);  // the grid holds at most ntiles blocks
  cp_async_commit();
  int it = 0;
  for (int64_t tile = blockIdx.x; tile < ntiles; tile += G, ++it) {
    const int slot = ring > 1 ? (it & 1) : 0;
    cp_async_wait<0>();
    __syncthreads();  // the tile's rows are in `slot`; the last tile's statistics are done
    if (ring > 1) {   // the next tile into the other slot, in flight during this tile's scores and statistics
      if (tile + G < ntiles) issue(tile + G, slot ^ 1);
      cp_async_commit();
    }
    const int16_t* cur = s_tile + slot * tile_elems;
    score_tile(cur, tile * kNT);
    __syncthreads();  // s_na
    stats_tile(cur);
    if (ring == 1) {  // one slot: the next tile's copies once this tile's statistics are done
      __syncthreads();
      if (tile + G < ntiles) issue(tile + G, 0);
      cp_async_commit();
    }
  }
  cp_async_wait<0>();
  const int sw_blk = mtm::block_sum(sw, s_ired);  // its barriers: the last statistics are in s_acc

  const int64_t b = blockIdx.x, FC = (int64_t)Fcp * C;
  for (int e = tid; e < Fcp * C; e += kThreads) part_stats[b * FC + e] = s_acc[(e / C) * CB + e % C];
  if (warp == 0) {
#pragma unroll
    for (int nt = 0; nt < NNT; ++nt) {
      int v = cnt[nt];
      v += __shfl_xor_sync(0xffffffffu, v, 1);
      v += __shfl_xor_sync(0xffffffffu, v, 2);
      const int c = nt * 8 + g;
      if (tq == 0 && c < C) part_counts[b * C + c] = v;
    }
  }
  if (tid == 0) part_sw[b] = sw_blk;
}

// The per-block partials added one warp an output: the statistics (FC, in
// int64), counts (C), switches; then one warp a `sub` of the objective:
// slot j < 256 the entries sub_start + j + 256 k in k order, the slots
// through block_sum's shuffle tree and warp order, as markov_em.cu's
// 256-thread blocks sum them.
template <typename WT>
__global__ void em_one_reduce(const int* __restrict__ part_stats, const int* __restrict__ part_counts,
                              const int* __restrict__ part_sw, const WT* __restrict__ obj_inst,
                              long long* __restrict__ macc, int* __restrict__ counts, int* __restrict__ switches,
                              WT* __restrict__ part_obj, int64_t nblocks, int64_t FC, int C, int64_t n, int sub,
                              int64_t nsub) {
  const int64_t e = ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (e < FC) {
    const long long a = mtm::warp_total<int, long long>(part_stats + e, FC, nblocks);
    if (lane == 0) macc[e] = a;
  } else if (e < FC + C) {
    const int a = mtm::warp_total(part_counts + (e - FC), C, nblocks);
    if (lane == 0) counts[e - FC] = a;
  } else if (e == FC + C) {
    const int a = mtm::warp_total(part_sw, 1, nblocks);
    if (lane == 0) *switches = a;
  } else if (e < FC + C + 1 + nsub) {
    const int64_t s = e - FC - C - 1, i0 = s * sub, i1 = i0 + sub < n ? i0 + sub : n;
    WT tot = WT(0);
    for (int w = 0; w < kObjSlots / 32; ++w) {
      WT v = WT(0);
      for (int64_t i = i0 + 32 * w + lane; i < i1; i += kObjSlots) v += obj_inst[i];
      for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
      tot += v;
    }
    if (lane == 0) part_obj[s] = tot;
  }
}

// The objective: the subs' partials added in order by one thread (0 under
// assign_mode "prev", nsub = 0), staged 1024 at a time.
template <typename WT>
__global__ void em_one_objective(const WT* __restrict__ part_obj, WT* __restrict__ obj, int64_t nsub) {
  __shared__ WT buf[1024];
  WT a = WT(0);
  for (int64_t b0 = 0; b0 < nsub; b0 += 1024) {
    const int m = nsub - b0 < 1024 ? (int)(nsub - b0) : 1024;
    for (int k = threadIdx.x; k < m; k += blockDim.x) buf[k] = part_obj[b0 + k];
    __syncthreads();
    if (threadIdx.x == 0)
      for (int k = 0; k < m; ++k) a += buf[k];
    __syncthreads();
  }
  if (threadIdx.x == 0) *obj = a;
}

template <typename WT, int CB, bool ARGMAX>
mtm::SmemLimit& smem_limit() {
  static mtm::SmemLimit limit;
  return limit;
}

struct OneArgs {
  const int16_t* phi;
  const int* prev;
  const void* wc;
  int* assign;
  int* part_stats;
  int* part_counts;
  int* part_sw;
  void* scratch;  // n WT (each instance's objective entry), then nsub (the subs' partials)
  long long* macc;
  int* counts;
  int* switches;
  void* obj;
  int64_t n;
  int Fcp, C, sub, ring, copy, grid;
  cudaStream_t stream;
};

template <typename WT, int CB, bool ARGMAX>
int run_one(const OneArgs& a) {
  const size_t smem = one_smem(a.Fcp, CB, sizeof(WT), a.ring, ARGMAX);
  if (smem > kMaxSmem) return -1;
  auto kern = em_one_kernel<WT, CB, ARGMAX>;
  cudaError_t err = smem_limit<WT, CB, ARGMAX>().raise(kern, smem);
  if (err != cudaSuccess) return (int)err;
  WT* obj_inst = static_cast<WT*>(a.scratch);
  kern<<<(unsigned)a.grid, kThreads, smem, a.stream>>>(a.phi, a.prev, static_cast<const WT*>(a.wc), a.assign,
                                                       obj_inst, a.part_stats, a.part_counts, a.part_sw, a.n,
                                                       a.Fcp, a.C, a.ring, a.copy);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int64_t nsub = ARGMAX ? (a.n + a.sub - 1) / a.sub : 0;
  const int64_t FC = (int64_t)a.Fcp * a.C, warps = FC + a.C + 1 + nsub;
  em_one_reduce<WT><<<(unsigned)((warps + 7) / 8), 256, 0, a.stream>>>(
      a.part_stats, a.part_counts, a.part_sw, obj_inst, a.macc, a.counts, a.switches, obj_inst + a.n, a.grid, FC,
      a.C, a.n, a.sub, nsub);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  em_one_objective<WT><<<1, 256, 0, a.stream>>>(obj_inst + a.n, static_cast<WT*>(a.obj), nsub);
  return (int)cudaGetLastError();
}

// The occupancy of the launch: {smem bytes, threads, blocks an SM, SMs,
// registers a thread, local bytes a thread}.
template <typename WT, int CB, bool ARGMAX>
int config_one(int Fcp, int ring, int* out) {
  const size_t smem = one_smem(Fcp, CB, sizeof(WT), ring, ARGMAX);
  if (smem > kMaxSmem) return -1;
  auto kern = em_one_kernel<WT, CB, ARGMAX>;
  int dev = 0, sms = 0, blocks = 0;
  cudaFuncAttributes attr{};
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess) err = smem_limit<WT, CB, ARGMAX>().raise(kern, smem);
  if (err == cudaSuccess) err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kern, kThreads, smem);
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, kern);
  if (err != cudaSuccess) return (int)err;
  if (blocks == 0) return -1;
  out[0] = (int)smem, out[1] = kThreads, out[2] = blocks, out[3] = sms, out[4] = attr.numRegs;
  out[5] = (int)attr.localSizeBytes;
  return 0;
}

struct RunOp {
  const OneArgs& a;
  template <typename WT, int CB, bool ARGMAX>
  int go() const {
    return run_one<WT, CB, ARGMAX>(a);
  }
};

struct ConfigOp {
  int Fcp, ring;
  int* out;
  template <typename WT, int CB, bool ARGMAX>
  int go() const {
    return config_one<WT, CB, ARGMAX>(Fcp, ring, out);
  }
};

// The body of (weights' type, C rounded up to 8, 16 or 32, mode).
template <typename WT, class Op>
int dispatch_cb(int C, bool argmax, Op op) {
  if (C <= 8) return argmax ? op.template go<WT, 8, true>() : op.template go<WT, 8, false>();
  if (C <= 16) return argmax ? op.template go<WT, 16, true>() : op.template go<WT, 16, false>();
  return argmax ? op.template go<WT, 32, true>() : op.template go<WT, 32, false>();
}

template <class Op>
int dispatch_one(int w_kind, int C, bool argmax, Op op) {
  if (w_kind == 1) return dispatch_cb<float>(C, argmax, op);
  if (w_kind == 2) return dispatch_cb<double>(C, argmax, op);
  return -1;
}

}  // namespace

// K1 under int16 Φ on the host plan (ops/markov_kernels.py:k1_plan): a
// ring of `ring` tiles (1 or 2), copies of `copy` bytes (16, 4, or 2 for
// plain loads; lowered here where n or Φ's address does not allow them),
// a persistent grid of `grid` blocks, each taking at most 65536 instances
// (the partial buffers hold grid blocks: (grid, Fcp, C), (grid, C), (grid)
// int32).  w_kind: 1 float32, 2 float64 weights.  `scratch` holds n +
// ceil(n / sub) values of the weights' type; `sub` must be a multiple of
// 256 (1024 is markov_em.cu's chunk).  macc is int64.  Returns a
// cudaError_t (0 on success), or -1 for an argument or plan the kernel
// does not take.
extern "C" int mtm_markov_em_one(int device, int w_kind, const void* phi, const void* prev, const void* wc,
                                 void* assign, void* part_stats, void* part_counts, void* part_sw, void* scratch,
                                 void* macc, void* counts, void* switches, void* obj, long long n, int Fcp, int C,
                                 int sub, int argmax, int ring, int copy, int grid, void* stream) {
  if (n <= 0 || Fcp <= 0 || C < 1 || C > 32 || sub <= 0 || sub % kObjSlots != 0 || ring < 1 || ring > 2 ||
      (copy != 16 && copy != 4 && copy != 2) || grid < 1)
    return -1;
  const int64_t ntiles = (n + kNT - 1) / kNT;
  if (grid > ntiles || (ntiles + grid - 1) / grid * kNT > kMaxBlockInstances) return -1;
  const uintptr_t base = reinterpret_cast<uintptr_t>(phi);
  if (copy == 16 && (n % 8 != 0 || base % 16 != 0)) copy = 4;
  if (copy == 4 && (n % 2 != 0 || base % 4 != 0)) copy = 2;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const OneArgs a{static_cast<const int16_t*>(phi), static_cast<const int*>(prev), wc,
                  static_cast<int*>(assign), static_cast<int*>(part_stats), static_cast<int*>(part_counts),
                  static_cast<int*>(part_sw), scratch, static_cast<long long*>(macc), static_cast<int*>(counts),
                  static_cast<int*>(switches), obj, (int64_t)n, Fcp, C, sub, ring, copy, grid,
                  static_cast<cudaStream_t>(stream)};
  return dispatch_one(w_kind, C, argmax != 0, RunOp{a});
}

// The launch of a plan on the current device: out = {smem bytes, threads,
// blocks an SM, SMs, registers a thread, local bytes a thread}.  Returns a
// cudaError_t (0 on success), or -1 for a plan the kernel does not take.
extern "C" int mtm_markov_em_one_config(int w_kind, int Fcp, int C, int argmax, int ring, void* out) {
  if (Fcp <= 0 || C < 1 || C > 32 || ring < 1 || ring > 2) return -1;
  return dispatch_one(w_kind, C, argmax != 0, ConfigOp{Fcp, ring, static_cast<int*>(out)});
}
