// K4b in float32: hard-assignment EM iterations for R restarts that
// rebuild Φ from the packed batch u on every call, Φ built once per tile
// for a cluster of restart groups.
//
// Replaces the TPU kernel ops/pallas_markov.py:markov_em_fused_packed_multi
// (body _markov_em_packed_multi_kernel) of the JAX package for float32 u
// and weights; markov_em_packed.cu sends those calls here and keeps K4a
// and float64 K4b on markov_em_multi.cuh.  The function is the one that
// header states: for restart r and instance i (one column of Φ),
//   scores_c = Σ_f wc[r, c, f] · Φ[f, i]   (C of them, K1's FMA chain)
//   na       = strict `>` argmax over c (a NaN never wins); a force slot,
//              and every slot under assign_mode "prev", takes na = prev
//   assign   = prev >= 0 ? na : C
// and over the valid instances counts, switches, the objective Σ best and
// the statistics macc[r, f, c] = Σ_{na == c} Φ[f, i].
//
// What it replaces: the header's body gave a block two restarts (its
// statistics and a whole Φ tile do not fit shared memory for more), so
// R = 32 made 16 restart groups, and each rebuilt every instance's Φ
// column from u in device memory (up to 2·T strided loads a row); its
// float statistics were added one instance after another by one thread
// per Φ row (markov_common.cuh:ordered_add), a dependent shared-memory
// read-add-write per step.
//
// What bounds it on the card: the score FMAs, R · C · Fcp per instance on
// the CUDA cores (float32, never TF32, so that every slot's scores are
// K4a's bit for bit): 5.7e10 at R = 32, C = 16, Fcp = 112, n = 1e6, 1.7 ms
// at 67 TFLOP/s, against 0.1 ms for the 320 MB of u.
//
// Design:
// - a block is one restart group of RG restarts (up to 8) times one chunk
//   of instances; a chunk's restart groups are consecutive blocks, CS of
//   them a thread-block cluster (CS divides the groups, up to 8);
// - the chunk goes through tiles of NT instances (128, or 64 and 32 where
//   T·s rows of u do not fit): the tile's u (T·s rows × NT) and lengths
//   are staged in shared memory by 16-byte cp.async copies (plain loads
//   where n % 4 != 0 leaves the rows unaligned), zero past n; rank q of
//   the cluster then builds the Φ rows f ≡ q (mod CS) of the tile from it
//   with K2's row build (acc_row_tile: markov_common.cuh:acc_row's terms
//   in its order) and stores each entry into every block's Φ tile over
//   distributed shared memory, so a chunk's tile is built once for all R
//   restarts, and every Φ entry equals K2's and K4a's bit for bit.  Once
//   Φ is built the next tile's copies start, and run during this tile's
//   scores and statistics;
// - scores: an item is IPT instances (j, j + NT/IPT; 2 with C ≤ 16, else
//   1) of one restart, so each 16-byte broadcast of the restart's weights
//   (shared memory, (RG, Fcp, CB)) serves 4 · IPT FMAs; each instance's
//   chain over f is K1's, in K1's order;
// - the objective in K4a's order: K4a's 128-thread blocks sum each
//   thread's instances (j, j + 128, ...) per `sub` = 1024 and then
//   block_sum; here instance j of a sub adds to slot j % 128 of its
//   restart's sums in shared memory, and at the sub's end each restart's
//   128 sums take block_sum's shuffle tree and warp order, so slot r's
//   objective equals a K4a call on slot r bit for bit;
// - statistics: warp w sorts restart w's tile by cluster, stably (a
//   counting sort on warp ballots), which also gives the counts; then a
//   warp takes a restart and 64 Φ rows, a lane per row and two rows a
//   lane, adds each cluster's instances in instance order into a float32
//   sum in registers, and adds those into the block's running sums once
//   every cluster is done.  No atomics, a fixed order (the same bits from
//   run to run), and Inf and NaN summed as the plain version sums them;
//   this replaces ordered_add's dependent read-add-write per instance.
//
// What holds it above the bound: a dependent shared-memory load costs
// about 100 cycles inside this kernel, and the Φ build (acc_row_tile's
// short loops) and the statistics (the sort and the segments) are chains
// of them, so 16 warps a SM leave the instruction slots mostly idle in those
// phases; only the scores run near the FMA rate
// (tools/k4b_phase_split.py --clocks splits a tile's cycles).
// - switches: integer sums in shared memory, exact in any order;
// - per-block partials, then em_multi_reduce (markov_em_multi.cuh) adds
//   them in block order.
//
// The Φ tile's rows have an odd pitch (NT + 1), so a warp reading one
// instance's column across 32 rows, or 32 instances of one row, hits 32
// banks.  Shared memory at R = 32, C = 16, Fcp = 112, T·s = 80, NT = 128,
// RG = 8: weights 57 KB, statistics 60 KB, the Φ tile 56 KB, the u tile
// 40 KB, 227 KB in all; a block of 512 threads (16 warps, 128 registers a
// thread) an SM.  The host plan (ops/markov_kernels.py:packed_mma_plan)
// picks RG, then NT, then CS from (Fcp, T·s, C, R): the most restarts a
// block, then the widest tile that fits.  At RG = 1 and NT = 32 a block
// holds Φ tiles of about 400 rows (C = 32) to 800 (C ≤ 8) beside 512 rows
// of u, more than the header's float32 body took (about 300 to 420 rows),
// so the body takes every shape that one took.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "markov_em_multi.cuh"
#include "markov_packed_tile.cuh"

namespace {

namespace cg = cooperative_groups;

constexpr int kPT = 512;          // threads of a block (one a SM: 16 warps hide latency)
constexpr int kPW = kPT / 32;     // warps of a block
constexpr int kMaxPRG = 8;        // restarts of a group
constexpr int kObjThreads = 128;  // K4a's block: the objective's order
constexpr int kMaxCS = 8;         // blocks of a cluster
constexpr int kRowsLane = 2;      // Φ rows a lane sums at once (32 apart)
using mtm::kSeg;

// instances an item scores: 2 with C ≤ 16, else 1, so that the scores fit
// the 128 registers a thread of a 512-thread block has
__host__ __device__ constexpr int packed_ipt(int cb) { return cb <= 16 ? 2 : 1; }

// Shared memory of a block, in floats then ints: w (RG, Fcp, CB) under
// argmax, the statistics (RG, Fcp, CB + 1: an odd row stride, so a warp
// adding into one cluster across 32 rows hits 32 banks), the Φ tile (Fcp,
// NT + 1), the u tile (T·s, NT), the objective's sums (RG, 128); the row
// table (Fcp), lengths (NT), na (RG, NT), the sorted tile (RG, NT; at a
// sub's end the objective's warp sums), each restart's cluster counts and
// offsets (RG, 2, 33), switches (RG).  ops/markov_kernels.py:
// packed_mma_smem is the same sum.
size_t packed_smem(int Fcp, int Ts, int cb, int rg, int nt, bool argmax) {
  return 4 * ((size_t)rg * Fcp * ((argmax ? cb : 0) + cb + 1) + (size_t)Fcp * (nt + 1) +
              (size_t)Ts * nt + (size_t)rg * kObjThreads + Fcp + nt + 2 * (size_t)rg * nt +
              2 * (size_t)rg * kSeg + rg);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src, int bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// K1's FMA chain over the Fcp rows of the Φ tile for the IPT instances
// j0, j0 + step, ... (weights `w`, row f at w + f · CB).
template <int CB, int IPT>
__device__ __forceinline__ void score_rows(float (&sc)[IPT][CB], const float* w, const float* phi,
                                           int pitch, int Fcp, int j0, int step) {
  for (int f = 0; f < Fcp; ++f) {
    float v[IPT];
#pragma unroll
    for (int u = 0; u < IPT; ++u) v[u] = phi[f * pitch + j0 + u * step];
    const float4* wf = reinterpret_cast<const float4*>(w + (size_t)f * CB);
#pragma unroll
    for (int q = 0; q < CB / 4; ++q) {
      const float4 wv = wf[q];
      const float we[4] = {wv.x, wv.y, wv.z, wv.w};
#pragma unroll
      for (int e = 0; e < 4; ++e)
#pragma unroll
        for (int u = 0; u < IPT; ++u) sc[u][q * 4 + e] = mtm::fused_ma(we[e], v[u], sc[u][q * 4 + e]);
    }
  }
}

template <int CB, bool ARGMAX>
__global__ void __launch_bounds__(kPT, 1)
    packed_mma_kernel(const float* __restrict__ u, const int* __restrict__ lens,
                      const int* __restrict__ desc, int steps, int s, int Fc,
                      const int* __restrict__ prev, const int* __restrict__ force,
                      const float* __restrict__ wc, int* __restrict__ assign,
                      float* __restrict__ part_stats, int* __restrict__ part_counts,
                      int* __restrict__ part_sw, float* __restrict__ part_obj, int64_t n,
                      int Fcp, int C, int R, int RG, int NT, int CS, int chunk, int sub,
                      int aligned) {
  constexpr int IPT = packed_ipt(CB);
  constexpr int KMAX = kMaxPRG * kObjThreads / IPT / kPT;  // items of a thread
  const int Ts = steps * s;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int ngroups = (R + RG - 1) / RG;
  const int64_t cidx = blockIdx.x / ngroups;  // the chunk
  const int r0 = (int)(blockIdx.x % ngroups) * RG;
  const int rg = RG < R - r0 ? RG : R - r0;
  const int pitch = NT + 1;  // odd: a warp reading a row or a column of Φ hits 32 banks
  const int NQ = NT / IPT;   // items of a restart in a tile
  const int lq = __ffs(NQ) - 1;  // NT and so NQ are powers of two
  const int64_t FC = (int64_t)Fcp * C;
  constexpr int SB = CB + 1;  // the statistics' row stride

  extern __shared__ __align__(16) unsigned char smem[];
  float* s_w = reinterpret_cast<float*>(smem);
  float* s_st = s_w + (ARGMAX ? (size_t)RG * Fcp * CB : 0);
  float* s_phi = s_st + (size_t)RG * Fcp * SB;
  float* s_u = s_phi + (size_t)Fcp * pitch;
  float* s_vobj = s_u + (size_t)Ts * NT;
  int* s_desc = reinterpret_cast<int*>(s_vobj + (size_t)RG * kObjThreads);  // kind | k << 4 | r << 14
  int* s_len = s_desc + Fcp;
  int* s_na = s_len + NT;
  int* s_perm = s_na + (size_t)RG * NT;  // restart rr's tile sorted by cluster: c << 8 | j
  float* s_red = reinterpret_cast<float*>(s_perm);  // the objective's warp sums, at a sub's end
  int* s_seg = s_perm + (size_t)RG * NT;  // restart rr's counts [0, 33), offsets [33, 66)
  int* s_sw = s_seg + 2 * RG * kSeg;
  float* part = part_stats + (cidx * R + r0) * FC;  // the block's partial
  int counts = 0;  // warp w < rg, lane c < C: restart w's count of cluster c

  // CS > 1: the blocks of a cluster are CS restart groups of one chunk;
  // rank q builds the Φ rows f ≡ q (mod CS) of each tile into every
  // block's tile
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = CS > 1 ? (int)cluster.block_rank() : 0;
  float* phi_at[kMaxCS];
#pragma unroll
  for (int q = 0; q < kMaxCS; ++q)
    phi_at[q] = q < CS && CS > 1 ? cluster.map_shared_rank(s_phi, q) : s_phi;
  auto cluster_sync = [&]() {
    if (CS > 1)
      cluster.sync();
    else
      __syncthreads();
  };

  if constexpr (ARGMAX) {
    for (int e = tid; e < rg * Fcp * CB; e += kPT) {
      const int rr = e / (Fcp * CB), rem = e % (Fcp * CB);
      const int f = rem / CB, c = rem % CB;
      s_w[e] = c < C ? wc[((int64_t)(r0 + rr) * C + c) * Fcp + f] : 0.f;
    }
  }
  for (int e = tid; e < rg * Fcp * SB; e += kPT) s_st[e] = 0.f;
  for (int f = tid; f < Fc; f += kPT)
    s_desc[f] = desc[3 * f] | desc[3 * f + 1] << 4 | desc[3 * f + 2] << 14;
  for (int e = tid; e < rg; e += kPT) s_sw[e] = 0;
  for (int e = tid; e < rg * kObjThreads; e += kPT) s_vobj[e] = 0.f;
  unsigned forced = 0;  // bit rr: slot r0 + rr takes prev
  if (ARGMAX)
    for (int rr = 0; rr < rg; ++rr) forced |= (force[r0 + rr] != 0) << rr;

  const int64_t start = cidx * chunk;
  const int64_t end = start + chunk < n ? start + chunk : n;
  const int ntiles = (int)((end - start + NT - 1) / NT);
  const int tiles_per_sub = sub / NT;

  // tile t's u (Ts rows x NT) and lengths into s_u and s_len: cp.async
  // (aligned rows) or plain loads, zero past the chunk
  auto load_u = [&](int t) {
    const int64_t i0 = start + (int64_t)t * NT;
    const int q4 = NT / 4, l4 = __ffs(q4) - 1, lt = l4 + 2;
    if (aligned) {
      for (int e = tid; e < (Ts + 1) * q4; e += kPT) {
        const int a = e >> l4, q = e & (q4 - 1);
        const int64_t i = i0 + 4 * q;
        const bool in = i < end;  // n % 4 == 0: four instances all in or all out
        if (a < Ts)
          cp_async16(s_u + a * NT + 4 * q, in ? u + (int64_t)a * n + i : u, in ? 16 : 0);
        else
          cp_async16(s_len + 4 * q, in ? lens + i : lens, in ? 16 : 0);
      }
      cp_async_commit();
    } else {
      for (int e = tid; e < (Ts + 1) * NT; e += kPT) {
        const int a = e >> lt, j = e & (NT - 1);
        const int64_t i = i0 + j;
        if (a < Ts)
          s_u[a * NT + j] = i < end ? u[(int64_t)a * n + i] : 0.f;
        else
          s_len[j] = i < end ? lens[i] : 0;
      }
    }
  };

  // The block's rows of the Φ tile of the NT instances from i0, stored
  // into every block's s_phi: K2's ACC rows from the u tile, zero past Fc
  // and past the chunk.  The tile is whole after the cluster's barrier.
  auto build = [&](int64_t i0) {
    const int j = tid % NT;
    const bool live = i0 + j < end;
    const int len = s_len[j];
    for (int f = rank + CS * (tid / NT); f < Fcp; f += CS * (kPT / NT)) {
      float v = 0.f;
      if (live && f < Fc) {
        const int d = s_desc[f];
        v = mtm::acc_row_tile(d & 0xF, d >> 4 & 0x3FF, d >> 14, s_u + j, NT, len, steps, s);
      }
      const int off = f * pitch + j;
#pragma unroll
      for (int q = 0; q < kMaxCS; ++q)
        if (q < CS) phi_at[q][off] = v;
    }
    cluster_sync();
  };

  // Scores, assignments, objective sums and switches of tile t's items;
  // s_na after.
  auto assign_items = [&](int t, int64_t i0) {
#pragma unroll
    for (int k = 0; k < KMAX; ++k) {
      const int e = tid + k * kPT, rr = e >> lq, j0 = e & (NQ - 1);
      if (rr >= rg) continue;
      int p[IPT], na[IPT];
      int nsw = 0;
#pragma unroll
      for (int v = 0; v < IPT; ++v) {
        const int64_t i = i0 + j0 + v * NQ;
        p[v] = i < end ? prev[(int64_t)(r0 + rr) * n + i] : -1;
        na[v] = p[v];
      }
      if (ARGMAX && !((forced >> rr) & 1) && i0 + j0 < end) {
        float sc[IPT][CB];
#pragma unroll
        for (int v = 0; v < IPT; ++v)
#pragma unroll
          for (int c = 0; c < CB; ++c) sc[v][c] = 0.f;
        score_rows<CB, IPT>(sc, s_w + (size_t)rr * Fcp * CB, s_phi, pitch, Fcp, j0, NQ);
#pragma unroll
        for (int v = 0; v < IPT; ++v) {
          float best = sc[v][0];
          na[v] = 0;
#pragma unroll
          for (int c = 1; c < CB; ++c) {
            if (c < C && sc[v][c] > best) {
              best = sc[v][c];
              na[v] = c;
            }
          }
          if (p[v] >= 0) {  // valid (and so before end)
            s_vobj[rr * kObjThreads + ((t * NT + j0 + v * NQ) & (kObjThreads - 1))] += best;
            nsw += na[v] != p[v];
          }
        }
      }
      if (nsw > 0) atomicAdd(&s_sw[rr], nsw);
#pragma unroll
      for (int v = 0; v < IPT; ++v) {
        const int64_t i = i0 + j0 + v * NQ;
        if (i < end) assign[(int64_t)(r0 + rr) * n + i] = p[v] >= 0 ? na[v] : C;
        s_na[rr * NT + j0 + v * NQ] = p[v] >= 0 && na[v] < C ? na[v] : -1;
      }
    }
  };

  // Warp w < rg: restart w's tile sorted by cluster, stably, into s_perm
  // (instance j of cluster c as c << 8 | j, clusters in order), each
  // cluster's count and first position into s_seg; the counts also add to
  // `counts`.  A counting sort on warp ballots: instance j = 32 q + lane's
  // position is the count of its cluster in the chunks before q plus the
  // lanes below it with its cluster.
  auto sort_tile = [&]() {
    if (warp >= rg) return;
    counts += mtm::sort_tile<CB>(s_na + warp * NT, s_perm + warp * NT, s_seg + warp * 2 * kSeg, NT);
  };

  // The tile's statistics: a warp takes restart rr and rows f = lane +
  // 32 (p0 + b), b < kRowsLane, and adds each cluster's instances, in
  // instance order, into run[c], which goes into the running sums
  // (restart rr's row f at s_st[(rr · Fcp + f) · SB]) once every cluster
  // is summed; the clusters' counts and first positions come from lane c
  // by shuffles, so no shared-memory load waits between two clusters.
  auto seg_sums = [&]() {
    const int nb = (Fcp + 32 * kRowsLane - 1) / (32 * kRowsLane);
    for (int e = warp; e < rg * nb; e += kPW) {
      const int rr = e / nb, p0 = (e % nb) * kRowsLane;
      mtm::seg_sum_rows<CB, kRowsLane>(s_st + (size_t)rr * Fcp * SB, SB, s_phi, pitch, Fcp, s_perm + rr * NT,
                                       s_seg + rr * 2 * kSeg, p0 * 32, 0, C);
    }
  };

  load_u(0);
  for (int t = 0; t < ntiles; ++t) {
    const int64_t i0 = start + (int64_t)t * NT;
    cp_async_wait_all();
    cluster_sync();  // u tile t is in s_u; the cluster is done with tile t - 1's s_phi
    build(i0);       // s_phi; s_u is free
    if (t + 1 < ntiles) load_u(t + 1);  // overlaps this tile's scores and statistics
    assign_items(t, i0);
    __syncthreads();  // s_na
    sort_tile();
    __syncthreads();  // s_perm, s_seg
    seg_sums();

    // the objective partial of each `sub` instances in K4a's order: each
    // restart's 128 sums through block_sum's shuffle tree and warp order,
    // kPW / 4 restarts at a time (warps 4 q .. 4 q + 3 the q-th)
    if ((t + 1) % tiles_per_sub == 0 || t + 1 == ntiles) {
      const int64_t ob = start / sub + t / tiles_per_sub;
      __syncthreads();  // every item's sums are in s_vobj
      for (int rb = 0; rb < rg; rb += kPW / 4) {
        const int rr = rb + (warp >> 2);
        float v = rr < rg ? s_vobj[rr * kObjThreads + (tid & (kObjThreads - 1))] : 0.f;
        for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
        if (lane == 0) s_red[warp] = v;
        __syncthreads();
        if ((tid & (kObjThreads - 1)) == 0 && rr < rg) {
          float tot = 0.f;
          for (int w = 0; w < kObjThreads / 32; ++w) tot += s_red[(warp & ~3) + w];
          part_obj[ob * R + r0 + rr] = tot;
        }
        __syncthreads();
      }
      for (int e = tid; e < rg * kObjThreads; e += kPT) s_vobj[e] = 0.f;
    }
  }
  cluster_sync();  // no block of the cluster writes into this one any more

  for (int e = tid; e < rg * Fcp * C; e += kPT) {
    const int rr = e / (Fcp * C), rem = e % (Fcp * C);
    part[e] = s_st[((size_t)rr * Fcp + rem / C) * SB + rem % C];
  }
  if (warp < rg && lane < C) part_counts[(cidx * R + r0 + warp) * C + lane] = counts;
  if (tid < rg) part_sw[cidx * R + r0 + tid] = s_sw[tid];
}

template <int CB, bool ARGMAX>
int run_packed_mma(const MultiArgs& a, int nt, int rg, int cs) {
  const size_t smem = packed_smem(a.Fcp, a.steps * a.s, CB, rg, nt, ARGMAX);
  if (smem > kMaxSmem) return -1;
  const int64_t nchunks = (a.n + a.chunk - 1) / a.chunk;
  const int ngroups = (a.R + rg - 1) / rg;
  if (ngroups % cs != 0) return -1;
  const int aligned = a.n % 4 == 0 && reinterpret_cast<uintptr_t>(a.u) % 16 == 0 &&
                      reinterpret_cast<uintptr_t>(a.lens) % 16 == 0;
  auto kern = packed_mma_kernel<CB, ARGMAX>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(nchunks * ngroups));
  cfg.blockDim = dim3(kPT);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = a.stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)cs;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kern, static_cast<const float*>(a.u), a.lens, a.desc, a.steps,
                           a.s, a.Fc, a.prev, a.force, static_cast<const float*>(a.wc), a.assign,
                           static_cast<float*>(a.part_stats), a.part_counts, a.part_sw,
                           static_cast<float*>(a.part_obj), a.n, a.Fcp, a.C, a.R, rg, nt, cs,
                           a.chunk, a.sub, aligned);
  if (err != cudaSuccess) return (int)err;
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int64_t FC = (int64_t)a.Fcp * a.C;
  const int64_t total = a.R * FC + (int64_t)a.R * a.C + 2 * a.R;
  em_multi_reduce<float, float, float><<<(unsigned)((total + 255) / 256), 256, 0, a.stream>>>(
      static_cast<const float*>(a.part_stats), a.part_counts, a.part_sw,
      static_cast<const float*>(a.part_obj), static_cast<float*>(a.macc), a.counts, a.switches,
      static_cast<float*>(a.obj), nchunks, (a.n + a.sub - 1) / a.sub, a.R, FC, a.C);
  return (int)cudaGetLastError();
}

template <bool ARGMAX>
int dispatch_packed_mma(const MultiArgs& a, int nt, int rg, int cs) {
  if (a.C <= 8) return run_packed_mma<8, ARGMAX>(a, nt, rg, cs);
  if (a.C <= 16) return run_packed_mma<16, ARGMAX>(a, nt, rg, cs);
  return run_packed_mma<32, ARGMAX>(a, nt, rg, cs);
}

}  // namespace

// K4b with float32 u and weights, called by mtm_markov_em_packed
// (markov_em_packed.cu) after its argument checks and cudaSetDevice, with
// its arguments but device, w_kind and strict, and the host plan
// (ops/markov_kernels.py:packed_mma_plan): tile width nt (128, 64 or 32),
// restarts a block rg (at most 8) and blocks a cluster cs (at most 8,
// dividing the restart groups).  `sub` must be a multiple of 128.
// Returns a cudaError_t (0 on success), or -1 for an argument or plan the
// kernel does not take.
extern "C" int mtm_markov_em_packed_f32(
    const void* u, const void* lens, const void* desc, const void* prev, const void* force,
    const void* wc, void* assign, void* part_stats, void* part_counts, void* part_sw,
    void* part_obj, void* macc, void* counts, void* switches, void* obj, long long n, int steps,
    int s, int Fc, int Fcp, int C, int R, int chunk, int sub, int argmax, int nt, int rg, int cs,
    void* stream) {
  if ((nt != 32 && nt != 64 && nt != 128) || rg < 1 || rg > kMaxPRG || cs < 1 || cs > kMaxCS ||
      sub % kObjThreads != 0 || Fcp % 4 != 0 || steps * s > 512)
    return -1;
  MultiArgs a{nullptr,
              u,
              static_cast<const int*>(lens),
              static_cast<const int*>(desc),
              steps,
              s,
              Fc,
              static_cast<const int*>(prev),
              static_cast<const int*>(force),
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
              R,
              chunk,
              sub,
              static_cast<cudaStream_t>(stream)};
  return argmax ? dispatch_packed_mma<true>(a, nt, rg, cs)
                : dispatch_packed_mma<false>(a, nt, rg, cs);
}

// The shared memory packed_smem gives a plan, for the host plan's tests.
extern "C" int mtm_markov_em_packed_mma_smem(int Fcp, int Ts, int C, int rg, int nt, int argmax) {
  const int cb = C <= 8 ? 8 : C <= 16 ? 16 : 32;
  return (int)packed_smem(Fcp, Ts, cb, rg, nt, argmax != 0);
}
