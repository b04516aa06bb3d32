// K3 under int16 Φ: hard-assignment EM iterations for R restarts over one
// batch, the statistics on the integer tensor cores.
//
// Replaces the TPU kernel ops/pallas_markov.py:markov_em_from_features_multi
// (body _markov_em_feat_multi_kernel) of the JAX package for int16 Φ with
// float32 or float64 weights; markov_em_multi.cu sends those calls here and
// keeps wide Φ (and K4a/K4b) on markov_em_multi.cuh.  The function is the
// one that header states: for restart r and instance i,
//   scores_c = Σ_f wc[r, c, f] · Φ[f, i]   (C of them, K1's FMA chain)
//   na       = strict `>` argmax over c (a NaN never wins); a force slot,
//              and every slot under assign_mode "prev", takes na = prev
//   assign   = prev >= 0 ? na : C
// and over the valid instances counts, switches, the objective Σ best and
// the statistics macc[r, f, c] = Σ_{na == c} Φ[f, i].
//
// What it replaces: the header's int16 body added every instance's Φ
// column into the (Fcp, C) statistics with shared-memory atomics, about
// R · Fcp of them per instance (3.6e9 a call at R = 32, n = 1e6), which
// serialize when a warp's instances share a cluster (as the slot pool's
// do once EM converges), and it reread Φ from device memory once per
// restart group and from L1/L2 once per restart.
//
// What bounds it on the card: the score FMAs, R · C · Fcp per instance on
// the CUDA cores (float32 or float64, never TF32, so that every slot's
// scores are K1's bit for bit): at R = 32, C = 16, Fcp = 112, n = 1e6 they
// take 1.7 ms at 67 TFLOP/s, against 0.07 ms for the 224 MB Φ stream.
// The statistics are (Fcp × n)·(n × C) products against a 0/1 operand,
// about 0.2% of the FMAs' operations, so mma.sync is enough (no wgmma).
//
// Design:
// - a block is one restart group of RG restarts (up to 8) times one chunk
//   of instances; the group is the grid's fastest index, so the groups of
//   a chunk run side by side and read its Φ columns from L2: Φ comes from
//   device memory about once a call;
// - the chunk goes through kT = 256-instance tiles of Φ (Fcp int16 rows) in
//   shared memory, brought in by 16-byte cp.async copies (plain loads where
//   n % 8 != 0 leaves the rows unaligned), zero past n; the next tile's
//   copies run during this tile's tensor-core products.  The tile's
//   16-byte chunks are XOR-swizzled by row, so the score reads and the
//   plane build below hit distinct banks;
// - scores: an item is IPT neighbouring instances (4 under float32 with
//   C ≤ 16) of one restart, so each 16-byte broadcast of the restart's
//   folded weights (shared memory, (RG, Fcp, CB)) serves IPT FMAs; each
//   instance's chain over f is K1's, in K1's order, on the int16 value
//   converted exactly (2^23 + 2^15 magic, two full-rate operations);
// - the objective: K1 sums each thread's instances (j, j + 256, ...) per
//   `sub` = 1024 and then the block in block_sum's order; the item of
//   instance j keeps K1's thread j's running sum in a register, and at a
//   sub's end the 256 sums of a restart go through shared memory to
//   block_sum, so slot r equals a K1 call on slot r bit for bit;
// - statistics: per tile and restart, macc += Φ_tile · onehot(na) on the
//   tensor cores with mma.sync m16n8k32.  Each int16 entry splits exactly
//   as Φ = 256 · hi + lo, hi = Φ >> 8 (s8) and lo = Φ & 0xFF (u8), built
//   once per tile into two byte planes in A-fragment order (two byte
//   permutes per four entries); one s8 × u8 and one u8 × u8 product run
//   against the u8 one-hot, built from the restart's assignments (one byte
//   per instance, 0xFF for none).  Warp w owns restart w % rg and its
//   m-tiles w / rg, w / rg + ⌈8 / rg⌉, ..., interleaving MG of them so
//   2 · NNT · MG accumulator chains are in flight, and adds 256 · hi + lo
//   into its own int32 region of shared memory after each tile: no
//   atomics, exact in int32 up to a chunk of 65536 instances;
// - counts come from the same one-hot fragments (a popcount per register),
//   switches from warp ballots into warp-owned slots; no atomics anywhere;
// - per-block partials, then em_multi_reduce (markov_em_multi.cuh) adds
//   them in block order, so two calls give the same bits.
//
// Shared memory at R = 32, C = 16, Fcp = 112, float32 weights, RG = 8:
// weights 57 KB, tile 57 KB, planes 57 KB, statistics 57 KB, of 227 KB;
// float64 weights, C > 16 or the canonical Φ's 144 rows take RG = 4 where
// RG = 8 does not fit (pick_mma).  Where even RG = 1 does not fit (from
// about 160-200 rows on), the block stages Φ in row strips of FS rows
// (a multiple of 8): each tile goes through the strips twice, once for
// the scores (each thread's chain over f running on in registers from
// strip to strip, RG ≤ IPT so a thread holds one item) and once, in
// reverse order so the last strip is reused, for the statistics, which
// each warp then adds straight into its block's int32 partial in device
// memory (the same exclusive ownership, still no atomics).  Only the
// weights then grow with Fcp, so the body takes every Fcp the header's
// int16 body took (at RG = 1: weights and int32 statistics in shared
// memory); an Fcp whose weights do not fit returns -1.

#include <cuda_runtime.h>
#include <stdint.h>

#include "markov_em_multi.cuh"
#include "markov_int16_tile.cuh"

namespace {

using namespace mtm::i16;

constexpr int kT = 256;           // threads of a block = instances of a tile
constexpr int kWarpsT = kT / 32;  // warps of a block
constexpr int kMaxRG = 8;         // restarts of a group
constexpr int kKSteps = kT / 32;  // k = 32 steps of the tensor-core product

// Shared memory of a block, widest type first: w (RG, Fcp, CB) WT,
// red (warps) WT, the Φ tile (FS, kT) int16, its hi and lo planes
// (2, ⌈FS / 16⌉ · 16 rows, kT) bytes, acc (RG, Fcp, CB) int32 (not in a
// strip block: its statistics go to device memory), counts (RG, CB) int,
// sw (warps, RG) int, then the assignments na (RG, kT) bytes, which the
// objective's kT WT sums share at a sub's end.
size_t mma_smem(int rg, int fs, int Fcp, int cb, size_t wsize, bool strip) {
  const size_t na = (size_t)rg * kT, vo = kT * wsize;
  const size_t rows16 = (size_t)(fs + 15) / 16 * 16;
  return wsize * ((size_t)rg * Fcp * cb + kWarpsT) + 2 * (size_t)fs * kT +
         2 * rows16 * kT + (strip ? 0 : 4 * (size_t)rg * Fcp * cb) +
         4 * ((size_t)rg * cb + (size_t)kWarpsT * rg) + (na > vo ? na : vo);
}

// A block's shape: RG restarts, FS Φ rows staged at a time (Fcp unless
// `strip`).
struct MmaPlan {
  int rg, fs;
  bool strip;
};

// The largest restart group (8, 4, 2, 1) whose block holds the whole tile;
// else a strip block: the largest group up to `ipt` (one item a thread)
// and then the most rows, in steps of 8, that fit; rg = 0 if nothing fits.
MmaPlan pick_mma(int Fcp, int cb, size_t wsize, int ipt) {
  for (int g = kMaxRG; g >= 1; g >>= 1)
    if (mma_smem(g, Fcp, Fcp, cb, wsize, false) <= kMaxSmem) return {g, Fcp, false};
  const int rows8 = (Fcp + 7) / 8 * 8;
  for (int g = ipt; g >= 1; g >>= 1) {
    if (mma_smem(g, 8, Fcp, cb, wsize, true) > kMaxSmem) continue;
    int fs = 8;
    while (fs < rows8 && mma_smem(g, fs + 8, Fcp, cb, wsize, true) <= kMaxSmem) fs += 8;
    return {g, fs, true};
  }
  return {0, 0, false};
}

// Instances a thread scores together, each weight load serving all of
// them: at most 64 score registers.
template <typename WT, int CB>
__host__ __device__ constexpr int ipt() {
  return 64 / (CB * (int)sizeof(WT) / 4) < 4 ? 64 / (CB * (int)sizeof(WT) / 4) : 4;
}

// STRIP: the tile holds FS of the Fcp rows at a time (RG ≤ IPT, so a
// thread has at most one item), and the statistics go straight to the
// block's partial in device memory; else FS == Fcp.
template <typename WT, int CB, bool ARGMAX, bool STRIP>
__global__ void __launch_bounds__(kT, 1)
    em_multi_mma_kernel(const int16_t* __restrict__ phi,
                        const int* __restrict__ prev,
                        const int* __restrict__ force,
                        const WT* __restrict__ wc, int* __restrict__ assign,
                        int* __restrict__ part_stats,
                        int* __restrict__ part_counts,
                        int* __restrict__ part_sw, WT* __restrict__ part_obj,
                        int64_t n, int Fcp, int C, int R, int RG, int FS,
                        int chunk, int sub, int aligned) {
  constexpr int NNT = CB / 8;  // n = 8 tiles of the clusters
  constexpr int MG = 8 / NNT;  // m-tiles whose products a warp interleaves
  constexpr int IPT = ipt<WT, CB>();
  constexpr int NQ = kT / IPT;                           // items of a restart in a tile
  constexpr int KMAX = STRIP ? 1 : kMaxRG * NQ / kT;     // items of a thread
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int ngroups = (R + RG - 1) / RG;
  const int64_t cb_idx = blockIdx.x / ngroups;  // the chunk
  const int r0 = (int)(blockIdx.x % ngroups) * RG;
  const int rg = RG < R - r0 ? RG : R - r0;
  const int Ms = (FS + 15) >> 4;       // m = 16 tiles of a strip's rows
  const int S = (Fcp + FS - 1) / FS;   // strips of a tile
  const int64_t FC = (int64_t)Fcp * C;

  extern __shared__ __align__(16) unsigned char smem[];
  WT* s_w = reinterpret_cast<WT*>(smem);
  WT* s_red = s_w + (size_t)RG * Fcp * CB;
  int16_t* s_tile = reinterpret_cast<int16_t*>(s_red + kWarpsT);
  uint4* s_hi = reinterpret_cast<uint4*>(s_tile + (size_t)FS * kT);
  uint4* s_lo = s_hi + (size_t)Ms * kKSteps * 32;
  int* s_acc = reinterpret_cast<int*>(s_lo + (size_t)Ms * kKSteps * 32);
  int* s_cnt = s_acc + (STRIP ? 0 : (size_t)RG * Fcp * CB);
  int* s_sw = s_cnt + RG * CB;
  unsigned char* s_na = reinterpret_cast<unsigned char*>(s_sw + kWarpsT * RG);
  WT* s_vo = reinterpret_cast<WT*>(s_na);  // at a sub's end only
  int* part = part_stats + (cb_idx * R + r0) * FC;  // the block's partial

  if constexpr (ARGMAX) {
    for (int e = tid; e < rg * Fcp * CB; e += kT) {
      const int rr = e / (Fcp * CB), rem = e % (Fcp * CB);
      const int f = rem / CB, c = rem % CB;
      s_w[e] = c < C ? wc[((int64_t)(r0 + rr) * C + c) * Fcp + f] : WT(0);
    }
  }
  if constexpr (STRIP)
    for (int64_t e = tid; e < rg * FC; e += kT) part[e] = 0;
  else
    for (int e = tid; e < rg * Fcp * CB; e += kT) s_acc[e] = 0;
  for (int e = tid; e < rg * CB; e += kT) s_cnt[e] = 0;
  for (int e = tid; e < kWarpsT * RG; e += kT) s_sw[e] = 0;
  unsigned forced = 0;  // bit rr: slot r0 + rr takes prev
  if (ARGMAX)
    for (int rr = 0; rr < rg; ++rr) forced |= (force[r0 + rr] != 0) << rr;

  const int64_t start = cb_idx * chunk;
  const int64_t end = start + chunk < n ? start + chunk : n;
  const int ntiles = (int)((end - start + kT - 1) / kT);
  const int tiles_per_sub = sub / kT;

  // Rows s · FS .. of tile t into s_tile (local row fl = f - s · FS):
  // cp.async (aligned rows) or plain loads, zero past n.
  auto load_strip = [&](int t, int s) {
    const int64_t i0 = start + (int64_t)t * kT;
    const int fb = s * FS, nf = FS < Fcp - fb ? FS : Fcp - fb;
    const int16_t* src = phi + (int64_t)fb * n;
    if (aligned) {
      for (int e = tid; e < nf * (kT / 8); e += kT) {
        const int fl = e / (kT / 8), q = e % (kT / 8);
        const int64_t i = i0 + q * 8;
        const bool in = i < n;  // n % 8 == 0: a chunk is all in or all out
        cp_async16(s_tile + fl * kT + ((q ^ ((fl & 3) << 1)) << 3),
                   in ? src + (int64_t)fl * n + i : phi, in ? 16 : 0);
      }
      cp_async_commit();
    } else {
      for (int e = tid; e < nf * kT; e += kT) {
        const int fl = e / kT, j = e % kT;
        const int64_t i = i0 + j;
        s_tile[fl * kT + tile_col(fl, j)] = i < n ? src[(int64_t)fl * n + i] : int16_t(0);
      }
    }
  };

  // the warp's share of the statistics: restart rr_w, its m-tiles
  // m_w, m_w + step_w, ... of each strip (every (restart, row) pair has
  // one owner), kept in shared memory (row stride CB) or, STRIP, in the
  // block's partial (row stride C)
  const int rr_w = warp % rg;
  const int m_w = warp / rg;
  const int step_w = (kWarpsT - 1 - rr_w) / rg + 1;
  const int g = lane >> 2, tq = lane & 3;
  int* const acc_r = STRIP ? part + rr_w * FC : s_acc + (size_t)rr_w * Fcp * CB;
  const int ldc = STRIP ? C : CB;

  // K1's per-thread objective sums of the items' instances
  WT vobj[KMAX][IPT];
#pragma unroll
  for (int k = 0; k < KMAX; ++k)
#pragma unroll
    for (int u = 0; u < IPT; ++u) vobj[k][u] = WT(0);

  load_strip(0, 0);
  for (int t = 0; t < ntiles; ++t) {
    cp_async_wait<0>();
    __syncthreads();  // strip 0 of tile t is in s_tile; the last tile's work is done
    const int64_t i0 = start + (int64_t)t * kT;

    // STRIP: the thread's item (restart tid / NQ) scored strip by strip,
    // the chain over f running on in registers
    WT ssc[IPT][CB];
    if constexpr (STRIP) {
      const int rr = tid / NQ, j0 = (tid % NQ) * IPT;
      const bool scored = ARGMAX && rr < rg && !((forced >> rr) & 1) && i0 + j0 < end;
#pragma unroll
      for (int u = 0; u < IPT; ++u)
#pragma unroll
        for (int c = 0; c < CB; ++c) ssc[u][c] = WT(0);
      for (int s = 0; s < S; ++s) {
        if (s > 0) {
          __syncthreads();  // strip s - 1 is scored
          load_strip(t, s);
          cp_async_wait<0>();
          __syncthreads();
        }
        if (scored) {
          const int fb = s * FS;
          score_rows<WT, CB, IPT, kT>(ssc, s_w + ((size_t)rr * Fcp + fb) * CB, s_tile,
                                  FS < Fcp - fb ? FS : Fcp - fb, j0);
        }
      }
    }

    // assignments, objective and switches: item e = tid + k · kT is
    // restart e / NQ and the IPT instances from (e % NQ) · IPT
#pragma unroll
    for (int k = 0; k < KMAX; ++k) {
      const int e = tid + k * kT, rr = e / NQ, j0 = (e % NQ) * IPT;
      if (rr < rg) {  // uniform over the warp
        const int64_t ib = i0 + j0;
        int p[IPT], na[IPT];
        bool sw[IPT];
#pragma unroll
        for (int u = 0; u < IPT; ++u) {
          p[u] = ib + u < end ? prev[(int64_t)(r0 + rr) * n + ib + u] : -1;
          na[u] = p[u];
          sw[u] = false;
        }
        if (ARGMAX && !((forced >> rr) & 1)) {
          if (ib < end) {
            WT sc[IPT][CB];
            if constexpr (STRIP) {
#pragma unroll
              for (int u = 0; u < IPT; ++u)
#pragma unroll
                for (int c = 0; c < CB; ++c) sc[u][c] = ssc[u][c];
            } else {
#pragma unroll
              for (int u = 0; u < IPT; ++u)
#pragma unroll
                for (int c = 0; c < CB; ++c) sc[u][c] = WT(0);
              score_rows<WT, CB, IPT, kT>(sc, s_w + (size_t)rr * Fcp * CB, s_tile, Fcp, j0);
            }
#pragma unroll
            for (int u = 0; u < IPT; ++u) {
              WT best = sc[u][0];
              na[u] = 0;
#pragma unroll
              for (int c = 1; c < CB; ++c) {
                if (c < C && sc[u][c] > best) {
                  best = sc[u][c];
                  na[u] = c;
                }
              }
              if (p[u] >= 0) {  // valid (and so before end)
                vobj[k][u] += best;
                sw[u] = na[u] != p[u];
              }
            }
          }
          int nsw = 0;
#pragma unroll
          for (int u = 0; u < IPT; ++u) nsw += __popc(__ballot_sync(0xffffffffu, sw[u]));
          if (lane == 0) s_sw[warp * RG + rr] += nsw;
        }
#pragma unroll
        for (int u = 0; u < IPT; ++u) {
          if (ib + u < end) assign[(int64_t)(r0 + rr) * n + ib + u] = p[u] >= 0 ? na[u] : C;
          s_na[rr * kT + j0 + u] =
              p[u] >= 0 && na[u] < C ? (unsigned char)na[u] : (unsigned char)0xFF;
        }
      }
    }
    __syncthreads();  // the tile's assignments

    // statistics on the tensor cores: restart rr_w's one-hot B fragments,
    // then per strip (last first: it is still in s_tile) the hi and lo
    // planes, and MG of the warp's m-tiles at a time, their 2 · NNT · MG
    // accumulator chains interleaved
    const unsigned char* na_r = s_na + rr_w * kT;
    unsigned b[kKSteps][NNT][2];
#pragma unroll
    for (int ks = 0; ks < kKSteps; ++ks) {
      const unsigned x0 = *reinterpret_cast<const unsigned*>(na_r + ks * 32 + tq * 4);
      const unsigned x1 = *reinterpret_cast<const unsigned*>(na_r + ks * 32 + 16 + tq * 4);
#pragma unroll
      for (int nt = 0; nt < NNT; ++nt) {
        b[ks][nt][0] = onehot4(x0, nt * 8 + g);
        b[ks][nt][1] = onehot4(x1, nt * 8 + g);
      }
    }
    if (m_w == 0) {  // counts: one bit per one-hot byte
#pragma unroll
      for (int nt = 0; nt < NNT; ++nt) {
        int cnt = 0;
#pragma unroll
        for (int ks = 0; ks < kKSteps; ++ks)
          cnt += __popc(b[ks][nt][0]) + __popc(b[ks][nt][1]);
        cnt += __shfl_xor_sync(0xffffffffu, cnt, 1);
        cnt += __shfl_xor_sync(0xffffffffu, cnt, 2);
        if (tq == 0) s_cnt[rr_w * CB + nt * 8 + g] += cnt;
      }
    }
    for (int s = S - 1; s >= 0; --s) {
      const int fb = s * FS, nf = FS < Fcp - fb ? FS : Fcp - fb;
      if (s < S - 1) {
        cp_async_wait<0>();
        __syncthreads();  // strip s is in s_tile; strip s + 1's products are done
      }
      // the strip's hi and lo planes in A-fragment order: fragment
      // (m, ks) of m16n8k32, lane L's four registers at [(m · 8 + ks) ·
      // 32 + L]; rows past the strip are zero
      for (int bi = warp; bi < Ms * kKSteps; bi += kWarpsT) {
        const int m = bi / kKSteps, ks = bi % kKSteps;
        const int f0 = m * 16 + g, f1 = f0 + 8;
        const int j0 = ks * 32 + tq * 4, j1 = j0 + 16;
        uint4 h = make_uint4(0u, 0u, 0u, 0u), l = make_uint4(0u, 0u, 0u, 0u);
        if (f0 < nf) {
          split4(s_tile + f0 * kT + tile_col(f0, j0), &h.x, &l.x);
          split4(s_tile + f0 * kT + tile_col(f0, j1), &h.z, &l.z);
        }
        if (f1 < nf) {
          split4(s_tile + f1 * kT + tile_col(f1, j0), &h.y, &l.y);
          split4(s_tile + f1 * kT + tile_col(f1, j1), &h.w, &l.w);
        }
        s_hi[bi * 32 + lane] = h;
        s_lo[bi * 32 + lane] = l;
      }
      __syncthreads();  // the planes; s_tile is free
      // the next strip (overlapping the products below): the one before,
      // or the next tile's first
      if (s > 0)
        load_strip(t, s - 1);
      else if (t + 1 < ntiles)
        load_strip(t + 1, 0);

      for (int m0 = m_w; m0 < Ms; m0 += MG * step_w) {
        int hi[MG][NNT][4], lo[MG][NNT][4];
#pragma unroll
        for (int x = 0; x < MG; ++x)
#pragma unroll
          for (int nt = 0; nt < NNT; ++nt)
#pragma unroll
            for (int e = 0; e < 4; ++e) hi[x][nt][e] = lo[x][nt][e] = 0;
#pragma unroll
        for (int ks = 0; ks < kKSteps; ++ks) {
#pragma unroll
          for (int x = 0; x < MG; ++x) {
            const int m = m0 + x * step_w;
            if (m < Ms) {  // uniform over the warp
              const uint4 h = s_hi[(m * kKSteps + ks) * 32 + lane];
              const uint4 l = s_lo[(m * kKSteps + ks) * 32 + lane];
              const unsigned ah[4] = {h.x, h.y, h.z, h.w}, al[4] = {l.x, l.y, l.z, l.w};
#pragma unroll
              for (int nt = 0; nt < NNT; ++nt) {
                mma_s8u8(hi[x][nt], ah, b[ks][nt]);
                mma_u8u8(lo[x][nt], al, b[ks][nt]);
              }
            }
          }
        }
#pragma unroll
        for (int x = 0; x < MG; ++x) {
          const int m = m0 + x * step_w;
          const int f0 = m * 16 + g, f1 = f0 + 8;  // rows of the strip
          int* a0 = acc_r + (int64_t)(fb + f0) * ldc;
          int* a1 = acc_r + (int64_t)(fb + f1) * ldc;
#pragma unroll
          for (int nt = 0; nt < NNT; ++nt) {
            const int c = nt * 8 + tq * 2;
            const bool c0 = !STRIP || c < C, c1 = !STRIP || c + 1 < C;
            if (m < Ms && f0 < nf) {
              if (c0) a0[c] += hi[x][nt][0] * 256 + lo[x][nt][0];
              if (c1) a0[c + 1] += hi[x][nt][1] * 256 + lo[x][nt][1];
            }
            if (m < Ms && f1 < nf) {
              if (c0) a1[c] += hi[x][nt][2] * 256 + lo[x][nt][2];
              if (c1) a1[c + 1] += hi[x][nt][3] * 256 + lo[x][nt][3];
            }
          }
        }
      }
    }

    // the objective partial of each `sub` instances, in K1's order: the
    // item of instance j holds K1's thread j's running sum; the restart's
    // 256 sums go through s_vo (over the assignments) to block_sum
    if ((t + 1) % tiles_per_sub == 0 || t + 1 == ntiles) {
      const int64_t ob = start / sub + t / tiles_per_sub;
      __syncthreads();  // the statistics are done with the assignments
#pragma unroll
      for (int rr = 0; rr < kMaxRG; ++rr) {
        if (rr < rg) {
          WT o = WT(0);
          if (ARGMAX && !((forced >> rr) & 1)) {
#pragma unroll
            for (int k = 0; k < KMAX; ++k) {
              const int e = tid + k * kT;
              if (e / NQ == rr) {
#pragma unroll
                for (int u = 0; u < IPT; ++u) {
                  s_vo[(e % NQ) * IPT + u] = vobj[k][u];
                  vobj[k][u] = WT(0);
                }
              }
            }
            __syncthreads();
            o = mtm::block_sum(s_vo[tid], s_red);
          }
          if (tid == 0) part_obj[ob * R + r0 + rr] = o;
        }
      }
    }
  }
  __syncthreads();

  if constexpr (!STRIP)
    for (int e = tid; e < rg * Fcp * C; e += kT) {
      const int rr = e / (Fcp * C), rem = e % (Fcp * C);
      part[e] = s_acc[((size_t)rr * Fcp + rem / C) * CB + rem % C];
    }
  for (int e = tid; e < rg * C; e += kT)
    part_counts[(cb_idx * R + r0) * C + e] = s_cnt[(e / C) * CB + e % C];
  if (tid < rg) {
    int sw = 0;
    for (int w = 0; w < kWarpsT; ++w) sw += s_sw[w * RG + tid];
    part_sw[cb_idx * R + r0 + tid] = sw;
  }
}

template <typename WT, int CB, bool ARGMAX>
int run_mma(const MultiArgs& a) {
  const MmaPlan plan = pick_mma(a.Fcp, CB, sizeof(WT), ipt<WT, CB>());
  if (plan.rg == 0) return -1;
  const int RG = plan.rg < a.R ? plan.rg : a.R;
  const size_t smem = mma_smem(RG, plan.fs, a.Fcp, CB, sizeof(WT), plan.strip);
  const int64_t nchunks = (a.n + a.chunk - 1) / a.chunk;
  const int ngroups = (a.R + RG - 1) / RG;
  const int aligned = a.n % 8 == 0 && reinterpret_cast<uintptr_t>(a.phi) % 16 == 0;
  auto kern = plan.strip ? em_multi_mma_kernel<WT, CB, ARGMAX, true>
                         : em_multi_mma_kernel<WT, CB, ARGMAX, false>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kern<<<(unsigned)(nchunks * ngroups), kT, smem, a.stream>>>(
      static_cast<const int16_t*>(a.phi), a.prev, a.force,
      static_cast<const WT*>(a.wc), a.assign, static_cast<int*>(a.part_stats),
      a.part_counts, a.part_sw, static_cast<WT*>(a.part_obj), a.n, a.Fcp, a.C,
      a.R, RG, plan.fs, a.chunk, a.sub, aligned);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int64_t FC = (int64_t)a.Fcp * a.C;
  const int64_t total = a.R * FC + (int64_t)a.R * a.C + 2 * a.R;
  em_multi_reduce<int, long long, WT>
      <<<(unsigned)((total + 255) / 256), 256, 0, a.stream>>>(
          static_cast<const int*>(a.part_stats), a.part_counts, a.part_sw,
          static_cast<const WT*>(a.part_obj), static_cast<long long*>(a.macc),
          a.counts, a.switches, static_cast<WT*>(a.obj), nchunks,
          (a.n + a.sub - 1) / a.sub, a.R, FC, a.C);
  return (int)cudaGetLastError();
}

template <typename WT, bool ARGMAX>
int dispatch_mma(const MultiArgs& a) {
  if (a.C <= 8) return run_mma<WT, 8, ARGMAX>(a);
  if (a.C <= 16) return run_mma<WT, 16, ARGMAX>(a);
  return run_mma<WT, 32, ARGMAX>(a);
}

}  // namespace

// K3 under int16 Φ, called by mtm_markov_em_multi (markov_em_multi.cu)
// after its argument checks and cudaSetDevice, with its arguments but
// phi_kind.  w_kind: 1 float32, 2 float64.  `sub` must be a multiple of
// 256.  Returns a cudaError_t (0 on success), or -1 for an argument the
// kernel does not take.
extern "C" int mtm_markov_em_multi_i16(
    int w_kind, const void* phi, const void* prev, const void* force,
    const void* wc, void* assign, void* part_stats, void* part_counts,
    void* part_sw, void* part_obj, void* macc, void* counts, void* switches,
    void* obj, long long n, int Fcp, int C, int R, int chunk, int sub,
    int argmax, void* stream) {
  if (sub % kT != 0) return -1;
  MultiArgs a{phi,
              nullptr,
              nullptr,
              nullptr,
              0,
              0,
              0,
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
  const bool am = argmax != 0;
  if (w_kind == 1) return am ? dispatch_mma<float, true>(a) : dispatch_mma<float, false>(a);
  if (w_kind == 2) return am ? dispatch_mma<double, true>(a) : dispatch_mma<double, false>(a);
  return -1;
}
