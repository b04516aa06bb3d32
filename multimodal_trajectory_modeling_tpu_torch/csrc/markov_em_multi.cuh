// The kernel body of K3 on wide Φ, K4a and float64 K4b: hard-assignment EM
// iterations for R restarts over one batch, with float statistics.
// markov_em_multi.cu launches it for K3 on float32 or float64 Φ,
// markov_em_packed.cu for K4a and float64 K4b; each includes this file, so
// the two compile in parallel.  K3 on int16 Φ runs
// markov_em_multi_mma.cu, float32 K4b markov_em_packed_mma.cu; both take
// this file's em_multi_reduce and MultiArgs.
//
// Replaces these TPU kernels of the JAX package (ops/pallas_markov.py):
// - K3  markov_em_from_features_multi (body _markov_em_feat_multi_kernel):
//   Φ (Fcp, n) read from device memory;
// - K4b markov_em_fused_packed_multi (body _markov_em_packed_multi_kernel)
//   and K4a markov_em_fused_packed (body _markov_em_packed_kernel, R = 1):
//   Φ rebuilt from the packed batch u (T*s, n) on every call.
//
// For each restart r and instance i (one column of Φ):
//   scores_c = Σ_f wc[r, c, f] · Φ[f, i]          (C of them)
//   na       = argmax_c scores_c, by the rule of the replaced kernel:
//              K3/K4b a strict `cand > best` scan over c (a NaN never
//              wins, a NaN at c = 0 stays), K4a the first maximum with
//              NaN counted as the maximum (jnp.argmax)
//   force[r] (K3/K4b): the slot takes prev verbatim, its scores are not
//              computed, its switches and objective are exactly 0
//     (assign_mode "prev" skips the scores for every slot: na = prev)
//   valid    = prev[r, i] >= 0;  assign[r, i] = valid ? na : C
// and over the valid instances: counts[r, c], switches[r], obj[r] = Σ max
// score, and the statistics macc[r, f, c] = Σ_{na == c} Φ[f, i].
//
// Restart r's scores are the same FMA chain over f, in the same order and
// from the same folded weights, as K1's (markov_em.cu), so on finite
// scores slot r's assignments, counts and switches equal a K1 call on
// slot r's inputs bit for bit.
//
// Bound on the card: K3 streams Φ once per restart group, and does
// R · C · Fcp FMAs plus about R · Fcp shared-memory additions per
// instance; the additions bound it.
// Design:
// - one thread per instance, the C scores of one restart in registers
//   (C rounded up to CB = 8, 16 or 32), FMAs on the CUDA cores in the
//   weights' type (never TF32);
// - the restarts are cut into groups of RG on the grid's second axis, so
//   a group's weights (RG · Fcp · CB) and statistics (RG · Fcp · C) fit
//   shared memory (at R=32, C=16 all of them would take 458 KB); each
//   group rereads the Φ column, mostly from L2;
// - each block covers `chunk` instances (1024 to 8192 from the wrapper,
//   growing with R so the partials stay small; int16 sums stay exact in
//   int32 up to 65536) and writes per-block partials; a second kernel
//   adds them in block order.  No global atomics.  The objective's
//   partials are taken per `sub` = 1024 instances, as K1 takes them per
//   block, so slot r's objective equals K1's bit for bit too.
// - float sums would depend on the order of float atomics, so the block
//   goes through its instances in tiles of one per thread, and each
//   restart's tile is added by one thread per feature row, in instance
//   order (markov_common.cuh:ordered_add).  Every output is then the same
//   bit for bit from run to run.
// - K4a/K4b: each thread first builds its instance's Φ column into a
//   shared-memory tile (markov_common.cuh:acc_row, K2's row build; rows
//   padded to nt + 1 so ordered_add's row reads miss no bank), then runs
//   the same body on it; Φ never reaches device memory.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "markov_common.cuh"

// internal linkage: each including file gets its own copy of the kernels
namespace {

using mtm::acc_row;
using mtm::block_sum;
using mtm::fused_ma;
using mtm::is_nan;
using mtm::ordered_add;

constexpr int kThreads = 256;        // K3
constexpr int kPackedThreads = 128;  // K4: one Φ column per thread in smem
constexpr size_t kMaxSmem = 232448;  // a block's shared-memory limit
constexpr size_t kSmemTarget = 113 * 1024;  // two blocks on an SM

// Float statistics (WT) at an odd row stride (C | 1), so that
// ordered_add's threads (one per row) hit distinct banks.
template <typename WT>
size_t multi_smem(int nt, bool packed, int cb, int Fcp, int C, int RG) {
  const size_t nw = nt / 32;
  return sizeof(WT) * (nw + (packed ? (size_t)Fcp * (nt + 1) : 0) +
                       (size_t)RG * nt + (size_t)RG * Fcp * cb +
                       (size_t)RG * Fcp * (C | 1)) +
         sizeof(int) * ((size_t)RG * C + (size_t)RG * nt + nw + nt);
}

// The largest restart group that keeps two blocks on an SM, else 1 if a
// block fits at all, else 0.
template <typename WT>
int pick_group(int nt, bool packed, int cb, int Fcp, int C, int R) {
  for (int rg = 8; rg > 1; rg >>= 1)
    if (rg <= R && multi_smem<WT>(nt, packed, cb, Fcp, C, rg) <= kSmemTarget)
      return rg;
  return multi_smem<WT>(nt, packed, cb, Fcp, C, 1) <= kMaxSmem ? 1 : 0;
}

// PACKED: PhiT == WT, and phi is unused (each thread builds its column
// from u); else u, lens and desc are unused.  PhiT is float or double.
template <typename PhiT, typename WT, int CB, bool ARGMAX, bool STRICT,
          bool PACKED>
__global__ void __launch_bounds__(kThreads)
    em_multi_kernel(const PhiT* __restrict__ phi, const WT* __restrict__ u,
                    const int* __restrict__ lens,
                    const int* __restrict__ desc, int steps, int s, int Fc,
                    const int* __restrict__ prev,
                    const int* __restrict__ force,
                    const WT* __restrict__ wc, int* __restrict__ assign,
                    WT* __restrict__ part_stats,
                    int* __restrict__ part_counts, int* __restrict__ part_sw,
                    WT* __restrict__ part_obj, int64_t n, int Fcp, int C,
                    int R, int RG, int chunk, int sub) {
  const int nt = blockDim.x, nw = nt >> 5, tid = threadIdx.x;
  const int ts = nt + 1;  // the tile's row stride
  const int cs = C | 1;
  const int FS = Fcp * cs;  // one restart's statistics
  const int r0 = blockIdx.y * RG;
  const int rg = RG < R - r0 ? RG : R - r0;  // restarts of this block
  // layout, widest type first: red (nw WT), tile (PACKED: Fcp x ts),
  // obj (RG x nt WT), w (RG x Fcp x CB WT), acc (RG x Fcp x cs WT),
  // counts (RG x C int), sw (RG x nt int), ired (nw int), na (nt int)
  extern __shared__ __align__(16) unsigned char smem[];
  WT* s_red = reinterpret_cast<WT*>(smem);
  PhiT* s_tile = reinterpret_cast<PhiT*>(s_red + nw);
  WT* s_obj =
      reinterpret_cast<WT*>(s_tile + (PACKED ? (size_t)Fcp * ts : 0));
  WT* s_w = s_obj + (size_t)RG * nt;
  WT* s_acc = s_w + (ARGMAX ? (size_t)RG * Fcp * CB : 0);
  int* s_counts = reinterpret_cast<int*>(s_acc + RG * FS);
  int* s_sw = s_counts + RG * C;
  int* s_ired = s_sw + RG * nt;
  int* s_na = s_ired + nw;

  if constexpr (ARGMAX) {
    for (int e = tid; e < rg * Fcp * CB; e += nt) {
      const int rr = e / (Fcp * CB), rem = e % (Fcp * CB);
      const int f = rem / CB, c = rem % CB;
      s_w[e] = c < C ? wc[((int64_t)(r0 + rr) * C + c) * Fcp + f] : WT(0);
    }
  }
  for (int e = tid; e < rg * FS; e += nt) s_acc[e] = WT(0);
  for (int e = tid; e < rg * C; e += nt) s_counts[e] = 0;
  for (int rr = 0; rr < rg; ++rr) {
    s_obj[rr * nt + tid] = WT(0);
    s_sw[rr * nt + tid] = 0;
  }
  __syncthreads();

  // Instance i under restart group slot rr (its Φ column: element f is
  // col[f * stride]): scores, assignment, counts, objective and switches.
  // Returns the cluster whose statistics take the instance, or -1.
  auto step = [&](int64_t i, const PhiT* col, int64_t stride, int rr) {
    const int r = r0 + rr;
    const int p = prev[(int64_t)r * n + i];
    const bool valid = p >= 0;
    int na = p;
    if (ARGMAX && force[r] == 0) {
      WT sc[CB];
#pragma unroll
      for (int c = 0; c < CB; ++c) sc[c] = WT(0);
      const WT* w = s_w + (size_t)rr * Fcp * CB;
      for (int f = 0; f < Fcp; ++f) {
        const WT v = static_cast<WT>(col[f * stride]);
        const WT* wf = w + f * CB;
#pragma unroll
        for (int c = 0; c < CB; ++c) sc[c] = fused_ma(wf[c], v, sc[c]);
      }
      WT best = sc[0];
      na = 0;
#pragma unroll
      for (int c = 1; c < CB; ++c) {
        if (c < C) {
          const bool take =
              STRICT ? sc[c] > best
                     : (sc[c] > best || (is_nan(sc[c]) && !is_nan(best)));
          if (take) {
            best = sc[c];
            na = c;
          }
        }
      }
      if (valid) {
        s_obj[rr * nt + tid] += best;
        s_sw[rr * nt + tid] += (na != p);
      }
    }
    assign[(int64_t)r * n + i] = valid ? na : C;
    if (!valid || na >= C) return -1;
    atomicAdd(&s_counts[rr * C + na], 1);
    return na;
  };

  const int64_t start = (int64_t)blockIdx.x * chunk;
  const int64_t end = start + chunk < n ? start + chunk : n;
  int64_t ob = start / sub;  // the block's first objective partial
  for (int64_t s0 = start; s0 < end; s0 += sub, ++ob) {
    const int64_t s1 = s0 + sub < end ? s0 + sub : end;
    // tiles of nt instances, each restart's tile added by ordered_add; the
    // tile's Φ columns: element (f, j) is tile[f * tstride + j]
    for (int64_t i0 = s0; i0 < s1; i0 += nt) {
      const int64_t i = i0 + tid;
      const bool live = i < s1;
      const PhiT* tile;
      int64_t tstride;
      if constexpr (PACKED) {
        tile = s_tile;
        tstride = ts;
        if (live) {
          PhiT* t = s_tile + tid;
          const int len = lens[i];
          const WT* ui = u + i;
          for (int f = 0; f < Fc; ++f)
            t[f * ts] = acc_row<WT>(desc[3 * f], desc[3 * f + 1],
                                    desc[3 * f + 2], ui, n, len, steps, s);
          for (int f = Fc; f < Fcp; ++f) t[f * ts] = PhiT(0);
        }
      } else {
        tile = phi + i0;
        tstride = n;
      }
      for (int rr = 0; rr < rg; ++rr) {
        s_na[tid] = live ? step(i, tile + tid, tstride, rr) : -1;
        __syncthreads();
        ordered_add(s_acc + rr * FS, cs, s_na, nt, tile, tstride, Fcp);
        __syncthreads();
      }
    }
    // the objective partial of these `sub` instances, in K1's order
    for (int rr = 0; rr < rg; ++rr) {
      const WT o = block_sum(s_obj[rr * nt + tid], s_red);
      if (tid == 0) part_obj[ob * R + r0 + rr] = o;
      s_obj[rr * nt + tid] = WT(0);
    }
  }
  __syncthreads();

  const int64_t b = blockIdx.x;
  for (int rr = 0; rr < rg; ++rr) {
    const int sw = block_sum(s_sw[rr * nt + tid], s_ired);
    if (tid == 0) part_sw[b * R + r0 + rr] = sw;
  }
  const int64_t FC = (int64_t)Fcp * C;
  WT* part = part_stats + (b * R + r0) * FC;
  for (int e = tid; e < rg * Fcp * C; e += nt)  // row f of restart rr at
    part[e] = s_acc[e / C * cs + e % C];        // (rr * Fcp + f) * cs
  for (int e = tid; e < rg * C; e += nt)
    part_counts[(b * R + r0) * C + e] = s_counts[e];
}

// Adds the per-block partials in block order (the objective's per `sub`
// instances): one thread per output.
template <typename SAcc, typename GAcc, typename WT>
__global__ void em_multi_reduce(const SAcc* __restrict__ part_stats,
                                const int* __restrict__ part_counts,
                                const int* __restrict__ part_sw,
                                const WT* __restrict__ part_obj,
                                GAcc* __restrict__ macc,
                                int* __restrict__ counts,
                                int* __restrict__ switches,
                                WT* __restrict__ obj, int64_t nblocks,
                                int64_t nsub, int R, int64_t FC, int C) {
  const int64_t e = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int64_t S = R * FC, K = (int64_t)R * C;
  if (e < S) {
    GAcc a = GAcc(0);
    for (int64_t b = 0; b < nblocks; ++b)
      a += static_cast<GAcc>(part_stats[b * S + e]);
    macc[e] = a;
  } else if (e < S + K) {
    const int64_t k = e - S;
    int a = 0;
    for (int64_t b = 0; b < nblocks; ++b) a += part_counts[b * K + k];
    counts[k] = a;
  } else if (e < S + K + R) {
    const int64_t r = e - S - K;
    int a = 0;
    for (int64_t b = 0; b < nblocks; ++b) a += part_sw[b * R + r];
    switches[r] = a;
  } else if (e < S + K + 2 * R) {
    const int64_t r = e - S - K - R;
    WT a = WT(0);
    for (int64_t b = 0; b < nsub; ++b) a += part_obj[b * R + r];
    obj[r] = a;
  }
}

struct MultiArgs {
  const void* phi;
  const void* u;
  const int* lens;
  const int* desc;
  int steps;
  int s;
  int Fc;
  const int* prev;
  const int* force;
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
  int R;
  int chunk;
  int sub;
  cudaStream_t stream;
};

template <typename PhiT, typename WT, int CB, bool ARGMAX, bool STRICT,
          bool PACKED>
int run_multi(const MultiArgs& a) {
  const int nt = PACKED ? kPackedThreads : kThreads;
  const int cb = ARGMAX ? CB : 0;
  const int RG = pick_group<WT>(nt, PACKED, cb, a.Fcp, a.C, a.R);
  if (RG == 0) return -1;
  const size_t smem = multi_smem<WT>(nt, PACKED, cb, a.Fcp, a.C, RG);
  const int64_t nblocks = (a.n + a.chunk - 1) / a.chunk;
  auto kern = em_multi_kernel<PhiT, WT, CB, ARGMAX, STRICT, PACKED>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)nblocks, (unsigned)((a.R + RG - 1) / RG));
  kern<<<grid, nt, smem, a.stream>>>(
      static_cast<const PhiT*>(a.phi), static_cast<const WT*>(a.u), a.lens,
      a.desc, a.steps, a.s, a.Fc, a.prev, a.force,
      static_cast<const WT*>(a.wc), a.assign,
      static_cast<WT*>(a.part_stats), a.part_counts, a.part_sw,
      static_cast<WT*>(a.part_obj), a.n, a.Fcp, a.C, a.R, RG, a.chunk, a.sub);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int64_t FC = (int64_t)a.Fcp * a.C;
  const int64_t total = a.R * FC + (int64_t)a.R * a.C + 2 * a.R;
  em_multi_reduce<WT, WT, WT>
      <<<(unsigned)((total + 255) / 256), 256, 0, a.stream>>>(
          static_cast<const WT*>(a.part_stats), a.part_counts, a.part_sw,
          static_cast<const WT*>(a.part_obj), static_cast<WT*>(a.macc),
          a.counts, a.switches, static_cast<WT*>(a.obj), nblocks,
          (a.n + a.sub - 1) / a.sub, a.R, FC, a.C);
  return (int)cudaGetLastError();
}

template <typename PhiT, typename WT, bool STRICT, bool PACKED>
int dispatch(const MultiArgs& a, bool argmax) {
  if (!argmax) return run_multi<PhiT, WT, 8, false, true, PACKED>(a);
  if (a.C <= 8) return run_multi<PhiT, WT, 8, true, STRICT, PACKED>(a);
  if (a.C <= 16) return run_multi<PhiT, WT, 16, true, STRICT, PACKED>(a);
  return run_multi<PhiT, WT, 32, true, STRICT, PACKED>(a);
}

bool args_ok(long long n, int Fcp, int C, int R, int chunk, int sub) {
  return n > 0 && Fcp > 0 && C >= 1 && C <= 32 && R >= 1 && sub > 0 &&
         chunk > 0 && chunk % sub == 0;
}

}  // namespace
