// The float32 quadratic forms of the dense E-step kernels K8, K14
// (estep_assign.cu) and K12, K13 (estep_logliks.cu) on the TF32 tensor
// cores.  Float64 keeps estep_tile.cuh's quad_form.
//
// A block holds BN rows of one missingness pattern in a shared-memory
// tile, one tile column per row (Dp x ldv, Dp = D rounded up to 8, ldv =
// BN + 8), and takes, for every cluster c in order, q_i = r_i^T M r_i with
// r_i the row's residual and M = M[c, p] (D x D, symmetric):
// - r formed in float32 exactly as quad_form forms it (mtm::residual), then
//   split r = r_hi + r_lo + O(2^-22 |r|), r_hi = tf32_rna(r), r_lo =
//   tf32_rna(r - r_hi); M split the same way as its fragments are loaded;
// - Y' = R M' by mma.sync.aligned.m16n8k8 TF32 with float32 accumulation:
//   rows in the M dimension (each warp 32 rows, two m tiles, so every B
//   fragment serves both), output coordinates in N, input coordinates in
//   K; three products into one accumulator per k step, the small ones
//   first (lo.hi, hi.lo, then hi.hi): about 2^-21 relative error a
//   product.  A single TF32 product (r_hi M_hi) errs by about 2^-11,
//   beyond the log-likelihoods' float32 tolerance (2e-5 of their
//   magnitude);
// - M' is M over 8x8 blocks with the blocks above the diagonal doubled
//   (exact) and those below it skipped: q = sum_j r_j y'_j all the same,
//   at 55 of the 100 block products at D = 80.  Each (k step, first n
//   tile) pair has a body of its own, so no product is predicated off;
// - M staged by cp.async in column strips of 8 NT columns (only the rows
//   the strip's k steps read), double-buffered across (cluster, strip)
//   stages where shared memory allows, so that the next strip loads while
//   this one multiplies; narrower strips, fewer rows a block or one
//   buffer where not, so every D the CUDA-core body took fits;
// - epilogue: q_i = sum_j r_ij y'_ij by float32 FMAs on the accumulator
//   fragments (r read at the fragment's positions), strips and n tiles in
//   order, then across the four lanes of a quad by a fixed butterfly, so
//   two calls give the same bits.  Each thread then owns one row;
// - a row whose q is not finite (a non-finite mean, residual or inverse:
//   the split turns Inf into Inf - Inf = NaN) is recomputed by
//   quad_form's float32 FMA chain over M in device memory, so the kernel
//   gives the plain version's class of non-finite value (NaN, +Inf or
//   -Inf).
//
// Work: 3 x 2 x 64 (Dp/8)(Dp/8 + 1)/2 TF32 operations a row and cluster,
// 3 C D (D + 8) n = 3.4e11 at n = 1e6, C = 16, D = 80: 0.68 ms at the
// H100's 495 TFLOP/s; the full product Y = R M would take 3 x 2 C D^2 n,
// 1.24 ms.
//
// Shared memory of a block: the tile (Dp x ldv), nbuf stage buffers of
// the mean row (Dp) and one strip (Dp x ldm), then the caller's tail.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>
#include <type_traits>
#include <utility>

#include "estep_tile.cuh"

namespace mtm {
namespace tc {

// strip widths, in n tiles of 8 columns, that have a compiled kernel,
// widest first
constexpr int kStripTiles[] = {8, 5, 4, 2, 1};
constexpr int kNumStripTiles = sizeof(kStripTiles) / sizeof(int);
constexpr int kMaxRows = 256;  // threads (= rows) of a block at most

struct Plan {
  int BN = 0, NT = 0, nbuf = 0;  // nbuf == 0: nothing fits
  int Dp = 0, ldv = 0, ldm = 0, strips = 0;
  bool shared_tail = true;  // the caller's tail in shared memory
  size_t smem = 0;
};

inline int round8(int x) { return (x + 7) / 8 * 8; }

// A strip's leading dimension: 8 or 24 modulo 32 words, so that the B
// fragment loads (k = t, t + 4 and n = g of a quad) hit 32 banks.
inline int strip_ld(int ns) {
  return ns % 32 == 8 || ns % 32 == 24 ? ns : ns + 8;
}

inline size_t plan_bytes(int Dp, int ldv, int ldm, int nbuf) {
  return sizeof(float) *
         ((size_t)Dp * ldv + (size_t)nbuf * ((size_t)Dp + (size_t)Dp * ldm));
}

inline int strips_of(int Dp, int nt) { return (Dp + 8 * nt - 1) / (8 * nt); }

// The k steps a warp takes per cluster with strips of nt n tiles (each
// forms its residual fragments once): strip s reads block rows up to its
// last column.
inline int ksteps_of(int Dp, int nt) {
  int k = 0;
  for (int s = 0; s < strips_of(Dp, nt); ++s) k += std::min(Dp, (s + 1) * 8 * nt) / 8;
  return k;
}

// The plan for blocks of BN rows: the strip width with the fewest k steps
// (then the least padding, then the widest), double-buffered if it fits,
// else single; a narrower strip if neither fits; the caller's tail (tail
// bytes) in shared memory if it fits, else in device memory.
inline Plan plan_for(int D, int BN, size_t tail) {
  Plan pl;
  if (D <= 0 || BN < 32 || BN > kMaxRows || BN % 32 != 0) return pl;
  const int Dp = round8(D), ldv = BN + 8;
  int order[kNumStripTiles];
  std::copy(kStripTiles, kStripTiles + kNumStripTiles, order);
  std::stable_sort(order, order + kNumStripTiles, [&](int a, int b) {
    const int ka = ksteps_of(Dp, a), kb = ksteps_of(Dp, b);
    return ka != kb ? ka < kb : strips_of(Dp, a) * a < strips_of(Dp, b) * b;
  });
  for (int pass = 0; pass < 2; ++pass) {
    const size_t t = pass == 0 ? tail : 0;
    for (int i = 0; i < kNumStripTiles; ++i)
      for (int nbuf = 2; nbuf >= 1; --nbuf) {
        const int nt = order[i], ldm = strip_ld(8 * nt);
        const size_t bytes = plan_bytes(Dp, ldv, ldm, nbuf) + t;
        if (bytes > kMaxSmem) continue;
        pl.BN = BN;
        pl.NT = nt;
        pl.nbuf = nbuf;
        pl.Dp = Dp;
        pl.ldv = ldv;
        pl.ldm = ldm;
        pl.strips = strips_of(Dp, nt);
        pl.shared_tail = pass == 0;
        pl.smem = bytes;
        return pl;
      }
  }
  return pl;
}

// A plan's k steps per cluster over the warps an SM holds (by shared
// memory, 228 KB an SM with 1 KB reserved a block; at most 16 counted).
inline double plan_cost(const Plan& pl) {
  const int blocks = std::min<int>(233472 / (pl.smem + 1024), 2048 / pl.BN);
  const int warps = std::min(16, std::max(1, blocks) * pl.BN / 32);
  return (double)ksteps_of(pl.Dp, pl.NT) / warps;
}

// The block of 256, 128, 64 or 32 rows whose plan costs least (the
// largest among equals), or -1 if none has a plan.
inline int plan_block(int D, size_t tail) {
  int best = -1;
  double cost = 0;
  for (int BN = kMaxRows; BN >= 32; BN /= 2) {
    const Plan pl = plan_for(D, BN, tail);
    if (pl.nbuf > 0 && (best < 0 || plan_cost(pl) < cost)) {
      best = BN;
      cost = plan_cost(pl);
    }
  }
  return best;
}

__device__ __forceinline__ uint32_t tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32(x);
  lo = tf32(x - __uint_as_float(hi));
}

// split() of a residual: the same rounding (to nearest, ties away from
// zero) done on the bits, two integer operations a part where cvt.rna
// takes three, since it keeps Inf and NaN.  Here Inf or NaN turns into
// another value, but q_i then takes the non-finite r_ij itself in the
// epilogue's float32 FMA, so the row goes to the exact recomputation.
__device__ __forceinline__ void split_residual(float x, uint32_t& hi,
                                               uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
  lo = (__float_as_uint(x - __uint_as_float(hi)) + 0x1000u) & 0xFFFFE000u;
}

// d += a b on a 16x8x8 tile: TF32 operands, float32 accumulation
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// BYTES (4 or 16) from src to dst, or zeros where !ok (src is not read)
template <int BYTES>
__device__ __forceinline__ void cp_async(float* dst, const float* src, bool ok) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  const int n = ok ? BYTES : 0;
  if (BYTES == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
                 "l"(src), "r"(n)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
                 "l"(src), "r"(n)
                 : "memory");
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Issues the copies of one stage into buf: the mean row (Dp, 0 past D),
// then columns [j0, j0 + 8 NT) of rows [0, kr) of M (D x D row-major)
// with leading dimension ldm (0 outside M).  vec: D % 4 == 0 and both
// sources 16-byte aligned.
template <int NT>
__device__ void stage(float* buf, const float* __restrict__ M,
                      const float* __restrict__ mrow, int D, int Dp, int ldm,
                      int j0, int kr, bool vec) {
  constexpr int NS = 8 * NT;
  float* s_mean = buf;
  float* s_M = buf + Dp;
  const int tid = threadIdx.x, nth = blockDim.x;
  if (vec) {
    for (int e = tid; e < Dp / 4; e += nth) {
      const int k = 4 * e;
      cp_async<16>(s_mean + k, k < D ? mrow + k : mrow, k < D);
    }
    constexpr int per = NS / 4;
    for (int e = tid; e < kr * per; e += nth) {
      const int k = e / per, jj = 4 * (e - k * per), j = j0 + jj;
      const bool ok = k < D && j < D;
      cp_async<16>(s_M + k * ldm + jj, ok ? M + (size_t)k * D + j : M, ok);
    }
  } else {
    for (int k = tid; k < Dp; k += nth)
      cp_async<4>(s_mean + k, k < D ? mrow + k : mrow, k < D);
    for (int e = tid; e < kr * NS; e += nth) {
      const int k = e / NS, jj = e - k * NS, j = j0 + jj;
      const bool ok = k < D && j < D;
      cp_async<4>(s_M + k * ldm + jj, ok ? M + (size_t)k * D + j : M, ok);
    }
  }
}

// q = r^T M r of tile column `row` by quad_form's float32 FMA chain (y_j
// over k in order, then q over j), M and the mean row from device memory.
// A NaN stays NaN through every later FMA, so the chain stops at the
// first one (a failed factorization makes all of M NaN).
template <bool RAW>
__device__ float exact_q(const float* s_v, int ldv, int row,
                         const float* __restrict__ M,
                         const float* __restrict__ mrow, int D) {
  float q = 0.f;
  for (int j = 0; j < D && !is_nan(q); ++j) {
    float y = 0.f;
    for (int k = 0; k < D && !is_nan(y); ++k)
      y = fused_ma(residual<float, RAW>(s_v[k * ldv + row], __ldg(mrow + k)),
                   __ldg(M + (size_t)k * D + j), y);
    q = fused_ma(residual<float, RAW>(s_v[j * ldv + row], __ldg(mrow + j)), y, q);
  }
  return q;
}

// One k step (block row k0 / 8) of Y' += R M' on n tiles [N0, NT) of the
// strip: A fragments (g, t), (g + 8, t), (g, t + 4), (g + 8, t + 4) of the
// residuals, B fragments (k = t, n = g) and (k = t + 4, n = g) of M'
// (M doubled, or as it is in tile N0 when DIAG: the diagonal block).
// Each accumulator takes lo.hi, hi.lo, then hi.hi; the accumulators'
// products interleave, so no product waits on the one before it.
template <bool RAW, int NT, int N0, bool DIAG>
__device__ __forceinline__ void kstep(float (&acc)[2][NT][4], const float* s_v,
                                      const float* s_mean, const float* s_M,
                                      int ldv, int ldm, int k0, int wrow, int g,
                                      int t) {
  uint32_t ah[2][4], al[2][4];
  const float m0 = s_mean[k0 + t], m1 = s_mean[k0 + t + 4];
  const float* v0 = s_v + (k0 + t) * ldv + wrow + g;
  const float* v1 = v0 + 4 * ldv;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
    split_residual(residual<float, RAW>(v0[16 * mt], m0), ah[mt][0], al[mt][0]);
    split_residual(residual<float, RAW>(v0[16 * mt + 8], m0), ah[mt][1], al[mt][1]);
    split_residual(residual<float, RAW>(v1[16 * mt], m1), ah[mt][2], al[mt][2]);
    split_residual(residual<float, RAW>(v1[16 * mt + 8], m1), ah[mt][3], al[mt][3]);
  }
  const float* b = s_M + (k0 + t) * ldm + g;
  uint32_t bh[NT][2], bl[NT][2];
#pragma unroll
  for (int nt = N0; nt < NT; ++nt) {
    const float sc = DIAG && nt == N0 ? 1.f : 2.f;
    split(sc * b[8 * nt], bh[nt][0], bl[nt][0]);
    split(sc * b[8 * nt + 4 * ldm], bh[nt][1], bl[nt][1]);
  }
#pragma unroll
  for (int nt = N0; nt < NT; ++nt)
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) mma(acc[mt][nt], al[mt], bh[nt][0], bh[nt][1]);
#pragma unroll
  for (int nt = N0; nt < NT; ++nt)
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) mma(acc[mt][nt], ah[mt], bl[nt][0], bl[nt][1]);
#pragma unroll
  for (int nt = N0; nt < NT; ++nt)
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) mma(acc[mt][nt], ah[mt], bh[nt][0], bh[nt][1]);
}

// The strip's own block rows: k step d (block row k0 / 8 + d) on n tiles
// d and on, for d < nd (the strip's n tiles within D), each a body of its
// own, so no product is predicated off.
template <bool RAW, int NT, int... Ds>
__device__ __forceinline__ void diagonal_ksteps(
    std::integer_sequence<int, Ds...>, float (&acc)[2][NT][4], const float* s_v,
    const float* s_mean, const float* s_M, int ldv, int ldm, int k0, int nd,
    int wrow, int g, int t) {
  ((Ds < nd ? kstep<RAW, NT, Ds, true>(acc, s_v, s_mean, s_M, ldv, ldm,
                                       k0 + 8 * Ds, wrow, g, t)
            : void()),
   ...);
}

// The row of the block's tile that this thread owns after a cluster's
// quad reduction: lane t of quad g takes (m tile t >> 1, half t & 1).
__device__ __forceinline__ int own_row() {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  return (threadIdx.x & ~31) + 16 * (t >> 1) + 8 * (t & 1) + g;
}

// For every cluster c in order, q = r^T M[c] r of every row of the tile
// s_v (Dp x ldv, rows past the block's count and coordinates past D
// zero), then fn(c, q) in every thread for its own row (own_row()).  M[c]
// is Mbase + c * Mstride (D x D), the mean row mbase + c * D.  Every
// thread of the block calls it; the first barrier publishes the tile and
// anything else written before the call.
template <bool RAW, int NT, typename Fn>
__device__ void quad_forms(const float* s_v, float* s_stage, const Plan pl,
                           int D, int C, bool vec,
                           const float* __restrict__ Mbase, size_t Mstride,
                           const float* __restrict__ mbase, Fn&& fn) {
  constexpr int NS = 8 * NT;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int wrow = threadIdx.x & ~31;
  const int Dp = pl.Dp, ldv = pl.ldv, ldm = pl.ldm, strips = pl.strips;
  const int nbuf = pl.nbuf;
  const size_t stage_floats = (size_t)Dp + (size_t)Dp * ldm;
  const int S = C * strips;
  auto issue = [&](int s) {
    const int c = s / strips, j0 = (s - c * strips) * NS;
    stage<NT>(s_stage + (nbuf == 2 ? (s & 1) : 0) * stage_floats,
              Mbase + (size_t)c * Mstride, mbase + (size_t)c * D, D, Dp, ldm,
              j0, min(Dp, j0 + NS), vec);
    cp_commit();
  };

  issue(0);
  float q[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
  for (int s = 0; s < S; ++s) {
    const int c = s / strips, st = s - c * strips, j0 = st * NS;
    if (nbuf == 2) {
      if (s + 1 < S)
        issue(s + 1);
      else
        cp_commit();
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();
    const float* s_mean = s_stage + (nbuf == 2 ? (s & 1) : 0) * stage_floats;
    const float* s_M = s_mean + Dp;
    const int ncols = min(NS, Dp - j0);

    float acc[2][NT][4];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[mt][nt][i] = 0.f;

    // M is symmetric, so q = sum_J r_J . y'_J with y'_J = sum_{I <= J} r_I
    // M'_IJ over 8x8 blocks, M' = M doubled above the diagonal blocks
    // (exact): the block rows above the strip take every n tile, the
    // strip's own block rows I = jt0 + d the n tiles d and on
    const int jt0 = j0 / 8;
    for (int kk = 0; kk < jt0; ++kk)
      kstep<RAW, NT, 0, false>(acc, s_v, s_mean, s_M, ldv, ldm, 8 * kk, wrow, g, t);
    diagonal_ksteps<RAW, NT>(std::make_integer_sequence<int, NT>{}, acc, s_v,
                             s_mean, s_M, ldv, ldm, 8 * jt0, ncols / 8, wrow, g, t);

    // q += r_ij y_ij at the accumulator's positions: (g, 2t), (g, 2t + 1),
    // (g + 8, 2t), (g + 8, 2t + 1) of each tile
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      if (8 * nt < ncols) {
        const int col = j0 + 8 * nt + 2 * t;
        const float mc0 = s_mean[col], mc1 = s_mean[col + 1];
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const float* vc = s_v + col * ldv + wrow + 16 * mt + 8 * h + g;
            q[mt][h] = fused_ma(residual<float, RAW>(vc[0], mc0),
                                acc[mt][nt][2 * h], q[mt][h]);
            q[mt][h] = fused_ma(residual<float, RAW>(vc[ldv], mc1),
                                acc[mt][nt][2 * h + 1], q[mt][h]);
          }
      }
    }

    if (st == strips - 1) {
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          q[mt][h] += __shfl_xor_sync(0xffffffffu, q[mt][h], 1);
          q[mt][h] += __shfl_xor_sync(0xffffffffu, q[mt][h], 2);
        }
      float qo = t == 0 ? q[0][0] : t == 1 ? q[0][1] : t == 2 ? q[1][0] : q[1][1];
      if (!isfinite(qo))
        qo = exact_q<RAW>(s_v, ldv, own_row(), Mbase + (size_t)c * Mstride,
                          mbase + (size_t)c * D, D);
      fn(c, qo);
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int h = 0; h < 2; ++h) q[mt][h] = 0.f;
    }
    __syncthreads();  // the stage buffer read here may be refilled next
    if (nbuf == 1 && s + 1 < S) issue(s + 1);
  }
}

// Zeros tile rows [D, Dp) (coordinates past D); the caller loads [0, D).
__device__ __forceinline__ void zero_pad_rows(float* s_v, int ldv, int D, int Dp) {
  for (int e = threadIdx.x; e < (Dp - D) * ldv; e += blockDim.x)
    s_v[D * ldv + e] = 0.f;
}

// Whether the stage copies may move 16 bytes: D % 4 == 0 and the inverses
// and mean rows 16-byte aligned.
inline bool vec_ok(int D, const void* minv, const void* means) {
  return D % 4 == 0 && reinterpret_cast<uintptr_t>(minv) % 16 == 0 &&
         reinterpret_cast<uintptr_t>(means) % 16 == 0;
}

// f(std::integral_constant<int, NT>) for a plan's strip width NT (one of
// kStripTiles), or -1.
template <typename F>
inline int with_strip_tiles(int nt, F&& f) {
  switch (nt) {
    case 8: return f(std::integral_constant<int, 8>{});
    case 5: return f(std::integral_constant<int, 5>{});
    case 4: return f(std::integral_constant<int, 4>{});
    case 2: return f(std::integral_constant<int, 2>{});
    case 1: return f(std::integral_constant<int, 1>{});
  }
  return -1;
}

}  // namespace tc
}  // namespace mtm
