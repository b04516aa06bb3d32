// The canonical Φ column of one instance, built from the transposed batch:
// shared by K5 (markov_features_longT.cu), which reads the batch from
// shared-memory stages (its global-memory body: from device memory, by
// longT_rows below) and writes the column to Φ, and K6/K10/K11
// (markov_em_batch.cu), which read it from shared-memory stages and build
// the column into shared memory to score it there.  Both run the same
// per-step arithmetic (the part structs below), so they hold the same Φ
// bit for bit.
//
// Input: z_t (T*d, n) and x_t (T*l, n), NaN (any non-finite value) read as
// 0, and the instance's length.  The rows are those of the g-layout
// (ops/markov_kernels.py:_canonical_offsets), each summed over t = 0..T-1
// in order, with vm = (len > t+1) and (t < T-1) and zn the slice at
// min(t+1, T-1):
//   g1 z⊗z   g2 vm·(z⊗z)   g3 z⊗(zn·vm)   g4 x⊗x   g5 z⊗x
//   g7 vm·z  g8 z          g9 x
// and from t = 0 alone: g6 z⊗z, g10 z, len, 1; rows F..Fpad are 0.
// Products and sums are rounded one at a time (no fused multiply-add), so
// Φ equals its plain torch version bit for bit.
//
// A caller may stop a row at its extent, 1 + its last step with a value
// that is not NaN (0 if it has none): every step past it reads zeros, so
// each of its terms is ±0, and adding ±0 to a running sum that starts at
// +0 changes nothing (such a sum is never −0).  The step at the extent's
// edge reads zn = 0, which is what it reads past the extent; a row that
// takes no step still writes its t = 0 rows (+0).
//
// The rows are cut into three parts (z⊗z with its masked twin and the t=0
// rows; z⊗zn with the z sums; x⊗x, z⊗x and the x sums), so that a thread
// that takes one part keeps at most d(d+1) running sums in registers (30
// at d=5, the symmetric products' upper triangles); K5's float32 body at
// the compiled (d, l) runs all three in one thread (89 sums at (5, 3),
// within 168 registers).  d and l are template parameters for the
// shapes of the repository's data, with one instantiation at kLongTMax = 8
// for the rest; the loops run over a < d in order either way, so every
// instantiation gives the same bits.

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "markov_common.cuh"

namespace mtm {

constexpr int kLongTMax = 8;

// Row offsets of the g-layout.
struct LongTLayout {
  int d, l, dd, g1, g2, g3, g4, g5, g6, g7, g8, g9, g10, len, one, F;
  __device__ __forceinline__ LongTLayout(int d_, int l_) : d(d_), l(l_), dd(d_ * d_) {
    g1 = 0, g2 = dd, g3 = 2 * dd, g4 = 3 * dd;
    g5 = g4 + l * l, g6 = g5 + d * l, g7 = g6 + dd;
    g8 = g7 + d, g9 = g8 + d, g10 = g9 + l;
    len = g10 + d, one = len + 1, F = one + 1;
  }
};

template <typename T>
__device__ __forceinline__ T finite_or_zero(T v) {
  return isfinite(v) ? v : T(0);
}

// Row (a, b) and row (b, a) of a product z⊗z sum the same products
// (a rounded product does not depend on the order of its factors), so the
// parts sum the upper triangle, b ≥ a, and write each sum to both rows.
// Put both places of (a, b) of a k×k block at row offset `base`.
template <class Put, typename T>
__device__ __forceinline__ void put_sym(Put put, int base, int k, int a, int b, T v) {
  put(base + a * k + b, v);
  if (b != a) put(base + b * k + a, v);
}

// Part 0: g1, g2 (and g6 at t = 0).
template <typename T, int DM>
struct RowsZZ {
  T a1[DM * DM], a2[DM * DM];  // entries with b ≥ a
  __device__ __forceinline__ RowsZZ() {
#pragma unroll
    for (int e = 0; e < DM * DM; ++e) a1[e] = a2[e] = T(0);
  }
  template <bool FIRST, class Put>
  __device__ __forceinline__ void step(const LongTLayout& o, const T (&zc)[DM], T vm, Put put) {
#pragma unroll
    for (int a = 0; a < DM; ++a)
#pragma unroll
      for (int b = a; b < DM; ++b)
        if (b < o.d) {
          const T zz = mul_rn(zc[a], zc[b]);
          a1[a * DM + b] = add_rn(a1[a * DM + b], zz);
          a2[a * DM + b] = add_rn(a2[a * DM + b], mul_rn(vm, zz));
          if constexpr (FIRST) put_sym(put, o.g6, o.d, a, b, add_rn(T(0), zz));
        }
  }
  template <class Put>
  __device__ __forceinline__ void finish(const LongTLayout& o, bool started, Put put) {
#pragma unroll
    for (int a = 0; a < DM; ++a)
#pragma unroll
      for (int b = a; b < DM; ++b)
        if (b < o.d) {
          put_sym(put, o.g1, o.d, a, b, a1[a * DM + b]);
          put_sym(put, o.g2, o.d, a, b, a2[a * DM + b]);
          if (!started) put_sym(put, o.g6, o.d, a, b, T(0));
        }
  }
};

// Part 1: g3, g7, g8 (and g10 at t = 0).
template <typename T, int DM>
struct RowsZN {
  T a3[DM * DM], a7[DM], a8[DM];
  __device__ __forceinline__ RowsZN() {
#pragma unroll
    for (int e = 0; e < DM * DM; ++e) a3[e] = T(0);
#pragma unroll
    for (int a = 0; a < DM; ++a) a7[a] = a8[a] = T(0);
  }
  template <bool FIRST, class Put>
  __device__ __forceinline__ void step(const LongTLayout& o, const T (&zc)[DM], const T (&zn)[DM], T vm,
                                       Put put) {
#pragma unroll
    for (int a = 0; a < DM; ++a) {
      if (a < o.d) {
#pragma unroll
        for (int b = 0; b < DM; ++b)
          if (b < o.d) a3[a * DM + b] = add_rn(a3[a * DM + b], mul_rn(zc[a], mul_rn(zn[b], vm)));
        a7[a] = add_rn(a7[a], mul_rn(vm, zc[a]));
        a8[a] = add_rn(a8[a], zc[a]);
        if constexpr (FIRST) put(o.g10 + a, add_rn(T(0), zc[a]));
      }
    }
  }
  template <class Put>
  __device__ __forceinline__ void finish(const LongTLayout& o, bool started, Put put) {
#pragma unroll
    for (int a = 0; a < DM; ++a) {
      if (a < o.d) {
#pragma unroll
        for (int b = 0; b < DM; ++b)
          if (b < o.d) put(o.g3 + a * o.d + b, a3[a * DM + b]);
        put(o.g7 + a, a7[a]);
        put(o.g8 + a, a8[a]);
        if (!started) put(o.g10 + a, T(0));
      }
    }
  }
};

// Part 2: g4, g5, g9, len, 1 and the zero rows.
template <typename T, int DM, int LM>
struct RowsX {
  T a4[LM * LM], a5[DM * LM], a9[LM];
  __device__ __forceinline__ RowsX() {
#pragma unroll
    for (int e = 0; e < LM * LM; ++e) a4[e] = T(0);
#pragma unroll
    for (int e = 0; e < DM * LM; ++e) a5[e] = T(0);
#pragma unroll
    for (int b = 0; b < LM; ++b) a9[b] = T(0);
  }
  __device__ __forceinline__ void step(const LongTLayout& o, const T (&zc)[DM], const T (&xc)[LM]) {
#pragma unroll
    for (int a = 0; a < LM; ++a) {
      if (a < o.l) {
#pragma unroll
        for (int b = a; b < LM; ++b)  // b ≥ a, as in RowsZZ
          if (b < o.l) a4[a * LM + b] = add_rn(a4[a * LM + b], mul_rn(xc[a], xc[b]));
        a9[a] = add_rn(a9[a], xc[a]);
      }
    }
#pragma unroll
    for (int a = 0; a < DM; ++a)
#pragma unroll
      for (int b = 0; b < LM; ++b)
        if (a < o.d && b < o.l) a5[a * LM + b] = add_rn(a5[a * LM + b], mul_rn(zc[a], xc[b]));
  }
  template <class Put>
  __device__ __forceinline__ void finish(const LongTLayout& o, int len, int Fpad, Put put) {
#pragma unroll
    for (int a = 0; a < LM; ++a) {
      if (a < o.l) {
#pragma unroll
        for (int b = a; b < LM; ++b)
          if (b < o.l) put_sym(put, o.g4, o.l, a, b, a4[a * LM + b]);
        put(o.g9 + a, a9[a]);
      }
    }
#pragma unroll
    for (int a = 0; a < DM; ++a)
#pragma unroll
      for (int b = 0; b < LM; ++b)
        if (a < o.d && b < o.l) put(o.g5 + a * o.l + b, a5[a * LM + b]);
    put(o.len, add_rn(T(0), T(len)));
    put(o.one, T(1));
    for (int f = o.F; f < Fpad; ++f) put(f, T(0));
  }
};

// Part `part` (0, 1 or 2) of instance i's column, read from device memory
// over all T; row f goes to out[f * ostride] (K5).
template <typename T, int DM, int LM, bool FIXED>
__device__ __forceinline__ void longT_rows(int part, const T* __restrict__ z,
                                           const T* __restrict__ x, int64_t n,
                                           int64_t i, int len, int steps,
                                           int d_rt, int l_rt, int Fpad,
                                           T* out, int64_t ostride) {
  const LongTLayout o(FIXED ? DM : d_rt, FIXED ? LM : l_rt);
  auto load = [&](const T* src, int row) { return finite_or_zero(src[(int64_t)row * n + i]); };
  auto put = [&](int row, T v) { out[(int64_t)row * ostride] = v; };
  auto vm_at = [&](int t) { return (len > t + 1 && t < steps - 1) ? T(1) : T(0); };
  if (part == 0) {
    RowsZZ<T, DM> r;
    for (int t = 0; t < steps; ++t) {
      T zc[DM];
#pragma unroll
      for (int a = 0; a < DM; ++a)
        if (a < o.d) zc[a] = load(z, t * o.d + a);
      if (t == 0) r.template step<true>(o, zc, vm_at(t), put);
      else r.template step<false>(o, zc, vm_at(t), put);
    }
    r.finish(o, true, put);
  } else if (part == 1) {
    RowsZN<T, DM> r;
    for (int t = 0; t < steps; ++t) {
      const int tn = t + 1 < steps ? t + 1 : steps - 1;
      T zc[DM], zn[DM];
#pragma unroll
      for (int a = 0; a < DM; ++a)
        if (a < o.d) {
          zc[a] = load(z, t * o.d + a);
          zn[a] = load(z, tn * o.d + a);
        }
      if (t == 0) r.template step<true>(o, zc, zn, vm_at(t), put);
      else r.template step<false>(o, zc, zn, vm_at(t), put);
    }
    r.finish(o, true, put);
  } else {
    RowsX<T, DM, LM> r;
    for (int t = 0; t < steps; ++t) {
      T zc[DM], xc[LM];
#pragma unroll
      for (int a = 0; a < DM; ++a)
        if (a < o.d) zc[a] = load(z, t * o.d + a);
#pragma unroll
      for (int b = 0; b < LM; ++b)
        if (b < o.l) xc[b] = load(x, t * o.l + b);
      r.step(o, zc, xc);
    }
    r.finish(o, len, Fpad, put);
  }
}

}  // namespace mtm
