// The canonical Φ column of one instance, built from the transposed batch:
// shared by K5 (markov_features_longT.cu), which writes it to device
// memory, and K6/K10/K11 (markov_em_batch.cu), which build it into shared
// memory and score it there.  Both therefore hold the same Φ bit for bit.
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
// The rows are cut into three parts (z⊗z with its masked twin and the t=0
// rows; z⊗zn with the z sums; x⊗x, z⊗x and the x sums), so that one thread
// keeps at most 2·d² running sums in registers (50 at d=5; one thread
// holding all 144 would spill).  d and l are template parameters for the
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

// Part `part` (0, 1 or 2) of instance i's column; row f goes to
// out[f * ostride].
template <typename T, int DM, int LM, bool FIXED>
__device__ __forceinline__ void longT_rows(int part, const T* __restrict__ z,
                                           const T* __restrict__ x, int64_t n,
                                           int64_t i, int len, int steps,
                                           int d_rt, int l_rt, int Fpad,
                                           T* out, int64_t ostride) {
  const int d = FIXED ? DM : d_rt;
  const int l = FIXED ? LM : l_rt;
  const int dd = d * d;
  const int o_g1 = 0, o_g2 = dd, o_g3 = 2 * dd, o_g4 = 3 * dd;
  const int o_g5 = o_g4 + l * l, o_g6 = o_g5 + d * l, o_g7 = o_g6 + dd;
  const int o_g8 = o_g7 + d, o_g9 = o_g8 + d, o_g10 = o_g9 + l;
  const int o_len = o_g10 + d, o_one = o_len + 1, F = o_one + 1;
  auto load = [&](const T* src, int row) {
    const T v = src[(int64_t)row * n + i];
    return isfinite(v) ? v : T(0);
  };
  auto put = [&](int row, T v) { out[(int64_t)row * ostride] = v; };
  if (part == 0) {  // g1, g2 (and g6 at t = 0)
    T a1[DM * DM], a2[DM * DM];
#pragma unroll
    for (int e = 0; e < DM * DM; ++e) a1[e] = a2[e] = T(0);
    for (int t = 0; t < steps; ++t) {
      T zc[DM];
#pragma unroll
      for (int a = 0; a < DM; ++a)
        if (a < d) zc[a] = load(z, t * d + a);
      const T vm = (len > t + 1 && t < steps - 1) ? T(1) : T(0);
#pragma unroll
      for (int a = 0; a < DM; ++a)
#pragma unroll
        for (int b = 0; b < DM; ++b)
          if (a < d && b < d) {
            const T zz = mul_rn(zc[a], zc[b]);
            a1[a * DM + b] = add_rn(a1[a * DM + b], zz);
            a2[a * DM + b] = add_rn(a2[a * DM + b], mul_rn(vm, zz));
            if (t == 0) put(o_g6 + a * d + b, add_rn(T(0), zz));
          }
    }
#pragma unroll
    for (int a = 0; a < DM; ++a)
#pragma unroll
      for (int b = 0; b < DM; ++b)
        if (a < d && b < d) {
          put(o_g1 + a * d + b, a1[a * DM + b]);
          put(o_g2 + a * d + b, a2[a * DM + b]);
        }
  } else if (part == 1) {  // g3, g7, g8 (and g10 at t = 0)
    T a3[DM * DM], a7[DM], a8[DM];
#pragma unroll
    for (int e = 0; e < DM * DM; ++e) a3[e] = T(0);
#pragma unroll
    for (int a = 0; a < DM; ++a) a7[a] = a8[a] = T(0);
    for (int t = 0; t < steps; ++t) {
      const int tn = t + 1 < steps ? t + 1 : steps - 1;
      T zc[DM], zn[DM];
#pragma unroll
      for (int a = 0; a < DM; ++a)
        if (a < d) {
          zc[a] = load(z, t * d + a);
          zn[a] = load(z, tn * d + a);
        }
      const T vm = (len > t + 1 && t < steps - 1) ? T(1) : T(0);
#pragma unroll
      for (int a = 0; a < DM; ++a) {
        if (a < d) {
#pragma unroll
          for (int b = 0; b < DM; ++b)
            if (b < d)
              a3[a * DM + b] =
                  add_rn(a3[a * DM + b], mul_rn(zc[a], mul_rn(zn[b], vm)));
          a7[a] = add_rn(a7[a], mul_rn(vm, zc[a]));
          a8[a] = add_rn(a8[a], zc[a]);
          if (t == 0) put(o_g10 + a, add_rn(T(0), zc[a]));
        }
      }
    }
#pragma unroll
    for (int a = 0; a < DM; ++a) {
      if (a < d) {
#pragma unroll
        for (int b = 0; b < DM; ++b)
          if (b < d) put(o_g3 + a * d + b, a3[a * DM + b]);
        put(o_g7 + a, a7[a]);
        put(o_g8 + a, a8[a]);
      }
    }
  } else {  // g4, g5, g9, len, 1 and the zero rows
    T a4[LM * LM], a5[DM * LM], a9[LM];
#pragma unroll
    for (int e = 0; e < LM * LM; ++e) a4[e] = T(0);
#pragma unroll
    for (int e = 0; e < DM * LM; ++e) a5[e] = T(0);
#pragma unroll
    for (int b = 0; b < LM; ++b) a9[b] = T(0);
    for (int t = 0; t < steps; ++t) {
      T zc[DM], xc[LM];
#pragma unroll
      for (int a = 0; a < DM; ++a)
        if (a < d) zc[a] = load(z, t * d + a);
#pragma unroll
      for (int b = 0; b < LM; ++b)
        if (b < l) xc[b] = load(x, t * l + b);
#pragma unroll
      for (int a = 0; a < LM; ++a) {
        if (a < l) {
#pragma unroll
          for (int b = 0; b < LM; ++b)
            if (b < l)
              a4[a * LM + b] = add_rn(a4[a * LM + b], mul_rn(xc[a], xc[b]));
          a9[a] = add_rn(a9[a], xc[a]);
        }
      }
#pragma unroll
      for (int a = 0; a < DM; ++a)
#pragma unroll
        for (int b = 0; b < LM; ++b)
          if (a < d && b < l)
            a5[a * LM + b] = add_rn(a5[a * LM + b], mul_rn(zc[a], xc[b]));
    }
#pragma unroll
    for (int a = 0; a < LM; ++a) {
      if (a < l) {
#pragma unroll
        for (int b = 0; b < LM; ++b)
          if (b < l) put(o_g4 + a * l + b, a4[a * LM + b]);
        put(o_g9 + a, a9[a]);
      }
    }
#pragma unroll
    for (int a = 0; a < DM; ++a)
#pragma unroll
      for (int b = 0; b < LM; ++b)
        if (a < d && b < l) put(o_g5 + a * l + b, a5[a * LM + b]);
    put(o_len, add_rn(T(0), T(len)));
    put(o_one, T(1));
    for (int f = F; f < Fpad; ++f) put(f, T(0));
  }
}

}  // namespace mtm
