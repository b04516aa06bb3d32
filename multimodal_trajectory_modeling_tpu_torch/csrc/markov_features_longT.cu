// K5: the per-instance Markov EM features Φ in the canonical layout, for
// any T.
//
// Replaces the TPU kernel ops/pallas_markov.py:markov_materialize_features_longT
// (body _markov_feat_grid_kernel) of the JAX package.
//
// Input: z_t (T*d, n) and x_t (T*l, n), NaN (any non-finite value) read as
// 0, and the per-instance lengths (n,).  Output: Φ (F_pad, n), the rows of
// the g-layout (ops/markov_kernels.py:_canonical_offsets), each summed over
// t = 0..T-1 in order, with vm = (len > t+1) and (t < T-1) and zn the slice
// at min(t+1, T-1):
//   g1 z⊗z   g2 vm·(z⊗z)   g3 z⊗(zn·vm)   g4 x⊗x   g5 z⊗x
//   g7 vm·z  g8 z          g9 x
// and from t = 0 alone: g6 z⊗z, g10 z, len, 1; rows F..F_pad are 0.
// Products and sums are rounded one at a time (no fused multiply-add), so
// Φ equals its plain torch version bit for bit, and two calls agree.
//
// Bound on the card: bytes, z_t and x_t read once and Φ written once
// (1.0 GB + 144 MB at T=128, n=2.5e5, d=5, l=3 in float32: 0.34 ms at
// 3.35 TB/s).  Design:
// - threads run along n, so every load of z_t, x_t and every store of Φ is
//   coalesced across the warp;
// - the rows are cut into three parts (z⊗z with its masked twin and t=0
//   rows; z⊗zn with the z sums; x⊗x, z⊗x and the x sums), one per block
//   of the grid's fast axis, so each thread keeps at most 2·d² running
//   sums in registers (50 at d=5; one thread holding all 144 would spill);
// - the three blocks of one instance tile run together, so the parts that
//   read the same z_t and x_t slices find them in L2;
// - d and l are template parameters (the shapes of the repository's data
//   exactly, and one instantiation at kMax = 8 for the rest).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "markov_common.cuh"

namespace {

using mtm::add_rn;
using mtm::mul_rn;

constexpr int kThreads = 128;
constexpr int kMax = 8;
constexpr int kMaxGridY = 65535;

template <typename T, int DM, int LM, bool FIXED>
__global__ void __launch_bounds__(kThreads)
    features_longT_kernel(const T* __restrict__ z, const T* __restrict__ x,
                          const int* __restrict__ lens, T* __restrict__ phi,
                          int64_t n, int steps, int d_rt, int l_rt, int Fpad,
                          int ntiles) {
  const int d = FIXED ? DM : d_rt;
  const int l = FIXED ? LM : l_rt;
  const int dd = d * d;
  const int o_g1 = 0, o_g2 = dd, o_g3 = 2 * dd, o_g4 = 3 * dd;
  const int o_g5 = o_g4 + l * l, o_g6 = o_g5 + d * l, o_g7 = o_g6 + dd;
  const int o_g8 = o_g7 + d, o_g9 = o_g8 + d, o_g10 = o_g9 + l;
  const int o_len = o_g10 + d, o_one = o_len + 1, F = o_one + 1;
  const int part = blockIdx.x;

  for (int tile = blockIdx.y; tile < ntiles; tile += gridDim.y) {
    const int64_t i = (int64_t)tile * blockDim.x + threadIdx.x;
    if (i >= n) continue;
    const int len = lens[i];
    T* out = phi + i;  // row f of this instance: out[f * n]
    auto load = [&](const T* src, int row) {
      const T v = src[(int64_t)row * n + i];
      return isfinite(v) ? v : T(0);
    };
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
              if (t == 0) out[(int64_t)(o_g6 + a * d + b) * n] = add_rn(T(0), zz);
            }
      }
#pragma unroll
      for (int a = 0; a < DM; ++a)
#pragma unroll
        for (int b = 0; b < DM; ++b)
          if (a < d && b < d) {
            out[(int64_t)(o_g1 + a * d + b) * n] = a1[a * DM + b];
            out[(int64_t)(o_g2 + a * d + b) * n] = a2[a * DM + b];
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
                a3[a * DM + b] = add_rn(a3[a * DM + b], mul_rn(zc[a], mul_rn(zn[b], vm)));
            a7[a] = add_rn(a7[a], mul_rn(vm, zc[a]));
            a8[a] = add_rn(a8[a], zc[a]);
            if (t == 0) out[(int64_t)(o_g10 + a) * n] = add_rn(T(0), zc[a]);
          }
        }
      }
#pragma unroll
      for (int a = 0; a < DM; ++a) {
        if (a < d) {
#pragma unroll
          for (int b = 0; b < DM; ++b)
            if (b < d) out[(int64_t)(o_g3 + a * d + b) * n] = a3[a * DM + b];
          out[(int64_t)(o_g7 + a) * n] = a7[a];
          out[(int64_t)(o_g8 + a) * n] = a8[a];
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
              if (b < l) a4[a * LM + b] = add_rn(a4[a * LM + b], mul_rn(xc[a], xc[b]));
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
            if (b < l) out[(int64_t)(o_g4 + a * l + b) * n] = a4[a * LM + b];
          out[(int64_t)(o_g9 + a) * n] = a9[a];
        }
      }
#pragma unroll
      for (int a = 0; a < DM; ++a)
#pragma unroll
        for (int b = 0; b < LM; ++b)
          if (a < d && b < l) out[(int64_t)(o_g5 + a * l + b) * n] = a5[a * LM + b];
      out[(int64_t)o_len * n] = add_rn(T(0), T(len));
      out[(int64_t)o_one * n] = T(1);
      for (int f = F; f < Fpad; ++f) out[(int64_t)f * n] = T(0);
    }
  }
}

template <typename T, int DM, int LM, bool FIXED>
int run(const void* z, const void* x, const int* lens, void* phi, int64_t n,
        int steps, int d, int l, int Fpad, cudaStream_t stream) {
  const int64_t tiles = (n + kThreads - 1) / kThreads;
  const dim3 grid(3, (unsigned)(tiles < kMaxGridY ? tiles : kMaxGridY));
  features_longT_kernel<T, DM, LM, FIXED><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(z), static_cast<const T*>(x), lens,
      static_cast<T*>(phi), n, steps, d, l, Fpad, (int)tiles);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* z, const void* x, const int* lens, void* phi,
             int64_t n, int steps, int d, int l, int Fpad, cudaStream_t s) {
#define MTM_LONGT_SHAPE(DD, LL)                                              \
  if (d == DD && l == LL)                                                    \
    return run<T, DD, LL, true>(z, x, lens, phi, n, steps, d, l, Fpad, s);
  MTM_LONGT_SHAPE(5, 3)  // the benchmark shape
  MTM_LONGT_SHAPE(2, 4)  // ADNI
  MTM_LONGT_SHAPE(2, 3)
  MTM_LONGT_SHAPE(3, 2)
  MTM_LONGT_SHAPE(1, 3)
  MTM_LONGT_SHAPE(1, 1)
#undef MTM_LONGT_SHAPE
  return run<T, kMax, kMax, false>(z, x, lens, phi, n, steps, d, l, Fpad, s);
}

}  // namespace

// The largest d and l the kernel takes.
extern "C" int mtm_markov_features_longT_max_dim() { return kMax; }

// kind: 0 float32, 1 float64.  Returns a cudaError_t (0 on success), or -1
// for an argument the kernel does not take.
extern "C" int mtm_markov_features_longT(int device, int kind, const void* z,
                                         const void* x, const void* lens,
                                         void* phi, long long n, int steps,
                                         int d, int l, int Fpad,
                                         void* stream) {
  if (n <= 0 || steps <= 0 || d < 1 || l < 1 || d > kMax || l > kMax)
    return -1;
  if (Fpad < 4 * d * d + l * l + d * l + 3 * d + l + 2) return -1;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const int* lens_i = static_cast<const int*>(lens);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (kind == 0)
    return dispatch<float>(z, x, lens_i, phi, (int64_t)n, steps, d, l, Fpad, s);
  if (kind == 1)
    return dispatch<double>(z, x, lens_i, phi, (int64_t)n, steps, d, l, Fpad, s);
  return -1;
}
