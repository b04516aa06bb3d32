// K5: the per-instance Markov EM features Φ in the canonical layout, for
// any T.
//
// Replaces the TPU kernel ops/pallas_markov.py:markov_materialize_features_longT
// (body _markov_feat_grid_kernel) of the JAX package.
//
// The column build is markov_longT_rows.cuh:longT_rows (shared with
// K6/K10/K11, which build the same Φ in shared memory): the rows of the
// g-layout, each summed over t in order, every product and sum rounded on
// its own, so Φ equals its plain torch version bit for bit, and two calls
// agree.
//
// Bound on the card: bytes, z_t and x_t read once and Φ written once
// (1.0 GB + 144 MB at T=128, n=2.5e5, d=5, l=3 in float32: 0.34 ms at
// 3.35 TB/s).  Design:
// - threads run along n, so every load of z_t, x_t and every store of Φ is
//   coalesced across the warp;
// - each block of the grid's fast axis builds one of the three row parts
//   of longT_rows for its instance tile, so a thread keeps at most 2·d²
//   running sums in registers;
// - the three blocks of one instance tile run together, so the parts that
//   read the same z_t and x_t slices find them in L2.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "markov_longT_rows.cuh"

namespace {

using mtm::kLongTMax;
using mtm::longT_rows;

constexpr int kThreads = 128;
constexpr int kMaxGridY = 65535;

template <typename T, int DM, int LM, bool FIXED>
__global__ void __launch_bounds__(kThreads)
    features_longT_kernel(const T* __restrict__ z, const T* __restrict__ x,
                          const int* __restrict__ lens, T* __restrict__ phi,
                          int64_t n, int steps, int d_rt, int l_rt, int Fpad,
                          int ntiles) {
  for (int tile = blockIdx.y; tile < ntiles; tile += gridDim.y) {
    const int64_t i = (int64_t)tile * blockDim.x + threadIdx.x;
    if (i >= n) continue;
    // one part of the rows per block of the grid's fast axis
    longT_rows<T, DM, LM, FIXED>(blockIdx.x, z, x, n, i, lens[i], steps,
                                 d_rt, l_rt, Fpad, phi + i, n);
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
  return run<T, kLongTMax, kLongTMax, false>(z, x, lens, phi, n, steps, d, l, Fpad, s);
}

}  // namespace

// The largest d and l the kernel takes.
extern "C" int mtm_markov_features_longT_max_dim() { return kLongTMax; }

// kind: 0 float32, 1 float64.  Returns a cudaError_t (0 on success), or -1
// for an argument the kernel does not take.
extern "C" int mtm_markov_features_longT(int device, int kind, const void* z,
                                         const void* x, const void* lens,
                                         void* phi, long long n, int steps,
                                         int d, int l, int Fpad,
                                         void* stream) {
  if (n <= 0 || steps <= 0 || d < 1 || l < 1 || d > kLongTMax || l > kLongTMax)
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
