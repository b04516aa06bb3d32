// K2: materialize the per-instance Markov EM feature matrix Φ.
//
// Replaces the TPU kernel ops/pallas_markov.py:markov_materialize_features
// (body _markov_feat_kernel -> _packed_acc_build) of the JAX package.
//
// Input: the packed batch u (T*s, n), row t*s + r holding [z_t; x_t; 0]
// of step t (NaN -> 0), and the per-instance lengths (n,).  Output:
// Φ (Fc_pad, n), one row per ACC row that the g-layout references
// (markov_compact_spec), rows Fc..Fc_pad zero.  Each row is one of
//
//   A  (k, r): Σ_t u[ts+r] · u[ts+r+k]       (products past T*s are 0)
//   B  (k, r): Σ_{t+1<len} u[ts+r] · u[ts+r+k]   (r + k < s)
//   F0 (k, r): u[r] · u[r+k]
//   AID (r):   Σ_t u[ts+r]
//   AVM (r):   Σ_{t+1<len} u[ts+r]
//   U0  (r):   u[r]
//   LEN, ONE, ZERO
//
// described by a host-built table desc (Fc, 3) = (kind, k, r), so both
// packages share one layout definition.  The TPU kernel built every ACC
// row and then compacted them with a 0/1 selection GEMM; here each thread
// computes only the referenced rows, so no GEMM remains.  The TPU kernel
// gets the vm_{t+1}-masked rows (B, AVM) by subtracting the last step's
// products; this kernel sums the masked products directly (equal to
// round-off on NaN-suffix data, whose steps past len are zero).
//
// Bound on the card: the bytes of u read plus Φ written (about 0.77 GB at
// n=1e6, T=10, d=5, l=3 in f32), once per fit.  Design: one thread per
// instance column, rows in the outer loop, so every load of u[row, i] and
// every store of Φ[f, i] is coalesced across the warp; a column's repeated
// reads of u hit L1/L2.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

enum RowKind {
  ROW_A = 0,
  ROW_B = 1,
  ROW_F0 = 2,
  ROW_AID = 3,
  ROW_AVM = 4,
  ROW_U0 = 5,
  ROW_LEN = 6,
  ROW_ONE = 7,
  ROW_ZERO = 8,
};

template <typename T>
__global__ void markov_features_kernel(const T* __restrict__ u,
                                       const int* __restrict__ lens,
                                       const int* __restrict__ desc,
                                       T* __restrict__ phi, int64_t n,
                                       int steps, int s, int Fc,
                                       int Fc_pad) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int Ts = steps * s;
  const int len = lens[i];
  const T* ui = u + i;  // element (row, i) is ui[row * n]
  for (int f = 0; f < Fc; ++f) {
    const int kind = desc[3 * f];
    const int k = desc[3 * f + 1];
    const int r = desc[3 * f + 2];
    T acc = T(0);
    switch (kind) {
      case ROW_A:
        for (int t = 0; t < steps; ++t) {
          const int a = t * s + r;
          if (a + k < Ts) acc += ui[(int64_t)a * n] * ui[(int64_t)(a + k) * n];
        }
        break;
      case ROW_B:
        for (int t = 0; t + 1 < len && t < steps; ++t) {
          const int a = t * s + r;
          acc += ui[(int64_t)a * n] * ui[(int64_t)(a + k) * n];
        }
        break;
      case ROW_F0:
        acc = ui[(int64_t)r * n] * ui[(int64_t)(r + k) * n];
        break;
      case ROW_AID:
        for (int t = 0; t < steps; ++t) acc += ui[(int64_t)(t * s + r) * n];
        break;
      case ROW_AVM:
        for (int t = 0; t + 1 < len && t < steps; ++t)
          acc += ui[(int64_t)(t * s + r) * n];
        break;
      case ROW_U0:
        acc = ui[(int64_t)r * n];
        break;
      case ROW_LEN:
        acc = T(len);
        break;
      case ROW_ONE:
        acc = T(1);
        break;
      default:
        break;
    }
    phi[(int64_t)f * n + i] = acc;
  }
  for (int f = Fc; f < Fc_pad; ++f) phi[(int64_t)f * n + i] = T(0);
}

template <typename T>
int launch(const void* u, const int* lens, const int* desc, void* phi,
           int64_t n, int steps, int s, int Fc, int Fc_pad,
           cudaStream_t stream) {
  const int threads = 256;
  const int64_t blocks = (n + threads - 1) / threads;
  markov_features_kernel<T><<<(unsigned)blocks, threads, 0, stream>>>(
      static_cast<const T*>(u), lens, desc, static_cast<T*>(phi), n, steps,
      s, Fc, Fc_pad);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 float32, 1 float64.  Returns a cudaError_t (0 on success), or
// -1 for an argument the kernel does not take.
extern "C" int mtm_markov_features(int device, int dtype, const void* u,
                                   const void* lens, const void* desc,
                                   void* phi, long long n, int steps, int s,
                                   int Fc, int Fc_pad, void* stream) {
  if (n <= 0 || steps <= 0 || s <= 0 || Fc > Fc_pad) return -1;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const int* lens_i = static_cast<const int*>(lens);
  const int* desc_i = static_cast<const int*>(desc);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(u, lens_i, desc_i, phi, n, steps, s, Fc, Fc_pad, st);
  if (dtype == 1)
    return launch<double>(u, lens_i, desc_i, phi, n, steps, s, Fc, Fc_pad,
                          st);
  return -1;
}
