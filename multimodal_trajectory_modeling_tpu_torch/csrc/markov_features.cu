// K2: materialize the per-instance Markov EM feature matrix Φ.
//
// Replaces the TPU kernel ops/pallas_markov.py:markov_materialize_features
// (body _markov_feat_kernel -> _packed_acc_build) of the JAX package.
//
// Input: the packed batch u (T*s, n), row t*s + r holding [z_t; x_t; 0]
// of step t (NaN -> 0), and the per-instance lengths (n,).  Output:
// Φ (Fc_pad, n), one row per ACC row that the g-layout references
// (markov_compact_spec), rows Fc..Fc_pad zero.  Each row is one ACC row
// (markov_common.cuh:acc_row), described by a host-built table desc
// (Fc, 3) = (kind, k, r), so both packages share one layout definition.
// The TPU kernel built every ACC row and then compacted them with a 0/1
// selection GEMM; here each thread computes only the referenced rows, so
// no GEMM remains.
//
// Bound on the card: the bytes of u read plus Φ written (about 0.77 GB at
// n=1e6, T=10, d=5, l=3 in f32), once per fit.  Design: one thread per
// instance column, rows in the outer loop, so every load of u[row, i] and
// every store of Φ[f, i] is coalesced across the warp; a column's repeated
// reads of u hit L1/L2.

#include <cuda_runtime.h>
#include <stdint.h>

#include "markov_common.cuh"

namespace {

template <typename T>
__global__ void markov_features_kernel(const T* __restrict__ u,
                                       const int* __restrict__ lens,
                                       const int* __restrict__ desc,
                                       T* __restrict__ phi, int64_t n,
                                       int steps, int s, int Fc,
                                       int Fc_pad) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int len = lens[i];
  const T* ui = u + i;  // element (row, i) is ui[row * n]
  for (int f = 0; f < Fc; ++f)
    phi[(int64_t)f * n + i] = mtm::acc_row<T>(
        desc[3 * f], desc[3 * f + 1], desc[3 * f + 2], ui, n, len, steps, s);
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
