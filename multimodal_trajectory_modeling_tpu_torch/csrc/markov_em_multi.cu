// K3: markov_em_from_features_multi of ops/pallas_markov.py (the JAX
// package).  Int16 Φ goes to the tensor-core body of
// markov_em_multi_mma.cu; wide Φ (float32, float64) to the kernel body of
// markov_em_multi.cuh, with Φ read from device memory.

#include "markov_em_multi.cuh"

extern "C" int mtm_markov_em_multi_i16(
    int w_kind, const void* phi, const void* prev, const void* force,
    const void* wc, void* assign, void* part_stats, void* part_counts,
    void* part_sw, void* part_obj, void* macc, void* counts, void* switches,
    void* obj, long long n, int Fcp, int C, int R, int chunk, int sub,
    int argmax, void* stream);

// K3.  phi_kind: 0 int16, 1 float32, 2 float64; w_kind: 1 float32,
// 2 float64, with the type pairs of mtm_markov_em.  prev and assign are
// (R, n), force (R,), wc (R, C, Fcp), macc (R, Fcp, C), counts (R, C),
// switches and obj (R,).  Partial buffers hold ceil(n / chunk) blocks of
// R restarts, the objective's ceil(n / sub); sub divides chunk.  Returns a cudaError_t (0 on success), or -1 for an
// argument the kernel does not take.
extern "C" int mtm_markov_em_multi(
    int device, int phi_kind, int w_kind, const void* phi, const void* prev,
    const void* force, const void* wc, void* assign, void* part_stats,
    void* part_counts, void* part_sw, void* part_obj, void* macc,
    void* counts, void* switches, void* obj, long long n, int Fcp, int C,
    int R, int chunk, int sub, int argmax, void* stream) {
  if (!args_ok(n, Fcp, C, R, chunk, sub)) return -1;
  if (phi_kind == 0 && chunk > 65536) return -1;  // int32 block sums
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (phi_kind == 0)
    return mtm_markov_em_multi_i16(w_kind, phi, prev, force, wc, assign,
                                   part_stats, part_counts, part_sw, part_obj,
                                   macc, counts, switches, obj, n, Fcp, C, R,
                                   chunk, sub, argmax, stream);
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
  if (phi_kind == 1 && w_kind == 1)
    return dispatch<float, float, true, false>(a, am);
  if (phi_kind == 2 && w_kind == 2)
    return dispatch<double, double, true, false>(a, am);
  return -1;
}
