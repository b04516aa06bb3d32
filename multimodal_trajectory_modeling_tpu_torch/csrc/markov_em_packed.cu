// K4a and K4b: markov_em_fused_packed and markov_em_fused_packed_multi of
// ops/pallas_markov.py (the JAX package).  Float32 K4b goes to the
// tensor-core body of markov_em_packed_mma.cu, float32 K4a to the staged
// body of markov_em_packed_one.cu; float64 K4a and K4b to the kernel body
// of markov_em_multi.cuh, with each instance's Φ column built in shared
// memory from u in device memory.  That body also takes float32 K4a where
// the host plan finds no tile that fits shared memory: past about 1 500
// rows of u, which only a direct call of markov_em_fused_packed sends (the
// trainers pack u only up to T·s = 512, where a plan always fits).

#include "markov_em_multi.cuh"

extern "C" int mtm_markov_em_packed_f32(
    const void* u, const void* lens, const void* desc, const void* prev, const void* force,
    const void* wc, void* assign, void* part_stats, void* part_counts, void* part_sw,
    void* part_obj, void* macc, void* counts, void* switches, void* obj, long long n, int steps,
    int s, int Fc, int Fcp, int C, int R, int chunk, int sub, int argmax, int nt, int rg, int cs,
    void* stream);
extern "C" int mtm_markov_em_packed_one(const void* u, const void* lens, const void* desc, const void* prev,
                                        const void* wc, void* assign, void* part_stats, void* part_counts,
                                        void* part_sw, void* part_obj, void* macc, void* counts, void* switches,
                                        void* obj, long long n, int steps, int s, int d, int l, int Fc, int Fcp,
                                        int C, int sub, int argmax, int nt, int q, int ring, int grid,
                                        void* stream);

// K4a (strict = 0, R = 1) and K4b (strict = 1).  w_kind: 1 float32,
// 2 float64, also the type of u.  u is (steps * s, n), lens (n,), desc
// (Fc, 3) the ACC-row table of the compact rows; the rest as for
// mtm_markov_em_multi, with Φ's Fcp rows built per call.  The host plan
// (ops/markov_kernels.py), unread by the header's body: float32 K4b's
// (packed_mma_plan) tile nt, restarts a block rg and blocks a cluster cs;
// float32 K4a's (packed_one_plan) tile nt (0: the header's body), threads
// an instance rg, ring depth cs and the persistent grid, whose blocks the
// partial buffers then hold (part_obj: n + ceil(n / sub) floats), with
// the batch's d and l.
extern "C" int mtm_markov_em_packed(
    int device, int w_kind, const void* u, const void* lens,
    const void* desc, const void* prev, const void* force, const void* wc,
    void* assign, void* part_stats, void* part_counts, void* part_sw,
    void* part_obj, void* macc, void* counts, void* switches, void* obj,
    long long n, int steps, int s, int Fc, int Fcp, int C, int R, int chunk,
    int sub, int argmax, int strict, int nt, int rg, int cs, int d, int l, int grid,
    void* stream) {
  if (!args_ok(n, Fcp, C, R, chunk, sub) || steps <= 0 || s <= 0 || Fc > Fcp)
    return -1;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (w_kind == 1 && strict)
    return mtm_markov_em_packed_f32(u, lens, desc, prev, force, wc, assign, part_stats,
                                    part_counts, part_sw, part_obj, macc, counts, switches, obj, n,
                                    steps, s, Fc, Fcp, C, R, chunk, sub, argmax, nt, rg, cs,
                                    stream);
  if (w_kind == 1 && nt > 0)
    return R == 1 ? mtm_markov_em_packed_one(u, lens, desc, prev, wc, assign, part_stats, part_counts,
                                             part_sw, part_obj, macc, counts, switches, obj, n, steps, s,
                                             d, l, Fc, Fcp, C, sub, argmax, nt, rg, cs, grid, stream)
                  : -1;
  MultiArgs a{nullptr,
              u,
              static_cast<const int*>(lens),
              static_cast<const int*>(desc),
              steps,
              s,
              Fc,
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
  if (w_kind == 1) return dispatch<float, float, false, true>(a, am);
  if (w_kind == 2)
    return strict ? dispatch<double, double, true, true>(a, am)
                  : dispatch<double, double, false, true>(a, am);
  return -1;
}
