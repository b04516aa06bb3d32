// What the two float32 bodies that build Φ step-outer from a staged tile of
// the packed batch share: float32 K4a (markov_em_packed_one.cu), which
// builds a Φ tile into shared memory and scores it there, and K2
// (markov_features.cu), which stores the rows straight to Φ in device
// memory.
//
// - stage_packed_tile: a tile's u (T·s rows × NT) and lengths into shared
//   memory by cp.async (16 bytes where `aligned`, else 4), zero past n;
// - Fixed<D, L>: the compile-time ACC-row table of a fixed (d, l)
//   (markov_acc_table.cuh);
// - Part<Sh, Q, P>, build_part, build_fixed: the step-outer build.  Part P
//   of Q threads an instance owns the rows f ≡ P (mod Q) in registers;
//   for each step t it holds the step's s values of u and the next step's,
//   loaded once from the staged tile, and adds each owned row's term for
//   that step.  Each row is still summed over t in increasing order with
//   markov_common.cuh:acc_row's operations and masks, so every Φ entry
//   equals acc_row's bit for bit.  The rows leave through a sink, sink(f,
//   value), which writes a shared-memory tile (K4a) or Φ itself (K2).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include <utility>

#include "markov_acc_table.cuh"
#include "markov_common.cuh"

namespace mtm {

__device__ __forceinline__ void cp_async16(void* dst, const void* src, int bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src), "r"(bytes) : "memory");
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src, int bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src), "r"(bytes) : "memory");
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
// Wait until at most `pending` (0 or 1) of this thread's groups are in flight.
__device__ __forceinline__ void cp_async_wait(int pending) {
  if (pending == 0)
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  else
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// The block's copies of instances i0 .. i0 + NT - 1 (NT a power of two ≥ 32)
// of the packed batch u (Ts, n) and of their lengths into du (Ts, NT) and
// dl (NT), zero past n; the caller commits the group.  `aligned`: n % 4 == 0
// and u, lens 16-byte aligned, so four instances move in one 16-byte copy
// (all in or all out).
__device__ __forceinline__ void stage_packed_tile(float* du, int* dl, const float* __restrict__ u,
                                                  const int* __restrict__ lens, int64_t n, int64_t i0, int NT,
                                                  int Ts, int aligned) {
  const int tid = threadIdx.x, nthreads = blockDim.x;
  if (aligned) {
    const int q4 = NT / 4, l4 = __ffs(q4) - 1;
    for (int e = tid; e < (Ts + 1) * q4; e += nthreads) {
      const int a = e >> l4, c4 = 4 * (e & (q4 - 1));
      const int64_t i = i0 + c4;
      const bool in = i < n;
      if (a < Ts)
        cp_async16(du + a * NT + c4, in ? u + (int64_t)a * n + i : u, in ? 16 : 0);
      else
        cp_async16(dl + c4, in ? lens + i : lens, in ? 16 : 0);
    }
  } else {
    const int lt = __ffs(NT) - 1;
    for (int e = tid; e < (Ts + 1) * NT; e += nthreads) {
      const int a = e >> lt, c = e & (NT - 1);
      const int64_t i = i0 + c;
      const bool in = i < n;
      if (a < Ts)
        cp_async4(du + a * NT + c, in ? u + (int64_t)a * n + i : u, in ? 4 : 0);
      else
        cp_async4(dl + c, in ? lens + i : lens, in ? 4 : 0);
    }
  }
}

// The compile-time table of a fixed (d, l); its entries are read only in
// constant expressions, through these functions.
template <int D, int L>
struct Fixed {
  static constexpr int S = 8 * ((D + L + 7) / 8);
  static constexpr AccTable kTable = make_acc_table(D, L);
  __host__ __device__ static constexpr int fc() { return kTable.fc; }
  __host__ __device__ static constexpr int kind(int f) { return kTable.kind[f]; }
  __host__ __device__ static constexpr int shift(int f) { return kTable.k[f]; }
  __host__ __device__ static constexpr int row(int f) { return kTable.r[f]; }
};

// Part P of Q of an instance's rows (f = P, P + Q, ...) in registers: each
// row's value before step 0 (F0 and U0 rows take theirs from step 0
// alone), its term at each step t (none past the masks of acc_row), and
// its entry of the Φ column.
template <class Sh, int Q, int P>
struct Part {
  static constexpr int S = Sh::S;
  static constexpr int NR = Sh::fc() > P ? (Sh::fc() - P + Q - 1) / Q : 0;
  using Rows = std::make_integer_sequence<int, NR>;
  float acc[NR > 0 ? NR : 1];

  template <int M>
  __device__ __forceinline__ void init(const float (&cur)[S]) {
    constexpr int f = P + M * Q, kind = Sh::kind(f), k = Sh::shift(f), r = Sh::row(f);
    if constexpr (kind == ROW_F0) {
      static_assert(r + k < S, "an F0 row reads one step");
      acc[M] = cur[r] * cur[r + k];
    } else if constexpr (kind == ROW_U0) {
      acc[M] = cur[r];
    } else {
      acc[M] = 0.f;
    }
  }
  // step t's term: `more` is t + 1 < T (A rows past the step read the
  // next one, none at the last), `on` is t + 1 < len (B and AVM rows)
  template <int M>
  __device__ __forceinline__ void step(const float (&cur)[S], const float (&nxt)[S], bool more, bool on) {
    constexpr int f = P + M * Q, kind = Sh::kind(f), k = Sh::shift(f), r = Sh::row(f);
    if constexpr (kind == ROW_A) {
      static_assert(r + k < 2 * S, "an A row reads two steps");
      if constexpr (r + k < S)
        acc[M] += cur[r] * cur[r + k];
      else if (more)
        acc[M] += cur[r] * nxt[r + k - S];
    } else if constexpr (kind == ROW_B) {
      static_assert(r + k < S, "a B row reads one step");
      if (on) acc[M] += cur[r] * cur[r + k];
    } else if constexpr (kind == ROW_AID) {
      acc[M] += cur[r];
    } else if constexpr (kind == ROW_AVM) {
      if (on) acc[M] += cur[r];
    }
  }
  template <int M, class Sink>
  __device__ __forceinline__ void put(Sink& sink, int len) const {
    constexpr int f = P + M * Q, kind = Sh::kind(f);
    float v = acc[M];
    if constexpr (kind == ROW_LEN) v = float(len);
    if constexpr (kind == ROW_ONE) v = 1.f;
    if constexpr (kind == ROW_ZERO) v = 0.f;
    sink(f, v);
  }
  template <int... M>
  __device__ __forceinline__ void init_all(std::integer_sequence<int, M...>, const float (&cur)[S]) {
    (init<M>(cur), ...);
  }
  template <int... M>
  __device__ __forceinline__ void step_all(std::integer_sequence<int, M...>, const float (&cur)[S],
                                           const float (&nxt)[S], bool more, bool on) {
    (step<M>(cur, nxt, more, on), ...);
  }
  template <class Sink, int... M>
  __device__ __forceinline__ void put_all(std::integer_sequence<int, M...>, Sink& sink, int len) const {
    (put<M>(sink, len), ...);
  }
};

// Part P's rows of one instance, step-outer: `su` is the instance's column
// of the staged u tile (element (row, j) at su[row · NT]); each row leaves
// through sink(f, value).
template <class Sh, int Q, int P, class Sink>
__device__ __forceinline__ void build_part(const float* su, int NT, int steps, int len, Sink& sink) {
  using Pt = Part<Sh, Q, P>;
  constexpr int S = Sh::S;
  Pt pt;
  float cur[S], nxt[S];
#pragma unroll
  for (int i = 0; i < S; ++i) {
    cur[i] = su[i * NT];
    nxt[i] = 0.f;
  }
  pt.init_all(typename Pt::Rows{}, cur);
  for (int t = 0; t < steps; ++t) {
    const bool more = t + 1 < steps;
    if (more) {
      const float* sn = su + (t + 1) * S * NT;
#pragma unroll
      for (int i = 0; i < S; ++i) nxt[i] = sn[i * NT];
    }
    pt.step_all(typename Pt::Rows{}, cur, nxt, more, t + 1 < len);
#pragma unroll
    for (int i = 0; i < S; ++i) cur[i] = nxt[i];
  }
  pt.put_all(typename Pt::Rows{}, sink, len);
}

// The rows of part `part` (0 ≤ part < Q) of one instance.
template <class Sh, int Q, class Sink, int... P>
__device__ __forceinline__ void build_fixed(std::integer_sequence<int, P...>, int part, const float* su, int NT,
                                            int steps, int len, Sink& sink) {
  ((part == P ? build_part<Sh, Q, P>(su, NT, steps, len, sink) : void()), ...);
}

}  // namespace mtm
