// K15: the per-cluster Khatri-Rao statistics of the masked M step, read in
// place from the states and observations by strides.
//
// Replaces the TPU kernel ops/pallas_mstep.py:mstep_stats_pallas (body
// _mstep_kernel) of the JAX package.
//
// z (T, n, d) and x (T, n, l), element (t, i, j) of z at z[t·zst + i·zsr + j]
// (likewise x): the masked trainer's (T, n, ·) tensors, or views of the
// packed joint batch v (n, T(d+l)) (zst = d, zsr = T(d+l)).  assign (n,).
// For each row i with c = assign_i in [0, C):
//   S_trans[c] += sum_{0 < t < T} [z_t-1, z_t finite] U U^T, U = [z_t-1, z_t, 1]
//   S_meas[c]  += sum_t          [z_t, x_t finite]   U U^T, U = [z_t, x_t, 1]
//   S_init[c]  +=                [z_0 finite]        U U^T, U = [z_0, 1]
// where "z_t finite" means every coordinate of z_t.  The outputs keep the
// JAX layout S[j, c u + k] (u = 2d+1, d+l+1, d+1).  A row whose assignment
// lies outside [0, C) counts nowhere.
//
// Bound on the card: one read of z, x and assign (324 MB at n = 1e6, T = 10,
// d = 5, l = 3: 0.097 ms) against the upper triangles' multiply-adds, 1065
// a row at that shape (2.1e9 operations, 0.032 ms at 67 TFLOP/s): bytes.
// The products of two float32 values are exact in float64, so the sums run
// in float64 (1.07e9 FP64 multiply-adds: ~0.064 ms at 64 an SM a clock),
// and each output is rounded once to the input type.  Design:
// - persistent blocks, each a contiguous range of rows, walk tiles of 32
//   rows; a tile's steps come in chunks (all T where they fit), each chunk
//   staged by cp.async (16 bytes where the source is aligned) into a ring
//   of two stages ahead of use.  A chunk of the (T, n, ·) tensors is one
//   contiguous span a step; of the packed batch one span a row;
// - the fast body (d, l fixed at compile time: (5, 3), ADNI's (2, 4) and
//   (2, 3), the shapes K7 also specialises first) has four
//   warps, each a part of the entries: warps 0 and 1 the two halves of the
//   transition entries (rows of the upper triangle), warps 2 and 3 those
//   of the measurement and first-state entries.  Each warp orders the
//   tile's 32 rows by cluster (stable, by shuffles), and lane i sums its
//   part for the i-th row over the row's steps in registers (at most 36
//   float64 sums at (5, 3)), each value loaded and converted once a step
//   (z_t-1 carried from the previous step); a pair whose rule fails is
//   skipped by a branch (nothing is multiplied by 0, so a NaN never
//   reaches a sum).  At the tile's end the rows of one cluster are a run
//   of lanes: a shuffle tree in a fixed order sums each run into its first
//   lane, which adds it to the block's per-cluster table (one writer an
//   element, no atomics), so no row sums pass through shared memory;
// - the general body (any d, l) keeps the tile and the ring: each chunk is
//   converted once into a float64 copy and its flags (one a rule, row and
//   step) computed once; a thread an entry, its two factors' places in the
//   copy worked out once a chunk, adds each row's sum over the chunk's
//   steps to the table;
// - where C clusters' tables do not fit a block's shared memory, the
//   clusters come in groups (the grid's y index), each group reading the
//   batch again;
// - each block writes its table as a partial, and a second kernel adds the
//   partials in a fixed order, a warp an output (markov_common.cuh:
//   warp_total), and writes both triangles, so two calls give the same
//   bits, and the strided and packed forms of one batch give the same bits.

#include <cuda_runtime.h>
#include <stdint.h>

#include "markov_common.cuh"

namespace {

constexpr int kRows = 32;   // rows a tile, one a lane
constexpr int kStages = 2;  // the ring
constexpr int kFastThreads = 128;  // four warps
constexpr int kMaxSmem = 232448;  // a block's most dynamic shared memory (227 KB)
// a block's shared memory for 3, 2 and 1 blocks an SM (the SM's 228 KB, 1 KB
// reserved a block)
constexpr int kTiers[3] = {76 * 1024, 113 * 1024, kMaxSmem};
constexpr size_t kPartBytes = size_t(256) << 20;  // a cap on the partials

// entry rules (and the order of the entries: transitions, measurements,
// the first state, each set's upper triangle row by row)
enum Set { TRANS = 0, MEAS = 1, INIT = 2 };

__host__ __device__ inline int tri(int u) { return u * (u + 1) / 2; }
__host__ __device__ inline int n_entries(int d, int l) {
  return tri(2 * d + 1) + tri(d + l + 1) + tri(d + 1);
}
__host__ __device__ inline int round_up(int v, int m) { return (v + m - 1) / m * m; }

// ---------------------------------------------------------------------
// The stage ring
// ---------------------------------------------------------------------

// One of the two tensors: element (t, i, j) at base[t st + i sr + j].  A
// chunk is copied by runs: a step's rows (time-major, sr == w) or a row's
// steps (row-major).
template <typename T>
struct Field {
  const T* base;
  long long st, sr;
  int w;
  __host__ __device__ bool time_major() const { return sr == w; }
};

// Where a field's chunk of `cap` steps sits in a stage: value (s, r, j) of
// the chunk at off + s s_t + r s_r + j; `size` elements, a multiple of 16
// bytes.
struct Region {
  int off, s_t, s_r, size;
};

template <typename T>
__host__ __device__ inline Region region(bool tmaj, int w, int cap, int off) {
  constexpr int V = 16 / sizeof(T);
  Region g;
  g.off = off;
  if (tmaj) {
    g.s_r = w;
    g.s_t = round_up(kRows * w, V);
    g.size = cap * g.s_t;
  } else {
    g.s_t = w;
    g.s_r = round_up(cap * w, V);
    g.size = kRows * g.s_r;
  }
  return g;
}

// The stage: z's chunk (one step more than x's: the previous step of the
// first pair) then x's.
template <typename T>
struct Stage {
  Region z, x;
  int size;
};

template <typename T>
__host__ __device__ inline Stage<T> stage_layout(bool zt, bool xt, int d, int l, int ts) {
  Stage<T> s;
  s.z = region<T>(zt, d, ts + 1, 0);
  s.x = region<T>(xt, l, ts, s.z.size);
  s.size = s.z.size + s.x.size;
  return s;
}

template <typename T>
__device__ __forceinline__ void cp_async(T* dst, const T* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if constexpr (sizeof(T) == 4)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src) : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(d), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
// wait until at most N of this thread's groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Copies steps [t_first, t_first + ns) of rows [r0, r0 + nr) of one field
// into its region: runs cut into 16-byte pieces, each one cp.async where
// the source is 16-byte aligned (the region's runs always are), else one a
// value.
template <typename T>
__device__ __forceinline__ void issue_field(T* stage, const Region& g, const Field<T>& f, int t_first,
                                            int ns, int64_t r0, int nr) {
  constexpr int V = 16 / sizeof(T);
  const bool tmaj = f.time_major();
  const int runs = tmaj ? ns : nr;
  const int len = tmaj ? nr * f.w : ns * f.w;
  const int ppr = (len + V - 1) / V;
  // piece q = run ppr + p, stepped by the block's threads without a division
  const int nt = blockDim.x, drun = nt / ppr, dp = nt - drun * ppr;
  int run = threadIdx.x / ppr, p = threadIdx.x - run * ppr;
  const T* base = tmaj ? f.base + (int64_t)t_first * f.st + r0 * f.sr : f.base + r0 * f.sr + (int64_t)t_first * f.st;
  const int64_t sstep = tmaj ? f.st : f.sr;
  const int dstep = tmaj ? g.s_t : g.s_r;
  for (; run < runs;) {
    const int e0 = p * V;
    const T* src = base + run * sstep + e0;
    T* dst = stage + g.off + run * dstep + e0;
    const int cnt = len - e0 < V ? len - e0 : V;
    if (cnt == V && (reinterpret_cast<uintptr_t>(src) & 15) == 0) {
      cp_async16(dst, src);
    } else {
      for (int k = 0; k < cnt; ++k) cp_async(dst + k, src + k);
    }
    run += drun;
    p += dp;
    if (p >= ppr) {
      p -= ppr;
      ++run;
    }
  }
}

// What a block walks: tiles of its rows, each in chunks of steps; item k
// is chunk k % nch of tile k / nch.
template <typename T>
struct Walk {
  Field<T> z, x;
  Stage<T> st;
  int T_, ts, nch, nitems;
  int64_t r_lo, r_hi;

  __device__ __forceinline__ int64_t row0(int k) const { return r_lo + (int64_t)(k / nch) * kRows; }
  __device__ __forceinline__ int rows(int k) const {
    const int64_t left = r_hi - row0(k);
    return left < kRows ? (int)left : kRows;
  }
  __device__ __forceinline__ int t0(int k) const { return (k % nch) * ts; }
  __device__ __forceinline__ int t1(int k) const { return t0(k) + ts < T_ ? t0(k) + ts : T_; }
  // the first z step staged: one before t0 (the previous step of the first
  // pair), none before 0
  __device__ __forceinline__ int tz(int k) const { return t0(k) > 0 ? t0(k) - 1 : 0; }
  __device__ __forceinline__ T* stage(T* ring, int k) const { return ring + (size_t)(k % kStages) * st.size; }

  // item k's copies (none past the block's items), then one commit
  __device__ __forceinline__ void issue(T* ring, int k) const {
    if (k < nitems) {
      T* s = stage(ring, k);
      const int nr = rows(k);
      issue_field(s, st.z, z, tz(k), t1(k) - tz(k), row0(k), nr);
      issue_field(s, st.x, x, t0(k), t1(k) - t0(k), row0(k), nr);
    }
    cp_async_commit();
  }
};

struct Launch {
  int64_t n, per_block;
  int T_, d, l, C, E, ts, cg;
};

template <typename T>
__device__ __forceinline__ Walk<T> make_walk(const Field<T>& z, const Field<T>& x, const Launch& a) {
  Walk<T> w;
  w.z = z;
  w.x = x;
  w.st = stage_layout<T>(z.time_major(), x.time_major(), a.d, a.l, a.ts);
  w.T_ = a.T_;
  w.ts = a.ts;
  w.nch = (a.T_ + a.ts - 1) / a.ts;
  w.r_lo = (int64_t)blockIdx.x * a.per_block;
  w.r_hi = w.r_lo + a.per_block < a.n ? w.r_lo + a.per_block : a.n;
  const int64_t rows = w.r_hi > w.r_lo ? w.r_hi - w.r_lo : 0;
  w.nitems = (int)((rows + kRows - 1) / kRows) * w.nch;
  return w;
}

// The cluster of a row relative to the block's group, or -1.
__device__ __forceinline__ int group_cluster(const int* __restrict__ assign, int64_t i, int C, int c_lo, int cg) {
  const int a = assign[i];
  return (a >= 0 && a < C && a - c_lo >= 0 && a - c_lo < cg) ? a - c_lo : -1;
}

template <typename T>
__device__ __forceinline__ void write_partial(const double* s_acc, double* __restrict__ part, const Launch& a,
                                              int c_lo) {
  double* out = part + ((size_t)blockIdx.x * a.C + c_lo) * a.E;
  const int cn = a.C - c_lo < a.cg ? a.C - c_lo : a.cg;  // the last group may be short
  for (int k = threadIdx.x; k < cn * a.E; k += blockDim.x) out[k] = s_acc[k];
}

// ---------------------------------------------------------------------
// The fast body: d and l fixed, a lane a row, four warps each a part of
// the entries
// ---------------------------------------------------------------------

// The entries of rows [a0, a1) of U's upper triangle, and where they start
// in the set's entries.
__host__ __device__ constexpr int tri_rows(int u, int a0, int a1) {
  return (a1 - a0) * u - (a1 * (a1 - 1) - a0 * (a0 - 1)) / 2;
}
// The row that splits U's upper triangle into two parts of the most
// nearly equal size.
__host__ __device__ constexpr int row_split(int u) {
  int best = 1;
  for (int a = 1; a < u; ++a) {
    const int m = tri_rows(u, 0, a) > tri_rows(u, a, u) ? tri_rows(u, 0, a) : tri_rows(u, a, u);
    const int mb = tri_rows(u, 0, best) > tri_rows(u, best, u) ? tri_rows(u, 0, best) : tri_rows(u, best, u);
    if (m < mb) best = a;
  }
  return best;
}

template <int DD, int LL>
struct Shape {
  static constexpr int UT = 2 * DD + 1, UM = DD + LL + 1, UI = DD + 1;
  static constexpr int ET = UT * (UT + 1) / 2, EM = UM * (UM + 1) / 2, EI = UI * (UI + 1) / 2;
  static constexpr int E = ET + EM + EI;
  // warp 0 and 1: the transitions' rows [0, ST) and [ST, UT); warp 2 and 3
  // the measurements' rows [0, SM) and [SM, UM), and the first state's
  // [0, SI) and [SI, UI)
  static constexpr int ST = row_split(UT), SM = row_split(UM), SI = row_split(UI);
  static constexpr int N0 = tri_rows(UT, 0, ST), N1 = tri_rows(UT, ST, UT);
  static constexpr int N2 = tri_rows(UM, 0, SM) + tri_rows(UI, 0, SI);
  static constexpr int N3 = tri_rows(UM, SM, UM) + tri_rows(UI, SI, UI);
  static constexpr int NA = (N0 > N1 ? N0 : N1) > (N2 > N3 ? N2 : N3) ? (N0 > N1 ? N0 : N1) : (N2 > N3 ? N2 : N3);
};

// acc[e] += U_a U_b over rows [A0, A1) of U's upper triangle (b ≥ a), row
// by row
template <int U, int A0, int A1>
__device__ __forceinline__ void add_rows(double* acc, const double* u) {
  int e = 0;
#pragma unroll
  for (int a = A0; a < A1; ++a) {
#pragma unroll
    for (int b = a; b < U; ++b) {
      acc[e] = fma(u[a], u[b], acc[e]);
      ++e;
    }
  }
}

template <typename T>
__device__ __forceinline__ bool finite(T v) {
  return isfinite(v);
}

template <typename T>
size_t fast_smem(const Stage<T>& st, int cg, int E) {
  return sizeof(T) * (size_t)kStages * st.size + sizeof(double) * (size_t)cg * E +
         sizeof(int) * kRows * (kFastThreads / 32);
}

// One chunk of a part's steps for the row at zs / xs (its z and x in the
// stage, by step): the transitions' rows [A0, A1) (pairs (t-1, t), z_t-1
// carried in zp/fp from the previous step), or the measurements' rows
// [A0, A1) and the first state's [I0, I1).
template <typename T, int DD, int LL, int A0, int A1>
__device__ __forceinline__ void trans_chunk(double* acc, double* zp, bool& fp, const T* zs, int zst, int t0, int t1,
                                            int tz, bool act) {
  constexpr int UT = 2 * DD + 1;
#pragma unroll 1
  for (int t = t0; t < t1; ++t) {
    const T* zv = zs + (t - tz) * zst;
    double u[UT];
    bool fz = true;
#pragma unroll
    for (int j = 0; j < DD; ++j) {
      const T v = zv[j];
      fz = fz && finite(v);
      u[j] = zp[j];
      u[DD + j] = static_cast<double>(v);
    }
    u[2 * DD] = 1.0;
    if (act && t > 0 && fz && fp) add_rows<UT, A0, A1>(acc, u);
#pragma unroll
    for (int j = 0; j < DD; ++j) zp[j] = u[DD + j];
    fp = fz;
  }
}

template <typename T, int DD, int LL, int A0, int A1, int I0, int I1>
__device__ __forceinline__ void meas_chunk(double* acc, const T* zs, int zst, const T* xs, int xst, int t0, int t1,
                                           int tz, bool act) {
  constexpr int UM = DD + LL + 1, UI = DD + 1;
#pragma unroll 1
  for (int t = t0; t < t1; ++t) {
    const T* zv = zs + (t - tz) * zst;
    const T* xv = xs + (t - t0) * xst;
    double u[UM];
    bool fz = true, fx = true;
#pragma unroll
    for (int j = 0; j < DD; ++j) {
      const T v = zv[j];
      fz = fz && finite(v);
      u[j] = static_cast<double>(v);
    }
#pragma unroll
    for (int j = 0; j < LL; ++j) {
      const T v = xv[j];
      fx = fx && finite(v);
      u[DD + j] = static_cast<double>(v);
    }
    u[DD + LL] = 1.0;
    if (act && fz && fx) add_rows<UM, A0, A1>(acc, u);
    if (act && t == 0 && fz) {
      double ui[UI];
#pragma unroll
      for (int j = 0; j < DD; ++j) ui[j] = u[j];
      ui[DD] = 1.0;
      add_rows<UI, I0, I1>(acc + tri_rows(UM, A0, A1), ui);
    }
  }
}

// A part's sums added to their places in a cluster's entries.
template <int N>
__device__ __forceinline__ void add_part(double* dst, const double* acc, int off) {
#pragma unroll
  for (int e = 0; e < N; ++e) dst[off + e] += acc[e];
}

// The rows of one cluster are a run of lanes (key: the cluster, rows of no
// cluster last): the first N sums of each run meet at its first lane in a
// fixed tree (v_i += v_i+o within the run, o = 1, 2, 4, ...).  Returns
// whether this lane heads a run.
template <int N>
__device__ __forceinline__ bool run_sums(double* acc, int key, int lane) {
  const int before = __shfl_up_sync(0xffffffffu, key, 1);
  const bool head = lane == 0 || before != key;
  const unsigned heads = __ballot_sync(0xffffffffu, head);
  const unsigned above = lane < 31 ? heads >> (lane + 1) : 0u;
  const int run = head ? (above ? __ffs(above) : 32 - lane) : 0;
  const int maxrun = __reduce_max_sync(0xffffffffu, run);
  for (int o = 1; o < maxrun; o <<= 1) {
    const int ko = __shfl_down_sync(0xffffffffu, key, o);
    const bool take = lane + o < 32 && ko == key;
#pragma unroll
    for (int e = 0; e < N; ++e) {
      const double v = __shfl_down_sync(0xffffffffu, acc[e], o);
      if (take) acc[e] += v;
    }
  }
  return head;
}

// Part P of the fast body (its warp's share of the entries): one chunk of
// steps of its row, and at the tile's end its runs' sums into the table.
template <typename T, int DD, int LL, int P>
__device__ __forceinline__ void part_chunk(double* acc, double* zp, bool& fp, const T* zs, int zst, const T* xs,
                                           int xst, int t0, int t1, int tz, bool act) {
  using S = Shape<DD, LL>;
  if constexpr (P == 0)
    trans_chunk<T, DD, LL, 0, S::ST>(acc, zp, fp, zs, zst, t0, t1, tz, act);
  else if constexpr (P == 1)
    trans_chunk<T, DD, LL, S::ST, S::UT>(acc, zp, fp, zs, zst, t0, t1, tz, act);
  else if constexpr (P == 2)
    meas_chunk<T, DD, LL, 0, S::SM, 0, S::SI>(acc, zs, zst, xs, xst, t0, t1, tz, act);
  else
    meas_chunk<T, DD, LL, S::SM, S::UM, S::SI, S::UI>(acc, zs, zst, xs, xst, t0, t1, tz, act);
}

template <int DD, int LL, int P>
__device__ __forceinline__ void part_end(double* acc, double* s_acc, int c, int lane) {
  using S = Shape<DD, LL>;
  constexpr int OM = S::ET, OI = S::ET + S::EM;
  constexpr int M0 = tri_rows(S::UM, 0, S::SM), M1 = tri_rows(S::UM, S::SM, S::UM);
  constexpr int N = P == 0 ? S::N0 : P == 1 ? S::N1 : P == 2 ? S::N2 : S::N3;
  if (!run_sums<N>(acc, c < 0 ? 0x7fffffff : c, lane) || c < 0) return;
  double* dst = s_acc + c * S::E;
  if constexpr (P == 0) {
    add_part<S::N0>(dst, acc, 0);
  } else if constexpr (P == 1) {
    add_part<S::N1>(dst, acc, S::N0);
  } else if constexpr (P == 2) {
    add_part<M0>(dst, acc, OM);
    add_part<tri_rows(S::UI, 0, S::SI)>(dst, acc + M0, OI);
  } else {
    add_part<M1>(dst, acc, OM + M0);
    add_part<tri_rows(S::UI, S::SI, S::UI)>(dst, acc + M1, OI + tri_rows(S::UI, 0, S::SI));
  }
}

template <typename T, int DD, int LL>
__global__ void __launch_bounds__(kFastThreads, 3) stats_fast(Field<T> zf, Field<T> xf, const int* __restrict__ assign,
                                                           double* __restrict__ part, Launch a) {
  using S = Shape<DD, LL>;
  extern __shared__ __align__(16) unsigned char smem[];
  const Walk<T> w = make_walk(zf, xf, a);
  T* ring = reinterpret_cast<T*>(smem);
  double* s_acc = reinterpret_cast<double*>(ring + (size_t)kStages * w.st.size);
  const int c_lo = blockIdx.y * a.cg;
  const int tid = threadIdx.x, r = tid & 31, wp = tid >> 5;
  int* s_perm = reinterpret_cast<int*>(s_acc + (size_t)a.cg * S::E) + wp * kRows;  // this warp's row order

  for (int k = tid; k < a.cg * S::E; k += kFastThreads) s_acc[k] = 0.0;
  for (int j = 0; j < kStages - 1; ++j) w.issue(ring, j);

  // a tile's sums of this lane's row, zero at its start: set here and after
  // each tile's sums are added to the table
  double acc[S::NA];
  double zp[DD];
#pragma unroll
  for (int e = 0; e < S::NA; ++e) acc[e] = 0.0;
#pragma unroll
  for (int j = 0; j < DD; ++j) zp[j] = 0.0;
  bool fp = false;
  int c = -1, rr = r;  // the cluster and the tile row of this lane
  for (int k = 0; k < w.nitems; ++k) {
    w.issue(ring, k + kStages - 1);  // into the stage item k - 1 left
    cp_async_wait<kStages - 1>();
    __syncthreads();  // item k has landed for every thread
    const T* s = w.stage(ring, k);
    const int nr = w.rows(k), t0 = w.t0(k), t1 = w.t1(k), tz = w.tz(k);
    if (t0 == 0) {
      // the tile's rows in a stable order by cluster (rows of no cluster
      // last), lane i taking the i-th: each warp ranks them alone
      const int own = r < nr ? group_cluster(assign, w.row0(k) + r, a.C, c_lo, a.cg) : -1;
      const int key = own < 0 ? 0x7fffffff : own;
      int pos = 0;
#pragma unroll
      for (int j = 0; j < 32; ++j) {
        const int kj = __shfl_sync(0xffffffffu, key, j);
        pos += (kj < key) || (kj == key && j < r);
      }
      s_perm[pos] = r;
      __syncwarp();
      rr = s_perm[r];
      c = __shfl_sync(0xffffffffu, own, rr);
      __syncwarp();
    }
    const bool act = c >= 0;
    const T* zs = s + w.st.z.off + rr * w.st.z.s_r;
    const T* xs = s + w.st.x.off + rr * w.st.x.s_r;
    const int zst = w.st.z.s_t, xst = w.st.x.s_t;
    if (wp == 0)
      part_chunk<T, DD, LL, 0>(acc, zp, fp, zs, zst, xs, xst, t0, t1, tz, act);
    else if (wp == 1)
      part_chunk<T, DD, LL, 1>(acc, zp, fp, zs, zst, xs, xst, t0, t1, tz, act);
    else if (wp == 2)
      part_chunk<T, DD, LL, 2>(acc, zp, fp, zs, zst, xs, xst, t0, t1, tz, act);
    else
      part_chunk<T, DD, LL, 3>(acc, zp, fp, zs, zst, xs, xst, t0, t1, tz, act);
    if (t1 == w.T_) {
      // each cluster's rows are a run of lanes: their sums meet at the run's
      // first lane, which adds them to the cluster's entries of the table
      if (wp == 0)
        part_end<DD, LL, 0>(acc, s_acc, c, r);
      else if (wp == 1)
        part_end<DD, LL, 1>(acc, s_acc, c, r);
      else if (wp == 2)
        part_end<DD, LL, 2>(acc, s_acc, c, r);
      else
        part_end<DD, LL, 3>(acc, s_acc, c, r);
#pragma unroll
      for (int e = 0; e < S::NA; ++e) acc[e] = 0.0;
#pragma unroll
      for (int j = 0; j < DD; ++j) zp[j] = 0.0;
    }
    __syncthreads();  // the stage may be refilled
  }
  write_partial<T>(s_acc, part, a, c_lo);
}

// ---------------------------------------------------------------------
// The general body: any d and l, a thread an entry
// ---------------------------------------------------------------------

// An entry's factor: (kind << 16) | index, kind 0 z_t-1, 1 z_t, 2 x_t, 3 the one.
__host__ __device__ inline int factor(int set, int j, int d, int l) {
  if (set == TRANS) return j < d ? j : j < 2 * d ? (1 << 16) | (j - d) : 3 << 16;
  if (set == MEAS) return j < d ? (1 << 16) | j : j < d + l ? (2 << 16) | (j - d) : 3 << 16;
  return j < d ? (1 << 16) | j : 3 << 16;
}

// Where a factor's values sit in the chunk's float64 copy: value (row r,
// step t0 + i) at off + r sr + i st; the one at the slot past the copy.
struct Addr {
  int off, sr, st;
};

template <typename T>
__device__ __forceinline__ Addr addr_of(int f, const Stage<T>& st, int t0, int tz) {
  const int kind = f >> 16, j = f & 0xffff;
  if (kind == 3) return {st.size, 0, 0};
  if (kind == 2) return {st.x.off + j, st.x.s_r, st.x.s_t};
  return {st.z.off + (t0 - (kind == 0) - tz) * st.z.s_t + j, st.z.s_r, st.z.s_t};
}

template <typename T>
size_t general_smem(const Stage<T>& st, int cg, int E, int ts) {
  return sizeof(T) * (size_t)kStages * st.size + sizeof(double) * ((size_t)st.size + 2 + (size_t)cg * E) +
         sizeof(int) * (3 * (size_t)E + kRows) + (size_t)kRows * 3 * ts;
}

// Each chunk's stage is copied once into float64 (the one in the slot past
// it), every (row, step) gets one flag a rule, and a thread an entry sums
// each row's products over the chunk's steps (two rows at a time) and adds
// the sum to the table.
template <typename T>
__global__ void stats_general(Field<T> zf, Field<T> xf, const int* __restrict__ assign,
                              const int* __restrict__ entries, double* __restrict__ part, Launch a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Walk<T> w = make_walk(zf, xf, a);
  const int E = a.E, d = a.d, l = a.l, ts = a.ts;
  T* ring = reinterpret_cast<T*>(smem);
  double* vb = reinterpret_cast<double*>(ring + (size_t)kStages * w.st.size);  // the chunk in float64, then 1
  double* s_acc = vb + w.st.size + 2;
  int* s_ent = reinterpret_cast<int*>(s_acc + (size_t)a.cg * E);  // set, factor a, factor b
  int* s_c = s_ent + 3 * E;
  unsigned char* s_ok = reinterpret_cast<unsigned char*>(s_c + kRows);  // (row, rule, step)
  const int c_lo = blockIdx.y * a.cg;
  const int tid = threadIdx.x, nt = blockDim.x;

  for (int k = tid; k < a.cg * E; k += nt) s_acc[k] = 0.0;
  for (int e = tid; e < E; e += nt) {
    const int set = entries[e * 3], j = entries[e * 3 + 1], kk = entries[e * 3 + 2];
    s_ent[3 * e] = set;
    s_ent[3 * e + 1] = factor(set, j, d, l);
    s_ent[3 * e + 2] = factor(set, kk, d, l);
  }
  if (tid == 0) vb[w.st.size] = 1.0;
  for (int j = 0; j < kStages - 1; ++j) w.issue(ring, j);
  for (int k = 0; k < w.nitems; ++k) {
    w.issue(ring, k + kStages - 1);
    cp_async_wait<kStages - 1>();
    __syncthreads();
    const T* s = w.stage(ring, k);
    const int nr = w.rows(k), t0 = w.t0(k), t1 = w.t1(k), tz = w.tz(k), ns = t1 - t0;
    for (int q = tid; q < w.st.size; q += nt) vb[q] = static_cast<double>(s[q]);
    if (t0 == 0)
      for (int r = tid; r < kRows; r += nt) s_c[r] = r < nr ? group_cluster(assign, w.row0(k) + r, a.C, c_lo, a.cg) : -1;
    for (int q = tid; q < nr * ns; q += nt) {
      const int r = q / ns, i = q - r * ns, t = t0 + i;
      bool fz = true, fx = true, fp = t > 0;
      for (int j = 0; j < d; ++j) fz = fz && finite(s[(t - tz) * w.st.z.s_t + r * w.st.z.s_r + j]);
      for (int j = 0; j < l; ++j) fx = fx && finite(s[w.st.x.off + i * w.st.x.s_t + r * w.st.x.s_r + j]);
      if (t > 0)
        for (int j = 0; j < d; ++j) fp = fp && finite(s[(t - 1 - tz) * w.st.z.s_t + r * w.st.z.s_r + j]);
      unsigned char* ok = s_ok + (size_t)r * 3 * ts + i;
      ok[TRANS * ts] = fz && fp;
      ok[MEAS * ts] = fz && fx;
      ok[INIT * ts] = fz && t == 0;
    }
    __syncthreads();
    for (int e = tid; e < E; e += nt) {
      const int set = s_ent[3 * e];
      const Addr fa = addr_of<T>(s_ent[3 * e + 1], w.st, t0, tz), fb = addr_of<T>(s_ent[3 * e + 2], w.st, t0, tz);
      // a transition pair never counts at t = 0 (nor is z_-1 read)
      const int i0 = set == TRANS && t0 == 0, steps = set == INIT ? (t0 == 0) : ns;
      // two rows at a time, two independent sums; a product whose flag is
      // off is dropped by a select, and each row's sum goes to the table in
      // row order
      for (int r = 0; r < nr; r += 2) {
        const int r1 = r + 1 < nr ? r + 1 : r;
        const int c0 = s_c[r], c1 = r + 1 < nr ? s_c[r1] : -1;
        if (c0 < 0 && c1 < 0) continue;
        const double *ua0 = vb + fa.off + r * fa.sr, *ub0 = vb + fb.off + r * fb.sr;
        const double *ua1 = vb + fa.off + r1 * fa.sr, *ub1 = vb + fb.off + r1 * fb.sr;
        const unsigned char* ok0 = s_ok + ((size_t)r * 3 + set) * ts;
        const unsigned char* ok1 = s_ok + ((size_t)r1 * 3 + set) * ts;
        double s0 = 0.0, s1 = 0.0;
        for (int i = i0; i < steps; ++i) {
          const double p0 = fma(ua0[i * fa.st], ub0[i * fb.st], s0);
          const double p1 = fma(ua1[i * fa.st], ub1[i * fb.st], s1);
          s0 = ok0[i] ? p0 : s0;
          s1 = ok1[i] ? p1 : s1;
        }
        if (c0 >= 0) s_acc[c0 * E + e] += s0;
        if (c1 >= 0) s_acc[c1 * E + e] += s1;
      }
    }
    __syncthreads();
  }
  write_partial<T>(s_acc, part, a, c_lo);
}

// out_set[j, c u + k] = out_set[k, c u + j] = the sum over the blocks, in
// a fixed order, of part[b, c, e] for the entry e = (set, j, k), rounded
// once to T; a warp an output.
template <typename T>
__global__ void stats_reduce(const double* __restrict__ part, const int* __restrict__ entries, T* __restrict__ s_trans,
                             T* __restrict__ s_meas, T* __restrict__ s_init, int blocks, int d, int l, int C, int E) {
  const int64_t wid = ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  if (wid >= (int64_t)C * E) return;
  const int c = (int)(wid / E), e = (int)(wid - (int64_t)c * E);
  const double s = mtm::warp_total<double>(part + (size_t)c * E + e, (int64_t)C * E, blocks);
  if ((threadIdx.x & 31) != 0) return;
  const int set = entries[e * 3], j = entries[e * 3 + 1], k = entries[e * 3 + 2];
  T* out = set == TRANS ? s_trans : set == MEAS ? s_meas : s_init;
  const int u = set == TRANS ? 2 * d + 1 : set == MEAS ? d + l + 1 : d + 1;
  const T v = static_cast<T>(s);
  out[(size_t)j * C * u + c * u + k] = v;
  out[(size_t)k * C * u + c * u + j] = v;
}

// ---------------------------------------------------------------------
// The plan and the launch
// ---------------------------------------------------------------------

enum Body { FAST = 0, GENERAL = 1 };

bool has_fast(int d, int l) { return (d == 5 && l == 3) || (d == 2 && l == 4) || (d == 2 && l == 3); }

template <typename T>
const void* kernel_of(int body, int d, int l) {
  if (body == FAST) {
    if (d == 5 && l == 3) return reinterpret_cast<const void*>(stats_fast<T, 5, 3>);
    if (d == 2 && l == 4) return reinterpret_cast<const void*>(stats_fast<T, 2, 4>);
    if (d == 2 && l == 3) return reinterpret_cast<const void*>(stats_fast<T, 2, 3>);
    return nullptr;
  }
  return reinterpret_cast<const void*>(stats_general<T>);
}

template <typename T>
size_t smem_of(int body, const Stage<T>& st, int cg, int E, int ts) {
  return body == FAST ? fast_smem<T>(st, cg, E) : general_smem<T>(st, cg, E, ts);
}

// plan = {body, threads, steps a chunk, clusters a group, blocks (x), smem}
template <typename T>
int make_plan(int want, int zt, int xt, int T_, int d, int l, int C, long long n, int* plan) {
  const int E = n_entries(d, l);
  int body = want;
  if (body < 0) body = has_fast(d, l) ? FAST : GENERAL;
  if (body == FAST && !has_fast(d, l)) return -1;
  const int threads = body == FAST ? kFastThreads : (E < 1024 ? round_up(E, 32) : 1024);
  int ts = 0, cg = 0;
  size_t smem = 0;
  // the most blocks an SM whose shared memory holds C clusters' tables with
  // chunks of the most steps (at most 16); else the clusters in groups at
  // one block an SM
  const int ts_max = T_ < 16 ? T_ : 16;
  for (int tier = 0; tier < 3 && ts == 0; ++tier) {
    for (int s = ts_max; s >= 1; --s) {
      const size_t b = smem_of<T>(body, stage_layout<T>(zt, xt, d, l, s), C, E, s);
      if (b <= (size_t)kTiers[tier]) {
        ts = s, cg = C, smem = b;
        break;
      }
    }
  }
  if (ts == 0) {
    ts = ts_max < 8 ? ts_max : 8;
    const size_t fixed = smem_of<T>(body, stage_layout<T>(zt, xt, d, l, ts), 0, E, ts);
    const size_t per = smem_of<T>(body, stage_layout<T>(zt, xt, d, l, ts), 1, E, ts) - fixed;
    if (fixed >= (size_t)kMaxSmem) return -1;
    cg = (int)((kMaxSmem - fixed) / per);
    if (cg < 1) return -1;
    cg = cg < C ? cg : C;
    smem = smem_of<T>(body, stage_layout<T>(zt, xt, d, l, ts), cg, E, ts);
  }
  const void* kern = kernel_of<T>(body, d, l);
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  int per_sm = 0, dev = 0, sms = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, threads, smem);
  if (err != cudaSuccess) return (int)err;
  if (per_sm < 1) return -1;
  err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  long long blocks = (long long)sms * per_sm;
  const long long tiles = (n + kRows - 1) / kRows;
  if (blocks > tiles) blocks = tiles;
  const long long cap = (long long)(kPartBytes / (sizeof(double) * (size_t)C * E));
  if (blocks > cap) blocks = cap > 1 ? cap : 1;
  plan[0] = body;
  plan[1] = threads;
  plan[2] = ts;
  plan[3] = cg;
  plan[4] = (int)blocks;
  plan[5] = (int)smem;
  return 0;
}

template <typename T>
int run(const int* plan, Field<T> z, Field<T> x, const int* assign, const int* entries, double* part, T* s_trans,
        T* s_meas, T* s_init, long long n, int T_, int d, int l, int C, cudaStream_t stream) {
  const int body = plan[0], threads = plan[1], ts = plan[2], cg = plan[3], blocks = plan[4], smem = plan[5];
  const int E = n_entries(d, l);
  if (ts < 1 || ts > T_ || cg < 1 || cg > C || blocks < 1 || threads < 32 || threads > 1024) return -1;
  if (smem_of<T>(body, stage_layout<T>(z.time_major(), x.time_major(), d, l, ts), cg, E, ts) > (size_t)smem)
    return -1;
  const void* kern = kernel_of<T>(body, d, l);
  if (kern == nullptr) return -1;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const long long tiles = (n + kRows - 1) / kRows;
  Launch a;
  a.n = n;
  a.per_block = (tiles + blocks - 1) / blocks * kRows;
  a.T_ = T_;
  a.d = d;
  a.l = l;
  a.C = C;
  a.E = E;
  a.ts = ts;
  a.cg = cg;
  const dim3 grid((unsigned)blocks, (unsigned)((C + cg - 1) / cg));
  if (body == FAST) {
    if (d == 5 && l == 3)
      stats_fast<T, 5, 3><<<grid, threads, smem, stream>>>(z, x, assign, part, a);
    else if (d == 2 && l == 4)
      stats_fast<T, 2, 4><<<grid, threads, smem, stream>>>(z, x, assign, part, a);
    else
      stats_fast<T, 2, 3><<<grid, threads, smem, stream>>>(z, x, assign, part, a);
  } else {
    stats_general<T><<<grid, threads, smem, stream>>>(z, x, assign, entries, part, a);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const long long warps = (long long)C * E;
  stats_reduce<T><<<(unsigned)((warps * 32 + 255) / 256), 256, 0, stream>>>(part, entries, s_trans, s_meas, s_init,
                                                                          blocks, d, l, C, E);
  return (int)cudaGetLastError();
}

template <typename T>
Field<T> field(const void* base, long long st, long long sr, int w) {
  Field<T> f;
  f.base = static_cast<const T*>(base);
  f.st = st;
  f.sr = sr;
  f.w = w;
  return f;
}

}  // namespace

// K15's plan for these shapes and layouts (kind 0 float32, 1 float64; body
// -1 the fast body where d and l have one, 0 the fast body, 1 the general
// body; z_tmaj / x_tmaj: the field's rows of a step are contiguous): plan[6]
// = {body, threads, steps a chunk, clusters a group, blocks, shared memory}.
// The partials hold blocks * C * E float64.  Returns a cudaError_t, or -1
// where no plan exists.
extern "C" int mtm_mstep_stats_plan(int device, int kind, int body, int z_tmaj, int x_tmaj, int T, int d, int l,
                                    int C, long long n, int* plan) {
  if (T < 1 || d < 1 || l < 1 || C < 1 || n < 1) return -1;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (kind == 0) return make_plan<float>(body, z_tmaj, x_tmaj, T, d, l, C, n, plan);
  if (kind == 1) return make_plan<double>(body, z_tmaj, x_tmaj, T, d, l, C, n, plan);
  return -1;
}

// The statistics of z (element (t, i, j) at z[t zst + i zsr + j]) and x
// under assign, on a plan from mtm_mstep_stats_plan for the same layouts;
// entries (E, 3) int32: set, j, k of each upper-triangle entry in order.
// Writes the three output sets whole.  Returns a cudaError_t (0 on
// success), or -1 for an argument the kernel does not take.
extern "C" int mtm_mstep_stats(int device, int kind, const int* plan, const void* z, long long zst, long long zsr,
                               const void* x, long long xst, long long xsr, const void* assign, const void* entries,
                               void* part, void* s_trans, void* s_meas, void* s_init, long long n, int T, int d,
                               int l, int C, void* stream) {
  if (n <= 0 || T < 1 || d < 1 || l < 1 || C < 1) return -1;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* a = static_cast<const int*>(assign);
  const int* en = static_cast<const int*>(entries);
  double* p = static_cast<double*>(part);
  if (kind == 0)
    return run<float>(plan, field<float>(z, zst, zsr, d), field<float>(x, xst, xsr, l), a, en, p,
                      static_cast<float*>(s_trans), static_cast<float*>(s_meas), static_cast<float*>(s_init), n, T,
                      d, l, C, s);
  if (kind == 1)
    return run<double>(plan, field<double>(z, zst, zsr, d), field<double>(x, xst, xsr, l), a, en, p,
                       static_cast<double*>(s_trans), static_cast<double*>(s_meas), static_cast<double*>(s_init), n,
                       T, d, l, C, s);
  return -1;
}
