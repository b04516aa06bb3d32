// K5: the per-instance Markov EM features Φ in the canonical layout, for
// any T.
//
// Replaces the TPU kernel ops/pallas_markov.py:markov_materialize_features_longT
// (body _markov_feat_grid_kernel) of the JAX package.
//
// The rows are those of markov_longT_rows.cuh (the part structs RowsZZ,
// RowsZN, RowsX, shared with K6/K10/K11, which build the same Φ in shared
// memory): the g-layout, each row summed over t in order, every product
// and sum rounded on its own, so Φ equals its plain torch version bit for
// bit, and two calls agree.
//
// Bound on the card: bytes, z_t and x_t read once and Φ written once
// (1.02 GB + 144 MB at T=128, n=2.5e5, d=5, l=3 in float32: 0.35 ms at
// 3.35 TB/s); the build, ~200 operations per (instance, step), stays
// below it.  Two bodies, chosen by the wrapper (ops/markov_kernels.py:
// k5_plan):
//
// - the staged body (every shape a block fits; the plan's steps a stage
//   and stages, the tile and threads an instance fixed by the body):
//   - persistent blocks walk the tiles b, b + G, ... of nt instances; a
//     block's walk is one sequence of windows (a tile's steps W at a
//     time, tile after tile), staged by cp.async into a ring of ns
//     shared-memory stages, each window's copies issued ns - 1 windows
//     ahead of the build that reads it, so the next tile's first windows
//     land during this tile's last steps;
//   - a window holds, for each of its steps, the d rows of z_t and the l
//     rows of x_t over the tile, each row copied in 16-byte pieces from
//     its aligned start at any n (one piece more a row where a row can
//     start inside a 16-byte line: n % (16 / sizeof(T)) != 0, or an
//     unaligned base); the build reads element j of a row at the row's
//     offset inside its first line plus j (no offsets where every row is
//     aligned); a thread's pieces are a fixed piece of a few rows, one
//     running pointer a row;
//   - each z and x slice is read from the stage: every part of an
//     instance takes z_t from there, and the transition part keeps z_t
//     in registers for the next step's z_t⊗z_{t+1} (it runs one step
//     behind), so the batch crosses from L2 once;
//   - q threads an instance: q = 1 (float32 at the compiled (d, l), 128
//     instances a tile) runs the three part structs in one thread,
//     loading each slice once and keeping every running sum in registers;
//     q = 3 (the generic instantiation and float64, 64 instances) gives
//     each part its own thread and its own loop;
//   - each finished row goes from registers straight to Φ with a
//     streaming store; the threads of a part run along n, so a warp's
//     store is one row's 32 consecutive entries.
//   What the card showed (tools/k5_phase_split.py, NVIDIA H100 80GB HBM3
//   at 700 W, T=128, n=2.5e5, (5, 3), float32): 0.45 ms against the
//   global body's 0.77; the copies alone 0.35 (2.96 TB/s), the build
//   alone 0.22, the two together 0.37, the stores the rest (0.05 alone).
//   Stages of 8 steps in a ring of two beat 2, 4 or 16 steps and rings of
//   three; q = 3 at the compiled shapes, tiles of 256 or 512 instances,
//   TMA bulk copies in place of cp.async, plain stores and a fused
//   masked sum measured no faster.
// - the global-memory body (the first port's; tests and tools force it, and it
//   takes any shape no staged block fits): a grid of (3, tiles) blocks of
//   128 threads, each block one part of the rows of its tile, every z and
//   x value loaded from device memory by each part that uses it
//   (markov_longT_rows.cuh:longT_rows).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "markov_common.cuh"
#include "markov_longT_rows.cuh"
#include "markov_step_rows.cuh"

namespace {

using mtm::finite_or_zero;
using mtm::kLongTMax;
using mtm::LongTLayout;
using mtm::longT_rows;
using mtm::RowsX;
using mtm::RowsZN;
using mtm::RowsZZ;

// ---------------------------------------------------------------------
// The global-memory body

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

// ---------------------------------------------------------------------
// The staged body

constexpr size_t kMaxSmem = 232448;  // a block's shared-memory limit
constexpr int kMaxStageSteps = 16;

// Shared memory of a block: ns stages of W steps, each step d + l rows of
// nt values and one 16-byte line more (a row copied from its aligned
// start).  ops/markov_kernels.py: k5_smem is the same product.
size_t staged_smem(int itemsize, int nt, int rows, int W, int ns) {
  return (size_t)ns * W * rows * (nt + 16 / itemsize) * itemsize;
}

// The threads an instance compiled for a body: one at the fixed shapes in
// float32 (every part in one thread), else three (a part a thread).
template <typename T, bool FIXED>
constexpr int kQ = FIXED && sizeof(T) == 4 ? 1 : 3;

// A body's tile, fixed at compile time so that every shared-memory address
// of the build is a constant offset: 128 instances (q = 1) or 64 (q = 3,
// 192 threads).  Blocks an SM asked of ptxas: three where one thread holds
// every part's sums (q = 1, at most 168 registers: (5, 3)'s 89 running
// sums and both walks spill nothing), two of 192 threads (q = 3, at most
// 168 registers).
template <int Q>
constexpr int kTile = Q == 1 ? 128 : 64;
template <int Q>
constexpr int kMinBlocks = Q == 1 ? 3 : 2;

// A barrier that the parts' loops reach from different places in the
// code (q = 3: each part walks the same windows in its own loop).
__device__ __forceinline__ void cta_sync() { asm volatile("barrier.sync 0;\n" ::: "memory"); }

// The ring of one block: window g of its walk (tile blockIdx.x + (g /
// nwin)·G, steps [(g % nwin)·W, ...)) goes to stage g % ns; a stage holds
// W steps of rows() lines of P values, line r of a step being z_t's
// row r (r < d) or x_t's row r - d over the tile, from its aligned start.
template <typename T, int DM, int LM, bool FIXED, int NT>
struct Ring {
  static constexpr int V = 16 / sizeof(T);  // values a 16-byte copy
  static constexpr int P = NT + V;          // a staged row: the tile from its row's aligned start
  static constexpr int CH = NT / V;         // a row's 16-byte pieces where it is aligned
  const T* __restrict__ z;
  const T* __restrict__ x;
  T* stages;
  int64_t n, G;
  int nglob, d_rt, l_rt, steps, W, ns, nwin, extra;

  __device__ __forceinline__ int d() const { return FIXED ? DM : d_rt; }
  __device__ __forceinline__ int l() const { return FIXED ? LM : l_rt; }
  __device__ __forceinline__ int rows() const { return d() + l(); }
  __device__ __forceinline__ const T* stage(int g) const {
    return stages + (size_t)(g % ns) * W * rows() * P;
  }
  // the offset of a row's element i0 inside its 16-byte line (i0 is a
  // multiple of the tile, so of V): row `row` of an array whose base sits
  // `base` values into its line; 0 where every row is aligned
  template <bool ALIGNED>
  __device__ __forceinline__ int offset(int base, int row) const {
    return ALIGNED ? 0 : (base + row * (int)(n & (V - 1))) & (V - 1);
  }
  // window g's copies (none past the walk), then one commit.  Thread
  // threadIdx.x copies piece c = threadIdx.x % CH (the 16 bytes c·V values
  // past a row's aligned start) of its rows r = threadIdx.x / CH, + per, ...
  // at each step of the window, a running pointer moving a step down a
  // row; with `extra`, piece CH of every line by one thread each.  A piece
  // that starts past the array is zero-filled (one that starts inside it
  // lies in the array's mapped lines).
  __device__ __forceinline__ void issue(int g) const {
    if (g < nglob) {
      const int64_t i0 = ((int64_t)blockIdx.x + (int64_t)(g / nwin) * G) * NT;
      const int t0 = (g % nwin) * W, nst = min(W, steps - t0);
      T* dst = const_cast<T*>(stage(g));
      auto copy = [&](int r, int c, int w0, int wstep) {
        const bool zr = r < d();
        const int64_t down = (int64_t)(zr ? d() : l()) * n;  // a step further down the row
        const T* end = zr ? z + (int64_t)steps * d() * n : x + (int64_t)steps * l() * n;
        const T* src = (zr ? z + (int64_t)r * n : x + (int64_t)(r - d()) * n) + (t0 + w0) * down + i0;
        T* sd = dst + (w0 * rows() + r) * P + c * V;
        for (int w = w0; w < nst; w += wstep, src += wstep * down, sd += wstep * rows() * P) {
          const T* a = src - ((reinterpret_cast<uintptr_t>(src) / sizeof(T)) & (V - 1)) + c * V;
          const bool in = a < end;
          mtm::cp_async16(sd, in ? a : src, in ? 16 : 0);
        }
      };
      const int per = (int)blockDim.x / CH;  // rows a pass
      for (int r = (int)threadIdx.x / CH; r < rows(); r += per) copy(r, threadIdx.x % CH, 0, 1);
      if (extra)
        for (int u = threadIdx.x; u < rows() * nst; u += blockDim.x) copy(u % rows(), CH, u / rows(), nst);
    }
    mtm::cp_async_commit();
  }
  // before window g: it has landed for every thread, and every thread is
  // done with window g - 1, whose stage then takes window g + ns - 1
  __device__ __forceinline__ void enter(int g) const {
    mtm::cp_async_wait(ns - 2);  // ns is 2 or 3
    cta_sync();
    issue(g + ns - 1);
  }
};

// The walk of the parts PARTS (bit p: part p; 7: all three) of lane j of
// the block's tiles: each step's slices from the ring, each row's sum
// over t in order, the rows stored to Φ.  The transition part runs one
// step behind: its step t - 1 takes z_{t-1} (kept in registers) and z_t;
// its last step z_{T-1} twice, as longT_rows reads zn at min(t + 1, T - 1).
// ALIGNED: every row starts on a 16-byte line (no offsets to add).
template <int PARTS, bool ALIGNED, typename T, int DM, int LM, bool FIXED, int NT>
__device__ __forceinline__ void walk(const Ring<T, DM, LM, FIXED, NT>& ring, const int* __restrict__ lens,
                                     T* __restrict__ phi, int Fpad, int j, int mine) {
  using R = Ring<T, DM, LM, FIXED, NT>;
  constexpr int V = R::V, P = R::P;
  const LongTLayout o(ring.d(), ring.l());
  const int slab = (o.d + o.l) * P, steps = ring.steps;
  const int64_t n = ring.n;
  // each array's base: values into its 16-byte line
  const int bz = (int)((reinterpret_cast<uintptr_t>(ring.z) / sizeof(T)) & (V - 1));
  const int bx = (int)((reinterpret_cast<uintptr_t>(ring.x) / sizeof(T)) & (V - 1));
  int g = 0;
  for (int it = 0; it < mine; ++it) {
    const int64_t i = ((int64_t)blockIdx.x + (int64_t)it * ring.G) * NT + j;
    const bool active = i < n;
    const int len = active ? lens[i] : 0;
    T* col = phi + i;
    auto put = [&](int row, T v) { __stcs(col + (int64_t)row * n, v); };
    auto vm_at = [&](int t) { return (len > t + 1 && t < steps - 1) ? T(1) : T(0); };
    RowsZZ<T, DM> r0;
    RowsZN<T, DM> r1;
    RowsX<T, DM, LM> r2;
    T zp[DM];
    const T* st = nullptr;
    for (int t = 0, w = ring.W; t < steps; ++t, ++w) {
      if (w == ring.W) {
        ring.enter(g);
        st = ring.stage(g) + j;
        ++g;
        w = 0;
      }
      if (active) {
        const T* s = st + w * slab;
        T zc[DM];
#pragma unroll
        for (int a = 0; a < DM; ++a)
          if (a < o.d) zc[a] = finite_or_zero(s[a * P + ring.template offset<ALIGNED>(bz, t * o.d + a)]);
        if constexpr ((PARTS & 1) != 0) {
          if (t == 0) r0.template step<true>(o, zc, vm_at(t), put);
          else r0.template step<false>(o, zc, vm_at(t), put);
        }
        if constexpr ((PARTS & 4) != 0) {
          T xc[LM];
          const T* sx = s + o.d * P;
#pragma unroll
          for (int b = 0; b < LM; ++b)
            if (b < o.l) xc[b] = finite_or_zero(sx[b * P + ring.template offset<ALIGNED>(bx, t * o.l + b)]);
          r2.step(o, zc, xc);
        }
        if constexpr ((PARTS & 2) != 0) {
          if (t == 1) r1.template step<true>(o, zp, zc, vm_at(0), put);
          else if (t > 1) r1.template step<false>(o, zp, zc, vm_at(t - 1), put);
#pragma unroll
          for (int a = 0; a < DM; ++a) zp[a] = zc[a];
        }
      }
    }
    if (active) {
      if constexpr ((PARTS & 1) != 0) r0.finish(o, true, put);
      if constexpr ((PARTS & 2) != 0) {
        if (steps == 1) r1.template step<true>(o, zp, zp, vm_at(0), put);
        else r1.template step<false>(o, zp, zp, vm_at(steps - 1), put);
        r1.finish(o, true, put);
      }
      if constexpr ((PARTS & 4) != 0) r2.finish(o, len, Fpad, put);
    }
  }
}

// The parts of thread threadIdx.x (q = 1: all; q = 3: the part of its
// warps, whole warps since a tile is ≥ 32 instances).
template <int Q, bool ALIGNED, typename T, int DM, int LM, bool FIXED, int NT>
__device__ __forceinline__ void walk_parts(const Ring<T, DM, LM, FIXED, NT>& ring, const int* __restrict__ lens,
                                           T* __restrict__ phi, int Fpad, int mine) {
  const int j = threadIdx.x % NT;
  if constexpr (Q == 1) {
    walk<7, ALIGNED>(ring, lens, phi, Fpad, j, mine);
  } else {
    const int part = threadIdx.x / NT;
    if (part == 0) walk<1, ALIGNED>(ring, lens, phi, Fpad, j, mine);
    else if (part == 1) walk<2, ALIGNED>(ring, lens, phi, Fpad, j, mine);
    else walk<4, ALIGNED>(ring, lens, phi, Fpad, j, mine);
  }
}

template <typename T, int DM, int LM, bool FIXED, int Q>
__global__ void __launch_bounds__(Q* kTile<Q>, kMinBlocks<Q>)
    features_longT_staged(const T* __restrict__ z, const T* __restrict__ x, const int* __restrict__ lens,
                          T* __restrict__ phi, int64_t n, int steps, int d_rt, int l_rt, int Fpad, int W, int ns) {
  constexpr int V = 16 / sizeof(T), NT = kTile<Q>;
  extern __shared__ __align__(16) unsigned char smem[];
  const int64_t ntiles = (n + NT - 1) / NT, G = gridDim.x;
  const int mine = blockIdx.x < ntiles ? (int)((ntiles - 1 - blockIdx.x) / G + 1) : 0;
  const int nwin = (steps + W - 1) / W;
  // a row can start inside a 16-byte line: one piece more a row
  const int extra = ((n & (V - 1)) | (reinterpret_cast<uintptr_t>(z) / sizeof(T) & (V - 1)) |
                     (reinterpret_cast<uintptr_t>(x) / sizeof(T) & (V - 1))) != 0;
  const Ring<T, DM, LM, FIXED, NT> ring{z, x, reinterpret_cast<T*>(smem), n, G, mine * nwin, d_rt, l_rt, steps,
                                        W, ns, nwin, extra};
  for (int g = 0; g < ns - 1; ++g) ring.issue(g);
  if (extra) walk_parts<Q, false>(ring, lens, phi, Fpad, mine);
  else walk_parts<Q, true>(ring, lens, phi, Fpad, mine);
  mtm::cp_async_wait(0);
}

// One dynamic shared-memory limit a body, raised (never lowered) by both
// the launch and the occupancy query.
template <typename T, int DM, int LM, bool FIXED, int Q>
mtm::SmemLimit& smem_limit() {
  static mtm::SmemLimit limit;
  return limit;
}

struct StagedArgs {
  const void* z;
  const void* x;
  const int* lens;
  void* phi;
  int64_t n;
  int steps, d, l, Fpad, W, ns, grid;
  cudaStream_t stream;
};

struct RunOp {
  const StagedArgs& a;
  template <typename T, int DM, int LM, bool FIXED, int Q>
  int go() const {
    const size_t smem = staged_smem(sizeof(T), kTile<Q>, a.d + a.l, a.W, a.ns);
    if (smem > kMaxSmem) return -1;
    auto kern = features_longT_staged<T, DM, LM, FIXED, Q>;
    cudaError_t err = smem_limit<T, DM, LM, FIXED, Q>().raise(kern, smem);
    if (err != cudaSuccess) return (int)err;
    kern<<<(unsigned)a.grid, Q * kTile<Q>, smem, a.stream>>>(
        static_cast<const T*>(a.z), static_cast<const T*>(a.x), a.lens, static_cast<T*>(a.phi), a.n, a.steps, a.d,
        a.l, a.Fpad, a.W, a.ns);
    return (int)cudaGetLastError();
  }
};

// The occupancy of a launch: {smem bytes, threads, blocks an SM, SMs,
// registers a thread, local bytes a thread}.
struct ConfigOp {
  int d, l, W, ns;
  int* out;
  template <typename T, int DM, int LM, bool FIXED, int Q>
  int go() const {
    const size_t smem = staged_smem(sizeof(T), kTile<Q>, d + l, W, ns);
    if (smem > kMaxSmem) return -1;
    auto kern = features_longT_staged<T, DM, LM, FIXED, Q>;
    int dev = 0, sms = 0, blocks = 0;
    cudaFuncAttributes attr{};
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess) err = smem_limit<T, DM, LM, FIXED, Q>().raise(kern, smem);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kern, Q * kTile<Q>, smem);
    if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, kern);
    if (err != cudaSuccess) return (int)err;
    if (blocks == 0) return -1;
    out[0] = (int)smem, out[1] = Q * kTile<Q>, out[2] = blocks, out[3] = sms, out[4] = attr.numRegs;
    out[5] = (int)attr.localSizeBytes;
    return 0;
  }
};

// The body of (d, l) with nt instances a tile and q threads an instance:
// the ones compiled for its instantiation (kQ, kTile) or -1.
template <typename T, int DM, int LM, bool FIXED, class Op>
int with_q(int nt, int q, const Op& op) {
  constexpr int Q = kQ<T, FIXED>;
  return q == Q && nt == kTile<Q> ? op.template go<T, DM, LM, FIXED, Q>() : -1;
}

template <typename T, class Op>
int dispatch_staged(int d, int l, int nt, int q, const Op& op) {
#define MTM_LONGT_SHAPE(DD, LL) \
  if (d == DD && l == LL) return with_q<T, DD, LL, true>(nt, q, op);
  MTM_LONGT_SHAPE(5, 3)
  MTM_LONGT_SHAPE(2, 4)
  MTM_LONGT_SHAPE(2, 3)
  MTM_LONGT_SHAPE(3, 2)
  MTM_LONGT_SHAPE(1, 3)
  MTM_LONGT_SHAPE(1, 1)
#undef MTM_LONGT_SHAPE
  return with_q<T, kLongTMax, kLongTMax, false>(nt, q, op);
}

template <class Op>
int dispatch_kind(int kind, int d, int l, int nt, int q, const Op& op) {
  if (kind == 0) return dispatch_staged<float>(d, l, nt, q, op);
  if (kind == 1) return dispatch_staged<double>(d, l, nt, q, op);
  return -1;
}

// (d, l) up to kLongTMax, 1..16 steps a stage, 2 or 3 stages
bool plan_ok(int d, int l, int W, int ns) {
  return d >= 1 && l >= 1 && d <= kLongTMax && l <= kLongTMax && W >= 1 && W <= kMaxStageSteps && ns >= 2 &&
         ns <= 3;
}

}  // namespace

// The largest d and l the kernel takes.
extern "C" int mtm_markov_features_longT_max_dim() { return kLongTMax; }

// The global-memory body.  kind: 0 float32, 1 float64.  Returns a
// cudaError_t (0 on success), or -1 for an argument the kernel does not
// take.
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

// The staged body on the host plan (ops/markov_kernels.py: k5_plan): nt
// instances a tile and q threads an instance (the ones compiled for the
// shape and type), W steps a stage, ns stages, a persistent grid of
// `grid` blocks.  kind: 0 float32, 1 float64.  Returns a cudaError_t (0 on
// success), or -1 for an argument or plan the kernel does not take.
extern "C" int mtm_markov_features_longT_staged(int device, int kind, const void* z, const void* x,
                                                const void* lens, void* phi, long long n, int steps, int d,
                                                int l, int Fpad, int nt, int q, int W, int ns, int grid,
                                                void* stream) {
  if (n <= 0 || steps <= 0 || grid < 1 || nt < 1 || !plan_ok(d, l, W, ns)) return -1;
  if (Fpad < 4 * d * d + l * l + d * l + 3 * d + l + 2) return -1;
  // a block's windows are counted in an int
  const long long per_block = ((n + nt - 1) / nt + grid - 1) / grid;
  if (per_block * ((steps + W - 1) / W) > (1LL << 30)) return -1;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const StagedArgs a{z, x, static_cast<const int*>(lens), phi, (int64_t)n, steps, d, l, Fpad, W, ns, grid,
                     static_cast<cudaStream_t>(stream)};
  return dispatch_kind(kind, d, l, nt, q, RunOp{a});
}

// The staged body's launch of a plan on the current device: out = {smem
// bytes, threads, blocks an SM, SMs, registers a thread, local bytes a
// thread}.  Returns a cudaError_t (0 on success), or -1 for a plan the
// kernel does not take.
extern "C" int mtm_markov_features_longT_staged_config(int kind, int d, int l, int nt, int q, int W, int ns,
                                                       void* out) {
  if (!plan_ok(d, l, W, ns)) return -1;
  return dispatch_kind(kind, d, l, nt, q, ConfigOp{d, l, W, ns, static_cast<int*>(out)});
}
