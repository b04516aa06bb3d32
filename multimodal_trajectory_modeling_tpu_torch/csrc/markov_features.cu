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
// What bounds it on the card: the bytes of u and the lengths read and of
// Φ written (324 MB + 448 MB at n = 1e6, T = 10, d = 5, l = 3 in float32:
// 0.230 ms at 3.35 TB/s), once per fit; its ~1 000 products and sums an
// instance take ~0.015 ms at 67 TFLOP/s.
//
// Two bodies, chosen by the wrapper from the dtype and the shape
// (ops/markov_kernels.py: k2_plan):
// - the row-at-a-time body (float64, and any shape no staged block fits):
//   one thread an instance, each row a loop over the steps that reads
//   both factors of every term from u in device memory (~2 000 loads an
//   instance for 80 values at the bench shape, served by L1/L2);
// - the staged body (float32): persistent blocks (the grid is the SMs
//   times the blocks an SM that shared memory and registers allow) walk
//   the tiles b, b + G, ... of NT instances; a tile's u (T·s rows × NT)
//   and lengths go into a ring of two tiles by cp.async (16 bytes where
//   n % 4 == 0 and the rows are 16-byte aligned, else 4), the next tile's
//   copies issued before this tile's build, so they land during it.  q
//   threads an instance (part p = tid / NT: whole warps), each owning the
//   rows f ≡ p (mod q).  At the shapes with a compile-time row table
//   ((d, l) = (5, 3), the bench's, and (2, 4), ADNI's) a thread keeps a
//   step's s values and the next step's in registers and adds each owned
//   row's term for that step (markov_step_rows.cuh, float32 K4a's build);
//   other shapes build each row from the staged tile with acc_row_tile
//   (markov_packed_tile.cuh).  Both give every entry acc_row's terms in
//   its order, so Φ equals the row-at-a-time body's bit for bit.  Each row
//   then goes straight to Φ with a streaming store: a warp is 32
//   consecutive instances of one part, so a store is one 128-byte row
//   segment.
// What the card showed (tools/k2_phase_split.py, n = 1e6, the bench
// shape): the copies alone take 0.104 ms, the stores alone 0.144 (0.249 at
// n = 1e6 + 37, whose rows of Φ start off the 128-byte lines), the build
// hides under them; tiles of 128 instances and one block of 512 threads
// an SM (80 registers) beat tiles of 32 or 64 and blocks capped at 64
// registers, most at n = 1e6 + 37 (0.36 against 0.47-0.61 ms).

#include <cuda_runtime.h>
#include <stdint.h>

#include <utility>

#include "markov_common.cuh"
#include "markov_packed_tile.cuh"
#include "markov_step_rows.cuh"

namespace {

using mtm::Fixed;

// ---------------------------------------------------------------------
// The row-at-a-time body

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

// ---------------------------------------------------------------------
// The staged float32 body

constexpr int kMaxThreads = 512;     // NT · q
constexpr size_t kMaxSmem = 232448;  // a block's shared-memory limit
constexpr int kMaxRing = 2;
constexpr int kQ = 4;  // threads an instance at the fixed shapes: (5, 3)'s 111 rows in parts of 27-28

// Shared memory of a block: the u ring (ring, T·s, NT) in floats, then
// the lengths (ring, NT) and the row table (Fcp) in ints.
// ops/markov_kernels.py: k2_smem is the same sum.
size_t staged_smem(int Fcp, int Ts, int nt, int ring) {
  return 4 * ((size_t)ring * Ts * nt + (size_t)ring * nt + Fcp);
}

// SHAPE 53 and 24: the compile-time tables of (d, l) = (5, 3) and (2, 4);
// 0: any (d, l), each row by acc_row_tile.
template <int SHAPE>
__global__ void __launch_bounds__(kMaxThreads, 1)
    features_staged(const float* __restrict__ u, const int* __restrict__ lens, const int* __restrict__ desc,
                    float* __restrict__ phi, int64_t n, int steps, int s, int Fc, int Fcp, int NT, int ring,
                    int aligned) {
  const int tid = threadIdx.x, q = blockDim.x / NT;
  const int part = tid / NT, j = tid % NT;  // NT ≥ 32: a part is whole warps
  const int Ts = steps * s;
  const int64_t ntiles = (n + NT - 1) / NT, G = gridDim.x;

  extern __shared__ __align__(16) unsigned char smem[];
  float* s_u = reinterpret_cast<float*>(smem);
  int* s_len = reinterpret_cast<int*>(s_u + (size_t)ring * Ts * NT);
  int* s_desc = s_len + ring * NT;  // kind | k << 4 | r << 14
  if constexpr (SHAPE == 0) {
    for (int f = tid; f < Fc; f += blockDim.x) s_desc[f] = desc[3 * f] | desc[3 * f + 1] << 4 | desc[3 * f + 2] << 14;
  }

  // tile `tile` into ring slot `slot`; the caller commits the group
  auto issue = [&](int64_t tile, int slot) {
    mtm::stage_packed_tile(s_u + (size_t)slot * Ts * NT, s_len + slot * NT, u, lens, n, tile * NT, NT, Ts, aligned);
  };
  // part `part`'s rows of instance i0 + j from ring slot `slot`, stored to Φ
  auto build_tile = [&](int64_t i0, int slot) {
    const int64_t i = i0 + j;
    if (i >= n) return;
    const float* su = s_u + (size_t)slot * Ts * NT + j;
    const int len = s_len[slot * NT + j];
    float* col = phi + i;
    auto sink = [=](int f, float v) { __stcs(col + (int64_t)f * n, v); };
    if constexpr (SHAPE == 53) {
      mtm::build_fixed<Fixed<5, 3>, kQ>(std::make_integer_sequence<int, kQ>{}, part, su, NT, steps, len, sink);
    } else if constexpr (SHAPE == 24) {
      mtm::build_fixed<Fixed<2, 4>, kQ>(std::make_integer_sequence<int, kQ>{}, part, su, NT, steps, len, sink);
    } else {
      for (int f = part; f < Fc; f += q) {
        const int d = s_desc[f];
        sink(f, mtm::acc_row_tile(d & 0xF, d >> 4 & 0x3FF, d >> 14, su, NT, len, steps, s));
      }
    }
    for (int f = Fc + part; f < Fcp; f += q) sink(f, 0.f);
  };

  // the block's first tile into slot 0
  if (blockIdx.x < ntiles) issue(blockIdx.x, 0);
  mtm::cp_async_commit();
  int it = 0;
  for (int64_t tile = blockIdx.x; tile < ntiles; tile += G, ++it) {
    mtm::cp_async_wait(0);
    __syncthreads();  // the tile has landed for every thread; every thread is done with the last tile
    if (ring > 1) {   // the next tile into the slot the last tile's build freed
      if (tile + G < ntiles) issue(tile + G, (it + 1) & 1);
      mtm::cp_async_commit();
    }
    build_tile(tile * NT, ring > 1 ? it & 1 : 0);
    if (ring == 1) {  // one slot: the next tile's copies after the build
      __syncthreads();
      if (tile + G < ntiles) issue(tile + G, 0);
      mtm::cp_async_commit();
    }
  }
  mtm::cp_async_wait(0);
}

// One dynamic shared-memory limit a body, raised (never lowered) by both
// the launch and the occupancy query.
template <int SHAPE>
mtm::SmemLimit& smem_limit() {
  static mtm::SmemLimit limit;
  return limit;
}

template <int SHAPE>
int run_staged(const float* u, const int* lens, const int* desc, float* phi, int64_t n, int steps, int s, int Fc,
               int Fcp, int nt, int q, int ring, int grid, cudaStream_t stream) {
  const size_t smem = staged_smem(Fcp, steps * s, nt, ring);
  if (smem > kMaxSmem) return -1;
  auto kern = features_staged<SHAPE>;
  cudaError_t err = smem_limit<SHAPE>().raise(kern, smem);
  if (err != cudaSuccess) return (int)err;
  const int aligned = n % 4 == 0 && reinterpret_cast<uintptr_t>(u) % 16 == 0 &&
                      reinterpret_cast<uintptr_t>(lens) % 16 == 0;
  kern<<<(unsigned)grid, nt * q, smem, stream>>>(u, lens, desc, phi, n, steps, s, Fc, Fcp, nt, ring, aligned);
  return (int)cudaGetLastError();
}

// The occupancy of a launch: {smem bytes, threads, blocks an SM, SMs,
// registers a thread, local bytes a thread}.
template <int SHAPE>
int config_staged(int Fcp, int Ts, int nt, int q, int ring, int* out) {
  const size_t smem = staged_smem(Fcp, Ts, nt, ring);
  if (smem > kMaxSmem) return -1;
  auto kern = features_staged<SHAPE>;
  int dev = 0, sms = 0, blocks = 0;
  cudaFuncAttributes attr{};
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess) err = smem_limit<SHAPE>().raise(kern, smem);
  if (err == cudaSuccess) err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kern, nt * q, smem);
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, kern);
  if (err != cudaSuccess) return (int)err;
  if (blocks == 0) return -1;
  out[0] = (int)smem, out[1] = nt * q, out[2] = blocks, out[3] = sms, out[4] = attr.numRegs;
  out[5] = (int)attr.localSizeBytes;
  return 0;
}

// The body of (d, l): its compile-time table where `table` and one is
// compiled (q must then be kQ), else acc_row_tile.
template <class Op>
int dispatch_shape(int d, int l, int table, Op op) {
  if (table && d == 5 && l == 3) return op.template go<53>();
  if (table && d == 2 && l == 4) return op.template go<24>();
  return op.template go<0>();
}

struct RunOp {
  const float* u;
  const int* lens;
  const int* desc;
  float* phi;
  int64_t n;
  int steps, s, Fc, Fcp, nt, q, ring, grid;
  cudaStream_t stream;
  template <int SHAPE>
  int go() const {
    return run_staged<SHAPE>(u, lens, desc, phi, n, steps, s, Fc, Fcp, nt, q, ring, grid, stream);
  }
};

struct ConfigOp {
  int Fcp, Ts, nt, q, ring;
  int* out;
  template <int SHAPE>
  int go() const {
    return config_staged<SHAPE>(Fcp, Ts, nt, q, ring, out);
  }
};

bool fixed_ok(int d, int l, int Fc, int q) {
  if (d == 5 && l == 3) return Fc == Fixed<5, 3>::fc() && q == kQ;
  if (d == 2 && l == 4) return Fc == Fixed<2, 4>::fc() && q == kQ;
  return true;
}

bool staged_ok(int d, int l, int s, int Fc, int Fcp, int nt, int q, int ring, int table) {
  if (d < 1 || l < 0 || s != 8 * ((d + l + 7) / 8) || Fcp % 8 != 0 || Fc > Fcp) return false;
  if ((nt != 32 && nt != 64 && nt != 128) || q < 1 || nt * q > kMaxThreads || ring < 1 || ring > kMaxRing)
    return false;
  return !table || fixed_ok(d, l, Fc, q);
}

}  // namespace

// The row-at-a-time body.  dtype: 0 float32, 1 float64.  Returns a
// cudaError_t (0 on success), or -1 for an argument the kernel does not
// take.
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

// The staged float32 body on the host plan (ops/markov_kernels.py:
// k2_plan): nt instances a tile (128, 64 or 32), q threads an instance, a
// ring of `ring` tiles (1 or 2) and a persistent grid of `grid` blocks;
// `table` 1 takes the shape's compile-time table where one is compiled, 0
// always acc_row_tile.  Returns a cudaError_t (0 on success), or -1 for an
// argument or plan the kernel does not take.
extern "C" int mtm_markov_features_staged(int device, const void* u, const void* lens, const void* desc, void* phi,
                                          long long n, int steps, int d, int l, int Fc, int Fcp, int nt, int q,
                                          int ring, int grid, int table, void* stream) {
  const int s = 8 * ((d + l + 7) / 8);
  if (n <= 0 || steps <= 0 || grid < 1 || !staged_ok(d, l, s, Fc, Fcp, nt, q, ring, table)) return -1;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const RunOp op{static_cast<const float*>(u), static_cast<const int*>(lens), static_cast<const int*>(desc),
                 static_cast<float*>(phi), (int64_t)n, steps, s, Fc, Fcp, nt, q, ring, grid,
                 static_cast<cudaStream_t>(stream)};
  return dispatch_shape(d, l, table, op);
}

// The staged body's launch of a plan on the current device: out = {smem
// bytes, threads, blocks an SM, SMs, registers a thread, local bytes a
// thread}.  Returns a cudaError_t (0 on success), or -1 for a plan the
// kernel does not take.
extern "C" int mtm_markov_features_staged_config(int d, int l, int Fc, int Fcp, int Ts, int nt, int q, int ring,
                                                 int table, void* out) {
  const int s = 8 * ((d + l + 7) / 8);
  if (Ts <= 0 || Ts % s != 0 || !staged_ok(d, l, s, Fc, Fcp, nt, q, ring, table)) return -1;
  return dispatch_shape(d, l, table, ConfigOp{Fcp, Ts, nt, q, ring, static_cast<int*>(out)});
}
