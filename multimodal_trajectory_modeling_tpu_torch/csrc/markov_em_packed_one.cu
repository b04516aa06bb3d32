// K4a in float32: one hard-assignment EM iteration that rebuilds Φ from
// the packed batch u on every call.
//
// Replaces the TPU kernel ops/pallas_markov.py:markov_em_fused_packed
// (body _markov_em_packed_kernel) of the JAX package for float32 u and
// weights; markov_em_packed.cu sends those calls here and keeps float64
// K4a on the header's body (markov_em_multi.cuh).  Per instance i (one
// column of Φ, K2's compact rows):
//   scores_c = Σ_f wc[c, f] · Φ[f, i]   (C of them, K1's FMA chain)
//   na       = the first maximum, NaN counted as the maximum (jnp.argmax);
//              assign_mode "prev" skips the scores: na = prev[i]
//   assign   = prev[i] >= 0 ? na : C
// and over the valid instances counts, switches, the objective Σ best
// and the statistics macc[f, c] = Σ_{na == c} Φ[f, i].  Every Φ entry is
// K2's, and every score K1's FMA chain over it, so the assignments, counts
// and switches equal K1's on K2's float32 Φ bit for bit; the objective is
// summed in the header's order (per `sub` instances, slot j % 128, then
// block_sum's tree), so it equals float32 K4b's slot objective bit for bit.
//
// What bounds it on the card: the 320 MB of u read once (n = 1e6, T = 10,
// s = 8): 0.096 ms at 3.35 TB/s; the operations (~2 900 an instance: the
// build's ~1 000 products and sums, C · Fcp = 1 792 score FMAs, Fcp
// statistics sums) take ~0.09 ms at 67 TFLOP/s.
//
// What the header's body did (tools/k4a_phase_split.py on the parent
// tree): one thread built each of its instance's Φ rows by a loop over
// the steps that read both factors of every term from u in device memory
// (~2 160 loads an instance for 80 values), 128-thread blocks one after
// another in 2.5 waves, statistics by ordered_add (a dependent
// shared-memory read-add-write an instance a row), and a reduce with one
// thread an output.  Design, a part for each:
// - persistent blocks (the grid is the SMs times the blocks an SM that
//   the host plan's shared memory and the registers allow), each walking
//   the tiles b, b + G, ... of NT instances; a tile's u (T·s rows × NT)
//   and lengths are staged by cp.async (16 bytes where n % 4 == 0 and the
//   rows are 16-byte aligned, else 4) into a ring of two tiles, the next
//   tile's copies issued before this one's build, so they run during its
//   build, scores and statistics (with one slot, where two do not fit
//   shared memory, after its build);
// - the build: q threads an instance (part p = tid / NT: whole warps), each
//   owning Φ rows f ≡ p (mod q).  For the bench shape (d, l) = (5, 3) the
//   rows' kinds, shifts and rows are compile-time constants
//   (markov_acc_table.cuh), so a thread keeps a step's s values
//   and the next step's in registers (markov_step_rows.cuh, shared with
//   K2), loads each once from the staged
//   tile (conflict-free: neighbouring instances, neighbouring banks), and
//   adds every one of its rows' products for that step into a register:
//   each row is still summed over t in increasing order with acc_row's
//   operations and masks (markov_common.cuh), so every Φ entry equals
//   K2's bit for bit.  Other shapes build each row with acc_row_tile
//   (markov_packed_tile.cuh, K4b's build from the same kind of tile);
//   the rows go once into a Φ tile in shared memory at an odd pitch;
// - scores: thread j < NT takes instance j, its C scores in registers,
//   the weights (Fcp, CB) in shared memory read as 16-byte broadcasts,
//   FMAs on the CUDA cores in K1's order (never TF32);
// - statistics: warp 0 sorts the tile by cluster, stably (K4b's counting
//   sort on warp ballots, markov_packed_tile.cuh, which also gives the
//   counts); then every warp takes 32 Φ rows and a range of clusters and
//   adds each cluster's instances, in instance order, into float32 sums
//   in registers, which go into the block's running sums once per
//   cluster: no atomics, a fixed order, Inf and NaN summed as the plain
//   version sums them;
// - the objective: each valid instance's best score (0 for the others)
//   goes to a scratch row of n floats; the reduce sums it in the header's
//   order;
// - a reduce of the per-block partials in block order with one warp an
//   output (markov_common.cuh:warp_total), one warp a `sub` for the
//   objective's partials, and one block for their sum in order.
// With one block an SM the phases of a tile run one after another
// (tools/k4a_phase_split.py --clocks: build, scores, sort and statistics
// take about 4.7k, 6.2k, 2.9k and 4.4k cycles a tile of 128 at the bench
// shape; the copies are hidden).  Measured no faster: the scores on more
// threads (two halves of the clusters; four instances by four clusters a
// thread), the sort's ballots in the scoring warps, prev staged with u,
// the score or step loops unrolled, tiles of 64 or 32, a ring of 3, two
// threads an instance for the build.  A ring of one tile measured faster
// than two at the bench shape (tools/k4a_phase_split.py, ring1); two stay,
// so that a tile's copies are in flight during the tile before it.

#include <cuda_runtime.h>
#include <stdint.h>

#include <utility>

#include "markov_common.cuh"
#include "markov_packed_tile.cuh"
#include "markov_step_rows.cuh"

namespace {

using mtm::cp_async_commit;
using mtm::cp_async_wait;
using mtm::Fixed;
using mtm::fused_ma;
using mtm::is_nan;

constexpr int kMaxThreads = 512;  // NT · q
constexpr int kObjSlots = 128;     // the header's block: the objective's slots
constexpr size_t kMaxSmem = 232448;  // a block's shared-memory limit
constexpr int kMaxRing = 2;
// threads an instance: the bench shape's 111 rows in four parts of 27-28
// (any other shape's rows in the plan's q parts)
constexpr int kQ53 = 4;

// Shared memory of a block, in floats then ints: the u ring (ring, T·s,
// NT), the weights (Fcp, CB) under argmax, the statistics (Fcp, CB + 1),
// the Φ tile (Fcp, NT + 1); the lengths (ring, NT), na (NT), the sorted
// tile (NT), the sort's counts and first positions (2 · 33), the row table
// (Fcp), the block sum's scratch (32).  ops/markov_kernels.py:
// packed_one_smem is the same sum.
size_t one_smem(int Fcp, int Ts, int cb, int nt, int ring, bool argmax) {
  return 4 * ((size_t)ring * Ts * nt + (argmax ? (size_t)Fcp * cb : 0) + (size_t)Fcp * (cb + 1) +
              (size_t)Fcp * (nt + 1) + (size_t)ring * nt + 2 * (size_t)nt + 2 * mtm::kSeg + Fcp + 32);
}

template <int CB, bool ARGMAX, int SHAPE>
__global__ void __launch_bounds__(kMaxThreads, 1)
    packed_one_kernel(const float* __restrict__ u, const int* __restrict__ lens, const int* __restrict__ desc,
                      int steps, int s, int Fc, const int* __restrict__ prev, const float* __restrict__ wc,
                      int* __restrict__ assign, float* __restrict__ obj_inst, float* __restrict__ part_stats,
                      int* __restrict__ part_counts, int* __restrict__ part_sw, int64_t n, int Fcp, int C,
                      int NT, int ring, int aligned) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nthreads = blockDim.x, nwarps = nthreads >> 5, q = nthreads / NT;
  const int part = tid / NT, j = tid % NT;  // NT ≥ 32: a part is whole warps
  const int Ts = steps * s, pitch = NT + 1;  // odd: a warp reading a row or a column of Φ hits 32 banks
  constexpr int SB = CB + 1;                 // the statistics' row stride
  const int64_t ntiles = (n + NT - 1) / NT, G = gridDim.x;

  extern __shared__ __align__(16) unsigned char smem[];
  float* s_u = reinterpret_cast<float*>(smem);
  float* s_w = s_u + (size_t)ring * Ts * NT;
  float* s_st = s_w + (ARGMAX ? (size_t)Fcp * CB : 0);
  float* s_phi = s_st + (size_t)Fcp * SB;
  int* s_len = reinterpret_cast<int*>(s_phi + (size_t)Fcp * pitch);
  int* s_na = s_len + ring * NT;
  int* s_perm = s_na + NT;
  int* s_seg = s_perm + NT;
  int* s_desc = s_seg + 2 * mtm::kSeg;  // kind | k << 4 | r << 14
  int* s_ired = s_desc + Fcp;

  if constexpr (ARGMAX) {
    for (int e = tid; e < Fcp * CB; e += nthreads) {
      const int f = e / CB, c = e % CB;
      s_w[e] = c < C ? wc[(int64_t)c * Fcp + f] : 0.f;
    }
  }
  for (int e = tid; e < Fcp * SB; e += nthreads) s_st[e] = 0.f;
  if constexpr (SHAPE == 0) {
    for (int f = tid; f < Fc; f += nthreads) s_desc[f] = desc[3 * f] | desc[3 * f + 1] << 4 | desc[3 * f + 2] << 14;
  }

  // tile `tile`'s u (Ts rows x NT) and lengths into ring slot `slot`,
  // zero past n; the caller commits the group
  auto issue = [&](int64_t tile, int slot) {
    mtm::stage_packed_tile(s_u + (size_t)slot * Ts * NT, s_len + slot * NT, u, lens, n, tile * NT, NT, Ts, aligned);
  };

  // the tile in ring slot `slot` into s_phi: part p's rows of instance j
  auto build_tile = [&](int slot) {
    const float* su = s_u + (size_t)slot * Ts * NT + j;
    const int len = s_len[slot * NT + j];
    float* col = s_phi + j;
    if constexpr (SHAPE == 53) {
      auto sink = [=](int f, float v) { col[f * pitch] = v; };
      mtm::build_fixed<Fixed<5, 3>, kQ53>(std::make_integer_sequence<int, kQ53>{}, part, su, NT, steps, len, sink);
    } else {
      for (int f = part; f < Fc; f += q) {
        const int d = s_desc[f];
        col[f * pitch] = mtm::acc_row_tile(d & 0xF, d >> 4 & 0x3FF, d >> 14, su, NT, len, steps, s);
      }
    }
    for (int f = Fc + part; f < Fcp; f += q) col[f * pitch] = 0.f;
  };

  int sw = 0;      // this thread's switches
  int counts = 0;  // warp 0, lane c < C: cluster c's instances
  // thread j < NT: instance i0 + j's scores (K1's FMA chain over its Φ
  // column for each cluster), assignment (the first maximum, NaN counted
  // as the maximum), objective entry and switch; its cluster (or -1) into
  // s_na[j]
  auto score_tile = [&](int64_t i0) {
    if (tid >= NT) return;
    const int64_t i = i0 + tid;
    int kept = -1;
    if (i < n) {
      const int p = prev[i];
      const bool valid = p >= 0;
      float sc[CB];
#pragma unroll
      for (int c = 0; c < CB; ++c) sc[c] = 0.f;
      const float* col = s_phi + tid;
      for (int f = 0; f < Fcp; ++f) {
        const float v = col[f * pitch];
        const float4* wf = reinterpret_cast<const float4*>(s_w + f * CB);
#pragma unroll
        for (int g = 0; g < CB / 4; ++g) {
          const float4 w = wf[g];
          sc[4 * g] = fused_ma(w.x, v, sc[4 * g]);
          sc[4 * g + 1] = fused_ma(w.y, v, sc[4 * g + 1]);
          sc[4 * g + 2] = fused_ma(w.z, v, sc[4 * g + 2]);
          sc[4 * g + 3] = fused_ma(w.w, v, sc[4 * g + 3]);
        }
      }
      float best = sc[0];
      int na = 0;
#pragma unroll
      for (int c = 1; c < CB; ++c) {
        if (c < C && (sc[c] > best || (is_nan(sc[c]) && !is_nan(best)))) {
          best = sc[c];
          na = c;
        }
      }
      obj_inst[i] = valid ? best : 0.f;
      sw += valid && na != p;
      assign[i] = valid ? na : C;
      if (valid) kept = na;
    }
    s_na[tid] = kept;
  };
  auto prev_tile = [&](int64_t i0) {
    if (tid >= NT) return;
    const int64_t i = i0 + tid;
    int kept = -1;
    if (i < n) {
      const int p = prev[i];
      assign[i] = p >= 0 ? p : C;
      if (p >= 0 && p < C) kept = p;
    }
    s_na[tid] = kept;
  };
  // the sorted tile's statistics: item e = (32 rows, a range of clusters),
  // as many ranges as keep every warp busy
  const int nb = (Fcp + 31) / 32;
  const int H = max(1, min(C, nwarps / nb));
  auto stats_tile = [&]() {
    for (int e = warp; e < nb * H; e += nwarps) {
      const int rb = e % nb, h = e / nb;
      mtm::seg_sum_rows<CB, 1>(s_st, SB, s_phi, pitch, Fcp, s_perm, s_seg, rb * 32, C * h / H, C * (h + 1) / H);
    }
  };

  const int lead = ring > 1 ? ring - 1 : 1;  // tiles issued before the first
  for (int k = 0; k < lead; ++k) {
    const int64_t t = blockIdx.x + k * G;
    if (t < ntiles) issue(t, k);
    cp_async_commit();
  }
  int it = 0;
  for (int64_t tile = blockIdx.x; tile < ntiles; tile += G, ++it) {
    if (ring > 1) {  // ring - 1 tiles ahead, into the slot the last tile's build freed
      const int64_t ahead = tile + (ring - 1) * G;
      if (ahead < ntiles) issue(ahead, (it + ring - 1) % ring);
      cp_async_commit();
    }
    cp_async_wait(ring > 1 ? ring - 1 : 0);
    __syncthreads();  // the tile's u and lengths are in; the last tile's statistics are done
    build_tile(it % ring);
    __syncthreads();  // s_phi
    if (ring == 1) {  // one slot: the next tile's copies after the build
      if (tile + G < ntiles) issue(tile + G, 0);
      cp_async_commit();
    }
    const int64_t i0 = tile * NT;
    if (ARGMAX) score_tile(i0);
    else prev_tile(i0);
    __syncthreads();  // s_na
    if (warp == 0) counts += mtm::sort_tile<CB>(s_na, s_perm, s_seg, NT);
    __syncthreads();  // s_perm, s_seg
    stats_tile();
  }
  cp_async_wait(0);
  const int sw_blk = mtm::block_sum(sw, s_ired);  // its barriers: the last statistics are in s_st

  const int64_t b = blockIdx.x, FC = (int64_t)Fcp * C;
  for (int e = tid; e < Fcp * C; e += nthreads) part_stats[b * FC + e] = s_st[(e / C) * SB + e % C];
  if (warp == 0 && lane < C) part_counts[b * C + lane] = counts;
  if (tid == 0) part_sw[b] = sw_blk;
}

// The per-block partials added in block order, one warp an output: the
// statistics (FC), counts (C), switches; then one warp a `sub` of the
// objective: slot j < 128 the instances sub_start + j + 128 k in k order
// (0 for the invalid ones), the slots through block_sum's shuffle tree and
// warp order, as the header's 128-thread blocks sum them.
__global__ void packed_one_reduce(const float* __restrict__ part_stats, const int* __restrict__ part_counts,
                                  const int* __restrict__ part_sw, const float* __restrict__ obj_inst,
                                  float* __restrict__ macc, int* __restrict__ counts, int* __restrict__ switches,
                                  float* __restrict__ part_obj, int64_t nblocks, int64_t FC, int C, int64_t n,
                                  int sub, int64_t nsub) {
  const int64_t e = ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (e < FC) {
    const float a = mtm::warp_total(part_stats + e, FC, nblocks);
    if (lane == 0) macc[e] = a;
  } else if (e < FC + C) {
    const int a = mtm::warp_total(part_counts + (e - FC), C, nblocks);
    if (lane == 0) counts[e - FC] = a;
  } else if (e == FC + C) {
    const int a = mtm::warp_total(part_sw, 1, nblocks);
    if (lane == 0) *switches = a;
  } else if (e < FC + C + 1 + nsub) {
    const int64_t b = e - FC - C - 1, i0 = b * sub, i1 = i0 + sub < n ? i0 + sub : n;
    float tot = 0.f;
    for (int g = 0; g < kObjSlots / 32; ++g) {
      float v = 0.f;
      for (int64_t i = i0 + 32 * g + lane; i < i1; i += kObjSlots) v += obj_inst[i];
      for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
      tot += v;
    }
    if (lane == 0) part_obj[b] = tot;
  }
}

// The objective: the subs' partials added in order by one thread (0 under
// assign_mode "prev", nsub = 0), staged 1024 at a time.
__global__ void packed_one_objective(const float* __restrict__ part_obj, float* __restrict__ obj, int64_t nsub) {
  __shared__ float buf[1024];
  float a = 0.f;
  for (int64_t b0 = 0; b0 < nsub; b0 += 1024) {
    const int m = nsub - b0 < 1024 ? (int)(nsub - b0) : 1024;
    for (int k = threadIdx.x; k < m; k += blockDim.x) buf[k] = part_obj[b0 + k];
    __syncthreads();
    if (threadIdx.x == 0)
      for (int k = 0; k < m; ++k) a += buf[k];
    __syncthreads();
  }
  if (threadIdx.x == 0) *obj = a;
}

struct OneArgs {
  const float* u;
  const int* lens;
  const int* desc;
  const int* prev;
  const float* wc;
  int* assign;
  float* part_stats;
  int* part_counts;
  int* part_sw;
  float* scratch;  // n floats (each instance's objective entry), then nsub (the subs' partials)
  float* macc;
  int* counts;
  int* switches;
  float* obj;
  int64_t n;
  int steps, s, Fc, Fcp, C, sub, nt, q, ring, grid;
  cudaStream_t stream;
};

template <int CB, bool ARGMAX, int SHAPE>
int run_one(const OneArgs& a) {
  const size_t smem = one_smem(a.Fcp, a.steps * a.s, CB, a.nt, a.ring, ARGMAX);
  if (smem > kMaxSmem) return -1;
  auto kern = packed_one_kernel<CB, ARGMAX, SHAPE>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int aligned = a.n % 4 == 0 && reinterpret_cast<uintptr_t>(a.u) % 16 == 0 &&
                      reinterpret_cast<uintptr_t>(a.lens) % 16 == 0;
  kern<<<(unsigned)a.grid, a.nt * a.q, smem, a.stream>>>(a.u, a.lens, a.desc, a.steps, a.s, a.Fc, a.prev, a.wc,
                                                          a.assign, a.scratch, a.part_stats, a.part_counts,
                                                          a.part_sw, a.n, a.Fcp, a.C, a.nt, a.ring, aligned);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int64_t nsub = ARGMAX ? (a.n + a.sub - 1) / a.sub : 0;
  const int64_t FC = (int64_t)a.Fcp * a.C, warps = FC + a.C + 1 + nsub;
  packed_one_reduce<<<(unsigned)((warps + 7) / 8), 256, 0, a.stream>>>(
      a.part_stats, a.part_counts, a.part_sw, a.scratch, a.macc, a.counts, a.switches, a.scratch + a.n, a.grid,
      FC, a.C, a.n, a.sub, nsub);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  packed_one_objective<<<1, 256, 0, a.stream>>>(a.scratch + a.n, a.obj, nsub);
  return (int)cudaGetLastError();
}

// The occupancy of the launch: {smem bytes, threads, blocks an SM, SMs,
// registers a thread, local bytes a thread}.
template <int CB, bool ARGMAX, int SHAPE>
int config_one(int Fcp, int Ts, int nt, int q, int ring, int* out) {
  const size_t smem = one_smem(Fcp, Ts, CB, nt, ring, ARGMAX);
  if (smem > kMaxSmem) return -1;
  auto kern = packed_one_kernel<CB, ARGMAX, SHAPE>;
  int dev = 0, sms = 0, blocks = 0;
  cudaFuncAttributes attr{};
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess) err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess) err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kern, nt * q, smem);
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, kern);
  if (err != cudaSuccess) return (int)err;
  if (blocks == 0) return -1;
  out[0] = (int)smem, out[1] = nt * q, out[2] = blocks, out[3] = sms, out[4] = attr.numRegs;
  out[5] = (int)attr.localSizeBytes;
  return 0;
}

// The body of a (shape, C, mode): SHAPE 53 the compile-time table of
// (d, l) = (5, 3), 0 any other; assign_mode "prev" (no
// weights) sorts and sums up to 32 clusters.
template <int SHAPE, class Op>
int dispatch_cb(int C, bool argmax, Op op) {
  if (!argmax) return op.template go<32, false, SHAPE>();
  if (C <= 8) return op.template go<8, true, SHAPE>();
  if (C <= 16) return op.template go<16, true, SHAPE>();
  return op.template go<32, true, SHAPE>();
}

// The shape's body, or -1 where the plan's q is not the fixed body's.
template <class Op>
int dispatch_shape(int d, int l, int q, int C, bool argmax, Op op) {
  if (d == 5 && l == 3) return q == kQ53 ? dispatch_cb<53>(C, argmax, op) : -1;
  return dispatch_cb<0>(C, argmax, op);
}

struct RunOp {
  const OneArgs& a;
  template <int CB, bool ARGMAX, int SHAPE>
  int go() const {
    return run_one<CB, ARGMAX, SHAPE>(a);
  }
};

struct ConfigOp {
  int Fcp, Ts, nt, q, ring;
  int* out;
  template <int CB, bool ARGMAX, int SHAPE>
  int go() const {
    return config_one<CB, ARGMAX, SHAPE>(Fcp, Ts, nt, q, ring, out);
  }
};

bool plan_ok(int d, int l, int s, int Fc, int Fcp, int C, int nt, int q, int ring) {
  if (d < 1 || l < 0 || s != 8 * ((d + l + 7) / 8) || Fcp % 8 != 0 || Fc > Fcp || C < 1 || C > 32) return false;
  if ((nt != 32 && nt != 64 && nt != 128) || q < 1 || nt * q > kMaxThreads || ring < 1 || ring > kMaxRing)
    return false;
  if (d == 5 && l == 3 && Fc != Fixed<5, 3>::fc()) return false;
  return true;
}

}  // namespace

// Float32 K4a (R = 1), called by mtm_markov_em_packed (markov_em_packed.cu)
// after its argument checks and cudaSetDevice, with the host plan
// (ops/markov_kernels.py: packed_one_plan): nt instances a tile (128, 64
// or 32), q threads an instance, a ring of `ring` tiles (1 or 2), and a
// persistent grid of `grid` blocks (the partial buffers hold grid
// blocks).  part_obj holds n + ceil(n / sub) floats; `sub` must be a
// multiple of 128.  Returns a cudaError_t (0 on success), or -1 for an
// argument or plan the kernel does not take.
extern "C" int mtm_markov_em_packed_one(const void* u, const void* lens, const void* desc, const void* prev,
                                        const void* wc, void* assign, void* part_stats, void* part_counts,
                                        void* part_sw, void* part_obj, void* macc, void* counts, void* switches,
                                        void* obj, long long n, int steps, int s, int d, int l, int Fc, int Fcp,
                                        int C, int sub, int argmax, int nt, int q, int ring, int grid,
                                        void* stream) {
  if (n <= 0 || steps <= 0 || grid < 1 || sub <= 0 || sub % kObjSlots != 0 ||
      !plan_ok(d, l, s, Fc, Fcp, C, nt, q, ring))
    return -1;
  const OneArgs a{static_cast<const float*>(u), static_cast<const int*>(lens), static_cast<const int*>(desc),
                  static_cast<const int*>(prev), static_cast<const float*>(wc), static_cast<int*>(assign),
                  static_cast<float*>(part_stats), static_cast<int*>(part_counts), static_cast<int*>(part_sw),
                  static_cast<float*>(part_obj), static_cast<float*>(macc), static_cast<int*>(counts),
                  static_cast<int*>(switches), static_cast<float*>(obj), (int64_t)n, steps, s, Fc, Fcp, C, sub,
                  nt, q, ring, grid, static_cast<cudaStream_t>(stream)};
  return dispatch_shape(d, l, q, C, argmax != 0, RunOp{a});
}

// The launch of a plan on the current device: out = {smem bytes, threads,
// blocks an SM, SMs, registers a thread, local bytes a thread}.  Returns a
// cudaError_t (0 on success), or -1 for a plan the kernel does not take.
extern "C" int mtm_markov_em_packed_one_config(int d, int l, int Fc, int Fcp, int Ts, int C, int argmax, int nt,
                                               int q, int ring, void* out) {
  const int s = 8 * ((d + l + 7) / 8);
  if (Ts <= 0 || Ts % s != 0 || !plan_ok(d, l, s, Fc, Fcp, C, nt, q, ring)) return -1;
  return dispatch_shape(d, l, q, C, argmax != 0, ConfigOp{Fcp, Ts, nt, q, ring, static_cast<int*>(out)});
}

// The shared memory one_smem gives a plan, for the host plan's tests.
extern "C" int mtm_markov_em_packed_one_smem(int Fcp, int Ts, int C, int nt, int ring, int argmax) {
  const int cb = !argmax || C > 16 ? 32 : C > 8 ? 16 : 8;
  return (int)one_smem(Fcp, Ts, cb, nt, ring, argmax != 0);
}
