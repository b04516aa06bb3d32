// K9: the per-segment, per-cluster Gram statistics of the pattern-sorted
// dense trainer's M step.
//
// Replaces the TPU kernel ops/pallas_mstep.py:mstep_stats_gram_sorted
// (body _mstep_gram_kernel) of the JAX package.
//
// The batch v (n, D) is sorted by missingness pattern.  With
// U_i = [v_i(NaN -> 0), 1] (u = D + 1 entries), the kernel computes for
// every segment p and cluster c
//   G[p, c] = sum over rows i of p with assign_i == c of U_i U_i^T
// into G (P, C, u, u); rows with an assignment outside [0, C) count
// nowhere.  The selection of the valid (t, t') blocks stays in torch.
//
// Bound on the card: one read of v (320 MB at n = 1e6, D = 80: 0.1 ms at
// 3.35 TB/s); the upper triangle of the Gram, padded to 8 x 8 tiles, is
// ~4.2e9 FMAs there (0.13 ms at the float32 FMA peak).  Design:
// - work items of equal size, whatever the cluster sizes.  A stable
//   counting sort on the card lists the rows of each (segment, cluster) in
//   row order: gram_count counts each chunk's rows per cluster (chunks of
//   one segment each, from the wrapper's cached table), gram_scan lays
//   the lists out (segment, cluster, chunk) and cuts each into pieces of
//   at most R rows, gram_scatter writes the row indices.  gram_pieces
//   then takes one piece a block: the largest cluster costs more pieces,
//   not a longer block.  Nothing is read back to the host: the grid is
//   the bound ceil(n / R) + P C, and a block with no piece exits;
// - the gather overlaps the FMAs: a piece's rows come into two shared
//   buffers by cp.async (16-byte copies where a row is a multiple of 16
//   bytes, else one element each), warp w the stage's rows w, w + warps,
//   ..., their row indices loaded a stage ahead, with no division; stage
//   s + 1 is in flight while stage s is added.  Each thread maps its own
//   copies' NaN and +-Inf to 0 once they land; the ones column and the
//   padding are written once.  A staged row has 16 bytes of padding after
//   every 128 (swz), so a quarter-warp's tile vectors hit distinct banks;
// - 8 x 8 register tiles of the upper triangle (66 at D = 80): a thread
//   reads 16 values from shared memory for 64 FMAs.  Where a block has
//   fewer tiles than threads, the stage's rows are dealt to `subs` thread
//   groups, whose tiles are added in group order at the end;
// - a fixed summation order, so two calls give the same bits: within a
//   group its rows in row order, then the groups in order; gram_reduce
//   adds each (segment, cluster)'s pieces in piece order and mirrors the
//   triangle.  Integer atomics only count rows (exact); no float atomics;
// - IEEE FMAs on the CUDA cores in the input type, never TF32; the ones
//   column makes the member counts, exact in float32 up to 2^24 rows.

#include <cuda_runtime.h>
#include <stdint.h>

#include "markov_common.cuh"

namespace {

using mtm::fused_ma;

constexpr int kTile = 8;                 // a thread's tile: kTile x kTile
constexpr int kThreads = 256;            // most threads of a Gram block
constexpr int kMaxSubs = 8;              // most row groups of a block
constexpr int kStageBytes = 32 * 1024;   // one stage buffer's bytes, at most
constexpr int kStageRows = 64;           // rows a stage, at most
constexpr int kScanThreads = 1024;
constexpr int kScanItems = 16;           // flat entries a scan thread takes a round
constexpr int kPrefetch = 8;             // row windows a scatter warp loads at once
constexpr size_t kMaxSmem = 232448;
constexpr unsigned kAll = 0xffffffffu;

__host__ __device__ inline int padded_u(int D) {
  return (D + 1 + kTile - 1) / kTile * kTile;
}

__host__ __device__ inline int tiles_of(int up) {
  const int nt = up / kTile;
  return nt * (nt + 1) / 2;
}

// (I, J), I <= J, of tile t in row-major upper-triangle order
__device__ __forceinline__ void tile_ij(int t, int nt, int& I, int& J) {
  I = 0;
  while (t >= nt - I) {
    t -= nt - I;
    ++I;
  }
  J = I + t;
}

// Byte b of a row sits at b + 16 (b / 128) of its row in a stage: 16
// bytes of padding after every 128, so that the tile vectors of eight
// consecutive tiles (one quarter-warp's 16-byte loads) hit distinct banks.
__host__ __device__ inline int swz(int b) { return b + ((b >> 7) << 4); }

// The Gram blocks' shape for width D.
struct Layout {
  int up;        // U padded to a multiple of kTile
  int tiles;     // upper-triangle tiles
  int tpb;       // tiles a block
  int subs;      // row groups a block
  int threads;   // subs x tpb, in whole warps
  int groups;    // blocks per piece (grid y), tpb tiles each
  int rb;        // rows a stage
  int ld;        // bytes of a staged row (swz: padded every 128 bytes)
  size_t smem;   // dynamic shared memory bytes
};

template <typename T>
Layout layout_for(int D) {
  Layout L;
  L.up = padded_u(D);
  L.tiles = tiles_of(L.up);
  L.tpb = L.tiles < kThreads ? L.tiles : kThreads;
  L.subs = kThreads / L.tpb < kMaxSubs ? kThreads / L.tpb : kMaxSubs;
  L.threads = (L.subs * L.tpb + 31) / 32 * 32;
  L.groups = (L.tiles + L.tpb - 1) / L.tpb;
  L.ld = swz((int)sizeof(T) * L.up);
  const int rb = kStageBytes / L.ld;
  L.rb = rb < 1 ? 1 : (rb > kStageRows ? kStageRows : rb);
  const size_t stages = 2 * (size_t)L.rb * L.ld;
  const size_t scratch = L.subs > 1 ? sizeof(T) * (size_t)L.tpb * kTile * kTile : 0;
  L.smem = stages > scratch ? stages : scratch;
  return L;
}

// ---------------------------------------------------------------------
// The piece plan: a stable counting sort of the valid rows by
// (segment, cluster).  work (int32) holds, in order:
//   counts (chunks, C)  rows of each chunk per cluster
//   base   (chunks, C)  where chunk k's rows of cluster c start in idx
//                       (gram_scatter's cursors: it leaves them at the ends)
//   list_start (P C + 1)  where each (segment, cluster)'s list starts
//   piece_start (P C + 1) its first piece; piece_start[P C] pieces in all
//   idx (n)             the lists' row indices
// ---------------------------------------------------------------------

__global__ void gram_count(const int* __restrict__ assign,
                           const int* __restrict__ table,
                           int* __restrict__ counts, int C) {
  const int k = blockIdx.x, lane = threadIdx.x & 31;
  const int64_t r0 = table[3 * k + 1];
  const int rows = table[3 * k + 2];
  for (int w0 = threadIdx.x & ~31; w0 < rows; w0 += blockDim.x) {
    const int r = w0 + lane;
    const int a = r < rows ? assign[r0 + r] : -1;
    const bool ok = a >= 0 && a < C;
    const unsigned peers = __match_any_sync(kAll, ok ? a : -1);
    if (ok && lane == __ffs(peers) - 1)
      atomicAdd(&counts[(size_t)k * C + a], __popc(peers));
  }
}

// Exclusive prefix of x over the block in thread order; total to all.
__device__ int block_scan(int x, int& total) {
  __shared__ int s_w[33];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  int inc = x;
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(kAll, inc, o);
    if (lane >= o) inc += y;
  }
  if (lane == 31) s_w[warp] = inc;
  __syncthreads();
  if (warp == 0) {
    const int w = lane < nw ? s_w[lane] : 0;
    int wi = w;
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(kAll, wi, o);
      if (lane >= o) wi += y;
    }
    s_w[lane] = wi - w;
    if (lane == 31) s_w[32] = wi;
  }
  __syncthreads();
  const int ex = s_w[warp] + inc - x;
  total = s_w[32];
  __syncthreads();  // s_w is rewritten by the next call
  return ex;
}

// One block.  The flat order of the lists is (segment p, cluster c,
// chunk k of p): segment p's entries are [first[p] C, first[p + 1] C).
__global__ void __launch_bounds__(kScanThreads) gram_scan(
    const int* __restrict__ table, const int* __restrict__ first,
    const int* __restrict__ counts, int* __restrict__ base,
    int* __restrict__ list_start, int* __restrict__ piece_start, int P,
    int C, int chunks, int R) {
  const int tid = threadIdx.x;
  const int nf = chunks * C, PC = P * C;
  int carry = 0;
  for (int f0 = 0; f0 < nf; f0 += kScanThreads * kScanItems) {
    int val[kScanItems], pos[kScanItems];
    int sum = 0;
#pragma unroll
    for (int i = 0; i < kScanItems; ++i) {
      const int f = f0 + tid * kScanItems + i;
      val[i] = 0;
      pos[i] = -1;
      if (f < nf) {
        const int p = table[3 * (f / C)];
        const int k0 = first[p], nk = first[p + 1] - k0;
        const int local = f - k0 * C;
        pos[i] = (k0 + local % nk) * C + local / nk;
        val[i] = counts[pos[i]];
      }
      sum += val[i];
    }
    int total;
    int ex = carry + block_scan(sum, total);
#pragma unroll
    for (int i = 0; i < kScanItems; ++i) {
      if (pos[i] >= 0) base[pos[i]] = ex;
      ex += val[i];
    }
    carry += total;
  }
  __syncthreads();  // base is read below
  for (int pc = tid; pc < PC; pc += kScanThreads) {
    const int p = pc / C, c = pc - p * C;
    const int k0 = first[p], nk = first[p + 1] - k0;
    // an empty segment's lists start where the next segment's do
    list_start[pc] = nk > 0 ? base[k0 * C + c] : (k0 < chunks ? base[k0 * C] : carry);
  }
  if (tid == 0) list_start[PC] = carry;
  __syncthreads();
  int pieces = 0;
  for (int pc0 = 0; pc0 < PC; pc0 += kScanThreads) {
    const int pc = pc0 + tid;
    const int len = pc < PC ? list_start[pc + 1] - list_start[pc] : 0;
    const int np = (len + R - 1) / R;
    int total;
    const int ex = block_scan(np, total);
    if (pc < PC) piece_start[pc] = pieces + ex;
    pieces += total;
  }
  if (tid == 0) piece_start[PC] = pieces;
}

// One warp a chunk: its rows of each cluster, in row order, at base.
// The chunk's cursors are its own entries of base, advanced in place.
__global__ void __launch_bounds__(32) gram_scatter(
    const int* __restrict__ assign, const int* __restrict__ table,
    int* __restrict__ base, int* __restrict__ idx, int C) {
  const int k = blockIdx.x, lane = threadIdx.x;
  const int r0 = table[3 * k + 1];
  const int rows = table[3 * k + 2];
  int* cur = base + (size_t)k * C;
  for (int w0 = 0; w0 < rows; w0 += 32 * kPrefetch) {
    int a[kPrefetch];
#pragma unroll
    for (int j = 0; j < kPrefetch; ++j) {
      const int r = w0 + 32 * j + lane;
      a[j] = r < rows ? assign[r0 + r] : -1;
    }
#pragma unroll
    for (int j = 0; j < kPrefetch; ++j) {
      const bool ok = a[j] >= 0 && a[j] < C;
      const unsigned peers = __match_any_sync(kAll, ok ? a[j] : -1);
      const int leader = __ffs(peers) - 1;
      int at = 0;
      if (ok && lane == leader) {
        at = cur[a[j]];
        cur[a[j]] = at + __popc(peers);
      }
      at = __shfl_sync(kAll, at, leader);
      if (ok) idx[at + __popc(peers & ((1u << lane) - 1u))] = r0 + w0 + 32 * j + lane;
      __syncwarp();  // the cursors are read again next window
    }
  }
}

// ---------------------------------------------------------------------
// The Grams of the pieces
// ---------------------------------------------------------------------

// BYTES (16, or one element of 4 or 8) from global to shared memory, async
template <int BYTES>
__device__ __forceinline__ void cp_async(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  if constexpr (BYTES == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src) : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(s), "l"(src), "n"(BYTES)
                 : "memory");
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// One copy of BYTES bytes of a staged row, as a vector
template <typename T, int BYTES>
struct Copy {
  using V = T;
};
template <>
struct Copy<float, 16> {
  using V = float4;
};
template <>
struct Copy<double, 16> {
  using V = double2;
};

__device__ __forceinline__ bool finite(float x) { return isfinite(x); }
__device__ __forceinline__ bool finite(double x) { return isfinite(x); }
__device__ __forceinline__ bool finite(float4 x) {
  return isfinite(x.x) && isfinite(x.y) && isfinite(x.z) && isfinite(x.w);
}
__device__ __forceinline__ bool finite(double2 x) { return isfinite(x.x) && isfinite(x.y); }
__device__ __forceinline__ float zeroed(float x) { return isfinite(x) ? x : 0.f; }
__device__ __forceinline__ double zeroed(double x) { return isfinite(x) ? x : 0.0; }
__device__ __forceinline__ float4 zeroed(float4 x) {
  return make_float4(zeroed(x.x), zeroed(x.y), zeroed(x.z), zeroed(x.w));
}
__device__ __forceinline__ double2 zeroed(double2 x) { return make_double2(zeroed(x.x), zeroed(x.y)); }

__device__ __forceinline__ void load8(const float* p, float (&r)[kTile]) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  r[0] = a.x, r[1] = a.y, r[2] = a.z, r[3] = a.w;
  r[4] = b.x, r[5] = b.y, r[6] = b.z, r[7] = b.w;
}

__device__ __forceinline__ void load8(const double* p, double (&r)[kTile]) {
#pragma unroll
  for (int h = 0; h < 4; ++h) {
    const double2 a = reinterpret_cast<const double2*>(p)[h];
    r[2 * h] = a.x, r[2 * h + 1] = a.y;
  }
}

// Block (piece q, tile group blockIdx.y): the piece's rows U_i, added to
// the group's tiles; writes part[q, tile, 8 x 8].  BYTES: bytes a copy.
// The rows come into two stage buffers in turn: stage s + 1 is in flight
// while stage s is added.
template <typename T, int BYTES>
__global__ void __launch_bounds__(kThreads, sizeof(T) == 4 ? 2 : 1) gram_pieces(
    const T* __restrict__ v, const int* __restrict__ idx,
    const int* __restrict__ list_start, const int* __restrict__ piece_start,
    T* __restrict__ part, int D, int PC, int R, Layout L) {
  using V = typename Copy<T, BYTES>::V;
  extern __shared__ __align__(16) unsigned char smem[];
  const int q = blockIdx.x;
  if (q >= piece_start[PC]) return;
  // the (segment, cluster) of piece q: piece_start[pc] <= q < piece_start[pc + 1]
  int lo = 0, hi = PC;
  while (hi - lo > 1) {
    const int mid = (lo + hi) >> 1;
    if (piece_start[mid] <= q) lo = mid;
    else hi = mid;
  }
  const int begin = list_start[lo] + (q - piece_start[lo]) * R;
  const int rows = min(R, list_start[lo + 1] - begin);
  const int RB = L.rb, ld = L.ld, stages = (rows + RB - 1) / RB;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nwarps = blockDim.x >> 5;
  // the ones column and the padding, in both stage buffers
  for (int e = tid; e < 2 * RB * (L.up - D); e += blockDim.x) {
    const int r = e / (L.up - D), k = D + e - r * (L.up - D);
    *reinterpret_cast<T*>(smem + (size_t)r * ld + swz(k * (int)sizeof(T))) = k == D ? T(1) : T(0);
  }

  const int row_bytes = D * (int)sizeof(T);
  // Row rr of a stage is copied by warp rr % nwarps; lane j of that warp
  // holds the row index of its (j + 32 h)-th row in rid[h] (at most 64
  // rows a stage), loaded a stage ahead of the copies.
  auto fetch = [&](int s, int (&rid)[2]) {
    const int nb = min(RB, rows - s * RB);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int rr = warp + nwarps * (lane + 32 * h);
      rid[h] = rr < nb ? idx[begin + s * RB + rr] : 0;
    }
  };
  auto copy = [&](int s, const int (&rid)[2]) {
    const int nb = min(RB, rows - s * RB);
    unsigned char* dst = smem + (size_t)(s & 1) * RB * ld;
    for (int j = 0, rr = warp; rr < nb; ++j, rr += nwarps) {
      const int row = __shfl_sync(kAll, j < 32 ? rid[0] : rid[1], j & 31);
      const unsigned char* src = reinterpret_cast<const unsigned char*>(v + (size_t)row * D);
      for (int b = lane * BYTES; b < row_bytes; b += 32 * BYTES)
        cp_async<BYTES>(dst + (size_t)rr * ld + swz(b), src + b);
    }
  };
  // this thread's own copies of stage s, once they have landed
  auto clean = [&](int s) {
    const int nb = min(RB, rows - s * RB);
    unsigned char* dst = smem + (size_t)(s & 1) * RB * ld;
    for (int rr = warp; rr < nb; rr += nwarps)
      for (int b = lane * BYTES; b < row_bytes; b += 32 * BYTES) {
        V* at = reinterpret_cast<V*>(dst + (size_t)rr * ld + swz(b));
        const V x = *at;
        if (!finite(x)) *at = zeroed(x);
      }
  };

  const int tl = tid % L.tpb, sub = tid / L.tpb;
  const int tile = blockIdx.y * L.tpb + tl;
  const bool active = sub < L.subs && tile < L.tiles;
  int I, J;
  tile_ij(active ? tile : 0, L.up / kTile, I, J);
  const int offI = swz(I * kTile * (int)sizeof(T)), offJ = swz(J * kTile * (int)sizeof(T));
  T acc[kTile][kTile];
#pragma unroll
  for (int a = 0; a < kTile; ++a)
#pragma unroll
    for (int b = 0; b < kTile; ++b) acc[a][b] = T(0);

  int rid[2];
  fetch(0, rid);
  copy(0, rid);
  cp_commit();
  fetch(1, rid);
  for (int s = 0; s < stages; ++s) {
    if (s + 1 < stages) copy(s + 1, rid);
    cp_commit();
    fetch(s + 2, rid);  // lands while this stage is added
    cp_wait<1>();       // this thread's copies of stage s have landed
    clean(s);
    __syncthreads();
    if (active) {
      const unsigned char* st = smem + (size_t)(s & 1) * RB * ld;
      const int nb = min(RB, rows - s * RB);
      for (int rr = sub; rr < nb; rr += L.subs) {
        T a[kTile], b[kTile];
        load8(reinterpret_cast<const T*>(st + (size_t)rr * ld + offI), a);
        load8(reinterpret_cast<const T*>(st + (size_t)rr * ld + offJ), b);
#pragma unroll
        for (int ia = 0; ia < kTile; ++ia)
#pragma unroll
          for (int ib = 0; ib < kTile; ++ib)
            acc[ia][ib] = fused_ma(a[ia], b[ib], acc[ia][ib]);
      }
    }
    __syncthreads();  // stage (s & 1) is rewritten by stage s + 2
  }

  // the row groups' tiles, added in group order
  T* scratch = reinterpret_cast<T*>(smem);  // (kTile^2, tpb)
  for (int g = 1; g < L.subs; ++g) {
    if (active && sub == g)
#pragma unroll
      for (int a = 0; a < kTile; ++a)
#pragma unroll
        for (int b = 0; b < kTile; ++b) scratch[(a * kTile + b) * L.tpb + tl] = acc[a][b];
    __syncthreads();
    if (active && sub == 0)
#pragma unroll
      for (int a = 0; a < kTile; ++a)
#pragma unroll
        for (int b = 0; b < kTile; ++b) acc[a][b] += scratch[(a * kTile + b) * L.tpb + tl];
    __syncthreads();
  }
  if (active && sub == 0) {
    T* out = part + ((size_t)q * L.tiles + tile) * kTile * kTile;
#pragma unroll
    for (int a = 0; a < kTile; ++a)
#pragma unroll
      for (int b = 0; b < kTile; ++b) out[a * kTile + b] = acc[a][b];
  }
}

// One thread an entry (pc, tile, a, b) on or above the diagonal of G:
// the sum of the pieces of pc in piece order, into G[pc, i, j] and
// G[pc, j, i]; 0 for a (segment, cluster) with no rows.  Eight pieces'
// partials are loaded at once, then added in order.
template <typename T>
__global__ void gram_reduce(const T* __restrict__ part,
                            const int* __restrict__ piece_start,
                            T* __restrict__ G, int PC, int u, int tiles) {
  constexpr int kBatch = 8;
  const int64_t e = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= (int64_t)PC * tiles * kTile * kTile) return;
  const int ab = (int)(e % (kTile * kTile));
  const int64_t t = e / (kTile * kTile);
  const int tile = (int)(t % tiles), pc = (int)(t / tiles);
  int I, J;
  tile_ij(tile, padded_u(u - 1) / kTile, I, J);
  const int a = ab / kTile, b = ab % kTile;
  const int i = I * kTile + a, j = J * kTile + b;
  if (i >= u || j >= u || (I == J && a > b)) return;
  const size_t stride = (size_t)tiles * kTile * kTile;
  const T* p = part + (size_t)tile * kTile * kTile + ab;
  const int q1 = piece_start[pc + 1];
  int q = piece_start[pc];
  T s = T(0);
  for (; q + kBatch <= q1; q += kBatch) {
    T x[kBatch];
#pragma unroll
    for (int k = 0; k < kBatch; ++k) x[k] = p[(size_t)(q + k) * stride];
#pragma unroll
    for (int k = 0; k < kBatch; ++k) s += x[k];
  }
  for (; q < q1; ++q) s += p[(size_t)q * stride];
  T* g = G + (size_t)pc * u * u;
  g[(size_t)i * u + j] = s;
  g[(size_t)j * u + i] = s;
}

int plan(const int* assign, const int* table, const int* first, int* work,
         int P, int C, int chunks, int R, cudaStream_t stream) {
  const size_t kc = (size_t)chunks * C;
  const int PC = P * C;
  int* counts = work;
  int* base = counts + kc;
  int* list_start = base + kc;
  int* piece_start = list_start + PC + 1;
  int* idx = piece_start + PC + 1;
  cudaError_t err = cudaMemsetAsync(counts, 0, kc * sizeof(int), stream);
  if (err != cudaSuccess) return (int)err;
  if (chunks > 0) {
    gram_count<<<chunks, 256, 0, stream>>>(assign, table, counts, C);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  gram_scan<<<1, kScanThreads, 0, stream>>>(table, first, counts, base, list_start,
                                            piece_start, P, C, chunks, R);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  if (chunks > 0) {
    gram_scatter<<<chunks, 32, 0, stream>>>(assign, table, base, idx, C);
    err = cudaGetLastError();
  }
  return (int)err;
}

template <typename T, int BYTES>
int grams(const Layout& L, const T* v, const int* work, T* part, T* G, int D,
          int P, int C, int chunks, int R, int pieces, cudaStream_t stream) {
  const size_t kc = (size_t)chunks * C;
  const int PC = P * C;
  const int* list_start = work + 2 * kc;
  const int* piece_start = list_start + PC + 1;
  const int* idx = piece_start + PC + 1;
  auto kern = gram_pieces<T, BYTES>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L.smem);
  if (err != cudaSuccess) return (int)err;
  kern<<<dim3((unsigned)pieces, (unsigned)L.groups), L.threads, L.smem, stream>>>(
      v, idx, list_start, piece_start, part, D, PC, R, L);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int64_t total = (int64_t)PC * L.tiles * kTile * kTile;
  gram_reduce<T><<<(unsigned)((total + 255) / 256), 256, 0, stream>>>(
      part, piece_start, G, PC, D + 1, L.tiles);
  return (int)cudaGetLastError();
}

template <typename T>
int run(const void* v, const void* assign, const void* table,
        const void* first, void* work, void* part, void* G, int D, int P,
        int C, int chunks, int R, int pieces, cudaStream_t stream) {
  const Layout L = layout_for<T>(D);
  if (L.smem > kMaxSmem || L.groups > 65535) return -1;
  int rc = plan(static_cast<const int*>(assign), static_cast<const int*>(table),
                static_cast<const int*>(first), static_cast<int*>(work), P, C,
                chunks, R, stream);
  if (rc != 0) return rc;
  const T* vt = static_cast<const T*>(v);
  const bool wide = (D * sizeof(T)) % 16 == 0 && reinterpret_cast<uintptr_t>(v) % 16 == 0;
  auto* w = static_cast<const int*>(work);
  auto* pt = static_cast<T*>(part);
  auto* g = static_cast<T*>(G);
  if (wide) return grams<T, 16>(L, vt, w, pt, g, D, P, C, chunks, R, pieces, stream);
  return grams<T, (int)sizeof(T)>(L, vt, w, pt, g, D, P, C, chunks, R, pieces, stream);
}

bool bad_args(int D, int P, int C, int chunks, int R) {
  return D <= 0 || P <= 0 || C < 1 || chunks < 0 || R < 1 ||
         (int64_t)P * C >= (1 << 30) || (int64_t)chunks * C >= (1 << 30);
}

}  // namespace

// Elements of one piece's partial: tiles x 8 x 8 of the padded upper
// triangle.  part must hold pieces times as many.
extern "C" int mtm_mstep_gram_part(int D) {
  return tiles_of(padded_u(D)) * kTile * kTile;
}

// The piece plan alone into work (layout above), for tests: returns a
// cudaError_t (0 on success), or -1 for arguments it does not take.
extern "C" int mtm_mstep_gram_plan(int device, const void* assign,
                                   const void* table, const void* first,
                                   void* work, int P, int C, int chunks, int R,
                                   void* stream) {
  if (bad_args(1, P, C, chunks, R)) return -1;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  return plan(static_cast<const int*>(assign), static_cast<const int*>(table),
              static_cast<const int*>(first), static_cast<int*>(work), P, C,
              chunks, R, static_cast<cudaStream_t>(stream));
}

// kind: 0 float32, 1 float64.  table/first: the chunks of at most a few
// thousand rows, none crossing a segment (ops/estep_kernels.py
// segment_table).  R: rows a piece; pieces: the grid, at least
// ceil(n / R) + P C.  Writes G (P, C, D + 1, D + 1).  Returns a
// cudaError_t (0 on success), or -1 for an argument the kernel does not
// take.
extern "C" int mtm_mstep_gram(int device, int kind, const void* v,
                              const void* assign, const void* table,
                              const void* first, void* work, void* part,
                              void* G, int D, int P, int C, int chunks, int R,
                              int pieces, void* stream) {
  if (bad_args(D, P, C, chunks, R) || pieces < 1) return -1;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (kind == 0)
    return run<float>(v, assign, table, first, work, part, G, D, P, C, chunks, R, pieces, s);
  if (kind == 1)
    return run<double>(v, assign, table, first, work, part, G, D, P, C, chunks, R, pieces, s);
  return -1;
}
