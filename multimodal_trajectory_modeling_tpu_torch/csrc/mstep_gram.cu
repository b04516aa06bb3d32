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
// Bound on the card: the upper triangle of the Gram, u (u + 1) / 2 FMAs
// per row (6.6e9 float32 operations at n = 1e6, D = 80: 0.1 ms at
// 67 TFLOP/s), against one read of v (320 MB, 0.1 ms).  Design:
// - the rows are cut into chunks of one segment each (a table that the
//   wrapper builds once per fit), and a block takes one (chunk, cluster,
//   tile group): it finds the chunk's rows of its cluster by a ballot
//   compaction over the assignments (in row order), stages those rows of
//   U in shared memory, and each thread adds the rows to its own 4 x 4
//   tile of the upper triangle in registers.  Every row of v is read by
//   one block only (its cluster's), and one segment's C u^2 Gram (420 KB
//   at D = 80) never has to fit a block;
// - float sums in a fixed order, so two calls give the same bits: each
//   thread adds its chunk's rows in row order, writes its tile as the
//   chunk's partial, and a second kernel adds each segment's chunk
//   partials in chunk order and mirrors the triangle.  No atomics;
// - IEEE FMAs on the CUDA cores in the input type, never TF32; the ones
//   column makes the member counts, exact in float32 up to 2^24 rows.

#include <cuda_runtime.h>
#include <stdint.h>

#include "markov_common.cuh"

namespace {

using mtm::fused_ma;

constexpr int kBN = 256;            // threads per block
constexpr int kWin = 4 * kBN;       // rows whose assignments one pass scans
constexpr int kTile = 4;            // each thread's tile is kTile x kTile
constexpr size_t kRowBytes = 48 * 1024;  // shared memory for staged rows

__host__ __device__ inline int padded_u(int D) {
  return (D + 1 + kTile - 1) / kTile * kTile;
}

__device__ __forceinline__ void load4(const float* p, float (&r)[kTile]) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  r[0] = v.x;
  r[1] = v.y;
  r[2] = v.z;
  r[3] = v.w;
}

__device__ __forceinline__ void load4(const double* p, double (&r)[kTile]) {
  const double2 a = reinterpret_cast<const double2*>(p)[0];
  const double2 b = reinterpret_cast<const double2*>(p)[1];
  r[0] = a.x;
  r[1] = a.y;
  r[2] = b.x;
  r[3] = b.y;
}

template <typename T>
int rows_per_stage(int D) {
  const int rb = (int)(kRowBytes / (sizeof(T) * (size_t)padded_u(D)));
  return rb < kWin ? rb : kWin;
}

template <typename T>
size_t smem_bytes(int D) {
  return sizeof(T) * (size_t)rows_per_stage<T>(D) * padded_u(D) +
         sizeof(int) * (kWin + kBN / 32);
}

template <typename T>
__global__ void __launch_bounds__(kBN) gram_kernel(
    const T* __restrict__ v,         // (n, D)
    const int* __restrict__ assign,  // (n,)
    const int* __restrict__ table,   // (chunks, 3): pattern, first row, rows
    T* __restrict__ part,            // (chunks, C, up, up), upper tiles
    int D, int C, int RB) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int up = padded_u(D);
  T* s_u = reinterpret_cast<T*>(smem);                         // RB x up
  int* s_idx = reinterpret_cast<int*>(s_u + (size_t)RB * up);  // kWin
  int* s_wcnt = s_idx + kWin;                                  // warps

  const int chunk = blockIdx.x, c = blockIdx.y;
  const int64_t r0 = table[3 * chunk + 1];
  const int rows = table[3 * chunk + 2];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;

  // this thread's tile (I, J), I <= J, of the nt x nt tile grid
  const int nt = up / kTile;
  int q = blockIdx.z * kBN + threadIdx.x;
  const bool owner = q < nt * (nt + 1) / 2;
  int I = 0;
  if (owner)
    while (q >= nt - I) {
      q -= nt - I;
      ++I;
    }
  const int J = I + q;

  T acc[kTile][kTile];
#pragma unroll
  for (int a = 0; a < kTile; ++a)
#pragma unroll
    for (int b = 0; b < kTile; ++b) acc[a][b] = T(0);

  for (int w0 = 0; w0 < rows; w0 += kWin) {
    // the window's rows of cluster c, in row order, into s_idx
    int cnt = 0;
    for (int k = 0; k < kWin; k += kBN) {
      const int r = w0 + k + threadIdx.x;
      const bool m = r < rows && assign[r0 + r] == c;
      const unsigned b = __ballot_sync(0xffffffffu, m);
      if (lane == 0) s_wcnt[warp] = __popc(b);
      __syncthreads();
      int off = cnt, tot = 0;
      for (int w = 0; w < kBN / 32; ++w) {
        if (w < warp) off += s_wcnt[w];
        tot += s_wcnt[w];
      }
      if (m) s_idx[off + __popc(b & ((1u << lane) - 1u))] = r;
      cnt += tot;
      __syncthreads();  // s_wcnt is rewritten in the next pass
    }
    for (int b0 = 0; b0 < cnt; b0 += RB) {
      const int nb = min(RB, cnt - b0);
      for (int e = threadIdx.x; e < nb * up; e += kBN) {
        const int rr = e / up, k = e - rr * up;
        T val = T(0);
        if (k < D) {
          const T x = v[(r0 + s_idx[b0 + rr]) * D + k];
          val = isfinite(x) ? x : T(0);
        } else if (k == D) {
          val = T(1);
        }
        s_u[e] = val;
      }
      __syncthreads();
      if (owner)
        for (int rr = 0; rr < nb; ++rr) {
          T a[kTile], b[kTile];
          load4(s_u + (size_t)rr * up + I * kTile, a);
          load4(s_u + (size_t)rr * up + J * kTile, b);
#pragma unroll
          for (int ia = 0; ia < kTile; ++ia)
#pragma unroll
            for (int ib = 0; ib < kTile; ++ib)
              acc[ia][ib] = fused_ma(a[ia], b[ib], acc[ia][ib]);
        }
      __syncthreads();  // s_u and s_idx are rewritten next
    }
  }
  if (owner) {
    T* out = part + ((size_t)chunk * C + c) * up * up;
#pragma unroll
    for (int ia = 0; ia < kTile; ++ia)
#pragma unroll
      for (int ib = 0; ib < kTile; ++ib)
        out[(size_t)(I * kTile + ia) * up + J * kTile + ib] = acc[ia][ib];
  }
}

// G[p, c, i, j] = sum over the chunks k of segment p, in order, of
// part[k, c, min(i, j), max(i, j)]; 0 for an empty segment.
template <typename T>
__global__ void gram_reduce(const T* __restrict__ part,
                            const int* __restrict__ first,  // (P + 1,)
                            T* __restrict__ G, int P, int C, int u, int up) {
  const int64_t e = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= (int64_t)P * C * u * u) return;
  const int j = (int)(e % u);
  int64_t t = e / u;
  const int i = (int)(t % u);
  t /= u;
  const int c = (int)(t % C);
  const int p = (int)(t / C);
  const int lo = min(i, j), hi = max(i, j);
  T s = T(0);
  for (int k = first[p]; k < first[p + 1]; ++k)
    s += part[((size_t)k * C + c) * up * up + (size_t)lo * up + hi];
  G[e] = s;
}

template <typename T>
int run(const void* v, const void* assign, const void* table,
        const void* first, void* part, void* G, int D, int P, int C,
        int chunks, cudaStream_t stream) {
  const int up = padded_u(D), u = D + 1, nt = up / kTile;
  const int groups = (nt * (nt + 1) / 2 + kBN - 1) / kBN;
  const int RB = rows_per_stage<T>(D);
  if (RB < 1) return -1;
  const size_t smem = smem_bytes<T>(D);
  auto kern = gram_kernel<T>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  if (chunks > 0) {
    kern<<<dim3((unsigned)chunks, (unsigned)C, (unsigned)groups), kBN, smem,
           stream>>>(static_cast<const T*>(v), static_cast<const int*>(assign),
                     static_cast<const int*>(table), static_cast<T*>(part), D,
                     C, RB);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  const int64_t total = (int64_t)P * C * u * u;
  gram_reduce<T><<<(unsigned)((total + 255) / 256), 256, 0, stream>>>(
      static_cast<const T*>(part), static_cast<const int*>(first),
      static_cast<T*>(G), P, C, u, up);
  return (int)cudaGetLastError();
}

}  // namespace

// The padded row width of the partials: part must hold
// chunks * C * up * up elements.
extern "C" int mtm_mstep_gram_padded(int D) { return padded_u(D); }

// kind: 0 float32, 1 float64.  Writes G (P, C, D + 1, D + 1).  Returns a
// cudaError_t (0 on success), or -1 for an argument the kernel does not
// take.
extern "C" int mtm_mstep_gram(int device, int kind, const void* v,
                              const void* assign, const void* table,
                              const void* first, void* part, void* G, int D,
                              int P, int C, int chunks, void* stream) {
  if (D <= 0 || P <= 0 || C < 1 || chunks < 0 || C > 65535) return -1;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (kind == 0)
    return run<float>(v, assign, table, first, part, G, D, P, C, chunks, s);
  if (kind == 1)
    return run<double>(v, assign, table, first, part, G, D, P, C, chunks, s);
  return -1;
}
