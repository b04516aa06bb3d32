// K16: the Φ stream probe, the sum of every element of a feature matrix
// threaded through a chained accumulator:  out = seed·0 + Σφ.
//
// Replaces the TPU kernel drivers/bench-phi-floor.py:stream_kernel (its
// pallas_call at :111), which measures the bare read rate of an (F, n) Φ at
// each storage width.  It computes what that kernel computes, not its
// block structure: float32 and bfloat16 are summed as float (here each
// thread's sum in float, the partials in double), int16 is widened and
// summed modulo 2^32 as the reference's int32 sum wraps (unsigned adds, so
// the wrap is defined).  The seed·0 term keeps the reference's data
// dependency: a NaN or infinite seed gives NaN.
//
// Bound on the card: one read of Φ (112 × 1e6 × 4 B = 448 MB in float32,
// 224 MB in int16 and bfloat16: 0.134 and 0.067 ms at 3.35 TB/s); one add
// an element (1.1e8, 0.0017 ms at 67 TFLOP/s): bytes.  Design:
// - persistent blocks (a few an SM) walk the flat buffer in tiles of
//   16-byte vectors, dealt to the blocks in turn (the tile is the JAX
//   driver's --bn: the elements a block streams a step; default 1024
//   vectors), four loads in flight a thread (streaming loads, evict
//   first), each thread summing its vectors in a fixed order;
// - the last (n mod elements a vector) elements are added by thread 0 of
//   block 0, so no padding is needed;
// - each block reduces its threads' sums by shuffles and then warps in
//   order into one partial; a second one-block kernel adds the partials in
//   a fixed order and adds seed·0.  No atomics: two calls give the same
//   bits.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;
constexpr int kBlocksPerSm = 4;
constexpr int kReduceThreads = 1024;

enum Kind { kF32 = 0, kBF16 = 1, kI16 = 2 };

template <int K>
struct Traits;
template <>
struct Traits<kF32> {
  using Elem = float;
  using Sum = float;      // a thread's sum
  using Part = double;    // a block's partial
  static constexpr int kPerVec = 4;
  __device__ static Sum vec(uint4 v) {
    return (__uint_as_float(v.x) + __uint_as_float(v.y)) + (__uint_as_float(v.z) + __uint_as_float(v.w));
  }
  __device__ static Sum one(const Elem* p) { return *p; }
};
template <>
struct Traits<kBF16> {
  using Elem = uint16_t;
  using Sum = float;
  using Part = double;
  static constexpr int kPerVec = 8;
  __device__ static float pair(uint32_t w) {
    return __uint_as_float(w << 16) + __uint_as_float(w & 0xffff0000u);
  }
  __device__ static Sum vec(uint4 v) { return (pair(v.x) + pair(v.y)) + (pair(v.z) + pair(v.w)); }
  __device__ static Sum one(const Elem* p) { return __uint_as_float(uint32_t(*p) << 16); }
};
template <>
struct Traits<kI16> {
  using Elem = int16_t;
  using Sum = uint32_t;   // modulo 2^32, as the reference's int32 sum
  using Part = uint32_t;
  static constexpr int kPerVec = 8;
  __device__ static uint32_t pair(uint32_t w) {
    return uint32_t(int32_t(int16_t(w & 0xffffu))) + uint32_t(int32_t(w) >> 16);
  }
  __device__ static Sum vec(uint4 v) { return pair(v.x) + pair(v.y) + pair(v.z) + pair(v.w); }
  __device__ static Sum one(const Elem* p) { return uint32_t(int32_t(*p)); }
};

template <typename V>
__device__ V shfl_sum(V v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  return v;
}

// the block's values summed in a fixed order; valid in thread 0
template <typename V>
__device__ V block_total(V v, V* red) {
  v = shfl_sum(v);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  V tot = V(0);
  if (threadIdx.x == 0)
    for (int w = 0; w < int(blockDim.x >> 5); ++w) tot += red[w];
  return tot;
}

template <int K>
__global__ void __launch_bounds__(kThreads) stream_partials(const uint4* __restrict__ vecs, long long nvec,
                                                            long long tile, const typename Traits<K>::Elem* __restrict__ tail,
                                                            int ntail, typename Traits<K>::Part* part) {
  using Tr = Traits<K>;
  using Sum = typename Tr::Sum;
  using Part = typename Tr::Part;
  __shared__ Part red[kThreads / 32];
  Sum acc[kUnroll];
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) acc[u] = Sum(0);
  // tiles of `tile` vectors, dealt to the blocks in turn; within a tile,
  // each round's kUnroll loads a thread are kThreads vectors apart, so a
  // warp's loads are coalesced and every thread has kUnroll in flight
  for (long long base = (long long)blockIdx.x * tile; base < nvec; base += (long long)gridDim.x * tile) {
    const long long end = base + tile < nvec ? base + tile : nvec;
    for (long long i = base + threadIdx.x; i < end; i += kThreads * kUnroll) {
      uint4 v[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const long long j = i + (long long)u * kThreads;
        v[u] = j < end ? __ldcs(vecs + j) : make_uint4(0u, 0u, 0u, 0u);
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) acc[u] += Tr::vec(v[u]);
    }
  }
  Sum mine = (acc[0] + acc[1]) + (acc[2] + acc[3]);
  if (blockIdx.x == 0 && threadIdx.x == 0)
    for (int j = 0; j < ntail; ++j) mine += Tr::one(tail + j);
  const Part tot = block_total<Part>(Part(mine), red);
  if (threadIdx.x == 0) part[blockIdx.x] = tot;
}

template <int K>
__global__ void __launch_bounds__(kReduceThreads) stream_finish(const typename Traits<K>::Part* part, int blocks,
                                                                const void* seed, void* out) {
  using Part = typename Traits<K>::Part;
  __shared__ Part red[kReduceThreads / 32];
  Part v = Part(0);
  for (int b = threadIdx.x; b < blocks; b += kReduceThreads) v += part[b];
  const Part tot = block_total<Part>(v, red);
  if (threadIdx.x != 0) return;
  if constexpr (K == kI16) {
    const uint32_t s = uint32_t(*static_cast<const int32_t*>(seed));
    *static_cast<int32_t*>(out) = int32_t(s * 0u + tot);
  } else {
    const float s = *static_cast<const float*>(seed);
    *static_cast<float*>(out) = s * 0.0f + float(tot);
  }
}

int elem_bytes(int kind) { return kind == kF32 ? 4 : 2; }

template <int K>
int launch(const void* phi, long long n, long long tile, const void* seed, void* part, int blocks, void* out,
           cudaStream_t s) {
  using Tr = Traits<K>;
  using Part = typename Tr::Part;
  const long long nvec = n / Tr::kPerVec;
  const int ntail = int(n - nvec * Tr::kPerVec);
  const auto* elems = static_cast<const typename Tr::Elem*>(phi);
  stream_partials<K><<<blocks, kThreads, 0, s>>>(static_cast<const uint4*>(phi), nvec, tile,
                                                 elems + nvec * Tr::kPerVec, ntail, static_cast<Part*>(part));
  stream_finish<K><<<1, kReduceThreads, 0, s>>>(static_cast<const Part*>(part), blocks, seed, out);
  return (int)cudaGetLastError();
}

}  // namespace

// The number of blocks (and partials) a call on n elements of `kind` in
// tiles of `tile` 16-byte vectors uses on `device`: a few an SM, fewer
// where there are fewer tiles.  Returns -1 for an argument the kernel does
// not take, else a cudaError_t negated.
extern "C" int mtm_phi_stream_blocks(int device, int kind, long long n, long long tile) {
  if (kind < kF32 || kind > kI16 || n < 0 || tile < kThreads || tile % kThreads) return -1;
  int sms = 0;
  cudaError_t err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return -(int)err;
  const long long nvec = n / (16 / elem_bytes(kind));
  long long want = (nvec + tile - 1) / tile;
  if (want < 1) want = 1;
  const long long most = (long long)sms * kBlocksPerSm;
  return int(want < most ? want : most);
}

// out = seed·0 + Σ phi[0:n]: phi contiguous and 16-byte aligned, of `kind`
// (0 float32, 1 bfloat16, 2 int16), streamed in tiles of `tile` 16-byte
// vectors (a multiple of 256); seed and out one float32 (int32 for int16)
// on the card; part holds `blocks` 8-byte partials.  Returns a cudaError_t
// (0 on success), or -1 for an argument the kernel does not take.
extern "C" int mtm_phi_stream(int device, int kind, const void* phi, long long n, long long tile, const void* seed,
                              void* part, int blocks, void* out, void* stream) {
  if (n < 0 || blocks < 1 || tile < kThreads || tile % kThreads || (reinterpret_cast<uintptr_t>(phi) & 15u) != 0)
    return -1;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (kind == kF32) return launch<kF32>(phi, n, tile, seed, part, blocks, out, s);
  if (kind == kBF16) return launch<kBF16>(phi, n, tile, seed, part, blocks, out, s);
  if (kind == kI16) return launch<kI16>(phi, n, tile, seed, part, blocks, out, s);
  return -1;
}
