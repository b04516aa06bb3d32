// Device code shared by the int16-Φ bodies of K3 (markov_em_multi_mma.cu)
// and K1 (markov_em_one.cu): a tile of Φ (rows × NT instances) staged in
// shared memory with 16-byte chunks XOR-swizzled by row, K1's FMA chain
// of scores over it, and the pieces of the statistics' tensor-core product
// (byte planes of the int16 entries, the u8 one-hot of the assignments,
// mma.sync m16n8k32).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "markov_common.cuh"

namespace mtm {
namespace i16 {

// Element j of tile row f: 16-byte chunks XOR-swizzled by (f & 3), so that
// the fragment loads of 8 rows and the score reads of one row hit
// distinct banks (a tile row holds at least 64 instances).
__device__ __forceinline__ int tile_col(int f, int j) {
  return (((j >> 3) ^ ((f & 3) << 1)) << 3) | (j & 7);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src, int bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src), "r"(bytes));
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src, int bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src), "r"(bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// d += a · b for a 16×32 A (s8 or u8) and a 32×8 u8 B, s32 accumulators.
__device__ __forceinline__ void mma_s8u8(int* d, const unsigned* a, const unsigned* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.u8.s32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}
__device__ __forceinline__ void mma_u8u8(int* d, const unsigned* a, const unsigned* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.u8.u8.s32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// 0x01 in each byte of x equal to c, else 0x00 (exact; no carry between
// bytes).
__device__ __forceinline__ unsigned onehot4(unsigned x, unsigned c) {
  const unsigned y = x ^ (c * 0x01010101u);
  const unsigned t = ((y & 0x7F7F7F7Fu) + 0x7F7F7F7Fu) | y | 0x7F7F7F7Fu;
  return (~t) >> 7;
}

// Four int16 of a tile row (8 bytes at `p`) as the hi (s8) and lo (u8)
// bytes of one A-fragment register each: Φ = 256 · hi + lo exactly.
__device__ __forceinline__ void split4(const int16_t* p, unsigned* hi, unsigned* lo) {
  const uint2 v = *reinterpret_cast<const uint2*>(p);
  *hi = __byte_perm(v.x, v.y, 0x7531);
  *lo = __byte_perm(v.x, v.y, 0x6420);
}

// 16 bytes of weights, for vector loads from shared memory.
template <typename WT>
struct alignas(16) W16 {
  WT x[16 / sizeof(WT)];
};

// An int16's raw 16 bits (0..65535) as the exact WT value of the int16,
// with two full-rate operations (the magic-number form of the conversion).
__device__ __forceinline__ float int16_raw_to(unsigned raw, float*) {
  return __int_as_float(raw ^ 0x4B008000u) - 8421376.0f;  // 2^23 + 2^15
}
__device__ __forceinline__ double int16_raw_to(unsigned raw, double*) {
  return __hiloint2double(0x43300000, raw ^ 0x8000u) - 4503599627403264.0;  // 2^52 + 2^15
}

// The raw bits of IPT neighbouring int16 of a tile row (IPT = 1, 2, 4).
template <int IPT>
__device__ __forceinline__ void load_raw(const int16_t* p, unsigned (&raw)[IPT]) {
  if constexpr (IPT == 4) {
    const uint2 v = *reinterpret_cast<const uint2*>(p);
    raw[0] = v.x & 0xFFFFu;
    raw[1] = v.x >> 16;
    raw[2] = v.y & 0xFFFFu;
    raw[3] = v.y >> 16;
  } else if constexpr (IPT == 2) {
    const unsigned v = *reinterpret_cast<const unsigned*>(p);
    raw[0] = v & 0xFFFFu;
    raw[1] = v >> 16;
  } else {
    raw[0] = *reinterpret_cast<const unsigned short*>(p);
  }
}

// One step of K1's FMA chain for IPT instances: sc[u][c] += w[f, c] ·
// Φ[f, j0 + u], the instances at column cl of row f of a tile NT wide,
// for CB clusters whose weights lie in rows of WS.
template <typename WT, int CB, int IPT, int NT, int WS = CB>
__device__ __forceinline__ void fma_row(WT (&sc)[IPT][CB], const WT* w,
                                        const int16_t* tile, int f, int cl) {
  constexpr int VW = 16 / (int)sizeof(WT);  // weights per vector load
  unsigned raw[IPT];
  load_raw<IPT>(tile + f * NT + cl, raw);
  WT v[IPT];
#pragma unroll
  for (int u = 0; u < IPT; ++u) v[u] = int16_raw_to(raw[u], (WT*)nullptr);
  const W16<WT>* wf = reinterpret_cast<const W16<WT>*>(w + f * WS);
#pragma unroll
  for (int q = 0; q < CB / VW; ++q) {
    const W16<WT> wv = wf[q];
#pragma unroll
    for (int e = 0; e < VW; ++e)
#pragma unroll
      for (int u = 0; u < IPT; ++u)
        sc[u][q * VW + e] = fused_ma(wv.x[e], v[u], sc[u][q * VW + e]);
  }
}

// K1's FMA chain over `nrows` rows of the tile for the IPT instances from
// column j0 and CB clusters, the weights `w` (rows of WS) starting at the
// tile's first row and the first of the clusters.
template <typename WT, int CB, int IPT, int NT, int WS = CB>
__device__ __forceinline__ void score_rows(WT (&sc)[IPT][CB], const WT* w,
                                           const int16_t* tile, int nrows, int j0) {
  const int c0 = tile_col(0, j0), c1 = tile_col(1, j0);
  const int c2 = tile_col(2, j0), c3 = tile_col(3, j0);
  int f = 0;
  for (; f + 4 <= nrows; f += 4) {
    fma_row<WT, CB, IPT, NT, WS>(sc, w, tile, f, c0);
    fma_row<WT, CB, IPT, NT, WS>(sc, w, tile, f + 1, c1);
    fma_row<WT, CB, IPT, NT, WS>(sc, w, tile, f + 2, c2);
    fma_row<WT, CB, IPT, NT, WS>(sc, w, tile, f + 3, c3);
  }
  for (; f < nrows; ++f) fma_row<WT, CB, IPT, NT, WS>(sc, w, tile, f, tile_col(f, j0));
}

}  // namespace i16
}  // namespace mtm
