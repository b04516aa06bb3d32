// What the two bodies that build Φ from a staged tile of the packed batch
// share: float32 K4b (markov_em_packed_mma.cu) and float32 K4a
// (markov_em_packed_one.cu).
//
// - acc_row_tile: one ACC row of one instance from a u tile in shared
//   memory, markov_common.cuh:acc_row's terms in its order (K4b's row
//   build, and K4a's where its (d, l) has no compile-time table);
// - sort_tile: a tile's assignments sorted by cluster, stably, by one warp
//   (a counting sort on warp ballots), with each cluster's count and first
//   position;
// - seg_sum_rows: a warp's Φ rows of a sorted tile added per cluster, in
//   instance order, into float32 sums in registers, and those into the
//   block's running sums once per cluster.
// Together the two give float statistics in a fixed order (the same bits
// from run to run) without atomics, and Inf and NaN summed as the plain
// version sums them.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "markov_common.cuh"

namespace mtm {

constexpr int kSortMax = 128;  // the widest tile the sort takes
constexpr int kNone = 32;      // the sort's key of an instance in no cluster
constexpr int kSeg = 33;       // clusters and kNone: a tile's counts, then its first positions

// markov_common.cuh:acc_row on a tile in shared memory (element (row, j)
// at ui[row * stride]): the same terms, added in the same order by the
// same expressions, so the same value bit for bit; each loop's trip count
// is computed first, so that no load waits on a condition and the loads
// of later steps are sent ahead of the sum.
__device__ __forceinline__ float acc_row_tile(int kind, int k, int r, const float* ui, int stride,
                                              int len, int steps, int s) {
  const int Ts = steps * s;
  // the masked rows' steps: t + 1 < len && t < steps
  const int tm = len - 1 < steps ? (len - 1 > 0 ? len - 1 : 0) : steps;
  float acc = 0.f;
  switch (kind) {
    case ROW_A: {
      // a + k < Ts with a = t s + r: t < ceil((Ts - k - r) / s)
      const int room = Ts - k - r;
      const int tn = room > 0 ? (room + s - 1) / s : 0;
      for (int t = 0; t < tn; ++t) {
        const int a = t * s + r;
        acc += ui[a * stride] * ui[(a + k) * stride];
      }
      break;
    }
    case ROW_B:
      for (int t = 0; t < tm; ++t) {
        const int a = t * s + r;
        acc += ui[a * stride] * ui[(a + k) * stride];
      }
      break;
    case ROW_F0:
      acc = ui[r * stride] * ui[(r + k) * stride];
      break;
    case ROW_AID:
      for (int t = 0; t < steps; ++t) acc += ui[(t * s + r) * stride];
      break;
    case ROW_AVM:
      for (int t = 0; t < tm; ++t) acc += ui[(t * s + r) * stride];
      break;
    case ROW_U0:
      acc = ui[r * stride];
      break;
    case ROW_LEN:
      acc = float(len);
      break;
    case ROW_ONE:
      acc = 1.f;
      break;
    default:
      break;
  }
  return acc;
}

// One warp sorts a tile of NT ≤ 128 instances (NT a multiple of 32) by
// cluster, stably: na[j] is instance j's cluster, or < 0 for none.  Writes
// perm (instance j of cluster c as c << 8 | j, clusters in order), seg[c]
// the count of cluster c and seg[kSeg + c] its first position; returns
// lane c's count (c < CB).  A counting sort on warp ballots: instance
// j = 32 q + lane's position is the count of its cluster in the chunks
// before q plus the lanes below it with its cluster.
template <int CB>
__device__ __forceinline__ int sort_tile(const int* na, int* perm, int* seg, int NT) {
  const int lane = threadIdx.x & 31;
  const unsigned below_mask = (1u << lane) - 1u;
  int seen = 0;  // lane c: cluster c's instances in the chunks so far
  int key[kSortMax / 32], pos[kSortMax / 32];
#pragma unroll
  for (int q = 0; q < kSortMax / 32; ++q) {
    if (q < NT / 32) {  // uniform
      const int c0 = na[q * 32 + lane];
      key[q] = c0 >= 0 ? c0 : kNone;
      unsigned m[CB];  // every ballot first, so that they run back to back
#pragma unroll
      for (int c = 0; c < CB; ++c) m[c] = __ballot_sync(0xffffffffu, key[q] == c);
      int below = 0, here = 0;
#pragma unroll
      for (int c = 0; c < CB; ++c) {
        if (key[q] == c) below = __popc(m[c] & below_mask);
        if (lane == c) here = __popc(m[c]);
      }
      pos[q] = __shfl_sync(0xffffffffu, seen, key[q] & 31) + below;
      seen += here;
    }
  }
  int incl = seen;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += y;
  }
  const int first = incl - seen;  // lane c: cluster c's first position
  seg[lane] = seen;
  seg[kSeg + lane] = first;
#pragma unroll
  for (int q = 0; q < kSortMax / 32; ++q) {
    if (q < NT / 32) {
      const int at = __shfl_sync(0xffffffffu, first, key[q] & 31);
      if (key[q] != kNone) perm[at + pos[q]] = key[q] << 8 | (q * 32 + lane);
    }
  }
  return seen;
}

// A warp adds the rows f = f0 + 32 b + lane (b < RL, f < Fcp) of a tile
// sorted by sort_tile (perm, seg), for the clusters c_lo ≤ c < c_hi: each
// cluster's instances, in instance order, into run[c], which goes into
// the running sums (row f at st[f · SB], cluster c at st[f · SB + c]) once
// every cluster is summed; the clusters' counts and first positions come
// from lane c by shuffles, so no shared-memory load waits between two
// clusters.  Element (f, j) of the Φ tile is phi[f · pitch + j].
template <int CB, int RL>
__device__ __forceinline__ void seg_sum_rows(float* st, int SB, const float* phi, int pitch, int Fcp,
                                             const int* perm, const int* seg, int f0, int c_lo, int c_hi) {
  const int lane = threadIdx.x & 31;
  const int my_n = seg[lane], my_k0 = seg[kSeg + lane];  // lane c < C: cluster c's
  const float* row[RL];
#pragma unroll
  for (int b = 0; b < RL; ++b) {
    const int f = f0 + b * 32 + lane;
    row[b] = phi + (f < Fcp ? f : 0) * pitch;
  }
  float run[CB][RL];
#pragma unroll
  for (int c = 0; c < CB; ++c) {
#pragma unroll
    for (int b = 0; b < RL; ++b) run[c][b] = 0.f;
    const int k0 = __shfl_sync(0xffffffffu, my_k0, c);
    const int k1 = c >= c_lo && c < c_hi ? k0 + __shfl_sync(0xffffffffu, my_n, c) : k0;
#pragma unroll 8
    for (int k = k0; k < k1; ++k) {
      const int j = perm[k] & 0xFF;
#pragma unroll
      for (int b = 0; b < RL; ++b) run[c][b] += row[b][j];
    }
  }
#pragma unroll
  for (int b = 0; b < RL; ++b) {
    const int f = f0 + b * 32 + lane;
    if (f < Fcp) {
      float* s = st + (size_t)f * SB;
#pragma unroll
      for (int c = 0; c < CB; ++c)
        if (c >= c_lo && c < c_hi) s[c] += run[c][b];
    }
  }
}

}  // namespace mtm
