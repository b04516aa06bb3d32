// The ACC-row table of the compact Φ (ops/markov_kernels.py:
// markov_compact_spec and _acc_row_table) computed at compile time for a
// fixed (d, l), so that a kernel can build each row of Φ with its shift,
// row and kind as constants: the step-outer row build of float32 K4a and
// K2 (markov_step_rows.cuh) keeps a step's values of u in registers and
// adds every row's product for that step from them.
//
// Plain C++17 (no device intrinsics): tests/test_torch_packed_body.py
// compiles it with the host compiler and holds it to the Python table.

#pragma once

#ifndef __CUDACC__
#define __host__
#define __device__
#endif

namespace mtm {

// row kinds: markov_common.cuh's RowKind
struct AccTable {
  int fc;  // referenced ACC rows (Φ's rows before padding)
  int kind[256];
  int k[256];
  int r[256];
};

__host__ __device__ constexpr int abs_diff(int a, int b) { return a > b ? a - b : b - a; }
__host__ __device__ constexpr int min_of(int a, int b) { return a < b ? a : b; }

// markov_packed_spec's rows for (d, l), uniquely and in ascending order
// (markov_compact_spec's uniq), each as _acc_row_table's (kind, k, r).
// fc = -1 where the layout has more than 256 ACC rows.
__host__ __device__ constexpr AccTable make_acc_table(int d, int l) {
  AccTable t{};
  const int s = 8 * ((d + l + 7) / 8);
  int ks[128] = {};
  int kpos[256] = {};
  int nk = 0;
  for (int k = 0; k < 2 * s; ++k)
    if (k < d + l || (k >= s - d + 1 && k < s + d)) {
      kpos[k] = nk;
      ks[nk++] = k;
    }
  const int base_b = nk * s, base_f0 = base_b + d * s, base_aid = base_f0 + d * s;
  const int base_avm = base_aid + s, base_u0 = base_avm + s, base_ex = base_u0 + s;
  const int facc = base_ex + s;
  if (facc > 256) {
    t.fc = -1;
    return t;
  }
  bool used[256] = {};
  for (int i = 0; i < d; ++i)
    for (int j = 0; j < d; ++j) {
      const int dk = abs_diff(i, j), r0 = min_of(i, j);
      used[kpos[dk] * s + r0] = true;            // g1
      used[base_b + dk * s + r0] = true;         // g2
      used[kpos[s + j - i] * s + i] = true;      // g3
      used[base_f0 + dk * s + r0] = true;        // g6
    }
  for (int a = 0; a < l; ++a)
    for (int b = 0; b < l; ++b) used[kpos[abs_diff(a, b)] * s + d + min_of(a, b)] = true;  // g4
  for (int i = 0; i < d; ++i)
    for (int a = 0; a < l; ++a) used[kpos[d + a - i] * s + i] = true;  // g5
  for (int i = 0; i < d; ++i) {
    used[base_avm + i] = true;  // g7
    used[base_aid + i] = true;  // g8
    used[base_u0 + i] = true;   // g10
  }
  for (int a = 0; a < l; ++a) used[base_aid + d + a] = true;  // g9
  used[base_ex] = used[base_ex + 1] = true;                   // len, const
  int f = 0;
  for (int row = 0; row < facc; ++row) {
    if (!used[row]) continue;
    int kind = 0, k = 0, r = 0;
    if (row < base_b) {
      kind = 0, k = ks[row / s], r = row % s;  // A
    } else if (row < base_f0) {
      k = (row - base_b) / s, r = (row - base_b) % s;
      kind = r + k < s ? 1 : 0;  // B, or A past the step (as _acc_row_table)
    } else if (row < base_aid) {
      kind = 2, k = (row - base_f0) / s, r = (row - base_f0) % s;  // F0
    } else if (row < base_avm) {
      kind = 3, r = row - base_aid;  // AID
    } else if (row < base_u0) {
      kind = 4, r = row - base_avm;  // AVM
    } else if (row < base_ex) {
      kind = 5, r = row - base_u0;  // U0
    } else {
      r = row - base_ex;
      kind = r == 0 ? 6 : r == 1 ? 7 : 8;  // LEN, ONE, ZERO
    }
    t.kind[f] = kind;
    t.k[f] = k;
    t.r[f] = r;
    ++f;
  }
  t.fc = f;
  return t;
}

}  // namespace mtm
