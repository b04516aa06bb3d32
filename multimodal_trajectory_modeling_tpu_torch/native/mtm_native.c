/* Native host-side data path of multimodal_trajectory_modeling_tpu_torch:
 * this package's own copy of multimodal_trajectory_modeling_tpu/native/
 * mtm_native.c, built by native/__init__.py into the package's _build/.
 *
 * The card owns the model math (the CUDA kernels of csrc/); these routines
 * own the host-side preprocessing that feeds it:
 *
 *  - pack_joint:      (T, n, d)+(T, n, l) → (n, T*(d+l)) stacked layout
 *  - pattern_groups:  hash-group rows of the packed batch by finite-mask
 *  - finite_lengths:  fully-finite prefix length per trajectory
 *
 * Pure C99 + OpenMP; loaded via ctypes (no Python.h dependency).
 */

#include <math.h>
#include <stdint.h>
#include <stdlib.h>
#include <string.h>

#ifdef _OPENMP
#include <omp.h>
#endif

/* (T, n, d) + (T, n, l) f64 → (n, T*(d+l)) packed rows:
 * [z_1..z_T, x_1..x_T] per instance. */
void pack_joint_f64(const double *z, const double *x, int64_t T, int64_t n,
                    int64_t d, int64_t l, double *out) {
  const int64_t D = T * (d + l);
#pragma omp parallel for schedule(static)
  for (int64_t i = 0; i < n; ++i) {
    double *row = out + i * D;
    for (int64_t t = 0; t < T; ++t)
      memcpy(row + t * d, z + (t * n + i) * d, (size_t)d * sizeof(double));
    double *xr = row + T * d;
    for (int64_t t = 0; t < T; ++t)
      memcpy(xr + t * l, x + (t * n + i) * l, (size_t)l * sizeof(double));
  }
}

/* FNV-1a over the finite-mask bits of one row. */
static uint64_t mask_hash(const double *row, int64_t D) {
  uint64_t h = 1469598103934665603ULL;
  for (int64_t j = 0; j < D; ++j) {
    uint64_t bit = isfinite(row[j]) ? 1u : 0u;
    h ^= bit + 0x9e3779b97f4a7c15ULL + (h << 6) + (h >> 2);
  }
  return h;
}

static int mask_equal(const double *row, const uint8_t *mask, int64_t D) {
  for (int64_t j = 0; j < D; ++j)
    if ((isfinite(row[j]) ? 1 : 0) != mask[j]) return 0;
  return 1;
}

/* Group rows of v (n, D) by finite-mask.
 * patterns_out: (max_patterns, D) uint8; pattern_id_out: (n,) int32.
 * Returns the number of distinct patterns, or -1 if it exceeds
 * max_patterns.  Single pass with open-addressed hashing on the host —
 * replaces np.unique's sort-based grouping (O(n D log n) → O(n D)). */
int64_t pattern_groups_f64(const double *v, int64_t n, int64_t D,
                           uint8_t *patterns_out, int32_t *pattern_id_out,
                           int64_t max_patterns) {
  /* table size: next power of two ≥ 4*max_patterns, so the open-addressed
   * table stays under 25% load and probes stay short */
  int64_t tsize = 64;
  while (tsize < 4 * max_patterns) tsize <<= 1;
  /* heap-allocated per-call scratch: reentrant/thread-safe, no size cap */
  int64_t *slot_pattern = malloc((size_t)tsize * sizeof(int64_t));
  uint64_t *slot_hash = malloc((size_t)tsize * sizeof(uint64_t));
  if (!slot_pattern || !slot_hash) {
    free(slot_pattern);
    free(slot_hash);
    return -2; /* allocation failure */
  }
  for (int64_t s = 0; s < tsize; ++s) slot_pattern[s] = -1;

  int64_t n_patterns = 0;
  for (int64_t i = 0; i < n; ++i) {
    const double *row = v + i * D;
    uint64_t h = mask_hash(row, D);
    int64_t s = (int64_t)(h & (uint64_t)(tsize - 1));
    int32_t id = -1;
    for (;;) {
      if (slot_pattern[s] < 0) {
        if (n_patterns >= max_patterns) {
          free(slot_pattern);
          free(slot_hash);
          return -1;
        }
        uint8_t *pat = patterns_out + n_patterns * D;
        for (int64_t j = 0; j < D; ++j) pat[j] = isfinite(row[j]) ? 1 : 0;
        slot_pattern[s] = n_patterns;
        slot_hash[s] = h;
        id = (int32_t)n_patterns;
        ++n_patterns;
        break;
      }
      if (slot_hash[s] == h &&
          mask_equal(row, patterns_out + slot_pattern[s] * D, D)) {
        id = (int32_t)slot_pattern[s];
        break;
      }
      s = (s + 1) & (tsize - 1);
    }
    pattern_id_out[i] = id;
  }
  free(slot_pattern);
  free(slot_hash);
  return n_patterns;
}

/* Length of the fully-finite prefix of each trajectory in a (T, n, d)
 * array (reference util_state_space.py:1049-1076). */
void finite_lengths_f64(const double *arr, int64_t T, int64_t n, int64_t d,
                        int32_t *out) {
#pragma omp parallel for schedule(static)
  for (int64_t i = 0; i < n; ++i) {
    int32_t len = (int32_t)T;
    for (int64_t t = 0; t < T; ++t) {
      const double *cell = arr + (t * n + i) * d;
      int ok = 1;
      for (int64_t j = 0; j < d; ++j)
        if (!isfinite(cell[j])) { ok = 0; break; }
      if (!ok) { len = (int32_t)t; break; }
    }
    out[i] = len;
  }
}
