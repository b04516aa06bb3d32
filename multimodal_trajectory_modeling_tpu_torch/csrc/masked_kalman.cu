// K7: the exact observed-data log-density of every (parameter row,
// instance) under any per-coordinate NaN mask: the masked Kalman filter.
//
// Replaces the TPU kernel ops/pallas_kalman.py:kalman_masked_logliks_packed
// (body _masked_kalman_kernel) of the JAX package.  The step is the algebra
// of ops/kalman.py:masked_filter_step_split:
//   1. condition the state (mu, lower triangle of P) on the observed z
//      coordinates one at a time (rank-1 downdates, rsqrt reciprocals);
//   2. update on the observed x coordinates against the conditioned
//      moments: masked innovation covariance H'P H + L with unit dummies,
//      its Cholesky, and the factored gain (w = L^-1 e, U_i = L^-1 PH_i);
//   3. predict: mu' = mu A, P' = A'P A + G on the lower triangle.
// Every masked entry is zeroed by a select, never by a multiply with the
// mask (0 * inf is NaN): an expansive A can overflow mu and P across a
// long unobserved tail in float32 while the observed prefix's log-density
// stays finite.  The masks are v == v, as in the TPU kernel.  A row with
// no finite entry gives exactly 0.0.
//
// Input: zp (T, d, n) and xp (T, l, n), NaNs kept, their rows in the
// order of a plan (ops/kalman_kernels.py:masked_plan): rows (n,) the
// caller's row at each position, extent (n,) each position's last step
// with a finite z or x entry, plus one (0 for none); params (C, np), each
// row m | S | A | G | H | L (np = d + 3d^2 + dl + l^2).  Output (C, n) in
// the caller's row order.
//
// Bound on the card: operations.  A step is 1229 element operations at
// d=5, l=3 (ops/kalman_kernels.py:masked_step_operations counts them from
// the step's code), and a row needs only the steps up to its extent: a
// step past the last observed one adds exactly -0.0 to the log-density
// (every term selected to 0, unit dummy pivots, w = 0), so the least work
// is 1229 * C * sum(extent): 1.55e11 at n=1e6, T=10, C=16 on the bench
// lengths (mean extent 7.9), ~2.3 ms at 67 TFLOP/s, against 0.1 ms for
// reading z and x once.  The step is issue-bound: about one instruction an
// element operation, one thread a (row, parameter row).  Design:
// - the plan orders the rows by extent, longest first (built once per fit
//   where the trainer packs the batch), and each thread stops at its row's
//   extent: a tile of 128 consecutive rows runs one loop count but at the
//   <= T boundaries between extents, the long tiles start first, and a
//   warp's reads of z and x stay contiguous; the result goes to the
//   caller's row;
// - one thread owns one (row, parameter row) and keeps mu, the lower
//   triangle of P and ll in registers through its steps; nothing but the
//   result goes to device memory;
// - the parameter row is staged in shared memory in the order the step
//   reads it (A and H by rows, the lower triangles of G and L), each piece
//   padded to 16 bytes and read with 128-bit loads.  Float32 at the fixed
//   shapes holds A, G and L in registers for the whole block (46 at
//   (5,3): 128 registers, 4 blocks an SM, no spill) and reads H's rows
//   once a step (5 loads); float64 and the general shape read each piece
//   where the step uses it.  The loads are volatile, so the compiler
//   neither repeats nor hoists them: what is held is chosen here, not by
//   the register allocator;
// - one log a step: every log of the step is the log of a pivot variance
//   s (log s for a z coordinate, 2 log(s rsqrt s) = log s for an x one),
//   so the step takes the log of the product of their mantissas (each in
//   [1, 2)) plus the sum of their exponents times ln 2.  A pivot that is
//   not a positive normal number (zero, subnormal, negative, Inf, NaN:
//   rare) sends its phase through an exact path that rescales subnormals
//   and adds the plain version's class for the rest: for a z pivot that of
//   log s (-Inf at 0, +Inf at +Inf, NaN below 0), for an x pivot that of
//   log(s rsqrt s) (NaN unless 0 < s < Inf); an unobserved z pivot is 1;
// - d and l are template parameters, so the unrolled algebra is
//   register-resident; the shapes of the repository's data and tests are
//   instantiated exactly, under __launch_bounds__(kThreads, kMinBlocks),
//   and one instantiation at kMax = 8 serves the rest (the same kernel,
//   its loops bounded by kMax and guarded by the run-time d and l);
// - a block takes kThreads positions of one parameter row, so any number
//   of parameter rows works (R*C = 512 of the masked pool included);
//   blockIdx.x is the parameter row, the fast axis of the grid, so the C
//   blocks of one tile run together and all but the first read the tile's
//   z and x from L2;
// - in float32 the reciprocals are rsqrtf (a relative error of at most
//   2 ulp), in float64 rsqrt; the one log is logf / log.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kMinBlocks = 4;  // blocks an SM asked of ptxas for the fixed shapes
constexpr int kMax = 8;        // d and l of the general instantiation
constexpr int kMaxGridY = 65535;
constexpr double kLog2Pi = 1.8378770664093453;  // log(2 pi)
constexpr double kLn2 = 0.69314718055994531;

__device__ __forceinline__ float rsqrt_(float v) { return rsqrtf(v); }
__device__ __forceinline__ double rsqrt_(double v) { return rsqrt(v); }
__device__ __forceinline__ float log_(float v) { return logf(v); }
__device__ __forceinline__ double log_(double v) { return log(v); }

// row-major lower triangle: element (i, j), j <= i
__host__ __device__ constexpr int tri(int i, int j) { return i * (i + 1) / 2 + j; }
__device__ __forceinline__ int sym(int i, int j) { return i >= j ? tri(i, j) : tri(j, i); }
__host__ __device__ constexpr int round_up(int k, int v) { return (k + v - 1) / v * v; }

// 16 bytes of shared memory in one 128-bit load
__device__ __forceinline__ void lds16(const float* src, float* dst) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(src);
  asm volatile("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4];"
               : "=f"(dst[0]), "=f"(dst[1]), "=f"(dst[2]), "=f"(dst[3])
               : "r"(a));
}
__device__ __forceinline__ void lds16(const double* src, double* dst) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(src);
  asm volatile("ld.shared.v2.f64 {%0, %1}, [%2];" : "=d"(dst[0]), "=d"(dst[1]) : "r"(a));
}

// N values (a whole number of 16-byte pieces) from 16-byte aligned shared memory
template <typename T, int N>
__device__ __forceinline__ void load_row(const T* src, T (&dst)[N]) {
  constexpr int kW = 16 / sizeof(T);
  static_assert(N % kW == 0, "staged pieces are padded to 16 bytes");
#pragma unroll
  for (int q = 0; q < N; q += kW) lds16(src + q, dst + q);
}

// a staged piece from the registers that hold it (HOLD) or from shared memory
template <bool HOLD, typename T, int N>
__device__ __forceinline__ void take_row(const T* held, const T* src, T (&dst)[N]) {
  if constexpr (HOLD) {
#pragma unroll
    for (int q = 0; q < N; ++q) dst[q] = held[q];
  } else {
    load_row(src, dst);
  }
}

// The staged parameter row: A by rows, G's lower triangle, H by rows, L's
// lower triangle, m, S's lower triangle; each piece and row padded to 16 bytes.
template <typename T, int DM, int LM>
struct Layout {
  static constexpr int kW = 16 / sizeof(T);
  static constexpr int kRowA = round_up(DM, kW);
  static constexpr int kRowH = round_up(LM, kW);
  static constexpr int kTriD = round_up(DM * (DM + 1) / 2, kW);
  static constexpr int kTriL = round_up(LM * (LM + 1) / 2, kW);
  static constexpr int kA = 0;
  static constexpr int kG = kA + DM * kRowA;
  static constexpr int kH = kG + kTriD;
  static constexpr int kL = kH + DM * kRowH;
  static constexpr int kM = kL + kTriL;
  static constexpr int kS = kM + kRowA;
  static constexpr int kSize = kS + kTriD;
};

__device__ __forceinline__ void lower_index(int q, int& r, int& j) {
  r = 0;
  while (tri(r + 1, 0) <= q) ++r;
  j = q - tri(r, 0);
}

// element e of the staged row, from the caller's row m | S | A | G | H | L; padding is 0
template <typename T, int DM, int LM>
__device__ T staged(const T* __restrict__ row, int e, int d, int l) {
  using Lay = Layout<T, DM, LM>;
  const T* S = row + d;
  const T* A = S + d * d;
  const T* G = A + d * d;
  const T* H = G + d * d;
  const T* L = H + d * l;
  int r, j;
  if (e < Lay::kG) {
    r = e / Lay::kRowA, j = e % Lay::kRowA;
    return r < d && j < d ? A[r * d + j] : T(0);
  }
  if (e < Lay::kH) {
    lower_index(e - Lay::kG, r, j);
    return r < d ? G[r * d + j] : T(0);
  }
  if (e < Lay::kL) {
    r = (e - Lay::kH) / Lay::kRowH, j = (e - Lay::kH) % Lay::kRowH;
    return r < d && j < l ? H[r * l + j] : T(0);
  }
  if (e < Lay::kM) {
    lower_index(e - Lay::kL, r, j);
    return r < l ? L[r * l + j] : T(0);
  }
  if (e < Lay::kS) return e - Lay::kM < d ? row[e - Lay::kM] : T(0);
  lower_index(e - Lay::kS, r, j);
  return r < d ? S[r * d + j] : T(0);
}

// The bits of a pivot variance: the word that holds its sign and exponent
template <typename T>
struct Bits;
template <>
struct Bits<float> {
  static constexpr int kBias = 127;
  static constexpr int kScaleExp = 24;
  static constexpr float kScale = 16777216.0f;  // 2^24: a subnormal made normal
  static __device__ __forceinline__ unsigned word(float s) { return __float_as_uint(s); }
  // not a positive normal number: zero, subnormal, Inf, NaN or negative
  static __device__ __forceinline__ bool odd(unsigned h) { return h - 0x00800000u >= 0x7f000000u; }
  static __device__ __forceinline__ int exponent(unsigned h) { return (int)(h >> 23); }
  static __device__ __forceinline__ float mantissa(float, unsigned h) {
    return __uint_as_float((h & 0x007fffffu) | 0x3f800000u);
  }
};
template <>
struct Bits<double> {
  static constexpr int kBias = 1023;
  static constexpr int kScaleExp = 54;
  static constexpr double kScale = 18014398509481984.0;  // 2^54
  static __device__ __forceinline__ unsigned word(double s) { return (unsigned)__double2hiint(s); }
  static __device__ __forceinline__ bool odd(unsigned h) { return h - 0x00100000u >= 0x7fe00000u; }
  static __device__ __forceinline__ int exponent(unsigned h) { return (int)(h >> 20); }
  static __device__ __forceinline__ double mantissa(double s, unsigned h) {
    return __hiloint2double((int)((h & 0x000fffffu) | 0x3ff00000u), __double2loint(s));
  }
};

// Sum of the logs of one phase's pivot variances, kept as the product f of
// their mantissas and the sum k of their biased exponents.
template <typename T>
struct PivotLog {
  T f = T(1);
  int k = 0;
  bool odd = false;

  __device__ __forceinline__ void take(T s) {
    const unsigned h = Bits<T>::word(s);
    odd = odd || Bits<T>::odd(h);
    f = f * Bits<T>::mantissa(s, h);
    k += Bits<T>::exponent(h);
  }

  // The phase again, exactly, after an odd pivot: subnormals rescaled; a
  // pivot that is zero, infinite, negative or NaN counts as 1 and adds its
  // class to cls: log s's for a z pivot, log(s rsqrt s)'s for an x pivot.
  template <int N>
  __device__ void exact(const T (&s)[N], int count, bool z_pivots, T& cls) {
    f = T(1);
    k = 0;
#pragma unroll
    for (int a = 0; a < N; ++a) {
      if (a < count) {
        T v = s[a];
        if (v > T(0) && v < T(INFINITY)) {
          int shift = 0;
          if (Bits<T>::odd(Bits<T>::word(v))) {
            v = v * Bits<T>::kScale;
            shift = Bits<T>::kScaleExp;
          }
          const unsigned h = Bits<T>::word(v);
          f = f * Bits<T>::mantissa(v, h);
          k += Bits<T>::exponent(h) - shift;
        } else {
          k += Bits<T>::kBias;
          const T bad = !z_pivots ? T(NAN) : v == T(0) ? -T(INFINITY) : v > T(0) ? T(INFINITY) : T(NAN);
          cls = cls + bad;
        }
      }
    }
  }
};

// DM, LM: array bounds; FIXED: d == DM and l == LM at compile time
template <typename T, int DM, int LM, bool FIXED>
__global__ void __launch_bounds__(kThreads, FIXED ? kMinBlocks : 1)
    masked_kalman_kernel(const T* __restrict__ zp, const T* __restrict__ xp,
                         const T* __restrict__ params, const int* __restrict__ rows,
                         const int* __restrict__ extent, T* __restrict__ out, int64_t n,
                         int steps, int d_rt, int l_rt, int ntiles) {
  using Lay = Layout<T, DM, LM>;
  constexpr int kRowA = Lay::kRowA;
  constexpr int kRowH = Lay::kRowH;
  const int d = FIXED ? DM : d_rt;
  const int l = FIXED ? LM : l_rt;
  const int np = d + 3 * d * d + d * l + l * l;
  __shared__ __align__(16) T p[Lay::kSize];
  const int c = blockIdx.x;
  for (int e = threadIdx.x; e < Lay::kSize; e += blockDim.x)
    p[e] = staged<T, DM, LM>(params + (int64_t)c * np, e, d, l);
  __syncthreads();
  const T log2pi = T(kLog2Pi);
  // float32 at the fixed shapes holds A, G and L in registers for the
  // whole block (46 of them at (5,3)); float64 and the general shape read
  // them from shared memory where the step uses them.  H is read once a step.
  constexpr bool kHold = FIXED && sizeof(T) == 4;
  T Ah[kHold ? DM : 1][kRowA], Gh[kHold ? Lay::kTriD : 1], Lh[kHold ? Lay::kTriL : 1];
  if constexpr (kHold) {
#pragma unroll
    for (int k = 0; k < DM; ++k) load_row(p + Lay::kA + k * kRowA, Ah[k]);
    load_row(p + Lay::kG, Gh);
    load_row(p + Lay::kL, Lh);
  }

  for (int tile = blockIdx.y; tile < ntiles; tile += gridDim.y) {
    const int64_t i = (int64_t)tile * kThreads + threadIdx.x;
    if (i >= n) continue;
    const int ext = min(extent[i], steps);
    T mu[DM], P[DM * (DM + 1) / 2];
    {
      T mv[kRowA], sv[Lay::kTriD];
      load_row(p + Lay::kM, mv);
      load_row(p + Lay::kS, sv);
#pragma unroll
      for (int a = 0; a < DM; ++a) {
        mu[a] = mv[a];
#pragma unroll
        for (int b = 0; b <= a; ++b) P[tri(a, b)] = sv[tri(a, b)];
      }
    }
    T ll = T(0);
#pragma unroll 1
    for (int t = 0; t < ext; ++t) {
      T zc[DM], xc[LM];
      bool oz[DM], ox[LM];
#pragma unroll
      for (int a = 0; a < DM; ++a) {
        if (a < d) {
          const T v = zp[((int64_t)t * d + a) * n + i];
          oz[a] = v == v;
          zc[a] = oz[a] ? v : T(0);
        }
      }
#pragma unroll
      for (int b = 0; b < LM; ++b) {
        if (b < l) {
          const T v = xp[((int64_t)t * l + b) * n + i];
          ox[b] = v == v;
          xc[b] = ox[b] ? v : T(0);
        }
      }
      // the step's log-density is -1/2 (sum log s + quad + nobs log 2 pi)
      T quad = T(0), nobs = T(0), cls = T(0);
      PivotLog<T> pz, px;

      // 1. the observed z coordinates, one at a time
      {
        T sz[DM];
#pragma unroll
        for (int a = 0; a < DM; ++a) {
          if (a < d) {
            const bool obs = oz[a];
            T pa[DM];
#pragma unroll
            for (int j = 0; j < DM; ++j)
              if (j < d) pa[j] = obs ? P[sym(a, j)] : T(0);
            const T s = P[tri(a, a)];
            const T ri = rsqrt_(s);
            const T inv = obs ? ri * ri : T(0);
            const T e = obs ? zc[a] - mu[a] : T(0);
            const T g = e * inv;
            quad = quad + e * g;
            nobs = nobs + (obs ? T(1) : T(0));
            sz[a] = obs ? s : T(1);
            pz.take(sz[a]);
            T k[DM];
#pragma unroll
            for (int r = 0; r < DM; ++r)
              if (r < d) k[r] = pa[r] * inv;
#pragma unroll
            for (int r = 0; r < DM; ++r)
              if (r < d) mu[r] = mu[r] + k[r] * e;
#pragma unroll
            for (int r = 0; r < DM; ++r)
#pragma unroll
              for (int j = 0; j <= r; ++j)
                if (r < d) P[tri(r, j)] = P[tri(r, j)] - k[r] * pa[j];
          }
        }
        if (pz.odd) pz.exact(sz, d, true, cls);
      }

      // 2. the observed x coordinates against the conditioned moments
      {
        // H by rows; PH = P H and mux = mu H
        T h[DM][kRowH], PH[DM][LM], mux[LM];
#pragma unroll
        for (int k = 0; k < DM; ++k)
          if (k < d) load_row(p + Lay::kH + k * kRowH, h[k]);
#pragma unroll
        for (int k = 0; k < DM; ++k) {
          if (k < d) {
#pragma unroll
            for (int b = 0; b < LM; ++b) {
              if (b < l) {
                mux[b] = k == 0 ? mu[0] * h[k][b] : mux[b] + mu[k] * h[k][b];
#pragma unroll
                for (int r = 0; r < DM; ++r)
                  if (r < d) PH[r][b] = k == 0 ? P[sym(r, 0)] * h[k][b] : PH[r][b] + P[sym(r, k)] * h[k][b];
              }
            }
          }
        }
        // masked innovation covariance L + H'PH (lower triangle)
        T Lc[LM * (LM + 1) / 2], invd[LM], sx[LM];
        {
          T lam[Lay::kTriL];
          take_row<kHold>(Lh, p + Lay::kL, lam);
#pragma unroll
          for (int a = 0; a < LM * (LM + 1) / 2; ++a) Lc[a] = lam[a];
        }
#pragma unroll
        for (int k = 0; k < DM; ++k)
          if (k < d)
#pragma unroll
            for (int a = 0; a < LM; ++a)
#pragma unroll
              for (int b = 0; b <= a; ++b)
                if (a < l) Lc[tri(a, b)] = Lc[tri(a, b)] + h[k][a] * PH[k][b];
#pragma unroll
        for (int a = 0; a < LM; ++a)
#pragma unroll
          for (int b = 0; b <= a; ++b)
            if (a < l) {
              const T v = Lc[tri(a, b)];
              Lc[tri(a, b)] = b < a ? ((ox[a] && ox[b]) ? v : T(0))
                                    : (ox[a] ? v : T(0)) + (ox[a] ? T(0) : T(1));
            }
        // its Cholesky; the pivots s go to the log
#pragma unroll
        for (int j = 0; j < LM; ++j) {
          if (j < l) {
            T s = Lc[tri(j, j)];
#pragma unroll
            for (int k = 0; k < j; ++k) s = s - Lc[tri(j, k)] * Lc[tri(j, k)];
            const T inv = rsqrt_(s);
            invd[j] = inv;
            sx[j] = s;
            px.take(s);
#pragma unroll
            for (int r = j + 1; r < LM; ++r) {
              if (r < l) {
                T t2 = Lc[tri(r, j)];
#pragma unroll
                for (int k = 0; k < j; ++k) t2 = t2 - Lc[tri(r, k)] * Lc[tri(j, k)];
                Lc[tri(r, j)] = t2 * inv;
              }
            }
          }
        }
        if (px.odd) px.exact(sx, l, false, cls);
        // innovation of the conditioned mean, w = L^-1 e
        T w[LM];
#pragma unroll
        for (int b = 0; b < LM; ++b) {
          if (b < l) {
            T t2 = ox[b] ? xc[b] - mux[b] : T(0);
#pragma unroll
            for (int k = 0; k < b; ++k) t2 = t2 - Lc[tri(b, k)] * w[k];
            w[b] = t2 * invd[b];
            quad = quad + w[b] * w[b];
            nobs = nobs + (ox[b] ? T(1) : T(0));
          }
        }
        // U_r = L^-1 (masked PH row r); mu += U' w; P -= U'U
        T U[DM][LM];
#pragma unroll
        for (int r = 0; r < DM; ++r) {
          if (r < d) {
#pragma unroll
            for (int b = 0; b < LM; ++b) {
              if (b < l) {
                T t2 = ox[b] ? PH[r][b] : T(0);
#pragma unroll
                for (int k = 0; k < b; ++k) t2 = t2 - Lc[tri(b, k)] * U[r][k];
                U[r][b] = t2 * invd[b];
              }
            }
            T acc = w[0] * U[r][0];
#pragma unroll
            for (int b = 1; b < LM; ++b)
              if (b < l) acc = acc + w[b] * U[r][b];
            mu[r] = mu[r] + acc;
          }
        }
#pragma unroll
        for (int r = 0; r < DM; ++r)
#pragma unroll
          for (int j = 0; j <= r; ++j)
            if (r < d) {
              T acc = U[r][0] * U[j][0];
#pragma unroll
              for (int b = 1; b < LM; ++b)
                if (b < l) acc = acc + U[r][b] * U[j][b];
              P[tri(r, j)] = P[tri(r, j)] - acc;
            }
      }
      const T logs = log_(pz.f * px.f) + T(pz.k + px.k - Bits<T>::kBias * (d + l)) * T(kLn2) + cls;
      ll = ll + T(-0.5) * (logs + quad + nobs * log2pi);

      // 3. predict: mu' = mu A, P' = A'P A + G (lower triangle), A by rows
      {
        T AP[DM][DM], mun[DM];
#pragma unroll
        for (int k = 0; k < DM; ++k) {
          if (k < d) {
            T ar[kRowA];
            take_row<kHold>(Ah[kHold ? k : 0], p + Lay::kA + k * kRowA, ar);
#pragma unroll
            for (int j = 0; j < DM; ++j)
              if (j < d) mun[j] = k == 0 ? mu[0] * ar[j] : mun[j] + mu[k] * ar[j];
#pragma unroll
            for (int r = 0; r < DM; ++r)
#pragma unroll
              for (int j = 0; j < DM; ++j)
                if (r < d && j < d)
                  AP[r][j] = k == 0 ? ar[r] * P[sym(0, j)] : AP[r][j] + ar[r] * P[sym(k, j)];
          }
        }
        {
          T g[Lay::kTriD];
          take_row<kHold>(Gh, p + Lay::kG, g);
#pragma unroll
          for (int a = 0; a < DM * (DM + 1) / 2; ++a) P[a] = g[a];
        }
#pragma unroll
        for (int k = 0; k < DM; ++k) {
          if (k < d) {
            T ar[kRowA];
            take_row<kHold>(Ah[kHold ? k : 0], p + Lay::kA + k * kRowA, ar);
#pragma unroll
            for (int r = 0; r < DM; ++r)
#pragma unroll
              for (int j = 0; j <= r; ++j)
                if (r < d) P[tri(r, j)] = P[tri(r, j)] + AP[r][k] * ar[j];
          }
        }
#pragma unroll
        for (int j = 0; j < DM; ++j)
          if (j < d) mu[j] = mun[j];
      }
    }
    out[(int64_t)c * n + rows[i]] = ll;
  }
}

template <typename T, int DM, int LM, bool FIXED>
int run(const void* zp, const void* xp, const void* params, const void* rows,
        const void* extent, void* out, int64_t n, int steps, int d, int l, int C,
        cudaStream_t stream) {
  const int64_t tiles = (n + kThreads - 1) / kThreads;
  const dim3 grid((unsigned)C, (unsigned)(tiles < kMaxGridY ? tiles : kMaxGridY));
  masked_kalman_kernel<T, DM, LM, FIXED><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(zp), static_cast<const T*>(xp), static_cast<const T*>(params),
      static_cast<const int*>(rows), static_cast<const int*>(extent), static_cast<T*>(out), n,
      steps, d, l, (int)tiles);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* zp, const void* xp, const void* params, const void* rows,
             const void* extent, void* out, int64_t n, int steps, int d, int l, int C,
             cudaStream_t s) {
#define MTM_KALMAN_SHAPE(DD, LL)                                                        \
  if (d == DD && l == LL)                                                               \
    return run<T, DD, LL, true>(zp, xp, params, rows, extent, out, n, steps, d, l, C, s);
  MTM_KALMAN_SHAPE(5, 3)  // the benchmark shape
  MTM_KALMAN_SHAPE(2, 4)  // ADNI
  MTM_KALMAN_SHAPE(2, 3)
  MTM_KALMAN_SHAPE(3, 2)
  MTM_KALMAN_SHAPE(1, 3)
  MTM_KALMAN_SHAPE(1, 1)
#undef MTM_KALMAN_SHAPE
  return run<T, kMax, kMax, false>(zp, xp, params, rows, extent, out, n, steps, d, l, C, s);
}

}  // namespace

// The largest d and l the kernel takes.
extern "C" int mtm_masked_kalman_max_dim() { return kMax; }

// kind: 0 float32, 1 float64.  rows and extent: int32 (n,), the plan of zp
// and xp's order.  Returns a cudaError_t (0 on success), or -1 for an
// argument the kernel does not take.
extern "C" int mtm_masked_kalman(int device, int kind, const void* zp, const void* xp,
                                 const void* params, const void* rows, const void* extent,
                                 void* out, long long n, int steps, int d, int l, int C,
                                 void* stream) {
  if (n <= 0 || n > INT32_MAX || steps <= 0 || d < 1 || l < 1 || d > kMax || l > kMax || C < 1)
    return -1;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (kind == 0)
    return dispatch<float>(zp, xp, params, rows, extent, out, (int64_t)n, steps, d, l, C, s);
  if (kind == 1)
    return dispatch<double>(zp, xp, params, rows, extent, out, (int64_t)n, steps, d, l, C, s);
  return -1;
}
