// K7: the exact observed-data log-density of every (parameter row,
// instance) under any per-coordinate NaN mask: the masked Kalman filter.
//
// Replaces the TPU kernel ops/pallas_kalman.py:kalman_masked_logliks_packed
// (body _masked_kalman_kernel) of the JAX package.  The step is the algebra
// of ops/kalman.py:masked_filter_step_split, written out once more here in
// the same order of operations:
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
// Input: zp (T, d, n) and xp (T, l, n), NaNs kept; params (C, np), each
// row m | S | A | G | H | L (np = d + 3d^2 + dl + l^2).  Output (C, n).
//
// Bound on the card: operations.  A step is about 1.2e3 element
// operations at d=5, l=3 (ops/kalman_kernels.py:masked_step_operations
// counts them from the step's code), so n=1e6, T=10, C=16 is about 1.9e11:
// ~2.9 ms at 67 TFLOP/s, against 0.1 ms for reading z and x once.  Design:
// - one thread owns one (instance, parameter row) and keeps mu, the lower
//   triangle of P and ll in registers through all T steps; nothing but the
//   result goes to device memory;
// - d and l are template parameters, so the unrolled algebra is
//   register-resident; the shapes of the repository's data and tests are
//   instantiated exactly, and one instantiation at kMax = 8 serves the
//   rest (the same kernel, its loops bounded by kMax and guarded by the
//   run-time d and l, its arrays partly in local memory);
// - a block takes kThreads instances of one parameter row, whose
//   parameters it stages in shared memory, so any number of parameter rows
//   works (R*C = 512 of the masked pool included);
// - blockIdx.x is the parameter row, the fast axis of the grid, so the C
//   blocks of one instance tile run together and all but the first read
//   the tile's z and x from L2, not from device memory;
// - in float32 the reciprocals are rsqrtf (a relative error of at most
//   2 ulp), in float64 rsqrt; logs are logf / log.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kMax = 8;             // d and l of the general instantiation
constexpr int kMaxGridY = 65535;
constexpr double kLog2Pi = 1.8378770664093453;  // log(2 pi)

__device__ __forceinline__ float rsqrt_(float v) { return rsqrtf(v); }
__device__ __forceinline__ double rsqrt_(double v) { return rsqrt(v); }
__device__ __forceinline__ float log_(float v) { return logf(v); }
__device__ __forceinline__ double log_(double v) { return log(v); }

// row-major lower triangle: element (i, j), j <= i
__host__ __device__ constexpr int tri(int i, int j) { return i * (i + 1) / 2 + j; }
__device__ __forceinline__ int sym(int i, int j) { return i >= j ? tri(i, j) : tri(j, i); }

// DM, LM: array bounds; FIXED: d == DM and l == LM at compile time
template <typename T, int DM, int LM, bool FIXED>
__global__ void __launch_bounds__(kThreads)
    masked_kalman_kernel(const T* __restrict__ zp, const T* __restrict__ xp,
                         const T* __restrict__ params, T* __restrict__ out,
                         int64_t n, int steps, int d_rt, int l_rt, int ntiles) {
  const int d = FIXED ? DM : d_rt;
  const int l = FIXED ? LM : l_rt;
  const int np = d + 3 * d * d + d * l + l * l;
  extern __shared__ __align__(16) unsigned char smem[];
  T* p = reinterpret_cast<T*>(smem);
  const int c = blockIdx.x;
  for (int e = threadIdx.x; e < np; e += blockDim.x)
    p[e] = params[(int64_t)c * np + e];
  __syncthreads();
  const T* m = p;
  const T* S = m + d;
  const T* A = S + d * d;
  const T* G = A + d * d;
  const T* H = G + d * d;
  const T* Lm = H + d * l;
  const T log2pi = T(kLog2Pi);

  for (int tile = blockIdx.y; tile < ntiles; tile += gridDim.y) {
    const int64_t i = (int64_t)tile * blockDim.x + threadIdx.x;
    if (i >= n) continue;
    T mu[DM], P[DM * (DM + 1) / 2];
#pragma unroll
    for (int a = 0; a < DM; ++a) {
      if (a < d) {
        mu[a] = m[a];
#pragma unroll
        for (int b = 0; b <= a; ++b) P[tri(a, b)] = S[a * d + b];
      }
    }
    T ll = T(0);
    for (int t = 0; t < steps; ++t) {
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

      // 1. the observed z coordinates, one at a time
      T llz = T(0);
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
          const T term = obs ? log_(s) + e * g + log2pi : T(0);
          llz = a == 0 ? term : llz + term;
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
      llz = T(-0.5) * llz;

      // 2. the observed x coordinates against the conditioned moments
      T PH[DM][LM];
#pragma unroll
      for (int r = 0; r < DM; ++r)
#pragma unroll
        for (int b = 0; b < LM; ++b)
          if (r < d && b < l) {
            T acc = P[sym(r, 0)] * H[b];
#pragma unroll
            for (int k = 1; k < DM; ++k)
              if (k < d) acc = acc + P[sym(r, k)] * H[k * l + b];
            PH[r][b] = acc;
          }
      // masked innovation covariance (lower triangle) and its Cholesky
      T Lc[LM * (LM + 1) / 2], invd[LM];
#pragma unroll
      for (int a = 0; a < LM; ++a) {
        if (a < l) {
#pragma unroll
          for (int b = 0; b <= a; ++b) {
            T acc = H[a] * PH[0][b];
#pragma unroll
            for (int k = 1; k < DM; ++k)
              if (k < d) acc = acc + H[k * l + a] * PH[k][b];
            acc = acc + Lm[a * l + b];
            Lc[tri(a, b)] = b < a ? ((ox[a] && ox[b]) ? acc : T(0))
                                  : (ox[a] ? acc : T(0)) + (ox[a] ? T(0) : T(1));
          }
        }
      }
#pragma unroll
      for (int j = 0; j < LM; ++j) {
        if (j < l) {
          T s = Lc[tri(j, j)];
#pragma unroll
          for (int k = 0; k < j; ++k) s = s - Lc[tri(j, k)] * Lc[tri(j, k)];
          const T inv = rsqrt_(s);
          Lc[tri(j, j)] = s * inv;
          invd[j] = inv;
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
      // innovation of the conditioned mean, w = L^-1 e
      T w[LM];
      T quad = T(0), logdet = T(0), nobs = T(0);
#pragma unroll
      for (int b = 0; b < LM; ++b) {
        if (b < l) {
          T mux = mu[0] * H[b];
#pragma unroll
          for (int r = 1; r < DM; ++r)
            if (r < d) mux = mux + mu[r] * H[r * l + b];
          T t2 = ox[b] ? xc[b] - mux : T(0);
#pragma unroll
          for (int k = 0; k < b; ++k) t2 = t2 - Lc[tri(b, k)] * w[k];
          w[b] = t2 * invd[b];
          quad = b == 0 ? w[b] * w[b] : quad + w[b] * w[b];
          logdet = b == 0 ? log_(Lc[tri(b, b)]) : logdet + log_(Lc[tri(b, b)]);
          nobs = b == 0 ? (ox[b] ? T(1) : T(0)) : nobs + (ox[b] ? T(1) : T(0));
        }
      }
      logdet = T(2) * logdet;
      const T llx = T(-0.5) * (logdet + quad + nobs * log2pi);
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

      // 3. predict: mu' = mu A, P' = A'P A + G (lower triangle)
      T mun[DM];
#pragma unroll
      for (int j = 0; j < DM; ++j)
        if (j < d) {
          T acc = mu[0] * A[j];
#pragma unroll
          for (int r = 1; r < DM; ++r)
            if (r < d) acc = acc + mu[r] * A[r * d + j];
          mun[j] = acc;
        }
      T AP[DM][DM];
#pragma unroll
      for (int r = 0; r < DM; ++r)
#pragma unroll
        for (int j = 0; j < DM; ++j)
          if (r < d && j < d) {
            T acc = A[r] * P[sym(0, j)];
#pragma unroll
            for (int k = 1; k < DM; ++k)
              if (k < d) acc = acc + A[k * d + r] * P[sym(k, j)];
            AP[r][j] = acc;
          }
#pragma unroll
      for (int r = 0; r < DM; ++r) {
        if (r < d) {
          mu[r] = mun[r];
#pragma unroll
          for (int j = 0; j <= r; ++j) {
            T acc = AP[r][0] * A[j];
#pragma unroll
            for (int k = 1; k < DM; ++k)
              if (k < d) acc = acc + AP[r][k] * A[k * d + j];
            P[tri(r, j)] = acc + G[r * d + j];
          }
        }
      }
      ll = ll + (llz + llx);
    }
    out[(int64_t)c * n + i] = ll;
  }
}

template <typename T, int DM, int LM, bool FIXED>
int run(const void* zp, const void* xp, const void* params, void* out,
        int64_t n, int steps, int d, int l, int C, cudaStream_t stream) {
  const int64_t tiles = (n + kThreads - 1) / kThreads;
  const int np = d + 3 * d * d + d * l + l * l;
  const size_t smem = sizeof(T) * (size_t)np;
  auto kern = masked_kalman_kernel<T, DM, LM, FIXED>;
  const dim3 grid((unsigned)C, (unsigned)(tiles < kMaxGridY ? tiles : kMaxGridY));
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(zp), static_cast<const T*>(xp),
      static_cast<const T*>(params), static_cast<T*>(out), n, steps, d, l,
      (int)tiles);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* zp, const void* xp, const void* params, void* out,
             int64_t n, int steps, int d, int l, int C, cudaStream_t s) {
#define MTM_KALMAN_SHAPE(DD, LL)                                             \
  if (d == DD && l == LL)                                                    \
    return run<T, DD, LL, true>(zp, xp, params, out, n, steps, d, l, C, s);
  MTM_KALMAN_SHAPE(5, 3)  // the benchmark shape
  MTM_KALMAN_SHAPE(2, 4)  // ADNI
  MTM_KALMAN_SHAPE(2, 3)
  MTM_KALMAN_SHAPE(3, 2)
  MTM_KALMAN_SHAPE(1, 3)
  MTM_KALMAN_SHAPE(1, 1)
#undef MTM_KALMAN_SHAPE
  return run<T, kMax, kMax, false>(zp, xp, params, out, n, steps, d, l, C, s);
}

}  // namespace

// The largest d and l the kernel takes.
extern "C" int mtm_masked_kalman_max_dim() { return kMax; }

// kind: 0 float32, 1 float64.  Returns a cudaError_t (0 on success), or -1
// for an argument the kernel does not take.
extern "C" int mtm_masked_kalman(int device, int kind, const void* zp,
                                 const void* xp, const void* params,
                                 void* out, long long n, int steps, int d,
                                 int l, int C, void* stream) {
  if (n <= 0 || steps <= 0 || d < 1 || l < 1 || d > kMax || l > kMax || C < 1)
    return -1;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (kind == 0)
    return dispatch<float>(zp, xp, params, out, (int64_t)n, steps, d, l, C, s);
  if (kind == 1)
    return dispatch<double>(zp, xp, params, out, (int64_t)n, steps, d, l, C, s);
  return -1;
}
