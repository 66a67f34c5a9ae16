// Hand-written Hopper (sm_90a) kernel for the batched small solve of the
// normal equations: the condition estimate, Gauss-Jordan elimination and,
// where the guard trips, the SVD rescue, for B symmetric (k, k) systems in
// one launch.  Plain C interface, loaded with ctypes (kernels/build.py).
//
// Replaces no TPU kernel: the JAX package leaves the solve to XLA's
// jnp.linalg.  It was added because the PyTorch chain of
// core/solve.py solve_with_fallback (eigvalsh, about 40 small launches of
// Gauss-Jordan, a batched SVD of every series) drains the queue three times
// a call to read cuSOLVER's info arrays, and launches about 60 kernels.
//
// What it computes, per series (one thread each), in this order:
//   1. cond: +inf where the Gram holds a non-finite entry; else the Gram
//      scaled by its largest |entry|, its eigenvalues by cyclic Jacobi in
//      double, cond = max|l| / min|l| (+inf where min|l| is 0).  This is
//      core/solve.py condition_estimate, at no lower precision.
//   2. x by Gauss-Jordan with partial pivoting, in the Gram's dtype, with
//      exactly the operations of core/solve.py gaussian_elimination in its
//      order: the pivot is the first row of largest |.| at or below the
//      column (NaN first, as torch.argmax), the factors are col / pivot with
//      the pivot row's set to 0, and each update is (multiply, then
//      subtract), the pivot row's 0 * row term included.  The __f*_rn /
//      __d*_rn intrinsics keep nvcc from contracting them into an FMA, so on
//      a finite Gram x has the bits of the torch chain.
//   3. bad = any non-finite x, or not (cond <= cap).
//   4. Only where bad and the fallback is the SVD: the rescue as
//      core/solve.py svd_solve defines it, in double: D = diag(A)^-1/2
//      (1 where the diagonal is not positive), the eigenpairs of DAD by
//      cyclic Jacobi, |l| <= eps * k * max|l| dropped (eps of the Gram's
//      dtype), x = D Q diag(1/l) Q^T D b.  For a symmetric matrix this is the
//      SVD's minimum-norm solve.  NaN where the Gram is not finite.
//   The fallback code: 0 none (used is all false), 1 svd, 2 gauss (the
//   primary's own rung: x stays, used = bad).
//
// What bounds it.  Nothing the card is short of: at B = 4096, k = 4 it reads
// and writes about 0.4 MB.  Each thread runs a chain of a few thousand
// dependent operations, so one launch takes some tens of microseconds; the
// point is that the host makes one launch and no read.  Every array lives in
// registers: the loops over rows and columns are unrolled for a k fixed at
// compile time (one instantiation for each k <= 8), and the pivot's row swap
// is a select over the rows, so no index is computed at run time.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxK = 8;
constexpr int kSolveThreads = 64;
constexpr int kMaxSweeps = 50;

// position of (i, j) in a packed upper triangle of a k x k matrix
__host__ __device__ constexpr int tri(int i, int j, int k) {
  return i <= j ? i * k - i * (i - 1) / 2 + (j - i) : tri(j, i, k);
}

__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float sub_rn(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ double sub_rn(double a, double b) { return __dsub_rn(a, b); }
__device__ __forceinline__ float div_rn(float a, float b) { return __fdiv_rn(a, b); }
__device__ __forceinline__ double div_rn(double a, double b) { return __ddiv_rn(a, b); }

template <typename T> struct Eps;
template <> struct Eps<float> { static constexpr double value = 1.1920928955078125e-07; };
template <> struct Eps<double> { static constexpr double value = 2.220446049250313e-16; };

template <typename T>
__device__ __forceinline__ bool finite(T v) { return isfinite(v); }

// Cyclic Jacobi on the packed upper triangle s (Numerical Recipes' rotation
// with its threshold in the first sweeps and its rule for negligible
// off-diagonal entries after the fourth).  On return the diagonal holds the
// eigenvalues and, with kVectors, the columns of v the eigenvectors.
template <int K, bool kVectors>
__device__ __forceinline__ void jacobi(double (&s)[K * (K + 1) / 2], double (&v)[K][K]) {
  if (kVectors) {
#pragma unroll
    for (int i = 0; i < K; ++i) {
#pragma unroll
      for (int j = 0; j < K; ++j) v[i][j] = i == j ? 1.0 : 0.0;
    }
  }
  for (int sweep = 0; sweep < kMaxSweeps; ++sweep) {
    double off = 0.0;
#pragma unroll
    for (int p = 0; p < K; ++p) {
#pragma unroll
      for (int q = p + 1; q < K; ++q) off += fabs(s[tri(p, q, K)]);
    }
    if (off == 0.0) break;
    const double tresh = sweep < 3 ? 0.2 * off / (K * K) : 0.0;
#pragma unroll
    for (int p = 0; p < K; ++p) {
#pragma unroll
      for (int q = p + 1; q < K; ++q) {
        const double apq = s[tri(p, q, K)];
        const double app = s[tri(p, p, K)], aqq = s[tri(q, q, K)];
        const double g = 100.0 * fabs(apq);
        if (sweep > 3 && fabs(app) + g == fabs(app) &&
            fabs(aqq) + g == fabs(aqq)) {
          s[tri(p, q, K)] = 0.0;
        } else if (fabs(apq) > tresh) {
          const double h = aqq - app;
          double t;
          if (fabs(h) + g == fabs(h)) {
            t = apq / h;
          } else {
            const double theta = 0.5 * h / apq;
            t = 1.0 / (fabs(theta) + sqrt(1.0 + theta * theta));
            if (theta < 0.0) t = -t;
          }
          const double c = 1.0 / sqrt(1.0 + t * t);
          const double sn = t * c;
          const double tau = sn / (1.0 + c);
          const double ht = t * apq;
          s[tri(p, p, K)] = app - ht;
          s[tri(q, q, K)] = aqq + ht;
          s[tri(p, q, K)] = 0.0;
#pragma unroll
          for (int r = 0; r < K; ++r) {
            if (r == p || r == q) continue;
            const double gr = s[tri(r, p, K)], hr = s[tri(r, q, K)];
            s[tri(r, p, K)] = gr - sn * (hr + gr * tau);
            s[tri(r, q, K)] = hr + sn * (gr - hr * tau);
          }
          if (kVectors) {
#pragma unroll
            for (int r = 0; r < K; ++r) {
              const double gr = v[r][p], hr = v[r][q];
              v[r][p] = gr - sn * (hr + gr * tau);
              v[r][q] = hr + sn * (gr - hr * tau);
            }
          }
        }
      }
    }
  }
}

template <typename T, int K>
__global__ void __launch_bounds__(kSolveThreads)
solve_small_kernel(const T* __restrict__ a, int64_t sa0, int64_t sa1,
                   int64_t sa2, const T* __restrict__ b, int64_t sb0,
                   int64_t sb1, int64_t B, double cap, int fallback,
                   T* __restrict__ x_out, T* __restrict__ cond_out,
                   uint8_t* __restrict__ used_out) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kSolveThreads + threadIdx.x;
  if (i >= B) return;
  const T* ai = a + i * sa0;
  const T* bi = b + i * sb0;
  auto at = [&](int r, int c) { return ai[r * sa1 + c * sa2]; };

  // ---- 1. condition estimate: the lower triangle, scaled, in double
  bool gram_finite = true;
  T amax = T(0);
#pragma unroll
  for (int r = 0; r < K; ++r) {
#pragma unroll
    for (int c = 0; c < K; ++c) {
      const T v = at(r, c);
      gram_finite = gram_finite && finite(v);
      amax = fmax(amax, fabs(v));
    }
  }
  double cond = __longlong_as_double(0x7ff0000000000000LL);   // +inf
  if (gram_finite) {
    const double scale = amax > T(0) ? static_cast<double>(amax) : 1.0;
    double s[K * (K + 1) / 2];
    double unused[K][K];
#pragma unroll
    for (int r = 0; r < K; ++r) {
#pragma unroll
      for (int c = 0; c <= r; ++c) s[tri(c, r, K)] = static_cast<double>(at(r, c)) / scale;
    }
    jacobi<K, false>(s, unused);
    double wmax = 0.0, wmin = fabs(s[tri(0, 0, K)]);
#pragma unroll
    for (int r = 0; r < K; ++r) {
      const double w = fabs(s[tri(r, r, K)]);
      wmax = fmax(wmax, w);
      wmin = fmin(wmin, w);
    }
    if (wmin > 0.0) cond = wmax / wmin;
  }
  const T cond_t = static_cast<T>(cond);

  // ---- 2. Gauss-Jordan with partial pivoting, in T, the torch chain's ops
  T aug[K][K + 1];
#pragma unroll
  for (int r = 0; r < K; ++r) {
#pragma unroll
    for (int c = 0; c < K; ++c) aug[r][c] = at(r, c);
    aug[r][K] = bi[r * sb1];
  }
#pragma unroll
  for (int k = 0; k < K; ++k) {
    // torch.argmax over |col| with rows above k at -inf: NaN wins, then the
    // largest, ties to the first row
    int p = k;
    T best = fabs(aug[k][k]);
#pragma unroll
    for (int r = k + 1; r < K; ++r) {
      const T v = fabs(aug[r][k]);
      if (!(best != best) && (v != v || v > best)) {
        best = v;
        p = r;
      }
    }
#pragma unroll
    for (int r = k + 1; r < K; ++r) {
      if (r == p) {
#pragma unroll
        for (int c = 0; c <= K; ++c) {
          const T t = aug[k][c];
          aug[k][c] = aug[r][c];
          aug[r][c] = t;
        }
      }
    }
    const T pivot = aug[k][k];
    T f[K];
#pragma unroll
    for (int r = 0; r < K; ++r) f[r] = r == k ? T(0) : div_rn(aug[r][k], pivot);
    T row[K + 1];
#pragma unroll
    for (int c = 0; c <= K; ++c) row[c] = aug[k][c];
#pragma unroll
    for (int r = 0; r < K; ++r) {
#pragma unroll
      for (int c = 0; c <= K; ++c) aug[r][c] = sub_rn(aug[r][c], mul_rn(f[r], row[c]));
    }
  }
  T x[K];
  bool x_finite = true;
#pragma unroll
  for (int r = 0; r < K; ++r) {
    x[r] = div_rn(aug[r][K], aug[r][r]);
    x_finite = x_finite && finite(x[r]);
  }

  // ---- 3. the guard
  const bool bad = !x_finite || !(cond_t <= static_cast<T>(cap));

  // ---- 4. the SVD rescue, only where it is used
  if (bad && fallback == 1) {
    if (!gram_finite) {
#pragma unroll
      for (int r = 0; r < K; ++r) x[r] = static_cast<T>(__longlong_as_double(0x7ff8000000000000LL));
    } else {
      double d[K], be[K];
#pragma unroll
      for (int r = 0; r < K; ++r) {
        const double arr = static_cast<double>(at(r, r));
        d[r] = arr > 0.0 ? 1.0 / sqrt(arr) : 1.0;
        be[r] = static_cast<double>(bi[r * sb1]) * d[r];
      }
      double s[K * (K + 1) / 2];
      double q[K][K];
#pragma unroll
      for (int r = 0; r < K; ++r) {
#pragma unroll
        for (int c = 0; c <= r; ++c)
          s[tri(c, r, K)] = static_cast<double>(at(r, c)) * d[r] * d[c];
      }
      jacobi<K, true>(s, q);
      double lmax = 0.0;
#pragma unroll
      for (int j = 0; j < K; ++j) lmax = fmax(lmax, fabs(s[tri(j, j, K)]));
      const double cutoff = Eps<T>::value * K * lmax;
      double z[K];
#pragma unroll
      for (int j = 0; j < K; ++j) {
        double qtb = 0.0;
#pragma unroll
        for (int l = 0; l < K; ++l) qtb += q[l][j] * be[l];
        const double lam = s[tri(j, j, K)];
        // dropped terms are multiplied by 0, not skipped: a NaN in b stays
        z[j] = (fabs(lam) > cutoff ? 1.0 / lam : 0.0) * qtb;
      }
#pragma unroll
      for (int r = 0; r < K; ++r) {
        double acc = 0.0;
#pragma unroll
        for (int j = 0; j < K; ++j) acc += q[r][j] * z[j];
        x[r] = static_cast<T>(acc * d[r]);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < K; ++r) x_out[i * K + r] = x[r];
  cond_out[i] = cond_t;
  used_out[i] = fallback != 0 && bad;
}

template <typename T, int K>
int launch_solve(const void* a, int64_t sa0, int64_t sa1, int64_t sa2,
                 const void* b, int64_t sb0, int64_t sb1, int64_t B,
                 double cap, int fallback, void* x, void* cond, void* used,
                 cudaStream_t st) {
  const int64_t blocks = (B + kSolveThreads - 1) / kSolveThreads;
  solve_small_kernel<T, K><<<static_cast<unsigned>(blocks), kSolveThreads, 0, st>>>(
      static_cast<const T*>(a), sa0, sa1, sa2, static_cast<const T*>(b), sb0,
      sb1, B, cap, fallback, static_cast<T*>(x), static_cast<T*>(cond),
      static_cast<uint8_t*>(used));
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_solve_k(int k, const void* a, int64_t sa0, int64_t sa1,
                   int64_t sa2, const void* b, int64_t sb0, int64_t sb1,
                   int64_t B, double cap, int fallback, void* x, void* cond,
                   void* used, cudaStream_t st) {
  switch (k) {
#define REPRO_SOLVE_K(KK)                                                   \
    case KK: return launch_solve<T, KK>(a, sa0, sa1, sa2, b, sb0, sb1, B, \
                                        cap, fallback, x, cond, used, st);
    REPRO_SOLVE_K(1) REPRO_SOLVE_K(2) REPRO_SOLVE_K(3) REPRO_SOLVE_K(4)
    REPRO_SOLVE_K(5) REPRO_SOLVE_K(6) REPRO_SOLVE_K(7) REPRO_SOLVE_K(8)
#undef REPRO_SOLVE_K
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype_code: 0 float32, 1 float64.  a: (B, k, k) at element strides
// (sa0, sa1, sa2); b: (B, k) at (sb0, sb1); x: contiguous (B, k); cond: (B,)
// in a's dtype; used: (B,) bytes.  fallback: 0 none, 1 svd, 2 gauss.
extern "C" int repro_solve_small(int dtype_code, int k, int fallback,
                                 const void* a, int64_t sa0, int64_t sa1,
                                 int64_t sa2, const void* b, int64_t sb0,
                                 int64_t sb1, int64_t B, double cap, void* x,
                                 void* cond, void* used, void* stream) {
  if (k < 1 || k > kMaxK || fallback < 0 || fallback > 2 || B < 0)
    return cudaErrorInvalidValue;
  if (B == 0) return 0;
  if ((B + kSolveThreads - 1) / kSolveThreads > 0x7fffffff)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype_code) {
    case 0: return launch_solve_k<float>(k, a, sa0, sa1, sa2, b, sb0, sb1, B, cap, fallback, x, cond, used, st);
    case 1: return launch_solve_k<double>(k, a, sa0, sa1, sa2, b, sb0, sb1, B, cap, fallback, x, cond, used, st);
    default: return cudaErrorInvalidValue;
  }
}
