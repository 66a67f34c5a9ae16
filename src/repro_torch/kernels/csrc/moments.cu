// Hand-written Hopper (sm_90a) kernels for the moment pass and the fused
// fit report.  Plain C interface, loaded with ctypes (kernels/build.py).
//
// Replaces the Pallas TPU kernels of repro/kernels/moments.py:
//   moments_plain   <- _moments_kernel via moments_extended (one series)
//   moments_packed  <- _packed_moments_kernel via moments_packed_extended
//   fused_report    <- _fused_report_kernel via fused_report_sums
// (the multi-buffered _packed_moments_db_kernel is in moments_ring.cu; the
// moment kernels' loops and arithmetic, which both files instantiate, are
// in moments_common.cuh)
//
// What they compute.  For each series b with points (x_i, y_i, w_i):
//   S_k = sum w x^k      (k = 0..2m)     power sums (the paper's CUDA scheme)
//   T_k = sum w x^k y    (k = 0..m)
//   U   = sum w y^2
// and the K x K extended Gram (K = m + 2, rows/cols x^0..x^m, y) is
// assembled from them: G[j][k] = S_{j+k}, G[j][m+1] = T_j, G[m+1][m+1] = U.
// The TPU kernels' 128-row padding and the packed tile's cross-series
// blocks are MXU artefacts and are not computed.
//
// What bounds them.  Each point is read once (x, y and optionally w) and
// costs O(m) multiply-adds, so at the degrees the main path uses the moment
// pass is bound by device-memory bytes, not by arithmetic.  The design keeps
// every accumulator in registers (degree <= 14), reads each input once with
// consecutive threads on consecutive addresses, and writes only small
// per-split partials.
//
// Layout of the work.  A "task" is one (series, n-split) pair; S splits per
// series are chosen by the caller from (B, n) so the grid covers the SMs
// several times.  moments_plain gives each task a whole CTA (256 threads,
// for long single series); moments_packed gives each task one warp, eight
// series per CTA (for batches of short and medium series).  Above degree 14
// both use a shared-memory kernel: the CTA stages the powers of a tile of
// points in shared memory and each thread owns at most two of the 3m+3
// sums.  A second small kernel sums the partials over the splits in a fixed
// order and assembles the Gram.  No float atomics: two runs on the same
// input give the same bits.
//
// The domain map.  Every launch hands shift and scale (two scalars on the
// card: a fit's domain, or the identity's 0 and 1), and the moment kernels
// map each x value as they load it, (x - shift) * scale rounded as
// PyTorch's sub and mul round it, so a fit that normalizes its domain reads
// x once and writes no mapped copy (moments_common.cuh).
//
// Compensated (Kahan) accumulation keeps a (hi, lo) pair per sum in the
// per-thread loop, in the warp/CTA reductions and in the cross-split pass.
// Never build with --use_fast_math: it would reassociate the error terms
// away.
#include "moments_common.cuh"

namespace {

constexpr int kReportSums = 7;

// ---------------------------------------------------------------------------
// Fused report: Horner f, e = y - f and the seven sums per task, no (B, n)
// array written.  coeffs: (B, m+1) in the accumulation type.
template <typename TIn, typename TAcc>
__global__ void __launch_bounds__(kThreads)
report_kernel(const TIn* __restrict__ x, const TIn* __restrict__ y,
              const TAcc* __restrict__ w, const TAcc* __restrict__ coeffs,
              int64_t B, int64_t n, int m, int S, TAcc* __restrict__ part) {
  __shared__ TAcc c[kMaxDegree + 2];
  __shared__ TAcc sh[kWarps][kReportSums];
  const int64_t task = blockIdx.x;
  const int64_t b = task / S;
  const int64_t s = task % S;
  const int64_t chunk = (n + S - 1) / S;
  const int64_t lo_i = s * chunk;
  const int64_t hi_i = lo_i + chunk < n ? lo_i + chunk : n;
  for (int i = threadIdx.x; i <= m; i += kThreads) c[i] = coeffs[b * (m + 1) + i];
  __syncthreads();
  const TIn* xb = x + b * n;
  const TIn* yb = y + b * n;
  const TAcc* wb = w ? w + b * n : nullptr;

  Acc<TAcc, false> a[kReportSums];
#pragma unroll
  for (int j = 0; j < kReportSums; ++j) a[j].zero();
  for (int64_t i = lo_i + threadIdx.x; i < hi_i; i += kThreads) {
    const TAcc xv = cvt<TAcc>(xb[i]);
    const TAcc yv = cvt<TAcc>(yb[i]);
    const TAcc wv = wb ? wb[i] : TAcc(1);
    TAcc f = c[m];
    for (int k = m - 1; k >= 0; --k) f = f * xv + c[k];
    const TAcc e = yv - f;
    a[0].add(wv);
    a[1].add(wv * yv);
    a[2].add(wv * yv * yv);
    a[3].add(wv * f);
    a[4].add(wv * f * f);
    a[5].add(wv * yv * f);
    a[6].add(wv * e * e);
  }
  const int warp = threadIdx.x / 32;
#pragma unroll
  for (int j = 0; j < kReportSums; ++j) {
    warp_reduce(a[j]);
    if (threadIdx.x % 32 == 0) sh[warp][j] = a[j].hi;
  }
  __syncthreads();
  if (threadIdx.x < kReportSums) {
    TAcc t = TAcc(0);
    for (int v = 0; v < kWarps; ++v) t += sh[v][threadIdx.x];
    part[task * kReportSums + threadIdx.x] = t;
  }
}

template <typename TAcc>
__global__ void report_finalize(const TAcc* __restrict__ part, int64_t B,
                                int S, TAcc* __restrict__ out) {
  const int64_t idx = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (idx >= B * kReportSums) return;
  const int64_t b = idx / kReportSums;
  const int j = static_cast<int>(idx % kReportSums);
  TAcc t = TAcc(0);
  for (int s = 0; s < S; ++s) t += part[(b * S + s) * kReportSums + j];
  out[idx] = t;
}

// ---------------------------------------------------------------------------
template <typename TIn, typename TAcc, bool KAHAN, int MAXD>
void launch_reg(int layout, const TIn* x, const TIn* y, const TAcc* w,
                int64_t B, int64_t n, int m, int S, TAcc* ph, TAcc* pl,
                const TIn* shift, const TIn* scale, cudaStream_t st) {
  const int64_t tasks = B * S;
  if (layout == 0) {
    moments_reg_kernel<DirectLoads, TIn, TAcc, KAHAN, MAXD, kThreads>
        <<<blocks_for(tasks, 1), kThreads, 0, st>>>(
            x, y, w, B, n, m, S, LoadArgs{}, ph, pl, shift, scale);
  } else {
    moments_reg_kernel<DirectLoads, TIn, TAcc, KAHAN, MAXD, 32>
        <<<blocks_for(tasks, kWarps), kThreads, 0, st>>>(
            x, y, w, B, n, m, S, LoadArgs{}, ph, pl, shift, scale);
  }
}

template <typename TIn, typename TAcc, bool KAHAN>
cudaError_t launch_moments(int layout, const void* xv, const void* yv,
                           const void* wv, int64_t B, int64_t n, int m, int S,
                           void* phv, void* plv, void* outv,
                           const void* shiftv, const void* scalev,
                           cudaStream_t st) {
  const TIn* x = static_cast<const TIn*>(xv);
  const TIn* y = static_cast<const TIn*>(yv);
  const TAcc* w = static_cast<const TAcc*>(wv);
  const TIn* shift = static_cast<const TIn*>(shiftv);
  const TIn* scale = static_cast<const TIn*>(scalev);
  TAcc* ph = static_cast<TAcc*>(phv);
  TAcc* pl = static_cast<TAcc*>(plv);
  if (m <= 3) {
    launch_reg<TIn, TAcc, KAHAN, 3>(layout, x, y, w, B, n, m, S, ph, pl,
                                    shift, scale, st);
  } else if (m <= 7) {
    launch_reg<TIn, TAcc, KAHAN, 7>(layout, x, y, w, B, n, m, S, ph, pl,
                                    shift, scale, st);
  } else if (m <= kRegMaxDegree) {
    launch_reg<TIn, TAcc, KAHAN, kRegMaxDegree>(layout, x, y, w, B, n, m, S,
                                                ph, pl, shift, scale, st);
  } else {
    moments_smem_kernel<DirectLoads, TIn, TAcc, KAHAN>
        <<<blocks_for(B * S, 1), kThreads, 0, st>>>(
            x, y, w, B, n, m, S, LoadArgs{}, ph, pl, shift, scale);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return launch_finalize<TAcc, KAHAN>(ph, pl, B, m, S,
                                      static_cast<TAcc*>(outv), st);
}

template <typename TIn, typename TAcc>
cudaError_t launch_moments_k(int kahan, int layout, const void* x,
                             const void* y, const void* w, int64_t B,
                             int64_t n, int m, int S, void* ph, void* pl,
                             void* out, const void* shift, const void* scale,
                             cudaStream_t st) {
  return kahan ? launch_moments<TIn, TAcc, true>(layout, x, y, w, B, n, m, S,
                                                 ph, pl, out, shift, scale,
                                                 st)
               : launch_moments<TIn, TAcc, false>(layout, x, y, w, B, n, m, S,
                                                  ph, pl, out, shift, scale,
                                                  st);
}

template <typename TIn, typename TAcc>
cudaError_t launch_report(const void* x, const void* y, const void* w,
                          const void* coeffs, int64_t B, int64_t n, int m,
                          int S, void* part, void* out, cudaStream_t st) {
  report_kernel<TIn, TAcc><<<blocks_for(B * S, 1), kThreads, 0, st>>>(
      static_cast<const TIn*>(x), static_cast<const TIn*>(y),
      static_cast<const TAcc*>(w), static_cast<const TAcc*>(coeffs), B, n, m,
      S, static_cast<TAcc*>(part));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  report_finalize<TAcc><<<blocks_for(B * kReportSums, kThreads), kThreads, 0,
                          st>>>(static_cast<const TAcc*>(part), B, S,
                                static_cast<TAcc*>(out));
  return cudaGetLastError();
}

}  // namespace

// in_code: 0 float32, 1 bfloat16, 2 float64; acc_code: 0 float32, 1 float64.
// shift, scale: the domain map's two scalars in the input type on the
// card, applied to x as it is loaded (the identity's 0 and 1 for none).
// Returns a cudaError_t (0 on success); an unknown code, or a null shift
// or scale, returns cudaErrorInvalidValue.
extern "C" int repro_moments(int layout, int in_code, int acc_code, int kahan,
                             const void* x, const void* y, const void* w,
                             int64_t B, int64_t n, int m, int S, void* part_hi,
                             void* part_lo, void* out, void* stream,
                             const void* shift, const void* scale) {
  if (m < 0 || m > kMaxDegree || S < 1 || shift == nullptr ||
      scale == nullptr)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (in_code * 2 + acc_code) {
    case 0: return launch_moments_k<float, float>(kahan, layout, x, y, w, B, n, m, S, part_hi, part_lo, out, shift, scale, st);
    case 1: return launch_moments_k<float, double>(kahan, layout, x, y, w, B, n, m, S, part_hi, part_lo, out, shift, scale, st);
    case 2: return launch_moments_k<__nv_bfloat16, float>(kahan, layout, x, y, w, B, n, m, S, part_hi, part_lo, out, shift, scale, st);
    case 3: return launch_moments_k<__nv_bfloat16, double>(kahan, layout, x, y, w, B, n, m, S, part_hi, part_lo, out, shift, scale, st);
    case 4: return launch_moments_k<double, float>(kahan, layout, x, y, w, B, n, m, S, part_hi, part_lo, out, shift, scale, st);
    case 5: return launch_moments_k<double, double>(kahan, layout, x, y, w, B, n, m, S, part_hi, part_lo, out, shift, scale, st);
    default: return cudaErrorInvalidValue;
  }
}

extern "C" int repro_report(int in_code, int acc_code, const void* x,
                            const void* y, const void* w, const void* coeffs,
                            int64_t B, int64_t n, int m, int S, void* part,
                            void* out, void* stream) {
  if (m < 0 || m > kMaxDegree + 1 || S < 1) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (in_code * 2 + acc_code) {
    case 0: return launch_report<float, float>(x, y, w, coeffs, B, n, m, S, part, out, st);
    case 1: return launch_report<float, double>(x, y, w, coeffs, B, n, m, S, part, out, st);
    case 2: return launch_report<__nv_bfloat16, float>(x, y, w, coeffs, B, n, m, S, part, out, st);
    case 3: return launch_report<__nv_bfloat16, double>(x, y, w, coeffs, B, n, m, S, part, out, st);
    case 4: return launch_report<double, float>(x, y, w, coeffs, B, n, m, S, part, out, st);
    case 5: return launch_report<double, double>(x, y, w, coeffs, B, n, m, S, part, out, st);
    default: return cudaErrorInvalidValue;
  }
}

extern "C" const char* repro_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
