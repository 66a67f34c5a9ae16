// Device code shared by moments.cu and moments_ring.cu: the accumulator,
// the per-point and per-tile updates, the reductions, the cross-split pass
// and the two moment kernels themselves.  A kernel takes its points through
// a loads policy (DirectLoads here: straight from global memory; RingLoads
// in moments_ring.cu: through an nbuf-slot cp.async ring in shared memory).
// The policy decides only where a block of points is read from; the task
// layout, the order in which each thread takes its points and every
// arithmetic operation are the kernel's, so the two forms give the same
// bits for the same (series, split) tasks.
//
// Every kernel maps x as it loads it: the affine domain map t = (x - shift)
// * scale (core/basis.py Domain.apply) applied to each x value before the
// conversion to the accumulation type, so the mapped x is never written to
// device memory.  A caller with no domain hands the identity's 0 and 1,
// under which the map gives x's own bits.  The map lives in the kernel
// bodies, not in a loads policy, so both policies give it the same bits.
//
// The arithmetic is pinned in the source, not left to the compiler: each
// product that feeds a sum is an explicit fused multiply-add (fma_rn), and
// each product that does not is an explicit rounded multiply (mul_rn),
// which nvcc never contracts.  A plain `+` then only ever adds two values
// that are already rounded, so nvcc's FMA contraction has nothing to choose.
#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxDegree = 126;          // degree + 2 <= 128
constexpr int kRegMaxDegree = 14;        // above: the shared-memory kernel
constexpr int kMaxPow = 2 * kMaxDegree + 1;
constexpr int kTile = 16;                // points staged per shared-memory tile
constexpr int kInFlight = 4;             // points loaded per step, register path

template <typename TAcc, typename TIn>
__device__ __forceinline__ TAcc cvt(TIn v) { return static_cast<TAcc>(v); }
template <>
__device__ __forceinline__ float cvt<float, __nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <>
__device__ __forceinline__ double cvt<double, __nv_bfloat16>(__nv_bfloat16 v) {
  return static_cast<double>(__bfloat162float(v));
}

// a * b + c rounded once, and a * b rounded on its own (never contracted)
__device__ __forceinline__ float fma_rn(float a, float b, float c) {
  return __fmaf_rn(a, b, c);
}
__device__ __forceinline__ double fma_rn(double a, double b, double c) {
  return __fma_rn(a, b, c);
}
__device__ __forceinline__ float mul_rn(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ double mul_rn(double a, double b) {
  return __dmul_rn(a, b);
}

// (v - s) * k rounded in v's type after each step: the bits of PyTorch's
// two CUDA ops, torch.sub(x, shift).mul_(scale).  bfloat16: each step in
// float, rounded to bfloat16, as PyTorch computes a bfloat16 sub and mul.
__device__ __forceinline__ float map_rn(float v, float s, float k) {
  return __fmul_rn(__fsub_rn(v, s), k);
}
__device__ __forceinline__ double map_rn(double v, double s, double k) {
  return __dmul_rn(__dsub_rn(v, s), k);
}
__device__ __forceinline__ __nv_bfloat16 map_rn(__nv_bfloat16 v,
                                                __nv_bfloat16 s,
                                                __nv_bfloat16 k) {
  const __nv_bfloat16 d = __float2bfloat16_rn(
      __fsub_rn(__bfloat162float(v), __bfloat162float(s)));
  return __float2bfloat16_rn(__fmul_rn(__bfloat162float(d),
                                       __bfloat162float(k)));
}

// The domain map of a launch, read once per thread before its loop (from
// device memory: no host read drains the queue).  (v - 0) * 1 is v in
// every input type, so the identity's launch has the bits of x unmapped.
template <typename TIn>
struct XMap {
  TIn s, k;
  __device__ __forceinline__ XMap(const TIn* shift, const TIn* scale)
      : s(*shift), k(*scale) {}
  __device__ __forceinline__ TIn operator()(TIn v) const {
    return map_rn(v, s, k);
  }
};

// One accumulator; with KAHAN the value is hi + lo.
template <typename T, bool KAHAN>
struct Acc {
  T hi, lo;
  __device__ __forceinline__ void zero() { hi = T(0); lo = T(0); }
  __device__ __forceinline__ void add(T v) {
    if constexpr (KAHAN) {
      T y = v + lo;
      T t = hi + y;
      lo = y - (t - hi);
      hi = t;
    } else {
      hi += v;
    }
  }
  // add a * b, with the product fused into the first addition
  __device__ __forceinline__ void add_prod(T a, T b) {
    if constexpr (KAHAN) {
      T y = fma_rn(a, b, lo);
      T t = hi + y;
      lo = y - (t - hi);
      hi = t;
    } else {
      hi = fma_rn(a, b, hi);
    }
  }
  // add another (hi, lo) pair: two-sum of the high parts, then renormalize
  __device__ __forceinline__ void merge(T h, T l) {
    if constexpr (KAHAN) {
      T s = hi + h;
      T bb = s - hi;
      T err = (hi - (s - bb)) + (h - bb);
      T low = lo + l + err;
      hi = s + low;
      lo = low - (hi - s);
    } else {
      hi += h;
    }
  }
  __device__ __forceinline__ T value() const {
    if constexpr (KAHAN) { return hi + lo; } else { return hi; }
  }
};

template <typename T, bool KAHAN>
__device__ __forceinline__ void warp_reduce(Acc<T, KAHAN>& a) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    T h = __shfl_down_sync(0xffffffffu, a.hi, off);
    T l = T(0);
    if constexpr (KAHAN) l = __shfl_down_sync(0xffffffffu, a.lo, off);
    a.merge(h, l);
  }
}

// partial-sum slot of the register layout -> slot of the output layout
__device__ __forceinline__ int out_slot(int k, int maxd, int m) {
  if (k <= 2 * maxd) return k;                       // S_k
  if (k <= 3 * maxd + 1) return 2 * m + 1 + (k - 2 * maxd - 1);  // T_k
  return 3 * m + 2;                                  // U
}

__device__ __forceinline__ bool slot_live(int k, int maxd, int m) {
  if (k <= 2 * maxd) return k <= 2 * m;
  if (k <= 3 * maxd + 1) return (k - 2 * maxd - 1) <= m;
  return true;
}

// The (series, n-split) task of a kernel: its series' rows and its point
// range [lo, hi).
template <typename TIn, typename TAcc>
struct Task {
  const TIn* x;
  const TIn* y;
  const TAcc* w;
  int64_t lo, hi;
  __device__ __forceinline__ Task(const TIn* xg, const TIn* yg,
                                  const TAcc* wg, int64_t task, int64_t n,
                                  int S) {
    const int64_t b = task / S;
    const int64_t s = task % S;
    const int64_t chunk = (n + S - 1) / S;
    lo = s * chunk;
    hi = lo + chunk < n ? lo + chunk : n;
    x = xg + b * n;
    y = yg + b * n;
    w = wg ? wg + b * n : nullptr;
  }
};

// The ring's shape (unused by DirectLoads).
struct LoadArgs {
  int block_n, nbuf;
};

// barrier over the NTHR threads of one task: a warp or the whole CTA
template <int NTHR>
__device__ __forceinline__ void group_sync() {
  if constexpr (NTHR == 32) __syncwarp(); else __syncthreads();
}

// A loads policy hands a kernel its task's points in blocks:
//   blocks              the number of blocks of [lo, hi)
//   begin(tid)          before the first block
//   acquire(k, tid)     block k readable by the task's NTHR threads
//   start(k), stop(k)   its point range; xs/ys/ws(k) its points, element
//                       i - start(k) holding point i (ws nullptr: unweighted)
//   release(k)          every thread of the task is done with block k
//   end()               no copy left in flight
// DirectLoads: one block, the whole range, read from global memory.
template <typename TIn, typename TAcc, int NTHR>
struct DirectLoads {
  Task<TIn, TAcc> tk;
  int64_t blocks;
  __device__ __forceinline__ DirectLoads(char*, int, LoadArgs,
                                         const Task<TIn, TAcc>& t)
      : tk(t), blocks(t.hi > t.lo ? 1 : 0) {}
  __device__ __forceinline__ void begin(int) const {}
  __device__ __forceinline__ void acquire(int64_t, int) const {}
  __device__ __forceinline__ void release(int64_t) const {}
  __device__ __forceinline__ void end() const {}
  __device__ __forceinline__ int64_t start(int64_t) const { return tk.lo; }
  __device__ __forceinline__ int64_t stop(int64_t) const { return tk.hi; }
  __device__ __forceinline__ const TIn* xs(int64_t) const { return tk.x + tk.lo; }
  __device__ __forceinline__ const TIn* ys(int64_t) const { return tk.y + tk.lo; }
  __device__ __forceinline__ const TAcc* ws(int64_t) const {
    return tk.w ? tk.w + tk.lo : nullptr;
  }
};

// Register path, one point: S_k += w x^k (k <= 2m), T_k += w x^k y
// (k <= m), U += w y^2.  NS = 3*MAXD + 3 accumulators.  p runs up the
// rounded powers w x^(k-1); S_k takes p * x fused into its sum, so no sum
// waits for the next rounded power, and T_k takes that power times y.
template <typename TAcc, bool KAHAN, int MAXD>
__device__ __forceinline__ void point_update(Acc<TAcc, KAHAN>* a, TAcc xv,
                                             TAcc yv, TAcc wv, int m) {
  constexpr int NS = 3 * MAXD + 3;
  constexpr int T0 = 2 * MAXD + 1;
  TAcc p = wv;
  a[0].add(p);
  a[T0].add_prod(p, yv);
#pragma unroll
  for (int k = 1; k <= 2 * MAXD; ++k) {
    if (k <= 2 * m) {
      a[k].add_prod(p, xv);
      p = mul_rn(p, xv);
      if (k <= MAXD && k <= m) a[T0 + k].add_prod(p, yv);
    }
  }
  a[NS - 1].add_prod(mul_rn(wv, yv), yv);
}

// Shared-memory path (any degree up to 126), one CTA per task.  Sixteen
// threads write the weighted power ladder of one point each
// (stage_point); after a barrier, thread t adds the tile's share of sums
// t and t + 256 of the 3m+3 (accumulate_tile).
template <typename TAcc>
struct TileBuf {
  TAcc pw[kTile][kMaxPow + 1];
  TAcc yt[kTile];
};

template <typename TAcc>
__device__ __forceinline__ void stage_point(TileBuf<TAcc>& buf, int t,
                                            TAcc xv, TAcc yv, TAcc p,
                                            int npow) {
  for (int k = 0; k < npow; ++k) {
    buf.pw[t][k] = p;
    p = mul_rn(p, xv);
  }
  buf.yt[t] = yv;
}

template <typename TAcc, bool KAHAN>
__device__ __forceinline__ void accumulate_tile(
    const TileBuf<TAcc>& buf, Acc<TAcc, KAHAN>* a, int m) {
  const int npow = 2 * m + 1;
  const int nsum = 3 * m + 3;
#pragma unroll
  for (int q = 0; q < 2; ++q) {
    const int slot = threadIdx.x + q * kThreads;
    TAcc v = TAcc(0);
    if (slot < npow) {
      for (int u = 0; u < kTile; ++u) v += buf.pw[u][slot];
    } else if (slot < npow + m + 1) {
      const int k = slot - npow;
      for (int u = 0; u < kTile; ++u) v = fma_rn(buf.pw[u][k], buf.yt[u], v);
    } else if (slot < nsum) {
      for (int u = 0; u < kTile; ++u)
        v = fma_rn(mul_rn(buf.pw[u][0], buf.yt[u]), buf.yt[u], v);
    }
    a[q].add(v);
  }
}

// ---------------------------------------------------------------------------
// Register path: degree m <= MAXD, G threads per task (256: one CTA per
// task; 32: one warp per task, eight tasks per CTA).  Thread `lane` takes
// the points lo + lane + G j in increasing j, whatever the blocks (a block
// holds a multiple of G points).
template <template <typename, typename, int> class Loads, typename TIn,
          typename TAcc, bool KAHAN, int MAXD, int G>
__global__ void __launch_bounds__(kThreads)
moments_reg_kernel(const TIn* __restrict__ x, const TIn* __restrict__ y,
                   const TAcc* __restrict__ w, int64_t B, int64_t n, int m,
                   int S, LoadArgs la, TAcc* __restrict__ part_hi,
                   TAcc* __restrict__ part_lo,
                   const TIn* __restrict__ shift,
                   const TIn* __restrict__ scale) {
  extern __shared__ __align__(16) char load_smem[];
  constexpr int NS = 3 * MAXD + 3;
  const int lane = threadIdx.x % G;
  const int group = threadIdx.x / G;
  const int64_t task = static_cast<int64_t>(blockIdx.x) * (kThreads / G) +
                       group;
  if (task >= B * S) return;  // whole group leaves together (G == 32 only)
  const Task<TIn, TAcc> tk(x, y, w, task, n, S);
  const Loads<TIn, TAcc, G> ld(load_smem, group, la, tk);
  const XMap<TIn> xm(shift, scale);

  Acc<TAcc, KAHAN> a[NS];
#pragma unroll
  for (int k = 0; k < NS; ++k) a[k].zero();

  ld.begin(lane);
  for (int64_t k = 0; k < ld.blocks; ++k) {
    ld.acquire(k, lane);
    const TIn* xs = ld.xs(k);
    const TIn* ys = ld.ys(k);
    const TAcc* ws = ld.ws(k);
    const int64_t len = ld.stop(k) - ld.start(k);
    // kInFlight points per step, all loaded before any is added: each
    // thread keeps that many points' loads in flight (left to itself, nvcc
    // may sink the later points' loads below the first one's update); the
    // sums still take the points one by one, in order
    int64_t j = lane;
    for (; j + (kInFlight - 1) * G < len; j += kInFlight * G) {
      TAcc xv[kInFlight], yv[kInFlight], wv[kInFlight];
#pragma unroll
      for (int u = 0; u < kInFlight; ++u) {
        xv[u] = cvt<TAcc>(xm(xs[j + u * G]));
        yv[u] = cvt<TAcc>(ys[j + u * G]);
        wv[u] = ws ? ws[j + u * G] : TAcc(1);
      }
#pragma unroll
      for (int u = 0; u < kInFlight; ++u)
        point_update<TAcc, KAHAN, MAXD>(a, xv[u], yv[u], wv[u], m);
    }
    for (; j < len; j += G)
      point_update<TAcc, KAHAN, MAXD>(a, cvt<TAcc>(xm(xs[j])),
                                      cvt<TAcc>(ys[j]),
                                      ws ? ws[j] : TAcc(1), m);
    ld.release(k);
  }
  ld.end();

  const int nsum = 3 * m + 3;
  TAcc* oh = part_hi + task * nsum;
  TAcc* ol = KAHAN ? part_lo + task * nsum : nullptr;
  if constexpr (G == 32) {
#pragma unroll
    for (int k = 0; k < NS; ++k) {
      warp_reduce(a[k]);
      if (lane == 0 && slot_live(k, MAXD, m)) {
        oh[out_slot(k, MAXD, m)] = a[k].hi;
        if (KAHAN) ol[out_slot(k, MAXD, m)] = a[k].lo;
      }
    }
  } else {
    __shared__ TAcc sh_hi[kWarps][NS];
    __shared__ TAcc sh_lo[kWarps][NS];
    const int warp = threadIdx.x / 32;
#pragma unroll
    for (int k = 0; k < NS; ++k) {
      warp_reduce(a[k]);
      if (threadIdx.x % 32 == 0) {
        sh_hi[warp][k] = a[k].hi;
        sh_lo[warp][k] = a[k].lo;
      }
    }
    __syncthreads();
    for (int k = threadIdx.x; k < NS; k += kThreads) {
      if (!slot_live(k, MAXD, m)) continue;
      Acc<TAcc, KAHAN> t;
      t.zero();
      for (int v = 0; v < kWarps; ++v) t.merge(sh_hi[v][k], sh_lo[v][k]);
      oh[out_slot(k, MAXD, m)] = t.hi;
      if (KAHAN) ol[out_slot(k, MAXD, m)] = t.lo;
    }
  }
}

// ---------------------------------------------------------------------------
// Shared-memory path for any degree up to 126: one CTA per task.  Sixteen
// threads build the weighted power ladder of a tile of points into shared
// memory; thread t then owns sums t and t + 256 of the 3m+3.  The tiles
// start at lo + 16 j whatever the blocks (block_n is a multiple of 16).  A
// tile's points past the range stay 0, unmapped, with weight 0.
template <template <typename, typename, int> class Loads, typename TIn,
          typename TAcc, bool KAHAN>
__global__ void __launch_bounds__(kThreads)
moments_smem_kernel(const TIn* __restrict__ x, const TIn* __restrict__ y,
                    const TAcc* __restrict__ w, int64_t B, int64_t n, int m,
                    int S, LoadArgs la, TAcc* __restrict__ part_hi,
                    TAcc* __restrict__ part_lo,
                    const TIn* __restrict__ shift,
                    const TIn* __restrict__ scale) {
  extern __shared__ __align__(16) char load_smem[];
  __shared__ TileBuf<TAcc> buf;
  const int64_t task = blockIdx.x;
  const Task<TIn, TAcc> tk(x, y, w, task, n, S);
  const Loads<TIn, TAcc, kThreads> ld(load_smem, 0, la, tk);
  const XMap<TIn> xm(shift, scale);
  const int npow = 2 * m + 1;
  const int t = threadIdx.x;

  Acc<TAcc, KAHAN> a[2];
  a[0].zero();
  a[1].zero();
  ld.begin(t);
  for (int64_t k = 0; k < ld.blocks; ++k) {
    ld.acquire(k, t);
    const TIn* xs = ld.xs(k);
    const TIn* ys = ld.ys(k);
    const TAcc* ws = ld.ws(k);
    const int64_t len = ld.stop(k) - ld.start(k);
    for (int64_t base = 0; base < len; base += kTile) {
      if (t < kTile) {
        const int64_t j = base + t;
        const bool in = j < len;
        stage_point(buf, t, in ? cvt<TAcc>(xm(xs[j])) : TAcc(0),
                    in ? cvt<TAcc>(ys[j]) : TAcc(0),
                    in ? (ws ? ws[j] : TAcc(1)) : TAcc(0), npow);
      }
      __syncthreads();
      accumulate_tile(buf, a, m);
      __syncthreads();
    }
    ld.release(k);
  }
  ld.end();

  const int nsum = 3 * m + 3;
#pragma unroll
  for (int q = 0; q < 2; ++q) {
    const int slot = t + q * kThreads;
    if (slot < nsum) {
      part_hi[task * nsum + slot] = a[q].hi;
      if (KAHAN) part_lo[task * nsum + slot] = a[q].lo;
    }
  }
}

// Sum the partials over the S splits in order and assemble the K x K Gram.
template <typename TAcc, bool KAHAN>
__global__ void moments_finalize(const TAcc* __restrict__ part_hi,
                                 const TAcc* __restrict__ part_lo, int64_t B,
                                 int m, int S, TAcc* __restrict__ out) {
  const int K = m + 2;
  const int64_t idx = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (idx >= B * K * K) return;
  const int64_t b = idx / (K * K);
  const int r = static_cast<int>(idx % (K * K));
  const int j = r / K, k = r % K;
  int slot;
  if (j <= m && k <= m) slot = j + k;
  else if (j == m + 1 && k == m + 1) slot = 3 * m + 2;
  else slot = 2 * m + 1 + (j == m + 1 ? k : j);
  const int nsum = 3 * m + 3;
  Acc<TAcc, KAHAN> a;
  a.zero();
  for (int s = 0; s < S; ++s) {
    const int64_t at = (b * S + s) * nsum + slot;
    a.merge(part_hi[at], KAHAN ? part_lo[at] : TAcc(0));
  }
  out[idx] = a.value();
}

inline unsigned int blocks_for(int64_t items, int per_block) {
  return static_cast<unsigned int>((items + per_block - 1) / per_block);
}

template <typename TAcc, bool KAHAN>
cudaError_t launch_finalize(const TAcc* ph, const TAcc* pl, int64_t B, int m,
                            int S, TAcc* out, cudaStream_t st) {
  const int K = m + 2;
  moments_finalize<TAcc, KAHAN><<<blocks_for(B * K * K, kThreads), kThreads,
                                  0, st>>>(ph, pl, B, m, S, out);
  return cudaGetLastError();
}

}  // namespace
