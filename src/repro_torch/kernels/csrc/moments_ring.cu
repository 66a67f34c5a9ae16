// The multi-buffered moment kernels: moments_packed with its loads
// streamed through an nbuf-slot ring in shared memory by cp.async.
// Plain C interface, loaded with ctypes (kernels/build.py).
//
// Replaces the Pallas TPU kernel _packed_moments_db_kernel (reached through
// moments_packed_extended(..., nbuf >= 2) in repro/kernels/moments.py).
// There one grid step per group walks the n-blocks with an in-kernel loop
// over an nbuf-slot VMEM ring: the DMAs of block k+1 are in flight while
// block k's MXU update runs, and the per-block math is the grid-streamed
// kernel's, so the two agree bit for bit.
//
// The Hopper form is moments_packed's own kernels (moments_reg_kernel with
// a warp per task, moments_smem_kernel above degree 14, moments_finalize:
// moments_common.cuh) instantiated with RingLoads in place of DirectLoads,
// so the task layout, the splits and every operation are the same; only
// the loads differ.  Each task walks its point range [lo, hi) in blocks of
// block_n points.  Block k+nbuf-1 is copied global -> shared with cp.async
// (one commit group per block) before block k is consumed, so up to nbuf-1
// blocks are in flight while block k's update runs.  block_n is a multiple
// of 32, so lane l still takes the points lo + l + 32j in increasing j, and
// above degree 14 the 16-point tiles still start at lo + 16j: the output
// equals moments_packed's bits for every block_n and nbuf.
//
// Copies.  A warp (or the CTA, above degree 14) copies each array's block
// as the naturally aligned words that cover it: 4 bytes for float32 and
// bfloat16 (a word holds two bfloat16; the slot keeps the byte offset of
// the block's first point in its word), 8 bytes for float64.  A split
// starts at an arbitrary point, so 16-byte copies or 1-D TMA bulk copies
// (which need 16-byte aligned addresses and sizes) would need a ragged
// head and tail handled apart; that is left to the PR that makes this
// kernel fast.  An aligned word that holds a point of the series lies in
// the series' allocation, so no copy reads outside it.
//
// What bounds it: the same bytes as moments_packed (each input read once),
// so device-memory bandwidth.  What the ring costs: shared memory.  The
// ring holds tasks x nbuf x (2 or 3 arrays) x block_n points; at float32,
// nbuf=2, block_n=1024 that is 128 KiB unweighted and 192 KiB weighted per
// CTA, which leaves one CTA (8 warps) per SM where moments_packed runs up to
// 8.  Fewer warps in flight with deeper prefetch each: the block-size
// tuner (kernels/tune.py) measures which side of that trade wins.  Static
// and dynamic shared memory beyond 48 KB need
// cudaFuncAttributeMaxDynamicSharedMemorySize; a ring beyond the card's
// 227 KB per block is refused and returned as an error.
#include "moments_common.cuh"

namespace {

// cp.async of one naturally aligned word (4 or 8 bytes), global -> shared
template <int W>
__device__ __forceinline__ void cp_async_word(void* smem, const void* gmem) {
  static_assert(W == 4 || W == 8, "cp.async word of 4 or 8 bytes");
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(s),
               "l"(gmem), "n"(W)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Wait until at most `pending` of this thread's newest groups are still in
// flight.  Waiting for more than asked is still correct, so beyond 7 the
// kernel waits down to 7.
__device__ __forceinline__ void cp_async_wait_pending(int pending) {
  switch (pending) {
    case 0: cp_async_wait<0>(); break;
    case 1: cp_async_wait<1>(); break;
    case 2: cp_async_wait<2>(); break;
    case 3: cp_async_wait<3>(); break;
    case 4: cp_async_wait<4>(); break;
    case 5: cp_async_wait<5>(); break;
    case 6: cp_async_wait<6>(); break;
    default: cp_async_wait<7>(); break;
  }
}

// One array's slot in the ring: the aligned words covering block_n points
// plus one word of head room, rounded to 16 bytes.
template <typename T>
struct Slot {
  static constexpr int kWord = sizeof(T) >= 4 ? sizeof(T) : 4;
  __host__ __device__ static constexpr int64_t bytes(int block_n) {
    return (static_cast<int64_t>(block_n) * sizeof(T) + kWord + 15) / 16 * 16;
  }
  // copy the words covering row[gs, ge) into slot; thread tid of nthr
  static __device__ __forceinline__ void issue(char* slot, const T* row,
                                               int64_t gs, int64_t ge,
                                               int tid, int nthr) {
    const uintptr_t a0 = reinterpret_cast<uintptr_t>(row + gs);
    const uintptr_t a1 = reinterpret_cast<uintptr_t>(row + ge);
    const uintptr_t base = a0 & ~static_cast<uintptr_t>(kWord - 1);
    const int64_t words = static_cast<int64_t>((a1 - base + kWord - 1) / kWord);
    for (int64_t v = tid; v < words; v += nthr)
      cp_async_word<kWord>(slot + v * kWord,
                           reinterpret_cast<const char*>(base) + v * kWord);
  }
  // the block's points as laid out in the slot: element i - gs of the block
  static __device__ __forceinline__ const T* view(const char* slot,
                                                  const T* row, int64_t gs) {
    const uintptr_t off = reinterpret_cast<uintptr_t>(row + gs) & (kWord - 1);
    return reinterpret_cast<const T*>(slot + off);
  }
};

template <typename TIn, typename TAcc>
__host__ __device__ constexpr int64_t slot_set_bytes(int block_n,
                                                     bool weighted) {
  return 2 * Slot<TIn>::bytes(block_n) +
         (weighted ? Slot<TAcc>::bytes(block_n) : 0);
}

// RingLoads: the loads policy (moments_common.cuh) of the ring.  Task
// group g of the CTA owns nbuf slot sets of (x, y[, w]) at
// smem + g * nbuf * set_bytes.
template <typename TIn, typename TAcc, int NTHR>
struct RingLoads {
  char* base;
  int64_t set_bytes;
  int nbuf, block_n;
  Task<TIn, TAcc> tk;   // by value: a reference would put it on the stack
  int64_t blocks;

  __device__ __forceinline__ RingLoads(char* smem, int group, LoadArgs la,
                                       const Task<TIn, TAcc>& t)
      : set_bytes(slot_set_bytes<TIn, TAcc>(la.block_n, t.w != nullptr)),
        nbuf(la.nbuf), block_n(la.block_n), tk(t),
        blocks(t.hi > t.lo ? (t.hi - t.lo + la.block_n - 1) / la.block_n
                           : 0) {
    base = smem + group * nbuf * set_bytes;
  }

  __device__ __forceinline__ char* set(int64_t k) const {
    return base + (k % nbuf) * set_bytes;
  }
  __device__ __forceinline__ int64_t start(int64_t k) const {
    return tk.lo + k * block_n;
  }
  __device__ __forceinline__ int64_t stop(int64_t k) const {
    const int64_t e = start(k) + block_n;
    return e < tk.hi ? e : tk.hi;
  }
  // start block k's copies (none past the last block) and close the
  // group: every thread commits one group per call, so the group count
  // stays in step with the block index
  __device__ __forceinline__ void issue(int64_t k, int tid) const {
    if (k < blocks) {
      char* s = set(k);
      const int64_t gs = start(k), ge = stop(k);
      const int64_t sx = Slot<TIn>::bytes(block_n);
      Slot<TIn>::issue(s, tk.x, gs, ge, tid, NTHR);
      Slot<TIn>::issue(s + sx, tk.y, gs, ge, tid, NTHR);
      if (tk.w) Slot<TAcc>::issue(s + 2 * sx, tk.w, gs, ge, tid, NTHR);
    }
    cp_async_commit();
  }
  // blocks 0 .. nbuf-2 in flight before the first is consumed
  __device__ __forceinline__ void begin(int tid) const {
    for (int k = 0; k < nbuf - 1; ++k) issue(k, tid);
  }
  __device__ __forceinline__ void acquire(int64_t k, int tid) const {
    issue(k + nbuf - 1, tid);          // into the slot block k-1 left
    cp_async_wait_pending(nbuf - 1);   // block k has landed ...
    group_sync<NTHR>();                // ... for every thread's words
  }
  __device__ __forceinline__ void release(int64_t) const {
    group_sync<NTHR>();                // slot free before it is refilled
  }
  __device__ __forceinline__ void end() const { cp_async_wait<0>(); }
  __device__ __forceinline__ const TIn* xs(int64_t k) const {
    return Slot<TIn>::view(set(k), tk.x, start(k));
  }
  __device__ __forceinline__ const TIn* ys(int64_t k) const {
    return Slot<TIn>::view(set(k) + Slot<TIn>::bytes(block_n), tk.y,
                           start(k));
  }
  __device__ __forceinline__ const TAcc* ws(int64_t k) const {
    return tk.w ? Slot<TAcc>::view(set(k) + 2 * Slot<TIn>::bytes(block_n),
                                   tk.w, start(k))
                : nullptr;
  }
};

// Dynamic shared memory of one CTA: the rings of its tasks (eight at the
// register path, one above); with the static tile beside it above degree 14
// (ring_cta_bytes).  kernels/tune.py's budget model mirrors ring_cta_bytes
// for planning off the card; a CUDA test holds it to repro_ring_smem_bytes.
template <typename TIn, typename TAcc>
int64_t ring_dynamic_bytes(int m, int block_n, int nbuf, bool weighted) {
  const int tasks_per_cta = m <= kRegMaxDegree ? kWarps : 1;
  return static_cast<int64_t>(tasks_per_cta) * nbuf *
         slot_set_bytes<TIn, TAcc>(block_n, weighted);
}

template <typename TIn, typename TAcc>
int64_t ring_cta_bytes(int m, int block_n, int nbuf, bool weighted) {
  const int64_t tile = m <= kRegMaxDegree ? 0 : sizeof(TileBuf<TAcc>);
  return ring_dynamic_bytes<TIn, TAcc>(m, block_n, nbuf, weighted) + tile;
}

// ---------------------------------------------------------------------------
template <typename TIn, typename TAcc, bool KAHAN>
cudaError_t launch_ring(const void* xv, const void* yv, const void* wv,
                        int64_t B, int64_t n, int m, int S, int block_n,
                        int nbuf, void* phv, void* plv, void* outv,
                        const void* shiftv, const void* scalev,
                        cudaStream_t st) {
  const TIn* x = static_cast<const TIn*>(xv);
  const TIn* y = static_cast<const TIn*>(yv);
  const TAcc* w = static_cast<const TAcc*>(wv);
  const TIn* shift = static_cast<const TIn*>(shiftv);
  const TIn* scale = static_cast<const TIn*>(scalev);
  TAcc* ph = static_cast<TAcc*>(phv);
  TAcc* pl = static_cast<TAcc*>(plv);
  const int64_t smem =
      ring_dynamic_bytes<TIn, TAcc>(m, block_n, nbuf, w != nullptr);
  if (smem > 0x7fffffff) return cudaErrorInvalidValue;
  const LoadArgs la{block_n, nbuf};
  auto run = [&](auto kernel, int tasks_per_cta) -> cudaError_t {
    // always: the 48 KB default bounds static + dynamic together, and the
    // shared-memory path has a static tile beside its ring
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) {
      cudaGetLastError();  // clear it: the next launch's check reads it
      return e;
    }
    kernel<<<blocks_for(B * S, tasks_per_cta), kThreads,
             static_cast<size_t>(smem), st>>>(x, y, w, B, n, m, S, la, ph,
                                              pl, shift, scale);
    return cudaGetLastError();
  };
  cudaError_t err;
  if (m <= 3)
    err = run(moments_reg_kernel<RingLoads, TIn, TAcc, KAHAN, 3, 32>,
              kWarps);
  else if (m <= 7)
    err = run(moments_reg_kernel<RingLoads, TIn, TAcc, KAHAN, 7, 32>,
              kWarps);
  else if (m <= kRegMaxDegree)
    err = run(moments_reg_kernel<RingLoads, TIn, TAcc, KAHAN, kRegMaxDegree,
                                 32>, kWarps);
  else
    err = run(moments_smem_kernel<RingLoads, TIn, TAcc, KAHAN>, 1);
  if (err != cudaSuccess) return err;
  return launch_finalize<TAcc, KAHAN>(ph, pl, B, m, S,
                                      static_cast<TAcc*>(outv), st);
}

template <typename TIn, typename TAcc>
cudaError_t launch_ring_k(int kahan, const void* x, const void* y,
                          const void* w, int64_t B, int64_t n, int m, int S,
                          int block_n, int nbuf, void* ph, void* pl,
                          void* out, const void* shift, const void* scale,
                          cudaStream_t st) {
  return kahan ? launch_ring<TIn, TAcc, true>(x, y, w, B, n, m, S, block_n,
                                              nbuf, ph, pl, out, shift,
                                              scale, st)
               : launch_ring<TIn, TAcc, false>(x, y, w, B, n, m, S, block_n,
                                               nbuf, ph, pl, out, shift,
                                               scale, st);
}

}  // namespace

// The ring form of repro_moments' packed layout (layout 1).  block_n: a
// positive multiple of 32; nbuf >= 2.  in_code 0 float32, 1 bfloat16,
// 2 float64; acc_code 0 float32, 1 float64.  shift, scale: the domain map,
// as repro_moments takes it.  Returns a cudaError_t (0 on success); bad
// arguments (a null shift or scale among them) return
// cudaErrorInvalidValue, a ring beyond the card's shared memory the error
// of cudaFuncSetAttribute.
extern "C" int repro_moments_ring(int in_code, int acc_code, int kahan,
                                  const void* x, const void* y,
                                  const void* w, int64_t B, int64_t n, int m,
                                  int S, int block_n, int nbuf, void* part_hi,
                                  void* part_lo, void* out, void* stream,
                                  const void* shift, const void* scale) {
  if (m < 0 || m > kMaxDegree || S < 1 || block_n < 32 || block_n % 32 ||
      nbuf < 2 || shift == nullptr || scale == nullptr)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (in_code * 2 + acc_code) {
    case 0: return launch_ring_k<float, float>(kahan, x, y, w, B, n, m, S, block_n, nbuf, part_hi, part_lo, out, shift, scale, st);
    case 1: return launch_ring_k<float, double>(kahan, x, y, w, B, n, m, S, block_n, nbuf, part_hi, part_lo, out, shift, scale, st);
    case 2: return launch_ring_k<__nv_bfloat16, float>(kahan, x, y, w, B, n, m, S, block_n, nbuf, part_hi, part_lo, out, shift, scale, st);
    case 3: return launch_ring_k<__nv_bfloat16, double>(kahan, x, y, w, B, n, m, S, block_n, nbuf, part_hi, part_lo, out, shift, scale, st);
    case 4: return launch_ring_k<double, float>(kahan, x, y, w, B, n, m, S, block_n, nbuf, part_hi, part_lo, out, shift, scale, st);
    case 5: return launch_ring_k<double, double>(kahan, x, y, w, B, n, m, S, block_n, nbuf, part_hi, part_lo, out, shift, scale, st);
    default: return cudaErrorInvalidValue;
  }
}

// Shared memory one CTA of repro_moments_ring takes for these arguments
// (dynamic ring + static tile), in bytes; -1 for an unknown code.
extern "C" int64_t repro_ring_smem_bytes(int in_code, int acc_code, int m,
                                         int block_n, int nbuf,
                                         int weighted) {
  const bool wt = weighted != 0;
  switch (in_code * 2 + acc_code) {
    case 0: return ring_cta_bytes<float, float>(m, block_n, nbuf, wt);
    case 1: return ring_cta_bytes<float, double>(m, block_n, nbuf, wt);
    case 2: return ring_cta_bytes<__nv_bfloat16, float>(m, block_n, nbuf, wt);
    case 3: return ring_cta_bytes<__nv_bfloat16, double>(m, block_n, nbuf, wt);
    case 4: return ring_cta_bytes<double, float>(m, block_n, nbuf, wt);
    case 5: return ring_cta_bytes<double, double>(m, block_n, nbuf, wt);
    default: return -1;
  }
}
