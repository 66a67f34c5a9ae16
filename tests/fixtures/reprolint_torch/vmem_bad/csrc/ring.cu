// Known-bad corpus for RL-VMEM's cp.async pass: a ring whose copies are
// committed but never waited on, so the reads race the copies.
namespace {

template <int W>
__device__ __forceinline__ void cp_async_word(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(s),
               "l"(gmem), "n"(W) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <typename T>
struct LeakyRing {
  char* slot;
  __device__ void issue(const T* row, int tid) const {
    cp_async_word<4>(slot + 4 * tid, row + tid);
    cp_async_commit();
  }
  __device__ T read(int tid) const {      // no wait: races the copy
    return reinterpret_cast<const T*>(slot)[tid];
  }
};

}  // namespace

__global__ void leaky_kernel(const float* x, float* out) {
  extern __shared__ char smem[];
  LeakyRing<float> ring{smem};
  ring.issue(x, threadIdx.x);
  out[threadIdx.x] = ring.read(threadIdx.x);
}
