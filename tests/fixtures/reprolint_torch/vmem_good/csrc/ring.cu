// Known-good corpus for RL-VMEM's cp.async pass: the ring commits each
// group of copies and waits for it before the slot is read.
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

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// the words of one slot; the ring that uses it commits and waits
template <typename T>
struct Slot {
  static __device__ void issue(char* slot, const T* row, int tid) {
    cp_async_word<4>(slot + 4 * tid, row + tid);
  }
};

template <typename T>
struct Ring {
  char* slot;
  __device__ void issue(const T* row, int tid) const {
    Slot<T>::issue(slot, row, tid);
    cp_async_commit();
  }
  __device__ T read(int tid) const {
    cp_async_wait<0>();
    __syncthreads();
    return reinterpret_cast<const T*>(slot)[tid];
  }
};

}  // namespace

__global__ void ring_kernel(const float* x, float* out) {
  extern __shared__ char smem[];
  Ring<float> ring{smem};
  ring.issue(x, threadIdx.x);
  out[threadIdx.x] = ring.read(threadIdx.x);
}
