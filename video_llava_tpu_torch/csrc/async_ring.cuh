// Helpers shared by the kernels that stream their operand through a ring of
// cp.async copies (csrc/decode_attention.cu, kernels 3 and 9; csrc/w4a16.cu,
// the W4A16 matvec), and the arrival count with which kernels 3 and 9 merge
// their split partials in the last block to finish.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace ring {

// 16 bytes from global to shared memory, asynchronously, through L2 only.
__device__ inline void cp_async16(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}

// 4 bytes from global to shared memory, asynchronously.
__device__ inline void cp_async4(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}

__device__ inline void commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N of this thread's copy groups are pending: its older
// copies have landed and are visible to it.
template <int N>
__device__ inline void wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Whether this block is the last of `total` blocks to arrive at `counter`.
// Every thread of the block calls it after writing its share of the
// block's partial; the partials of the blocks that arrived before are then
// visible to the last one (read them with __ldcg, past L1). One thread
// fences and counts for the block, after the barrier that orders its
// threads' writes. The last
// block sets the counter back to 0, so a buffer of counters that starts at
// zero serves every later launch in stream order.
__device__ inline bool arrive_last(int* counter, int total) {
  __shared__ int last;
  __syncthreads();  // the block's partial is written
  if (threadIdx.x == 0) {
    __threadfence();  // ... and visible on the device before the count
    last = atomicAdd(counter, 1) == total - 1;
    if (last) {
      *counter = 0;
      __threadfence();  // the others' partials before the block reads them
    }
  }
  __syncthreads();
  return last;
}

}  // namespace ring
