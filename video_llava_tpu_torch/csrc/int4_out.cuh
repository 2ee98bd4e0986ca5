// Output helpers shared by the int4 kernels (w4a8_matvec.cu, w4a8_block.cu,
// w4a16.cu): an f32 result stored as f32 or bf16, and the ordered add of
// split-K partials.

#pragma once

#include <cuda_bf16.h>
#include <stddef.h>

namespace {

__device__ inline void store(float* p, float v) { *p = v; }
__device__ inline void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

// out[i] = sum over k of partial[k, i], k in order: deterministic, no
// atomics. partial is (splits, n) f32.
template <typename TOut>
__global__ void add_splits_kernel(const float* __restrict__ partial,
                                  TOut* __restrict__ out, int n, int splits) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float s = 0.f;
  for (int k = 0; k < splits; ++k) s += partial[(size_t)k * n + i];
  store(out + i, s);
}

}  // namespace
