// Output helpers shared by the int4 kernels (w4a8_matvec.cu, w4a8_block.cu,
// w4a16.cu): an f32 result stored as f32 or bf16 (one or four at a time),
// and the ordered add of split-K partials.

#pragma once

#include <cuda_bf16.h>
#include <stddef.h>

namespace {

__device__ inline void store(float* p, float v) { *p = v; }
__device__ inline void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

// Four consecutive outputs in one 16-byte (f32) or 8-byte (bf16) store.
__device__ inline void store4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}
__device__ inline void store4(__nv_bfloat16* p, float4 v) {
  const __nv_bfloat162 a = __floats2bfloat162_rn(v.x, v.y);
  const __nv_bfloat162 b = __floats2bfloat162_rn(v.z, v.w);
  *reinterpret_cast<uint2*>(p) = make_uint2(
      *reinterpret_cast<const unsigned*>(&a),
      *reinterpret_cast<const unsigned*>(&b));
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
