// Fused spatio-temporal pooling of per-frame CLIP patch features.
//
// Replaces video_llava_tpu/ops/pooling.py::spatio_temporal_pool_pallas
// (via _pool_call, Pallas body _pool_kernel). From x (t, s, c), in one read:
//     out[f, :]     = mean_s x[f, s, :]   for f < min(t, n), else 0,
//                     for f < T (T = max_temporal_tokens, rows zero-padded)
//     out[T + j, :] = sum_{f < n} x[f, j, :] / max(n, 1)
// with f32 sums and the result written in the output dtype.
//
// What bounds it on Hopper: pure device-memory bandwidth (one read of x,
// (100, 256, 1024) bf16 = 52 MB on the chat path; no matrix work). The TPU
// kernel carried the temporal sum across its sequential s-grid axis in
// VMEM. Hopper blocks run in no order, so each block (a run of kRows
// patches x kThreads channels) writes its per-frame partial sums to a small
// f32 scratch (nsb, t, c), and a second kernel adds the nsb partials in a
// fixed order: deterministic, no atomics. One thread owns one channel, so
// any s and c work (no divisibility fallback as on the TPU). Few patches
// per block keep enough loads in flight ((100, 256, 1024): 512 blocks of
// 128 threads) at the price of a (s/4, t, c) f32 scratch, a quarter of
// the input's bytes written and read once more.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRows = 4;       // patches per block
constexpr int kThreads = 128;  // channels per block

__device__ inline void from_f32(float* p, float x) { *p = x; }
__device__ inline void from_f32(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

template <typename TOut>
__global__ void __launch_bounds__(kThreads)
pool_spatial_kernel(const __nv_bfloat16* __restrict__ x, TOut* __restrict__ out,
                    float* __restrict__ partial, int t, int s, int c,
                    int T, int n) {
  const int ch = blockIdx.x * kThreads + threadIdx.x;
  const int sb = blockIdx.y;
  const int s0 = sb * kRows;
  if (ch >= c) return;
  float sp[kRows];
#pragma unroll
  for (int i = 0; i < kRows; ++i) sp[i] = 0.f;
  for (int f = 0; f < t; ++f) {
    const __nv_bfloat16* xf = x + ((size_t)f * s + s0) * c + ch;
    const bool valid = f < n;
    float row = 0.f;
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      if (s0 + i < s) {
        const float val = __bfloat162float(xf[(size_t)i * c]);
        row += val;
        if (valid) sp[i] += val;
      }
    }
    partial[((size_t)sb * t + f) * c + ch] = row;
  }
  const float inv = 1.f / fmaxf((float)n, 1.f);
#pragma unroll
  for (int i = 0; i < kRows; ++i)
    if (s0 + i < s) from_f32(out + (size_t)(T + s0 + i) * c + ch, sp[i] * inv);
}

template <typename TOut>
__global__ void pool_temporal_kernel(const float* __restrict__ partial,
                                     TOut* __restrict__ out, int t, int s,
                                     int c, int n, int nsb) {
  const int ch = blockIdx.x * blockDim.x + threadIdx.x;
  const int f = blockIdx.y;  // 0 .. T-1
  if (ch >= c) return;
  float acc = 0.f;
  if (f < t && f < n) {
    for (int sb = 0; sb < nsb; ++sb) acc += partial[((size_t)sb * t + f) * c + ch];
    acc /= (float)s;
  }
  from_f32(out + (size_t)f * c + ch, acc);
}

template <typename TOut>
int launch(const void* x, void* out, void* partial, int t, int s, int c,
           int T, int n, cudaStream_t stream) {
  const int nsb = (s + kRows - 1) / kRows;
  dim3 g1((c + kThreads - 1) / kThreads, nsb);
  pool_spatial_kernel<TOut><<<g1, kThreads, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<TOut*>(out),
      static_cast<float*>(partial), t, s, c, T, n);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  dim3 g2((c + 255) / 256, T);
  pool_temporal_kernel<TOut><<<g2, 256, 0, stream>>>(
      static_cast<const float*>(partial), static_cast<TOut*>(out), t, s, c,
      n, nsb);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int vlt_pool_rows_per_block() { return kRows; }

// x: (t, s, c) bf16. out_bf16: 1 for a bf16 output, 0 for f32.
// partial: (ceil(s / vlt_pool_rows_per_block()), t, c) f32.
extern "C" int vlt_spatio_temporal_pool(const void* x, void* out,
                                        void* partial, int t, int s, int c,
                                        int T, int n, int out_bf16,
                                        void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (out_bf16)
    return launch<__nv_bfloat16>(x, out, partial, t, s, c, T, n, st);
  return launch<float>(x, out, partial, t, s, c, T, n, st);
}
