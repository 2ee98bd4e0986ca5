// Fused spatio-temporal pooling of per-frame CLIP patch features.
//
// Replaces video_llava_tpu/ops/pooling.py::spatio_temporal_pool_pallas
// (via _pool_call, Pallas body _pool_kernel), and the same kernel under the
// JAX package's vmap over a batch of videos (its scalar-prefetched valid
// count batched, ops/pooling.py:58-64): x (B, t, s, c) with a valid count
// n_b a video, every video in one launch, the videos along grid z, each
// block reading its video's count from device memory (or one host count
// for all). For each video, from x_b (t, s, c), in one read:
//     out[f, :]     = mean_s x[f, s, :]   for f < min(t, n), else 0,
//                     for f < T (T = max_temporal_tokens, rows zero-padded)
//     out[T + j, :] = sum_{f < n} x[f, j, :] / max(m, 1)
// with f32 sums and the result written in the output dtype. The divisor m
// is the video's own count n, or one host value for every video: the
// JAX kernel's pair [n_mask, n_denom] (ops/pooling.py:93-101), which
// differ under its frame-sharded wrapper, where each 'data' rank pools its
// own frames (n its valid ones) and divides its spatial partial by the
// global count before the ranks add them.
//
// What bounds it on Hopper: device-memory bandwidth (one read of x,
// (100, 256, 1024) bf16 = 52 MB on the chat path; a few adds a byte). So
// the design is about bytes in flight and bytes not moved. The TPU kernel
// carried the temporal sum across its sequential s-grid axis in VMEM;
// Hopper blocks run in no order.
//
// A lane loads 16 bytes, 8 channels, neighbouring lanes on neighbouring
// addresses (a patch row of a block is kLanes * 16 = 128 contiguous bytes).
// A block of kLanes x kRun threads covers kChannels channels and a run of
// kRun patches, one a thread row. It walks the frames below min(n, t)
// (frames at or past n are never read: their temporal rows are 0 and they
// add nothing to the spatial sums), each thread keeping kDepth frames of
// its 16 bytes in flight with cp.async into a ring of shared-memory stages
// (a stage is refilled as soon as its frame is consumed; a thread reads
// only what it copied, so the ring needs no barrier), and its patch's 8
// spatial sums in registers. A ring of registers held the same loads but
// kept about one in flight a thread (ptxas tracks them on a handful of
// dependency barriers): 1 TB/s, depth 8 or 16 alike; through shared
// memory, depths 8, 16 and 24 measured within 4% of each other. Each
// group of kGroup frames goes through shared memory, where the block sums
// it over its kRun patch rows into a temporal partial (run, frame,
// channel) in f32: 2 / kRun = 1/16 of x's bytes reach device memory. A
// second, small kernel adds each (frame, channel)'s partials in run order
// and writes the temporal rows, spread over the whole card (the last
// block of each channel slice doing it alone left one SM's worth of L2
// round trips as the tail). Every sum runs in a fixed order and no value
// goes through an atomic, so the result has the same bits on every run.
// c % 8 == 0 takes the 16-byte copies; any other c loads 8 masked scalars
// a lane where the copy would be, so any s and c work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kLanes = 8;                  // lanes across a patch row
constexpr int kChannels = kLanes * 8;      // channels a block
constexpr int kRun = 32;                   // patches a block, one a row
constexpr int kThreads = kLanes * kRun;    // 256
constexpr int kDepth = 8;                  // frames in flight a thread
constexpr int kGroup = 4;                  // frames a temporal reduction
static_assert(kGroup * kChannels == kThreads, "one reduced value a thread");
// dynamic shared memory: the ring, then a group's rows (64 KB)
constexpr size_t kRingBytes = (size_t)kDepth * kThreads * sizeof(uint4);
constexpr size_t kSmemBytes =
    kRingBytes + (size_t)kGroup * kRun * kChannels * sizeof(float);

__device__ inline void cp_async16(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}
__device__ inline void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// Wait until at most kDepth - 1 of the thread's copy groups are pending.
__device__ inline void cp_async_wait_oldest() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kDepth - 1) : "memory");
}

__device__ inline void from_f32(float* p, float x) { *p = x; }
__device__ inline void from_f32(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// Channels ch .. ch + 7 of one patch row when c % 8 != 0 (rows not 16-byte
// aligned): 8 scalar loads, the channels at or past c read as 0.
__device__ inline uint4 load8_masked(const __nv_bfloat16* row, int ch,
                                     int c) {
  const unsigned short* src = reinterpret_cast<const unsigned short*>(row);
  uint32_t w[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const uint32_t lo = ch + 2 * j < c ? src[ch + 2 * j] : 0u;
    const uint32_t hi = ch + 2 * j + 1 < c ? src[ch + 2 * j + 1] : 0u;
    w[j] = lo | (hi << 16);
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

__device__ inline void unpack8(const uint4& raw, float (&f)[8]) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float2 x = __bfloat1622float2(h[j]);
    f[2 * j] = x.x;
    f[2 * j + 1] = x.y;
  }
}

// out[ch .. ch + 7] = v: one 16-byte store (bf16) or two (f32) when c % 8
// == 0, else the channels below c one by one.
template <bool kVec>
__device__ inline void store8(__nv_bfloat16* out, const float (&v)[8], int ch,
                              int c) {
  if constexpr (kVec) {
    uint4 raw;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      h[j] = __floats2bfloat162_rn(v[2 * j], v[2 * j + 1]);
    *reinterpret_cast<uint4*>(out + ch) = raw;
  } else {
#pragma unroll
    for (int e = 0; e < 8; ++e)
      if (ch + e < c) out[ch + e] = __float2bfloat16(v[e]);
  }
}

template <bool kVec>
__device__ inline void store8(float* out, const float (&v)[8], int ch, int c) {
  if constexpr (kVec) {
    float4* o = reinterpret_cast<float4*>(out + ch);
    o[0] = make_float4(v[0], v[1], v[2], v[3]);
    o[1] = make_float4(v[4], v[5], v[6], v[7]);
  } else {
#pragma unroll
    for (int e = 0; e < 8; ++e)
      if (ch + e < c) out[ch + e] = v[e];
  }
}

template <typename TOut, bool kVec>
__global__ void __launch_bounds__(kThreads)
pool_kernel(const __nv_bfloat16* __restrict__ x, TOut* __restrict__ out,
            float* __restrict__ partial, const int* __restrict__ nvalid,
            int t, int s, int c, int T, int n, int denom) {
  extern __shared__ uint4 smem[];
  uint4* ring = smem;  // (kDepth, kThreads): stage f % kDepth holds frame f
  auto tp = reinterpret_cast<float (*)[kRun][kChannels]>(
      reinterpret_cast<char*>(smem) + kRingBytes);  // (kGroup, kRun, kChannels)
  const int lane = threadIdx.x % kLanes, row = threadIdx.x / kLanes;
  // video blockIdx.z: its count, and its slices of x, out and partial
  const int vid = blockIdx.z;
  if (nvalid != nullptr) n = nvalid[vid];
  if (denom < 0) denom = n;
  x += (size_t)vid * t * s * c;
  out += (size_t)vid * (T + s) * c;
  partial += (size_t)vid * gridDim.y * t * c;
  const int c0 = blockIdx.x * kChannels;
  const int ch = c0 + lane * 8;
  const int run = blockIdx.y;
  const int p = run * kRun + row;
  const bool live = p < s && ch < c;
  const int nv = min(n, t);  // the frames read: the valid ones
  const size_t fstride = (size_t)s * c;
  const __nv_bfloat16* src = x + (size_t)min(p, s - 1) * c;

  // Frame f's copy into its stage, one commit group a frame (empty where
  // there is nothing to copy), so every thread counts the same groups.
  auto fetch = [&](int f) {
    if (kVec && live && f < nv)
      cp_async16(&ring[(f % kDepth) * kThreads + threadIdx.x],
                 src + (size_t)f * fstride + ch);
    cp_async_commit();
  };
  float sp[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) sp[e] = 0.f;
  for (int f = 0; f < kDepth; ++f) fetch(f);

  // The loop runs the same frames in every thread, so its barriers are
  // reached by all.
  for (int f0 = 0; f0 < nv; f0 += kGroup) {
#pragma unroll
    for (int u = 0; u < kGroup; ++u) {
      const int f = f0 + u;
      float v[8];
      cp_async_wait_oldest();  // frame f has landed
      if (live && f < nv) {
        const uint4 raw = kVec ? ring[(f % kDepth) * kThreads + threadIdx.x]
                               : load8_masked(src + (size_t)f * fstride, ch, c);
        unpack8(raw, v);
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e) v[e] = 0.f;
      }
      fetch(f + kDepth);  // into the stage just read
#pragma unroll
      for (int e = 0; e < 8; ++e) sp[e] += v[e];
      float4* dst = reinterpret_cast<float4*>(&tp[u][row][lane * 8]);
      dst[0] = make_float4(v[0], v[1], v[2], v[3]);
      dst[1] = make_float4(v[4], v[5], v[6], v[7]);
      if (u == kGroup - 1) {
        __syncthreads();
        // thread -> (frame g of the group, channel j of the slice): the
        // sum over the block's patch rows, four interleaved sums added in
        // a fixed order
        const int g = threadIdx.x / kChannels, j = threadIdx.x % kChannels;
        float a[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int r = 0; r < kRun; ++r) a[r % 4] += tp[g][r][j];
        const int fg = f0 + g;
        if (fg < nv && c0 + j < c)
          partial[((size_t)run * t + fg) * c + c0 + j] =
              (a[0] + a[1]) + (a[2] + a[3]);
        __syncthreads();  // tp is read before the next group writes it
      }
    }
  }

  if (live) {
    const float inv = 1.f / fmaxf((float)denom, 1.f);
    float v[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) v[e] = sp[e] * inv;
    store8<kVec>(out + (size_t)(T + p) * c, v, ch, c);
  }
}

// out[f, ch] = (sum over runs, in order, of partial[run, f, ch]) / s for f
// < min(n, t), 0 up to T: one thread a (frame, channel).
constexpr int kCombineThreads = 256;

template <typename TOut>
__global__ void __launch_bounds__(kCombineThreads)
pool_temporal_kernel(const float* __restrict__ partial, TOut* __restrict__ out,
                     const int* __restrict__ nvalid, int t, int s, int c,
                     int T, int n, int runs) {
  const int ch = blockIdx.x * kCombineThreads + threadIdx.x;
  const int f = blockIdx.y;
  const int vid = blockIdx.z;
  if (ch >= c) return;
  if (nvalid != nullptr) n = nvalid[vid];
  partial += (size_t)vid * runs * t * c;
  out += (size_t)vid * (T + s) * c;
  float acc = 0.f;
  if (f < min(n, t)) {
    const float* pr = partial + (size_t)f * c + ch;
#pragma unroll 8
    for (int r = 0; r < runs; ++r) acc += pr[(size_t)r * t * c];
    acc /= (float)s;
  }
  from_f32(out + (size_t)f * c + ch, acc);
}

template <typename TOut>
int launch(const void* x, void* out, void* partial, const int* nvalid,
           int nb, int t, int s, int c, int T, int n, int denom,
           cudaStream_t stream) {
  const int runs = (s + kRun - 1) / kRun;
  const dim3 grid((c + kChannels - 1) / kChannels, runs, nb);
  const auto* xb = static_cast<const __nv_bfloat16*>(x);
  auto* o = static_cast<TOut*>(out);
  auto* pt = static_cast<float*>(partial);
  auto kern = c % 8 == 0 ? pool_kernel<TOut, true> : pool_kernel<TOut, false>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmemBytes);
  if (err != cudaSuccess) return (int)err;
  kern<<<grid, kThreads, kSmemBytes, stream>>>(xb, o, pt, nvalid, t, s, c, T,
                                               n, denom);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const dim3 g2((c + kCombineThreads - 1) / kCombineThreads, T, nb);
  pool_temporal_kernel<TOut><<<g2, kCombineThreads, 0, stream>>>(
      pt, o, nvalid, t, s, c, T, n, runs);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int vlt_pool_rows_per_block() { return kRun; }

// x: (nb, t, s, c) bf16, out: (nb, T + s, c). nvalid: nb int32 valid
// counts on the device, or null for n in every video. denom: the spatial
// mean's divisor for every video, or -1 for each video's count. out_bf16:
// 1 for a bf16 output, 0 for f32. partial: (nb, ceil(s /
// vlt_pool_rows_per_block()), t, c) f32 scratch.
extern "C" int vlt_spatio_temporal_pool(const void* x, void* out,
                                        void* partial, const void* nvalid,
                                        int nb, int t, int s, int c, int T,
                                        int n, int denom, int out_bf16,
                                        void* stream) {
  if (nb < 1 || nb > 65535 || t < 1 || s < 1 || c < 1 || T < t)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int* nv = static_cast<const int*>(nvalid);
  if (out_bf16)
    return launch<__nv_bfloat16>(x, out, partial, nv, nb, t, s, c, T, n,
                                 denom, st);
  return launch<float>(x, out, partial, nv, nb, t, s, c, T, n, denom, st);
}
