// Decode attention for one query token against one layer of a KV cache,
// bf16 or int8 with per-(position, head) f32 scales. Two cache layouts,
// one MHA kernel body (head dims 32, 64, 128):
//   stacked (NL, b, L, h, d), scales (NL, b, L, h): the slot cache.
//     Replaces video_llava_tpu/ops/attention.py::decode_attention_mxu_stacked
//     (Pallas body _decode_attn_mxu_stacked_kernel). A flat per-layer cache
//     (b, L, h, d) is the stacked one with NL = 1 at layer 0, so the same
//     entry also replaces decode_attention_mxu (Pallas body
//     _decode_attn_mxu_kernel).
//   paged (NL, NB, BS, h, d), scales (NL, NB, BS, h), with a block table
//     (b, MAXB): the serving block pool. Position p of row bi lives in pool
//     block table[bi, p / BS] at offset p % BS.
//     Replaces video_llava_tpu/ops/attention.py::decode_attention_mxu_paged
//     (Pallas body _decode_attn_mxu_paged_kernel).
// For row bi, head hh, with n = lengths[bi]:
//     s_p = (q . k_p) * scale [* k_scale_p]            p < n
//     o   = sum_p softmax(s)_p [* v_scale_p] v_p        (bf16 out)
// Positions at or past a row's length are never read, and neither are the
// table entries that map them (the pad block 0 past a row's allocation).
// The layer select that the TPU kernels did with scalar prefetch, and the
// block-table index map, are address arithmetic here (row_of below).
//
// What bounds it on Hopper: device-memory bandwidth on the cache stream
// (2 * n * h * d bytes per layer and row in bf16, half that in int8); the
// arithmetic is a few flops per byte. One block per (head, row) with 8 warps;
// lanes split d so each cache row is one coalesced 256-byte (bf16, d = 128)
// read, and each warp keeps kUnroll rows in flight to hide latency. A paged
// block keeps that: a 64-position block of one head is 64 such reads. The
// row's table (MAXB ints) is staged in shared memory once. Scores go to
// shared memory (n floats), so the softmax is exact two-pass, not online.
// At b = 1 the grid is h = 32 blocks, which fills 32 of 132 SMs: splitting L
// across blocks (flash-decoding) is later work.
// Grouped-query attention (h_kv < h) over a flat cache has a body of its
// own below (kernel 11), so that the MHA body keeps its parameters and time.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kUnroll = 8;

// What the entry points pass to launch().
struct Args {
  const void* q;        // (b, 1, h, D) bf16
  const void* k;        // cache values, layout above
  const void* v;
  const float* ks;      // scales, or null for a bf16 cache
  const float* vs;
  const int* lengths;   // (b,)
  const int* table;     // (b, maxb), or null for the stacked cache
  void* o;              // (b, 1, h, D) bf16
  int layer, b;
  int L;                // positions a row can hold: L, or maxb * bs
  int h;
  int nblocks, bs, maxb;  // paged only
  float scale;
};

template <int E>
__device__ inline void load_row(const __nv_bfloat16* p, float (&f)[E]) {
  if constexpr (E == 4) {
    const uint2 raw = *reinterpret_cast<const uint2*>(p);
    const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
    const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
    f[0] = a.x; f[1] = a.y; f[2] = b.x; f[3] = b.y;
  } else if constexpr (E == 2) {
    const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
    f[0] = a.x; f[1] = a.y;
  } else {
    f[0] = __bfloat162float(*p);
  }
}

template <int E>
__device__ inline void load_row(const int8_t* p, float (&f)[E]) {
  if constexpr (E == 4) {
    const char4 c = *reinterpret_cast<const char4*>(p);
    f[0] = c.x; f[1] = c.y; f[2] = c.z; f[3] = c.w;
  } else if constexpr (E == 2) {
    const char2 c = *reinterpret_cast<const char2*>(p);
    f[0] = c.x; f[1] = c.y;
  } else {
    f[0] = *p;
  }
}

__device__ inline float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ inline float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

// Reduce across the block's warps; every thread gets the result.
template <bool kMax>
__device__ inline float block_reduce(float x, float* red) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  x = kMax ? warp_max(x) : warp_sum(x);
  __syncthreads();
  if (lane == 0) red[warp] = x;
  __syncthreads();
  float r = red[0];
  for (int w = 1; w < kWarps; ++w) r = kMax ? fmaxf(r, red[w]) : r + red[w];
  return r;
}

// The pointers are separate __restrict__ kernel parameters (not members of
// Args), so nvcc knows they are global and unaliased and streams the cache
// through the read-only path.
template <typename T, int D, bool kPaged>
__global__ void __launch_bounds__(kThreads)
decode_attn_kernel(const __nv_bfloat16* __restrict__ q,
                   const T* __restrict__ kc, const T* __restrict__ vc,
                   const float* __restrict__ ks, const float* __restrict__ vs,
                   const int* __restrict__ lengths,
                   const int* __restrict__ table,
                   __nv_bfloat16* __restrict__ o, int layer, int b, int L,
                   int h, int nblocks, int bs, int maxb, float scale) {
  constexpr int E = D / 32;
  extern __shared__ float smem[];
  float* sc = smem;                 // (L,) scores, then weights
  float* acc_s = smem + L;          // (kWarps, D) partial outputs
  float* red = acc_s + kWarps * D;  // (kWarps,) reduction scratch
  int* tbl = reinterpret_cast<int*>(red + kWarps);  // (maxb,) paged only

  const int hh = blockIdx.x, bi = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int n = min(lengths[bi], L);
  __nv_bfloat16* orow = o + ((size_t)bi * h + hh) * D;
  if (n <= 0) {
    for (int c = threadIdx.x; c < D; c += kThreads) orow[c] = __float2bfloat16(0.f);
    return;
  }
  if constexpr (kPaged) {
    for (int i = threadIdx.x; i < maxb; i += kThreads) tbl[i] = table[(size_t)bi * maxb + i];
    __syncthreads();
  }

  // slot(p): where position p sits in the layer's slab, counted in
  // positions from `first` (the layer's row bi stacked; the layer's pool
  // block 0 paged): the values of head hh at (first + slot) * h * D +
  // hh * D, its scale at (first + slot) * h + hh. Passes 1 and 2 walk runs
  // of kUnroll positions that start at a multiple of kUnroll, and a paged
  // block (bs a multiple of 16) never splits a run, so they look the table
  // up once a run: p + u sits at slot(p) + u.
  const size_t first = kPaged ? (size_t)layer * nblocks * bs
                              : ((size_t)layer * b + bi) * L;
  auto slot = [=](int p) -> int {
    if constexpr (kPaged) return tbl[p / bs] * bs + p % bs;
    else return p;
  };
  const size_t pstride = (size_t)h * D;  // elements between positions
  const T* kbase = kc + first * pstride + (size_t)hh * D + lane * E;
  const T* vbase = vc + first * pstride + (size_t)hh * D + lane * E;
  const float* ksb = ks ? ks + first * h + hh : nullptr;
  const float* vsb = vs ? vs + first * h + hh : nullptr;

  float qf[E];
  load_row<E>(q + ((size_t)bi * h + hh) * D + lane * E, qf);

  // Pass 1: scores.
  for (int base = warp * kUnroll; base < n; base += kWarps * kUnroll) {
    const int s0 = slot(base);
    float part[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      part[u] = 0.f;
      if (base + u < n) {
        float kf[E];
        load_row<E>(kbase + (size_t)(s0 + u) * pstride, kf);
#pragma unroll
        for (int e = 0; e < E; ++e) part[u] += qf[e] * kf[e];
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const float dot = warp_sum(part[u]);
      const int p = base + u;
      if (lane == 0 && p < n) sc[p] = dot * scale * (ksb ? ksb[(size_t)(s0 + u) * h] : 1.f);
    }
  }
  __syncthreads();

  // Softmax: max, weights, sum (the sum excludes the v scales).
  float mx = -INFINITY;
  for (int p = threadIdx.x; p < n; p += kThreads) mx = fmaxf(mx, sc[p]);
  mx = block_reduce<true>(mx, red);
  float sum = 0.f;
  for (int p = threadIdx.x; p < n; p += kThreads) {
    const float w = __expf(sc[p] - mx);
    sum += w;
    sc[p] = vsb ? w * vsb[(size_t)slot(p) * h] : w;
  }
  sum = block_reduce<false>(sum, red);  // also orders the sc writes

  // Pass 2: weighted sum of values.
  float acc[E];
#pragma unroll
  for (int e = 0; e < E; ++e) acc[e] = 0.f;
  for (int base = warp * kUnroll; base < n; base += kWarps * kUnroll) {
    const int s0 = slot(base);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int p = base + u;
      if (p < n) {
        float vf[E];
        load_row<E>(vbase + (size_t)(s0 + u) * pstride, vf);
        const float w = sc[p];
#pragma unroll
        for (int e = 0; e < E; ++e) acc[e] += w * vf[e];
      }
    }
  }
#pragma unroll
  for (int e = 0; e < E; ++e) acc_s[warp * D + lane * E + e] = acc[e];
  __syncthreads();
  const float inv = 1.f / sum;
  for (int c = threadIdx.x; c < D; c += kThreads) {
    float r = 0.f;
    for (int w = 0; w < kWarps; ++w) r += acc_s[w * D + c];
    orow[c] = __float2bfloat16(r * inv);
  }
}

template <typename T, int D, bool kPaged>
int launch(const Args& a, cudaStream_t stream) {
  auto kern = decode_attn_kernel<T, D, kPaged>;
  const size_t smem = ((size_t)a.L + kWarps * D + kWarps) * sizeof(float)
                      + (kPaged ? (size_t)a.maxb * sizeof(int) : 0);
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kern<<<dim3(a.h, a.b), kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), a.ks, a.vs, a.lengths, a.table,
      static_cast<__nv_bfloat16*>(a.o), a.layer, a.b, a.L, a.h, a.nblocks,
      a.bs, a.maxb, a.scale);
  return (int)cudaGetLastError();
}

template <bool kPaged>
int dispatch(const Args& a, int d, int int8, cudaStream_t st) {
  if (int8) {
    if (d == 128) return launch<int8_t, 128, kPaged>(a, st);
    if (d == 32) return launch<int8_t, 32, kPaged>(a, st);
    return launch<int8_t, 64, kPaged>(a, st);
  }
  if (d == 128) return launch<__nv_bfloat16, 128, kPaged>(a, st);
  if (d == 32) return launch<__nv_bfloat16, 32, kPaged>(a, st);
  return launch<__nv_bfloat16, 64, kPaged>(a, st);
}

// ---------------------------------------------------------------------------
// Kernel 11: grouped-query decode over a flat (b, L, h_kv, D) cache.
// ---------------------------------------------------------------------------
// Replaces video_llava_tpu/ops/attention.py::decode_attention_pallas (body
// _decode_attn_kernel). Query head i reads KV head i / group. For row bi and
// KV head kh, with n = lengths[bi] and qs_i = q_i * scale (f32):
//     s_ip = (qs_i . k_p) [* k_scale_p]                 p < n
//     o_i  = sum_p softmax(s_i)_p [* v_scale_p] v_p      (bf16 out)
// One block per (row, KV head, run of G of its query heads): G is the
// largest of 8, 4, 2, 1 that divides the group, so for a group of 1, 2, 4
// or 8 a block holds the whole group and reads each K/V position of its
// head once for all of it (other groups take runs of 1 or 2 heads: four
// instantiations of G keep the build short).
// Lanes split d as in the MHA body; each position's K row is loaded once
// and dotted with the G queries held in registers. Scores (G, n) go to
// shared memory, warp g takes query head g's softmax (exact, two-pass), and
// pass 2 reads each V row once into G accumulators. The Pallas kernel's
// block_l tiling, online softmax and masked tail are TPU formulations of
// the same function: here no position at or past n is read.
template <typename T, int D, int G>
__global__ void __launch_bounds__(kThreads)
decode_gqa_kernel(const __nv_bfloat16* __restrict__ q,
                  const T* __restrict__ kc, const T* __restrict__ vc,
                  const float* __restrict__ ks, const float* __restrict__ vs,
                  const int* __restrict__ lengths,
                  __nv_bfloat16* __restrict__ o, int L, int h, int h_kv,
                  int group, float scale) {
  constexpr int E = D / 32;
  extern __shared__ float smem[];
  float* sc = smem;                      // (G, L) scores, then weights
  float* acc_s = smem + (size_t)G * L;   // (kWarps, G, D) partial outputs
  float* inv = acc_s + kWarps * G * D;   // (G,) 1 / softmax sums

  const int runs = group / G;
  const int kh = blockIdx.x / runs;
  const int h0 = kh * group + (blockIdx.x % runs) * G;  // first query head
  const int bi = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int n = min(lengths[bi], L);
  __nv_bfloat16* obase = o + ((size_t)bi * h + h0) * D;
  if (n <= 0) {
    for (int c = threadIdx.x; c < G * D; c += kThreads) obase[c] = __float2bfloat16(0.f);
    return;
  }

  const size_t pstride = (size_t)h_kv * D;  // elements between positions
  const size_t first = (size_t)bi * L;      // row bi's position 0
  const T* kbase = kc + first * pstride + (size_t)kh * D + lane * E;
  const T* vbase = vc + first * pstride + (size_t)kh * D + lane * E;
  const float* ksb = ks ? ks + first * h_kv + kh : nullptr;
  const float* vsb = vs ? vs + first * h_kv + kh : nullptr;

  float qf[G][E];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    load_row<E>(q + ((size_t)bi * h + h0 + g) * D + lane * E, qf[g]);
#pragma unroll
    for (int e = 0; e < E; ++e) qf[g][e] *= scale;
  }

  // Pass 1: scores of the G heads, one K row load per position.
  for (int base = warp * kUnroll; base < n; base += kWarps * kUnroll) {
    float part[kUnroll][G];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
#pragma unroll
      for (int g = 0; g < G; ++g) part[u][g] = 0.f;
      if (base + u < n) {
        float kf[E];
        load_row<E>(kbase + (size_t)(base + u) * pstride, kf);
#pragma unroll
        for (int g = 0; g < G; ++g)
#pragma unroll
          for (int e = 0; e < E; ++e) part[u][g] += qf[g][e] * kf[e];
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int p = base + u;
      const float ksc = (ksb && p < n) ? ksb[(size_t)p * h_kv] : 1.f;
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const float dot = warp_sum(part[u][g]);
        if (lane == 0 && p < n) sc[(size_t)g * L + p] = dot * ksc;
      }
    }
  }
  __syncthreads();

  // Softmax: warp g takes head g (max, weights, sum; the sum excludes the
  // v scales).
  for (int g = warp; g < G; g += kWarps) {
    float* sg = sc + (size_t)g * L;
    float mx = -INFINITY;
    for (int p = lane; p < n; p += 32) mx = fmaxf(mx, sg[p]);
    mx = warp_max(mx);
    float sum = 0.f;
    for (int p = lane; p < n; p += 32) {
      const float w = __expf(sg[p] - mx);
      sum += w;
      sg[p] = vsb ? w * vsb[(size_t)p * h_kv] : w;
    }
    sum = warp_sum(sum);
    if (lane == 0) inv[g] = 1.f / sum;
  }
  __syncthreads();

  // Pass 2: weighted sums of values, one V row load per position.
  float acc[G][E];
#pragma unroll
  for (int g = 0; g < G; ++g)
#pragma unroll
    for (int e = 0; e < E; ++e) acc[g][e] = 0.f;
  for (int base = warp * kUnroll; base < n; base += kWarps * kUnroll) {
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int p = base + u;
      if (p < n) {
        float vf[E];
        load_row<E>(vbase + (size_t)p * pstride, vf);
#pragma unroll
        for (int g = 0; g < G; ++g) {
          const float w = sc[(size_t)g * L + p];
#pragma unroll
          for (int e = 0; e < E; ++e) acc[g][e] += w * vf[e];
        }
      }
    }
  }
#pragma unroll
  for (int g = 0; g < G; ++g)
#pragma unroll
    for (int e = 0; e < E; ++e) acc_s[(warp * G + g) * D + lane * E + e] = acc[g][e];
  __syncthreads();
  for (int c = threadIdx.x; c < G * D; c += kThreads) {
    const int g = c / D;
    float r = 0.f;
    for (int w = 0; w < kWarps; ++w) r += acc_s[(w * G + g) * D + c % D];
    obase[c] = __float2bfloat16(r * inv[g]);
  }
}

// Floats of kernel 11's shared memory: scores (g, L), partial outputs
// (kWarps, g, d), the g softmax sums.
inline size_t gqa_smem_floats(int g, int L, int d) {
  return (size_t)g * L + (size_t)kWarps * g * d + g;
}
constexpr size_t kMaxSmemFloats = 227 * 1024 / sizeof(float);

template <typename T, int D, int G>
int launch_gqa(const void* q, const void* k, const void* v, const float* ks,
               const float* vs, const int* lengths, void* o, int b, int L,
               int h, int h_kv, float scale, cudaStream_t stream) {
  auto kern = decode_gqa_kernel<T, D, G>;
  const size_t smem = gqa_smem_floats(G, L, D) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int group = h / h_kv;
  kern<<<dim3(h_kv * (group / G), b), kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), ks, vs, lengths,
      static_cast<__nv_bfloat16*>(o), L, h, h_kv, group, scale);
  return (int)cudaGetLastError();
}

template <typename T, int D>
int dispatch_gqa_g(int g, const void* q, const void* k, const void* v,
                   const float* ks, const float* vs, const int* lengths,
                   void* o, int b, int L, int h, int h_kv, float scale,
                   cudaStream_t st) {
#define VLT_GQA_CASE(N) \
  case N: return launch_gqa<T, D, N>(q, k, v, ks, vs, lengths, o, b, L, h, h_kv, scale, st);
  switch (g) {
    VLT_GQA_CASE(1) VLT_GQA_CASE(2) VLT_GQA_CASE(4) VLT_GQA_CASE(8)
    default: return (int)cudaErrorInvalidValue;
  }
#undef VLT_GQA_CASE
}

// Heads of one block: the largest of 8, 4, 2 that divides the group, or 1.
inline int gqa_run(int group) {
  for (int g = 8; g > 1; g /= 2)
    if (group % g == 0) return g;
  return 1;
}

}  // namespace

// Kernel 11's longest cache for h query heads over h_kv of dim d: what its
// block's shared memory holds (0 when h_kv does not divide h).
extern "C" int vlt_decode_attention_gqa_max_len(int h, int h_kv, int d) {
  if (h_kv <= 0 || h % h_kv) return 0;
  const int g = gqa_run(h / h_kv);
  const size_t fixed = gqa_smem_floats(g, 0, d);
  return fixed >= kMaxSmemFloats ? 0 : (int)((kMaxSmemFloats - fixed) / g);
}

// int8: 0 for a bf16 cache (ks/vs ignored, pass null), 1 for int8 + scales.
// d must be 64 or 128 (the wrappers check).
extern "C" int vlt_decode_attention(const void* q, const void* k,
                                    const void* v, const void* ks,
                                    const void* vs, const void* lengths,
                                    void* o, int layer, int b, int L, int h,
                                    int d, int int8, float scale,
                                    void* stream) {
  const Args a{q, k, v, int8 ? static_cast<const float*>(ks) : nullptr,
               int8 ? static_cast<const float*>(vs) : nullptr,
               static_cast<const int*>(lengths), nullptr, o, layer, b, L, h,
               0, 0, 0, scale};
  return dispatch<false>(a, d, int8, (cudaStream_t)stream);
}

// The paged pool: k/v (NL, nblocks, bs, h, d), scales (NL, nblocks, bs, h),
// table (b, maxb) int32 with every entry in [0, nblocks).
extern "C" int vlt_decode_attention_paged(const void* q, const void* k,
                                          const void* v, const void* ks,
                                          const void* vs, const void* table,
                                          const void* lengths, void* o,
                                          int layer, int b, int nblocks,
                                          int bs, int maxb, int h, int d,
                                          int int8, float scale,
                                          void* stream) {
  const Args a{q, k, v, int8 ? static_cast<const float*>(ks) : nullptr,
               int8 ? static_cast<const float*>(vs) : nullptr,
               static_cast<const int*>(lengths),
               static_cast<const int*>(table), o, layer, b, maxb * bs, h,
               nblocks, bs, maxb, scale};
  return dispatch<true>(a, d, int8, (cudaStream_t)stream);
}

// Kernel 11. q (b, 1, h, d) bf16; k, v (b, L, h_kv, d), bf16 or int8 with
// scales (b, L, h_kv) f32; lengths (b,); o (b, 1, h, d) bf16. h a multiple
// of h_kv; d in {32, 64, 128} (the wrapper checks); L at most
// vlt_decode_attention_gqa_max_len (else cudaErrorInvalidValue).
extern "C" int vlt_decode_attention_gqa(const void* q, const void* k,
                                        const void* v, const void* ks,
                                        const void* vs, const void* lengths,
                                        void* o, int b, int L, int h,
                                        int h_kv, int d, int int8,
                                        float scale, void* stream) {
  if (L > vlt_decode_attention_gqa_max_len(h, h_kv, d))
    return (int)cudaErrorInvalidValue;
  const int g = gqa_run(h / h_kv);
  const float* ksf = int8 ? static_cast<const float*>(ks) : nullptr;
  const float* vsf = int8 ? static_cast<const float*>(vs) : nullptr;
  const int* len = static_cast<const int*>(lengths);
  cudaStream_t st = (cudaStream_t)stream;
#define VLT_GQA_ARGS g, q, k, v, ksf, vsf, len, o, b, L, h, h_kv, scale, st
  if (int8) {
    if (d == 128) return dispatch_gqa_g<int8_t, 128>(VLT_GQA_ARGS);
    if (d == 64) return dispatch_gqa_g<int8_t, 64>(VLT_GQA_ARGS);
    if (d == 32) return dispatch_gqa_g<int8_t, 32>(VLT_GQA_ARGS);
  } else {
    if (d == 128) return dispatch_gqa_g<__nv_bfloat16, 128>(VLT_GQA_ARGS);
    if (d == 64) return dispatch_gqa_g<__nv_bfloat16, 64>(VLT_GQA_ARGS);
    if (d == 32) return dispatch_gqa_g<__nv_bfloat16, 32>(VLT_GQA_ARGS);
  }
#undef VLT_GQA_ARGS
  return (int)cudaErrorInvalidValue;
}
