// Decode attention for one query token against one layer of a KV cache,
// bf16 or int8 with per-(position, head) f32 scales, head dims 32, 64, 128.
// Two kernel bodies:
//   * one block per (head, row), MHA (below): the stacked cache (NL, b, L,
//     h, d), scales (NL, b, L, h), the slot cache.
//     Replaces video_llava_tpu/ops/attention.py::decode_attention_mxu_stacked
//     (Pallas body _decode_attn_mxu_stacked_kernel). A flat per-layer cache
//     (b, L, h, d) is the stacked one with NL = 1 at layer 0, so the same
//     entry also replaces decode_attention_mxu (Pallas body
//     _decode_attn_mxu_kernel).
//   * split along the positions, then a combine (kernel 11's body, further
//     down): grouped-query heads over a flat cache, and with a block table
//     (b, MAXB) the paged pool (NL, NB, BS, h, d), scales (NL, NB, BS, h),
//     where position p of row bi lives in pool block table[bi, p / BS] at
//     offset p % BS.
//     Replaces video_llava_tpu/ops/attention.py::decode_attention_pallas
//     (body _decode_attn_kernel) and decode_attention_mxu_paged (Pallas
//     body _decode_attn_mxu_paged_kernel).
// For row bi, head hh, with n = lengths[bi]:
//     s_p = (q . k_p) * scale [* k_scale_p]            p < n
//     o   = sum_p softmax(s)_p [* v_scale_p] v_p        (bf16 out)
// Positions at or past a row's length are never read, and neither are the
// table entries that map them (the pad block 0 past a row's allocation).
// The layer select that the TPU kernels did with scalar prefetch, and the
// block-table index map, are address arithmetic here.
//
// What bounds it on Hopper: device-memory bandwidth on the cache stream
// (2 * n * h * d bytes per layer and row in bf16, half that in int8); the
// arithmetic is a few flops per byte. The per-(head, row) body: 8 warps;
// lanes split d so each cache row is one coalesced 256-byte (bf16, d = 128)
// read, and each warp keeps kUnroll rows in flight to hide latency. Scores
// go to shared memory (n floats), so the softmax is exact two-pass, not
// online, and the body takes L only up to that memory (the wrappers send a
// longer cache to the split body with one head a block). At b = 1 the grid
// is h = 32 blocks, which fills 32 of 132 SMs.

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
  void* o;              // (b, 1, h, D) bf16
  int layer, b;
  int L;                // positions a row can hold
  int h;
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
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
decode_attn_kernel(const __nv_bfloat16* __restrict__ q,
                   const T* __restrict__ kc, const T* __restrict__ vc,
                   const float* __restrict__ ks, const float* __restrict__ vs,
                   const int* __restrict__ lengths,
                   __nv_bfloat16* __restrict__ o, int layer, int b, int L,
                   int h, float scale) {
  constexpr int E = D / 32;
  extern __shared__ float smem[];
  float* sc = smem;                 // (L,) scores, then weights
  float* acc_s = smem + L;          // (kWarps, D) partial outputs
  float* red = acc_s + kWarps * D;  // (kWarps,) reduction scratch

  const int hh = blockIdx.x, bi = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int n = min(lengths[bi], L);
  __nv_bfloat16* orow = o + ((size_t)bi * h + hh) * D;
  if (n <= 0) {
    for (int c = threadIdx.x; c < D; c += kThreads) orow[c] = __float2bfloat16(0.f);
    return;
  }
  // Position p of the row sits at (first + p) positions into the cache:
  // the values of head hh at (first + p) * h * D + hh * D, its scale at
  // (first + p) * h + hh.
  const size_t first = ((size_t)layer * b + bi) * L;
  const size_t pstride = (size_t)h * D;  // elements between positions
  const T* kbase = kc + first * pstride + (size_t)hh * D + lane * E;
  const T* vbase = vc + first * pstride + (size_t)hh * D + lane * E;
  const float* ksb = ks ? ks + first * h + hh : nullptr;
  const float* vsb = vs ? vs + first * h + hh : nullptr;

  float qf[E];
  load_row<E>(q + ((size_t)bi * h + hh) * D + lane * E, qf);

  // Pass 1: scores.
  for (int base = warp * kUnroll; base < n; base += kWarps * kUnroll) {
    float part[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      part[u] = 0.f;
      if (base + u < n) {
        float kf[E];
        load_row<E>(kbase + (size_t)(base + u) * pstride, kf);
#pragma unroll
        for (int e = 0; e < E; ++e) part[u] += qf[e] * kf[e];
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const float dot = warp_sum(part[u]);
      const int p = base + u;
      if (lane == 0 && p < n) sc[p] = dot * scale * (ksb ? ksb[(size_t)p * h] : 1.f);
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
    sc[p] = vsb ? w * vsb[(size_t)p * h] : w;
  }
  sum = block_reduce<false>(sum, red);  // also orders the sc writes

  // Pass 2: weighted sum of values.
  float acc[E];
#pragma unroll
  for (int e = 0; e < E; ++e) acc[e] = 0.f;
  for (int base = warp * kUnroll; base < n; base += kWarps * kUnroll) {
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int p = base + u;
      if (p < n) {
        float vf[E];
        load_row<E>(vbase + (size_t)p * pstride, vf);
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

template <typename T, int D>
int launch(const Args& a, cudaStream_t stream) {
  auto kern = decode_attn_kernel<T, D>;
  const size_t smem = ((size_t)a.L + kWarps * D + kWarps) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kern<<<dim3(a.h, a.b), kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), a.ks, a.vs, a.lengths,
      static_cast<__nv_bfloat16*>(a.o), a.layer, a.b, a.L, a.h, a.scale);
  return (int)cudaGetLastError();
}

int dispatch(const Args& a, int d, int int8, cudaStream_t st) {
  if (int8) {
    if (d == 128) return launch<int8_t, 128>(a, st);
    if (d == 32) return launch<int8_t, 32>(a, st);
    return launch<int8_t, 64>(a, st);
  }
  if (d == 128) return launch<__nv_bfloat16, 128>(a, st);
  if (d == 32) return launch<__nv_bfloat16, 32>(a, st);
  return launch<__nv_bfloat16, 64>(a, st);
}

// ---------------------------------------------------------------------------
// Kernels 11 and 10: decode split along the positions (flash-decoding), over
// a flat (b, L, h_kv, D) cache or, through a block table, the paged pool.
// ---------------------------------------------------------------------------
// Replaces video_llava_tpu/ops/attention.py::decode_attention_pallas (body
// _decode_attn_kernel) and, paged (MHA, one head a block),
// decode_attention_mxu_paged (body _decode_attn_mxu_paged_kernel); the
// wrappers of kernels 3 and 9 also send a cache longer than the per-(head,
// row) body's shared memory here, flat, one head a block. Query head i
// reads KV head i / group. For row bi and KV head kh, with n =
// min(lengths[bi], L) and qs_i = q_i * scale (f32):
//     s_ip = (qs_i . k_p) [* k_scale_p]                 p < n
//     o_i  = sum_p softmax(s_i)_p [* v_scale_p] v_p      (bf16 out)
// What bounds it: the cache's bytes (2 n h_kv D a row in bf16, half that
// and the scales in int8), and at b 1 the latency of one pass over them:
// the chat's 734 positions x 8 KV heads are 3 MB, about what the card
// must keep in flight to read at its rate.
// The design: the host's plan (ops/attention.py gqa_split_plan) cuts [0, L)
// into `splits` chunks of `chunk` positions, enough for about two blocks an
// SM. A split block (chunk, row, KV head, run of G query heads: G the
// largest of 8, 4, 2, 1 that divides the group) reads its chunk of K and V
// once for all G heads, 16 bytes a lane (a cache row is LR lanes), in steps
// of WIN positions: every K and V row of a step is loaded before the first
// is used, the scores of the step go to shared memory, and an online
// softmax (the running max is the same in every thread: it comes from the
// shared scores) folds the step into each thread's G x VE accumulators.
// Shared memory is bounded by the step, never by L. The block then sums
// its accumulators over rows (shuffles within a warp, shared memory across
// warps) and writes its partial (row max m, sum l, G x D accumulator) to
// an f32 workspace; a chunk at or past the row's length writes an empty
// partial (m = -inf, l = 0) and reads nothing. The combine kernel merges
// each query head's partials in split order (m = max m_j, o = sum_j
// e^(m_j - m) acc_j / sum_j e^(m_j - m) l_j): deterministic, no atomics.
// With one split the block writes the output itself and the combine is
// not launched. The sums exclude the v scales, as the JAX kernel's do.
// Paged (kPaged), L is the table's maxb * bs positions and the plan's
// chunk a multiple of bs (ops/attention.py paged_split_plan), so a chunk
// covers whole pool blocks: the block stages the table entries of its
// chunk's live positions in shared memory once (at most kTableMax), and
// position p sits at slot tbl[(p - p0) / bs] * bs + p % bs of layer
// `layer`'s slab. A chunk at or past the row's length reads neither the
// cache nor the table.

constexpr int kGqaThreads = 128;
constexpr int kGqaWarps = kGqaThreads / 32;
constexpr int kGqaUnroll = 4;  // cache rows a thread loads a step (K and V)
constexpr int kTableMax = 256;  // pool blocks a paged chunk spans, at most

// A cache row of D elements of T, 16 bytes a lane.
template <typename T, int D>
struct GqaRows {
  static constexpr int VE = 16 / sizeof(T);           // elements a lane
  static constexpr int LR = D / VE;                   // lanes a row
  static constexpr int RPP = kGqaThreads / LR;        // rows a load
  static constexpr int WIN = RPP * kGqaUnroll;        // rows a step
};

__device__ inline void unpack16(const uint4& raw, float (&f)[8]) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float2 x = __bfloat1622float2(h[j]);
    f[2 * j] = x.x;
    f[2 * j + 1] = x.y;
  }
}

__device__ inline void unpack16(const uint4& raw, float (&f)[16]) {
  const char4* c = reinterpret_cast<const char4*>(&raw);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    f[4 * j] = c[j].x;
    f[4 * j + 1] = c[j].y;
    f[4 * j + 2] = c[j].z;
    f[4 * j + 3] = c[j].w;
  }
}

template <typename T, int D, int G, bool kPaged>
__global__ void __launch_bounds__(kGqaThreads)
decode_gqa_split_kernel(const __nv_bfloat16* __restrict__ q,
                        const T* __restrict__ kc, const T* __restrict__ vc,
                        const float* __restrict__ ks,
                        const float* __restrict__ vs,
                        const int* __restrict__ lengths,
                        __nv_bfloat16* __restrict__ o,
                        float* __restrict__ ws_ml, float* __restrict__ ws_acc,
                        int L, int h, int h_kv, int group, int chunk,
                        int splits, float scale,
                        const int* __restrict__ table, int layer,
                        int nblocks, int bs, int maxb) {
  using R = GqaRows<T, D>;
  constexpr int VE = R::VE, LR = R::LR, RPP = R::RPP, WIN = R::WIN;
  __shared__ float qsm[G][D];              // q * scale
  __shared__ float sc[G][WIN];             // a step's scores
  __shared__ float step_max[G];
  __shared__ float red[kGqaWarps][G][D];   // the warps' accumulators
  __shared__ float lred[kGqaWarps][G];     // and sums
  __shared__ int tbl[kPaged ? kTableMax : 1];  // the chunk's pool blocks

  const int runs = group / G;
  int x = blockIdx.x;
  const int c = x % splits;
  x /= splits;
  const int run = x % runs;
  x /= runs;
  const int kh = x % h_kv, bi = x / h_kv;
  const int h0 = kh * group + run * G;  // first query head
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int n = min(lengths[bi], L);
  const int p0 = c * chunk, p1 = min(p0 + chunk, n);
  // head h0 + g's partial: (bi * h + h0 + g) * splits + c
  const size_t part = ((size_t)bi * h + h0) * splits + c;
  __nv_bfloat16* obase = o + ((size_t)bi * h + h0) * D;
  if (p0 >= p1) {  // nothing of the row in this chunk
    if (splits == 1) {
      for (int i = threadIdx.x; i < G * D; i += kGqaThreads)
        obase[i] = __float2bfloat16(0.f);
    } else if (threadIdx.x < G) {
      ws_ml[2 * (part + (size_t)threadIdx.x * splits)] = -INFINITY;
      ws_ml[2 * (part + (size_t)threadIdx.x * splits) + 1] = 0.f;
    }
    return;
  }

  for (int i = threadIdx.x; i < G * D; i += kGqaThreads)
    qsm[i / D][i % D] =
        __bfloat162float(q[((size_t)bi * h + h0) * D + i]) * scale;
  if constexpr (kPaged) {  // p0 is a multiple of bs
    const int* trow = table + (size_t)bi * maxb + p0 / bs;
    for (int i = threadIdx.x; i < (p1 - p0 + bs - 1) / bs; i += kGqaThreads)
      tbl[i] = trow[i];
  }
  // slot(p): position p's place in the slab that starts at `first`
  // positions (row bi's position 0 flat, layer `layer`'s pool block 0
  // paged)
  auto slot = [&](int p) -> int {
    if constexpr (kPaged) return tbl[(p - p0) / bs] * bs + p % bs;
    else return p;
  };

  const int r = threadIdx.x / LR;         // row of a load
  const int e0 = (threadIdx.x % LR) * VE;  // first element of the lane
  const bool lead = threadIdx.x % LR == 0;
  const size_t pstride = (size_t)h_kv * D;  // elements between positions
  const size_t first = kPaged ? (size_t)layer * nblocks * bs
                              : (size_t)bi * L;
  const T* kbase = kc + first * pstride + (size_t)kh * D + e0;
  const T* vbase = vc + first * pstride + (size_t)kh * D + e0;
  const float* ksb = ks ? ks + first * h_kv + kh : nullptr;
  const float* vsb = vs ? vs + first * h_kv + kh : nullptr;

  float acc[G][VE], l[G], m[G];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    l[g] = 0.f;
    m[g] = -INFINITY;
#pragma unroll
    for (int e = 0; e < VE; ++e) acc[g][e] = 0.f;
  }
  __syncthreads();  // qsm, tbl

  for (int s0 = p0; s0 < p1; s0 += WIN) {
    uint4 kr[kGqaUnroll], vr[kGqaUnroll];
    float ksc[kGqaUnroll], vsc[kGqaUnroll];
#pragma unroll
    for (int u = 0; u < kGqaUnroll; ++u) {
      const int p = s0 + u * RPP + r;
      ksc[u] = vsc[u] = 1.f;
      if (p < p1) {
        const size_t at = (size_t)slot(p);
        kr[u] = *reinterpret_cast<const uint4*>(kbase + at * pstride);
        vr[u] = *reinterpret_cast<const uint4*>(vbase + at * pstride);
        if (ksb) {
          ksc[u] = ksb[at * h_kv];
          vsc[u] = vsb[at * h_kv];
        }
      }
    }
    // Scores: each row's LR lanes dot their elements, then sum by shuffles.
#pragma unroll
    for (int u = 0; u < kGqaUnroll; ++u) {
      const int p = s0 + u * RPP + r;
      float kf[VE];
      if (p < p1) {
        unpack16(kr[u], kf);
      } else {
#pragma unroll
        for (int e = 0; e < VE; ++e) kf[e] = 0.f;
      }
#pragma unroll
      for (int g = 0; g < G; ++g) {
        float dot = 0.f;
#pragma unroll
        for (int e = 0; e < VE; ++e) dot = fmaf(qsm[g][e0 + e], kf[e], dot);
#pragma unroll
        for (int off = LR / 2; off > 0; off >>= 1)
          dot += __shfl_xor_sync(0xffffffffu, dot, off);
        if (lead && p < p1) sc[g][u * RPP + r] = dot * ksc[u];
      }
    }
    __syncthreads();
    const int cnt = min(WIN, p1 - s0);
    for (int g = warp; g < G; g += kGqaWarps) {
      float mx = -INFINITY;
      for (int j = lane; j < cnt; j += 32) mx = fmaxf(mx, sc[g][j]);
      mx = warp_max(mx);
      if (lane == 0) step_max[g] = mx;
    }
    __syncthreads();
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const float mn = fmaxf(m[g], step_max[g]);
      const float alpha = __expf(m[g] - mn);  // 0 on the first step
      m[g] = mn;
      l[g] *= alpha;
#pragma unroll
      for (int e = 0; e < VE; ++e) acc[g][e] *= alpha;
    }
    // Values: weight each of the thread's rows into its accumulators.
#pragma unroll
    for (int u = 0; u < kGqaUnroll; ++u) {
      const int j = u * RPP + r;
      if (s0 + j < p1) {
        float vf[VE];
        unpack16(vr[u], vf);
#pragma unroll
        for (int g = 0; g < G; ++g) {
          const float w = __expf(sc[g][j] - m[g]);
          if (lead) l[g] += w;
          const float wv = w * vsc[u];
#pragma unroll
          for (int e = 0; e < VE; ++e) acc[g][e] = fmaf(wv, vf[e], acc[g][e]);
        }
      }
    }
    __syncthreads();  // sc is read before the next step writes it
  }

  // Sum over rows: the lanes of a warp that hold the same elements, then
  // the warps.
#pragma unroll
  for (int g = 0; g < G; ++g) {
#pragma unroll
    for (int e = 0; e < VE; ++e)
#pragma unroll
      for (int off = LR; off < 32; off <<= 1)
        acc[g][e] += __shfl_xor_sync(0xffffffffu, acc[g][e], off);
    l[g] = warp_sum(l[g]);
  }
  if (lane < LR) {
#pragma unroll
    for (int g = 0; g < G; ++g)
#pragma unroll
      for (int e = 0; e < VE; ++e) red[warp][g][e0 + e] = acc[g][e];
  }
  if (lane == 0) {
#pragma unroll
    for (int g = 0; g < G; ++g) lred[warp][g] = l[g];
  }
  __syncthreads();
  for (int i = threadIdx.x; i < G * D; i += kGqaThreads) {
    const int g = i / D, dd = i % D;
    float a = 0.f, lt = 0.f;
#pragma unroll
    for (int w = 0; w < kGqaWarps; ++w) {
      a += red[w][g][dd];
      lt += lred[w][g];
    }
    if (splits == 1)
      obase[i] = __float2bfloat16(a / lt);
    else
      ws_acc[(part + (size_t)g * splits) * D + dd] = a;
  }
  if (splits > 1 && threadIdx.x < G) {
    float lt = 0.f;
#pragma unroll
    for (int w = 0; w < kGqaWarps; ++w) lt += lred[w][threadIdx.x];
    ws_ml[2 * (part + (size_t)threadIdx.x * splits)] = m[threadIdx.x];
    ws_ml[2 * (part + (size_t)threadIdx.x * splits) + 1] = lt;
  }
}

// One block a (row, query head): the head's partials merged in split order.
// The largest max of a non-empty partial (l > 0) first, a block reduction;
// then thread t takes element t % D of the splits j = t / D, t / D + P,
// ... (P = kCombineThreads / D), and the P sums of each element are added
// in order: the result does not depend on timing. Empty partials are
// skipped unread.
constexpr int kCombineThreads = 256;

template <int D>
__global__ void __launch_bounds__(kCombineThreads)
decode_gqa_combine_kernel(const float* __restrict__ ws_ml,
                          const float* __restrict__ ws_acc,
                          __nv_bfloat16* __restrict__ o, int splits) {
  constexpr int P = kCombineThreads / D;
  __shared__ float red[kCombineThreads / 32];
  __shared__ float part_acc[P][D], part_l[P][D];
  const size_t bh = blockIdx.x;
  const float* ml = ws_ml + bh * splits * 2;
  const float* a = ws_acc + bh * splits * D;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float mx = -INFINITY;
  for (int j = threadIdx.x; j < splits; j += kCombineThreads)
    if (ml[2 * j + 1] > 0.f) mx = fmaxf(mx, ml[2 * j]);
  mx = warp_max(mx);
  if (lane == 0) red[warp] = mx;
  __syncthreads();
  mx = red[0];
#pragma unroll
  for (int w = 1; w < kCombineThreads / 32; ++w) mx = fmaxf(mx, red[w]);

  const int dd = threadIdx.x % D, part = threadIdx.x / D;
  float l = 0.f, acc = 0.f;
#pragma unroll 4
  for (int j = part; j < splits; j += P) {
    const float lj = ml[2 * j + 1];
    if (lj > 0.f) {
      const float w = __expf(ml[2 * j] - mx);
      l = fmaf(w, lj, l);
      acc = fmaf(w, a[(size_t)j * D + dd], acc);
    }
  }
  part_acc[part][dd] = acc;
  part_l[part][dd] = l;
  __syncthreads();
  if (threadIdx.x < D) {
    for (int p = 1; p < P; ++p) {
      acc += part_acc[p][dd];
      l += part_l[p][dd];
    }
    o[bh * D + dd] = __float2bfloat16(l > 0.f ? acc / l : 0.f);
  }
}

// The paged pool's geometry (table null for a flat cache).
struct Paged {
  const int* table;
  int layer, nblocks, bs, maxb;
};

template <typename T, int D, int G, bool kPaged>
int launch_gqa(const void* q, const void* k, const void* v, const float* ks,
               const float* vs, const int* lengths, void* o, float* ws,
               int b, int L, int h, int h_kv, int chunk, int splits,
               float scale, const Paged& pg, cudaStream_t stream) {
  const int group = h / h_kv;
  const size_t blocks = (size_t)b * h_kv * (group / G) * splits;
  float* ws_acc = ws + (size_t)2 * b * h * splits;  // after the (m, l) pairs
  decode_gqa_split_kernel<T, D, G, kPaged><<<(unsigned)blocks, kGqaThreads,
                                             0, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), ks, vs, lengths,
      static_cast<__nv_bfloat16*>(o), ws, ws_acc, L, h, h_kv, group, chunk,
      splits, scale, pg.table, pg.layer, pg.nblocks, pg.bs, pg.maxb);
  if (splits == 1) return (int)cudaGetLastError();
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  decode_gqa_combine_kernel<D><<<b * h, kCombineThreads, 0, stream>>>(
      ws, ws_acc, static_cast<__nv_bfloat16*>(o), splits);
  return (int)cudaGetLastError();
}

template <typename T, int D>
int dispatch_gqa_g(int g, const void* q, const void* k, const void* v,
                   const float* ks, const float* vs, const int* lengths,
                   void* o, float* ws, int b, int L, int h, int h_kv,
                   int chunk, int splits, float scale, cudaStream_t st) {
#define VLT_GQA_CASE(N)                                                    \
  case N:                                                                  \
    return launch_gqa<T, D, N, false>(q, k, v, ks, vs, lengths, o, ws, b,  \
                                      L, h, h_kv, chunk, splits, scale,    \
                                      Paged{}, st);
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

// int8: 0 for a bf16 cache (ks/vs ignored, pass null), 1 for int8 + scales.
// d in {32, 64, 128}; L up to the block's shared memory for its scores
// (the wrappers check).
extern "C" int vlt_decode_attention(const void* q, const void* k,
                                    const void* v, const void* ks,
                                    const void* vs, const void* lengths,
                                    void* o, int layer, int b, int L, int h,
                                    int d, int int8, float scale,
                                    void* stream) {
  const Args a{q, k, v, int8 ? static_cast<const float*>(ks) : nullptr,
               int8 ? static_cast<const float*>(vs) : nullptr,
               static_cast<const int*>(lengths), o, layer, b, L, h, scale};
  return dispatch(a, d, int8, (cudaStream_t)stream);
}

// Kernel 10. The paged pool: k/v (NL, nblocks, bs, h, d), scales (NL,
// nblocks, bs, h), table (b, maxb) int32 with every entry in [0, nblocks);
// ws as kernel 11's (b * h * splits * (2 + d) floats, unused when splits
// is 1); [0, maxb * bs) in `splits` chunks of `chunk` positions, chunk a
// multiple of bs spanning at most kTableMax blocks. MHA, d in
// {32, 64, 128} (the wrapper checks).
extern "C" int vlt_decode_attention_paged(const void* q, const void* k,
                                          const void* v, const void* ks,
                                          const void* vs, const void* table,
                                          const void* lengths, void* o,
                                          void* ws, int layer, int b,
                                          int nblocks, int bs, int maxb,
                                          int h, int d, int int8, int chunk,
                                          int splits, float scale,
                                          void* stream) {
  const int L = maxb * bs;
  if (bs <= 0 || chunk <= 0 || chunk % bs || chunk / bs > kTableMax ||
      (long long)chunk * splits < L || (splits > 1 && ws == nullptr))
    return (int)cudaErrorInvalidValue;
  const Paged pg{static_cast<const int*>(table), layer, nblocks, bs, maxb};
  const float* ksf = int8 ? static_cast<const float*>(ks) : nullptr;
  const float* vsf = int8 ? static_cast<const float*>(vs) : nullptr;
  const int* len = static_cast<const int*>(lengths);
  float* wsf = static_cast<float*>(ws);
  cudaStream_t st = (cudaStream_t)stream;
#define VLT_PAGED_ARGS \
  q, k, v, ksf, vsf, len, o, wsf, b, L, h, h, chunk, splits, scale, pg, st
  if (int8) {
    if (d == 128) return launch_gqa<int8_t, 128, 1, true>(VLT_PAGED_ARGS);
    if (d == 64) return launch_gqa<int8_t, 64, 1, true>(VLT_PAGED_ARGS);
    if (d == 32) return launch_gqa<int8_t, 32, 1, true>(VLT_PAGED_ARGS);
  } else {
    if (d == 128) return launch_gqa<__nv_bfloat16, 128, 1, true>(VLT_PAGED_ARGS);
    if (d == 64) return launch_gqa<__nv_bfloat16, 64, 1, true>(VLT_PAGED_ARGS);
    if (d == 32) return launch_gqa<__nv_bfloat16, 32, 1, true>(VLT_PAGED_ARGS);
  }
#undef VLT_PAGED_ARGS
  return (int)cudaErrorInvalidValue;
}

// Kernel 11. q (b, 1, h, d) bf16; k, v (b, L, h_kv, d), bf16 or int8 with
// scales (b, L, h_kv) f32; lengths (b,); o (b, 1, h, d) bf16; ws the f32
// workspace of the partials, b * h * splits * (2 + d) floats (unused when
// splits is 1); [0, L) in `splits` chunks of `chunk` positions (splits =
// ceil(L / chunk)). h a multiple of h_kv; d in {32, 64, 128} (the wrapper
// checks).
extern "C" int vlt_decode_attention_gqa(const void* q, const void* k,
                                        const void* v, const void* ks,
                                        const void* vs, const void* lengths,
                                        void* o, void* ws, int b, int L,
                                        int h, int h_kv, int d, int int8,
                                        int chunk, int splits, float scale,
                                        void* stream) {
  if (h_kv <= 0 || h % h_kv || chunk <= 0 ||
      (long long)chunk * splits < L || (splits > 1 && ws == nullptr))
    return (int)cudaErrorInvalidValue;
  const int g = gqa_run(h / h_kv);
  const float* ksf = int8 ? static_cast<const float*>(ks) : nullptr;
  const float* vsf = int8 ? static_cast<const float*>(vs) : nullptr;
  const int* len = static_cast<const int*>(lengths);
  float* wsf = static_cast<float*>(ws);
  cudaStream_t st = (cudaStream_t)stream;
#define VLT_GQA_ARGS \
  g, q, k, v, ksf, vsf, len, o, wsf, b, L, h, h_kv, chunk, splits, scale, st
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
