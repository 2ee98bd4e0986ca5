// Decode attention for one query token against one layer of a KV cache,
// bf16 or int8 with per-(position, head) f32 scales, head dims 32, 64, 128.
// Every body splits a row's positions into chunks, a block a chunk, and
// merges the chunks' partials in split order.
//   * MHA over the stacked cache (NL, b, L, h, d), scales (NL, b, L, h),
//     one head a block, the merge in the same launch (below): kernels 3 and
//     9. Replaces video_llava_tpu/ops/attention.py::
//     decode_attention_mxu_stacked (Pallas body
//     _decode_attn_mxu_stacked_kernel). A flat per-layer cache (b, L, h, d)
//     is the stacked one with NL = 1 at layer 0, so the same entry also
//     replaces decode_attention_mxu (Pallas body _decode_attn_mxu_kernel).
//   * grouped query heads over a flat cache (kernel 11) and, with a block
//     table (b, MAXB), the paged pool (NL, NB, BS, h, d), scales (NL, NB,
//     BS, h) (kernel 10), where position p of row bi lives in pool block
//     table[bi, p / BS] at offset p % BS: a split kernel and a combine
//     kernel, further down. Replaces video_llava_tpu/ops/attention.py::
//     decode_attention_pallas (body _decode_attn_kernel) and
//     decode_attention_mxu_paged (Pallas body _decode_attn_mxu_paged_kernel).
// For row bi, head hh, with n = min(lengths[bi], L):
//     s_p = (q . k_p) * scale [* k_scale_p]            p < n
//     o   = sum_p softmax(s)_p [* v_scale_p] v_p        (bf16 out)
// The sums exclude the v scales, as the JAX kernels' do. Positions at or
// past a row's length are never read, and neither are the table entries
// that map them (the pad block 0 past a row's allocation). The layer select
// that the TPU kernels did with scalar prefetch, and the block-table index
// map, are address arithmetic here.
//
// What bounds the MHA body on Hopper: device-memory bandwidth on the cache
// stream (2 n h d bytes a row in bf16, half that plus the scales in int8;
// a few flops a byte), and at the chat's one row the latency of a single
// pass: 734 positions x 32 heads are 12 MB, 3.6 us at 3.35 TB/s, about
// what the card must keep in flight at HBM latency, and in the order of a
// launch. The design:
//   * Split along the positions (ops/attention.py mha_split_plan: about
//     MHA_BLOCKS_PER_SM blocks an SM over the b * h (row, head) pairs), so
//     that one row of 32 heads fills 132 SMs and at the serving rows the
//     longest row no longer sets the time; chunks at or past a row's length
//     read nothing.
//   * Bytes in flight: each thread streams its share of a chunk with
//     cp.async into a ring of kMhaStages shared-memory stages (kMhaRows
//     rows of K and of V a thread a stage, 16 bytes a lane, a cache row
//     across LR lanes), and reads back only what it copied, so the ring
//     needs no block barrier (the int8 scales, copied by two lanes of a
//     row, need a warp's).
//   * One pass, no barrier a step: each thread keeps an online softmax (max
//     m, sum l, VE accumulators) over its own rows; the block merges its
//     threads' states at the end, by shuffles within a warp and shared
//     memory across warps, in a fixed order.
//   * One launch: a block writes its partial (m, l, d accumulators) to an
//     f32 workspace and counts itself in on its (row, head)'s counter; the
//     last block to arrive resets the counter and merges the row's live
//     partials in split order, o = sum_j e^(m_j - M) acc_j / sum_j
//     e^(m_j - M) l_j. Deterministic: the order never depends on arrival.
//   * int8 values become floats by bit arithmetic (the sign-flipped byte as
//     the low byte of 2^23, one subtraction), not by conversions, which
//     Hopper issues at an eighth of its f32 rate.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "async_ring.cuh"

namespace {

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

// ---------------------------------------------------------------------------
// Kernels 3 and 9: MHA decode, split along the positions, merged in-launch
// ---------------------------------------------------------------------------

constexpr int kMhaThreads = 128;
constexpr int kMhaWarps = kMhaThreads / 32;
constexpr int kMhaRows = 4;         // rows of K (and of V) a thread a stage
constexpr int kMhaStages = 4;       // stages in flight
constexpr int kMhaSplitsMax = 128;  // = MHA_SPLITS_MAX in ops/attention.py

// A cache row of D elements of T, 16 bytes a lane; a stage of the ring.
template <typename T, int D>
struct MhaTile {
  static constexpr bool Q8 = sizeof(T) == 1;
  static constexpr int VE = 16 / sizeof(T);       // elements a lane
  static constexpr int LR = D / VE;               // lanes a row
  static constexpr int RPP = kMhaThreads / LR;    // rows a pass
  static constexpr int WIN = RPP * kMhaRows;      // rows a stage
  // K rows, V rows, then (int8) their k and v scales
  static constexpr int STAGE = 2 * WIN * D * (int)sizeof(T) + (Q8 ? 8 * WIN : 0);
  static constexpr int SMEM = kMhaStages * STAGE;
};

__device__ inline void bf16x8_to_f32(const uint4& raw, float* f) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float2 x = __bfloat1622float2(h[j]);
    f[2 * j] = x.x;
    f[2 * j + 1] = x.y;
  }
}

// 16 int8 values as floats: byte b, its sign bit flipped (b + 128), made
// the low byte of the f32 2^23 (0x4B000000) reads 2^23 + b + 128; one
// subtraction leaves b exactly.
__device__ inline void int8x16_to_f32(const uint4& raw, float* f) {
  const uint32_t w[4] = {raw.x ^ 0x80808080u, raw.y ^ 0x80808080u,
                         raw.z ^ 0x80808080u, raw.w ^ 0x80808080u};
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i)
      f[4 * j + i] =
          __uint_as_float(__byte_perm(w[j], 0x4B000000u, 0x7540 + i)) -
          8388736.f;
}

template <typename T>
__device__ inline void row_to_f32(const uint4& raw, float* f) {
  if constexpr (sizeof(T) == 1) int8x16_to_f32(raw, f);
  else bf16x8_to_f32(raw, f);
}

// Merge two online-softmax states (m, l, acc): the result's max is the
// larger, each side scaled by e^(its m - max); an empty side (m = -inf)
// adds nothing.
__device__ inline float merge_weight(float m, float mx) {
  return m == -INFINITY ? 0.f : __expf(m - mx);
}

// A block's sum (kMax: max) over its threads; every thread gets it. `red`
// holds kMhaWarps floats.
template <bool kMax>
__device__ inline float mha_block_reduce(float x, float* red) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  x = kMax ? warp_max(x) : warp_sum(x);
  __syncthreads();  // red is free
  if (lane == 0) red[warp] = x;
  __syncthreads();
  float r = red[0];
#pragma unroll
  for (int w = 1; w < kMhaWarps; ++w) r = kMax ? fmaxf(r, red[w]) : r + red[w];
  return r;
}

// Block x = (bi * h + hh) * splits + c: chunk c of row bi, head hh.
// ws: the accumulators (b * h, splits, D), then the (m, l) pairs (b * h,
// splits, 2), f32; counters: b * h ints at 0 (unused when splits is 1).
template <typename T, int D>
__global__ void __launch_bounds__(kMhaThreads)
decode_mha_kernel(const __nv_bfloat16* __restrict__ q,
                  const T* __restrict__ kc, const T* __restrict__ vc,
                  const float* __restrict__ ks, const float* __restrict__ vs,
                  const int* __restrict__ lengths,
                  __nv_bfloat16* __restrict__ o, float* __restrict__ ws,
                  int* __restrict__ counters, int layer, int b, int L, int h,
                  int chunk, int splits, float scale) {
  using M = MhaTile<T, D>;
  constexpr int VE = M::VE, LR = M::LR, RPP = M::RPP, WIN = M::WIN;
  extern __shared__ __align__(16) unsigned char ring_smem[];
  __shared__ float red_acc[kMhaWarps][D];  // the warps' states
  __shared__ float red_m[kMhaWarps], red_l[kMhaWarps];
  __shared__ float red[kMhaWarps];
  __shared__ float cw[kMhaSplitsMax];      // the merge's weights
  __shared__ float4 red4[kMhaThreads];     // the merge's groups

  const int c = blockIdx.x % splits;
  const int bh = blockIdx.x / splits;  // bi * h + hh
  const int hh = bh % h, bi = bh / h;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int r = tid / LR, sub = tid % LR, e0 = sub * VE;
  uint4 qraw[VE / 8];  // issued beside the length's load
#pragma unroll
  for (int e = 0; e < VE; e += 8)
    qraw[e / 8] = *reinterpret_cast<const uint4*>(q + (size_t)bh * D + e0 + e);
  const int n = min(lengths[bi], L);
  const int p0 = c * chunk, p1 = min(p0 + chunk, n);
  float* ws_acc = ws;
  float* ws_ml = ws + (size_t)b * h * splits * D;
  __nv_bfloat16* orow = o + (size_t)bh * D;

  if (p0 < p1) {  // block-uniform
    // position p of the row sits (first + p) positions into the cache
    const size_t first = ((size_t)layer * b + bi) * L;
    const size_t pstride = (size_t)h * D;
    const T* kb = kc + first * pstride + (size_t)hh * D + e0;
    const T* vb = vc + first * pstride + (size_t)hh * D + e0;
    const float* ksb = M::Q8 ? ks + first * h + hh : nullptr;
    const float* vsb = M::Q8 ? vs + first * h + hh : nullptr;

    // Stage i holds positions p0 + i * WIN + [0, WIN); the thread copies,
    // and later reads, rows r + RPP * u of it. One commit group a stage
    // (empty past the chunk), so every thread counts the same groups.
    const int nsteps = (p1 - p0 + WIN - 1) / WIN;
    auto stage = [&](int i) { return ring_smem + (i % kMhaStages) * M::STAGE; };
    auto issue = [&](int i) {
      if (i < nsteps) {
        T* sk = reinterpret_cast<T*>(stage(i));
        T* sv = sk + WIN * D;
        float* ssc = reinterpret_cast<float*>(sv + WIN * D);
        const int s0 = p0 + i * WIN;
#pragma unroll
        for (int u = 0; u < kMhaRows; ++u) {
          const int j = r + RPP * u, p = s0 + j;
          if (p < p1) {
            ring::cp_async16(sk + j * D + e0, kb + (size_t)p * pstride);
            ring::cp_async16(sv + j * D + e0, vb + (size_t)p * pstride);
            if constexpr (M::Q8) {
              if (sub == 0) ring::cp_async4(ssc + j, ksb + (size_t)p * h);
              if (sub == 1) ring::cp_async4(ssc + WIN + j, vsb + (size_t)p * h);
            }
          }
        }
      }
      ring::commit();
    };
#pragma unroll
    for (int i = 0; i < kMhaStages; ++i) issue(i);
    float qf[VE];  // q * scale, this lane's elements
#pragma unroll
    for (int e = 0; e < VE; e += 8) {
      bf16x8_to_f32(qraw[e / 8], qf + e);
#pragma unroll
      for (int i = 0; i < 8; ++i) qf[e + i] *= scale;
    }

    float m = -INFINITY, l = 0.f, acc[VE];
#pragma unroll
    for (int e = 0; e < VE; ++e) acc[e] = 0.f;
    for (int i = 0; i < nsteps; ++i) {
      ring::wait<kMhaStages - 1>();  // stage i has landed
      if constexpr (M::Q8) __syncwarp();  // and the row's scales
      const T* sk = reinterpret_cast<const T*>(stage(i));
      const T* sv = sk + WIN * D;
      const float* ssc = reinterpret_cast<const float*>(sv + WIN * D);
      const int s0 = p0 + i * WIN;
      float s[kMhaRows];
      float smax = -INFINITY;
#pragma unroll
      for (int u = 0; u < kMhaRows; ++u) {
        const int j = r + RPP * u;
        const bool live = s0 + j < p1;  // the same in the row's LR lanes
        float dot = 0.f;
        if (live) {
          float kf[VE];
          row_to_f32<T>(*reinterpret_cast<const uint4*>(sk + j * D + e0), kf);
#pragma unroll
          for (int e = 0; e < VE; ++e) dot = fmaf(qf[e], kf[e], dot);
        }
#pragma unroll
        for (int off = LR / 2; off > 0; off >>= 1)
          dot += __shfl_xor_sync(0xffffffffu, dot, off);
        s[u] = live ? (M::Q8 ? dot * ssc[j] : dot) : -INFINITY;
        smax = fmaxf(smax, s[u]);
      }
      if (smax > -INFINITY) {  // a live row of this thread in the stage
        const float mn = fmaxf(m, smax);
        const float alpha = merge_weight(m, mn);
        m = mn;
        l *= alpha;
#pragma unroll
        for (int e = 0; e < VE; ++e) acc[e] *= alpha;
#pragma unroll
        for (int u = 0; u < kMhaRows; ++u) {
          const int j = r + RPP * u;
          if (s0 + j < p1) {
            const float w = __expf(s[u] - m);
            l += w;
            const float wv = M::Q8 ? w * ssc[WIN + j] : w;
            float vf[VE];
            row_to_f32<T>(*reinterpret_cast<const uint4*>(sv + j * D + e0), vf);
#pragma unroll
            for (int e = 0; e < VE; ++e) acc[e] = fmaf(wv, vf[e], acc[e]);
          }
        }
      }
      if constexpr (M::Q8) __syncwarp();  // the scales are read before a refill
      issue(i + kMhaStages);  // into the stage just read
    }
    ring::wait<0>();

    // Merge the block's states: the lanes of a warp with the same elements
    // (lane ^ LR, ^ 2 LR, ...), then the warps, in order.
#pragma unroll
    for (int off = LR; off < 32; off <<= 1) {
      const float mo = __shfl_xor_sync(0xffffffffu, m, off);
      const float lo = __shfl_xor_sync(0xffffffffu, l, off);
      const float mn = fmaxf(m, mo);
      const float a = merge_weight(m, mn), bo = merge_weight(mo, mn);
      l = a * l + bo * lo;
#pragma unroll
      for (int e = 0; e < VE; ++e)
        acc[e] = a * acc[e] + bo * __shfl_xor_sync(0xffffffffu, acc[e], off);
      m = mn;
    }
    if (lane < LR) {
#pragma unroll
      for (int e = 0; e < VE; ++e) red_acc[warp][e0 + e] = acc[e];
    }
    if (lane == 0) {
      red_m[warp] = m;
      red_l[warp] = l;
    }
    __syncthreads();
    if (tid < D) {
      float mx = red_m[0];
#pragma unroll
      for (int w = 1; w < kMhaWarps; ++w) mx = fmaxf(mx, red_m[w]);
      float at = 0.f, lt = 0.f;
#pragma unroll
      for (int w = 0; w < kMhaWarps; ++w) {
        const float a = merge_weight(red_m[w], mx);
        at = fmaf(a, red_acc[w][tid], at);
        lt = fmaf(a, red_l[w], lt);
      }
      if (splits == 1) {
        orow[tid] = __float2bfloat16(at / lt);
      } else {
        const size_t part = (size_t)bh * splits + c;
        ws_acc[part * D + tid] = at;
        if (tid == 0) {
          ws_ml[2 * part] = mx;
          ws_ml[2 * part + 1] = lt;
        }
      }
    }
    if (splits == 1) return;
  } else if (splits == 1) {  // an empty row
    for (int t = tid; t < D; t += kMhaThreads) orow[t] = __float2bfloat16(0.f);
    return;
  }

  if (!ring::arrive_last(counters + bh, splits)) return;
  // The last block of the (row, head): its live partials merged in split
  // order. Every live chunk holds a position, so its l >= 1. Thread t
  // takes float4 e4 = t % Q of the splits j = g, g + G, ... (g = t / Q),
  // the first kMhaBatch of them loaded beside the (m, l) pairs, before
  // the weights are known; the G group sums are added in order.
  constexpr int Q = D / 4, G = kMhaThreads / Q, kMhaBatch = 8;
  const int live = (n + chunk - 1) / chunk;
  const int e4 = tid % Q, grp = tid / Q;
  const float4* a4 =
      reinterpret_cast<const float4*>(ws_acc + (size_t)bh * splits * D) + e4;
  float4 av[kMhaBatch];
#pragma unroll
  for (int u = 0; u < kMhaBatch; ++u) {
    const int j = grp + G * u;
    av[u] = j < live ? __ldcg(a4 + (size_t)j * Q) : make_float4(0.f, 0.f, 0.f, 0.f);
  }
  const float2 mlj =
      tid < live ? __ldcg(reinterpret_cast<const float2*>(ws_ml) +
                          (size_t)bh * splits + tid)
                 : make_float2(-INFINITY, 0.f);
  const float mx = mha_block_reduce<true>(mlj.x, red);
  const float wj = tid < live ? __expf(mlj.x - mx) : 0.f;
  cw[tid] = wj;
  const float lt = mha_block_reduce<false>(wj * mlj.y, red);  // also orders cw
  float4 sum = make_float4(0.f, 0.f, 0.f, 0.f);
  auto add = [&](float w, const float4& a) {
    sum.x = fmaf(w, a.x, sum.x);
    sum.y = fmaf(w, a.y, sum.y);
    sum.z = fmaf(w, a.z, sum.z);
    sum.w = fmaf(w, a.w, sum.w);
  };
#pragma unroll
  for (int u = 0; u < kMhaBatch; ++u) {
    const int j = grp + G * u;
    if (j < live) add(cw[j], av[u]);
  }
  for (int j = grp + G * kMhaBatch; j < live; j += G)
    add(cw[j], __ldcg(a4 + (size_t)j * Q));
  red4[tid] = sum;
  __syncthreads();
  if (tid < Q) {
    float4 t = red4[tid];
#pragma unroll
    for (int g = 1; g < G; ++g) {
      const float4 x = red4[g * Q + tid];
      t.x += x.x;
      t.y += x.y;
      t.z += x.z;
      t.w += x.w;
    }
    const float inv = live > 0 ? 1.f / lt : 0.f;
    __nv_bfloat162* o2 = reinterpret_cast<__nv_bfloat162*>(orow) + 2 * tid;
    o2[0] = __floats2bfloat162_rn(t.x * inv, t.y * inv);
    o2[1] = __floats2bfloat162_rn(t.z * inv, t.w * inv);
  }
}

template <typename T, int D>
int launch_mha(const void* q, const void* k, const void* v, const float* ks,
               const float* vs, const int* lengths, void* o, float* ws,
               int* counters, int layer, int b, int L, int h, int chunk,
               int splits, float scale, cudaStream_t stream) {
  auto kern = decode_mha_kernel<T, D>;
  constexpr int smem = MhaTile<T, D>::SMEM;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  kern<<<(unsigned)((size_t)b * h * splits), kMhaThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), ks, vs, lengths,
      static_cast<__nv_bfloat16*>(o), ws, counters, layer, b, L, h, chunk,
      splits, scale);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// Kernels 11 and 10: decode split along the positions (flash-decoding), over
// a flat (b, L, h_kv, D) cache or, through a block table, the paged pool.
// ---------------------------------------------------------------------------
// Replaces video_llava_tpu/ops/attention.py::decode_attention_pallas (body
// _decode_attn_kernel) and, paged (MHA, one head a block),
// decode_attention_mxu_paged (body _decode_attn_mxu_paged_kernel). Query
// head i reads KV head i / group. For row bi and KV head kh, with n =
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

// Kernels 3 and 9. q (b, 1, h, d) bf16; k, v (NL, b, L, h, d), bf16 or int8
// with scales (NL, b, L, h) f32 (a flat (b, L, h, d) cache is NL = 1 at
// layer 0); lengths (b,) int32; o (b, 1, h, d) bf16; ws b * h * splits *
// (2 + d) floats and counters b * h ints at 0 (both unused when splits is
// 1); [0, L) in `splits` chunks of `chunk` positions, splits at most
// kMhaSplitsMax. d in {32, 64, 128} (the wrappers check).
extern "C" int vlt_decode_attention(const void* q, const void* k,
                                    const void* v, const void* ks,
                                    const void* vs, const void* lengths,
                                    void* o, void* ws, void* counters,
                                    int layer, int b, int L, int h, int d,
                                    int int8, int chunk, int splits,
                                    float scale, void* stream) {
  if (chunk <= 0 || splits < 1 || splits > kMhaSplitsMax ||
      (long long)chunk * splits < L ||
      (splits > 1 && (ws == nullptr || counters == nullptr)))
    return (int)cudaErrorInvalidValue;
  const float* ksf = int8 ? static_cast<const float*>(ks) : nullptr;
  const float* vsf = int8 ? static_cast<const float*>(vs) : nullptr;
  const int* len = static_cast<const int*>(lengths);
  float* wsf = static_cast<float*>(ws);
  int* cnt = static_cast<int*>(counters);
  cudaStream_t st = (cudaStream_t)stream;
#define VLT_MHA_ARGS \
  q, k, v, ksf, vsf, len, o, wsf, cnt, layer, b, L, h, chunk, splits, scale, st
  if (int8) {
    if (d == 128) return launch_mha<int8_t, 128>(VLT_MHA_ARGS);
    if (d == 64) return launch_mha<int8_t, 64>(VLT_MHA_ARGS);
    if (d == 32) return launch_mha<int8_t, 32>(VLT_MHA_ARGS);
  } else {
    if (d == 128) return launch_mha<__nv_bfloat16, 128>(VLT_MHA_ARGS);
    if (d == 64) return launch_mha<__nv_bfloat16, 64>(VLT_MHA_ARGS);
    if (d == 32) return launch_mha<__nv_bfloat16, 32>(VLT_MHA_ARGS);
  }
#undef VLT_MHA_ARGS
  return (int)cudaErrorInvalidValue;
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
