// The first, WMMA body of kernels 7 and 8 (csrc/flash_attention.cu), kept
// for the head dims the Hopper body does not take (16, 32, 48, 80, 96, 112,
// 256): 64-row tiles, one block of 4 warps per (head, 64 rows): b*h
// (b*h_kv in the dk/dv kernel) along grid x, whose limit is 2^31 - 1, and
// the tiles along y (at most 65,535, so s up to about 4.2 M), every
// product through WMMA 16x16x16 with scores and probabilities staged in
// shared memory, K/V (or Q/dO) tiles loaded synchronously. The same
// function as the Hopper body (see flash_attention.cu's header); the C
// entries there choose between the two by head dim alone.
//
// Past d 128 (the wrappers pad d in (128, 256] to 256) a block's f32
// accumulators and staging for all d output columns would not fit its
// registers and shared memory, so the output columns split into slabs of
// 128 along grid z: each block computes the scores over the whole d (Q
// K^T, and dO V^T in the backward) and writes its slab of o, dq, or dk
// and dv (the forward reads only its slab of V). The slabs recompute the
// same scores: twice the first products' work at d 256, for a body whose
// tiles fit (forward 158 KB of shared memory, dq 191 KB, dk/dv 201 KB).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <mma.h>
#include <stdint.h>

namespace flash {

constexpr float kSentinel = 1e30f;

struct Shape {
  int b, sq, skv, h, hkv, causal;
  float scale;
};

namespace wmma_body {

using namespace nvcuda;

constexpr int kB = 64;        // rows of a tile: queries or keys
constexpr int kThreads = 128;  // 4 warps x 16 rows

using bf16 = __nv_bfloat16;
using FragA = wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major>;
using FragBRow =
    wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major>;
using FragBCol =
    wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major>;
using FragC = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;

// Output columns a block writes (its slab): all D up to 128, else 128.
template <int D>
constexpr int kCols = D > 128 ? 128 : D;

// Shared-memory pitches: bf16 tiles of D columns, bf16 64-column
// probability tiles, f32 staging wide enough for 64 scores or a slab of
// outputs.
template <int D>
struct Pitch {
  static constexpr int h = D + 8;
  static constexpr int p = kB + 8;
  static constexpr int f = (kCols<D> > kB ? kCols<D> : kB) + 4;
  static constexpr int s = kB + 4;
  static constexpr size_t tile = (size_t)kB * h * 2;
  static constexpr size_t ptile = (size_t)kB * p * 2;
  static constexpr size_t ftile = (size_t)kB * f * 4;
  static constexpr size_t stile = (size_t)kB * s * 4;
};

// Rows [row0, row0 + 64) of one head of a BSHD tensor (rows `stride`
// elements apart) into a padded tile; rows at or past `valid` are zero.
template <int D>
__device__ inline void load_tile(bf16* dst, const bf16* src, size_t stride,
                                 int row0, int valid) {
  constexpr int kVec = D / 8;
  for (int i = threadIdx.x; i < kB * kVec; i += kThreads) {
    const int r = i / kVec, c = (i % kVec) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < valid)
      val = *reinterpret_cast<const uint4*>(src + (size_t)(row0 + r) * stride
                                            + c);
    *reinterpret_cast<uint4*>(dst + r * Pitch<D>::h + c) = val;
  }
}

// out(16 x 64, f32, pitch ldo) = A_w(16 x D) . B^T for B a 64 x D tile:
// this warp's rows of a tile times the transpose of another tile.
template <int D>
__device__ inline void rows_times_tile_t(float* out, int ldo, const bf16* a,
                                         const bf16* b) {
#pragma unroll
  for (int n = 0; n < kB / 16; ++n) {
    FragC acc;
    wmma::fill_fragment(acc, 0.f);
#pragma unroll
    for (int kk = 0; kk < D; kk += 16) {
      FragA fa;
      FragBCol fb;
      wmma::load_matrix_sync(fa, a + kk, Pitch<D>::h);
      wmma::load_matrix_sync(fb, b + n * 16 * Pitch<D>::h + kk, Pitch<D>::h);
      wmma::mma_sync(acc, fa, fb, acc);
    }
    wmma::store_matrix_sync(out + n * 16, acc, ldo, wmma::mem_row_major);
  }
}

// acc[n] += P_w(16 x 64, bf16, pitch Pitch::p) . T(64 x N columns of a
// tile of pitch LD), n over the N / 16 column blocks.
template <int N, int LD>
__device__ inline void accumulate(FragC* acc, const bf16* p, const bf16* t) {
#pragma unroll
  for (int n = 0; n < N / 16; ++n) {
#pragma unroll
    for (int kk = 0; kk < kB; kk += 16) {
      FragA fa;
      FragBRow fb;
      wmma::load_matrix_sync(fa, p + kk, Pitch<N>::p);
      wmma::load_matrix_sync(fb, t + kk * LD + n * 16, LD);
      wmma::mma_sync(acc[n], fa, fb, acc[n]);
    }
  }
}

// Store scale * acc (this warp's 16 x N rows) as bf16 rows of a BSHD head
// (N columns from dst on): staged through `stage` (f32, pitch Pitch::f);
// rows at or past `valid` are not written. Two lanes per row, each half of
// the columns.
template <int N>
__device__ inline void store_rows(FragC* acc, float scale, float* stage,
                                  bf16* dst, size_t stride, int row0,
                                  int valid) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
#pragma unroll
  for (int n = 0; n < N / 16; ++n) {
#pragma unroll
    for (int i = 0; i < acc[n].num_elements; ++i) acc[n].x[i] *= scale;
    wmma::store_matrix_sync(stage + warp * 16 * Pitch<N>::f + n * 16, acc[n],
                            Pitch<N>::f, wmma::mem_row_major);
  }
  __syncwarp();
  const int row = warp * 16 + (lane >> 1), d0 = (lane & 1) * (N / 2);
  if (row0 + row < valid) {
    bf16* out = dst + (size_t)(row0 + row) * stride;
    for (int c = d0; c < d0 + N / 2; ++c)
      out[c] = __float2bfloat16(stage[row * Pitch<N>::f + c]);
  }
  __syncwarp();
}

__device__ inline bool visible(const Shape& sh, int qi, int kj) {
  return kj < sh.skv && (!sh.causal || kj <= qi + sh.skv - sh.sq);
}

// Key tiles a query tile starting at q0 reads: all, or (causal) up to the
// key its last real row sees.
__device__ inline int key_tiles(const Shape& sh, int q0) {
  int n = (sh.skv + kB - 1) / kB;
  if (sh.causal) {
    const int last = min(q0 + kB, sh.sq) - 1 + sh.skv - sh.sq;
    n = min(n, last / kB + 1);
  }
  return n;
}

// ---------------------------------------------------------------------------
// Kernel 7: forward
// ---------------------------------------------------------------------------

template <int D>
struct FwdSmem {
  using P = Pitch<D>;
  static constexpr int ldo = kCols<D> + 4;
  static constexpr size_t q = 0, k = q + P::tile, v = k + P::tile,
                          p = v + Pitch<kCols<D>>::tile, f = p + P::ptile,
                          o = f + P::ftile,
                          bytes = o + (size_t)kB * ldo * 4;
};

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, bf16* __restrict__ o,
                 float* __restrict__ lse, Shape sh) {
  using P = Pitch<D>;
  using L = FwdSmem<D>;
  constexpr int DO = kCols<D>;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* qs = reinterpret_cast<bf16*>(smem + L::q);
  bf16* ks = reinterpret_cast<bf16*>(smem + L::k);
  bf16* vs = reinterpret_cast<bf16*>(smem + L::v);
  bf16* ps = reinterpret_cast<bf16*>(smem + L::p);
  float* fs = reinterpret_cast<float*>(smem + L::f);
  float* os = reinterpret_cast<float*>(smem + L::o);

  const int bi = blockIdx.x / sh.h, hi = blockIdx.x % sh.h;
  const int kvh = hi / (sh.h / sh.hkv);
  const size_t qstride = (size_t)sh.h * D, kstride = (size_t)sh.hkv * D;
  const size_t qhead = (size_t)bi * sh.sq * qstride + (size_t)hi * D;
  const size_t khead = (size_t)bi * sh.skv * kstride + (size_t)kvh * D;
  const int q0 = blockIdx.y * kB;
  const int col0 = blockIdx.z * DO;  // this block's slab of o (and V)
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  load_tile<D>(qs, q + qhead, qstride, q0, sh.sq);
  for (int i = threadIdx.x; i < kB * L::ldo; i += kThreads) os[i] = 0.f;

  // Softmax ownership: two lanes per row, each half of the columns.
  const int row = warp * 16 + (lane >> 1);
  const int half = lane & 1;
  const int qi = q0 + row;
  float m = -INFINITY, l = 0.f;

  const int num_kb = key_tiles(sh, q0);
  for (int kb = 0; kb < num_kb; ++kb) {
    __syncthreads();  // the previous tile's K/V fully consumed
    load_tile<D>(ks, k + khead, kstride, kb * kB, sh.skv);
    load_tile<DO>(vs, v + khead + col0, kstride, kb * kB, sh.skv);
    __syncthreads();

    rows_times_tile_t<D>(fs + warp * 16 * P::f, P::f,
                         qs + warp * 16 * P::h, ks);
    __syncwarp();

    // Online softmax over this lane's half row, f32. Key 0 is seen by
    // every row (sq <= skv under the causal mask), so m is finite from
    // the first tile on. P is rounded to bf16 for the second product.
    float* srow = fs + row * P::f;
    const int c0 = half * (kB / 2);
    float mx = -INFINITY;
    for (int c = c0; c < c0 + kB / 2; ++c) {
      const float x = visible(sh, qi, kb * kB + c) ? srow[c] * sh.scale
                                                    : -INFINITY;
      srow[c] = x;
      mx = fmaxf(mx, x);
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    const float m_new = fmaxf(m, mx);
    const float alpha = __expf(m - m_new);
    float sum = 0.f;
    for (int c = c0; c < c0 + kB / 2; ++c) {
      const float pv = __expf(srow[c] - m_new);
      ps[row * P::p + c] = __float2bfloat16(pv);
      sum += pv;
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    l = alpha * l + sum;
    m = m_new;
    __syncwarp();

    // PV(16 x DO) = P_w V, staged in the (now free) score rows.
#pragma unroll
    for (int n = 0; n < DO / 16; ++n) {
      FragC acc;
      wmma::fill_fragment(acc, 0.f);
#pragma unroll
      for (int kk = 0; kk < kB; kk += 16) {
        FragA fa;
        FragBRow fb;
        wmma::load_matrix_sync(fa, ps + warp * 16 * P::p + kk, P::p);
        wmma::load_matrix_sync(fb, vs + kk * Pitch<DO>::h + n * 16,
                               Pitch<DO>::h);
        wmma::mma_sync(acc, fa, fb, acc);
      }
      wmma::store_matrix_sync(fs + warp * 16 * P::f + n * 16, acc, P::f,
                              wmma::mem_row_major);
    }
    __syncwarp();
    const int d0 = half * (DO / 2);
    for (int c = d0; c < d0 + DO / 2; ++c)
      os[row * L::ldo + c] = alpha * os[row * L::ldo + c] + srow[c];
    __syncwarp();
  }

  if (qi < sh.sq) {
    const float lc = fmaxf(l, 1e-30f);
    const float inv = 1.f / lc;
    bf16* orow = o + qhead + (size_t)qi * qstride + col0;
    const int d0 = half * (DO / 2);
    for (int c = d0; c < d0 + DO / 2; ++c)
      orow[c] = __float2bfloat16(os[row * L::ldo + c] * inv);
    if (half == 0 && blockIdx.z == 0) {
      const float x = m + logf(lc);
      lse[(size_t)blockIdx.x * sh.sq + qi] = isfinite(x) ? x : kSentinel;
    }
  }
}

// ---------------------------------------------------------------------------
// Kernel 8: backward, dq (one block per 64 query rows of a head, a loop
// over key tiles)
// ---------------------------------------------------------------------------

template <int D>
struct DqSmem {
  using P = Pitch<D>;
  static constexpr size_t q = 0, dout = q + P::tile, k = dout + P::tile,
                          v = k + P::tile, ds = v + P::tile,
                          f = ds + P::ptile, dp = f + P::ftile,
                          bytes = dp + P::stile;
};

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, const bf16* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, bf16* __restrict__ dq,
                    Shape sh) {
  using P = Pitch<D>;
  using L = DqSmem<D>;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* qs = reinterpret_cast<bf16*>(smem + L::q);
  bf16* dos = reinterpret_cast<bf16*>(smem + L::dout);
  bf16* ks = reinterpret_cast<bf16*>(smem + L::k);
  bf16* vs = reinterpret_cast<bf16*>(smem + L::v);
  bf16* dss = reinterpret_cast<bf16*>(smem + L::ds);
  float* fs = reinterpret_cast<float*>(smem + L::f);
  float* dps = reinterpret_cast<float*>(smem + L::dp);

  const int bi = blockIdx.x / sh.h, hi = blockIdx.x % sh.h;
  const int kvh = hi / (sh.h / sh.hkv);
  const size_t qstride = (size_t)sh.h * D, kstride = (size_t)sh.hkv * D;
  const size_t qhead = (size_t)bi * sh.sq * qstride + (size_t)hi * D;
  const size_t khead = (size_t)bi * sh.skv * kstride + (size_t)kvh * D;
  constexpr int DO = kCols<D>;
  const int q0 = blockIdx.y * kB;
  const int col0 = blockIdx.z * DO;  // this block's slab of dq
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  load_tile<D>(qs, q + qhead, qstride, q0, sh.sq);
  load_tile<D>(dos, dout + qhead, qstride, q0, sh.sq);

  const int row = warp * 16 + (lane >> 1);
  const int half = lane & 1;
  const int qi = q0 + row;
  const size_t stat = (size_t)blockIdx.x * sh.sq + qi;
  const float lse_r = qi < sh.sq ? lse[stat] : 0.f;
  const float delta_r = qi < sh.sq ? delta[stat] : 0.f;

  FragC acc[DO / 16];
#pragma unroll
  for (int n = 0; n < DO / 16; ++n) wmma::fill_fragment(acc[n], 0.f);

  const int num_kb = key_tiles(sh, q0);
  for (int kb = 0; kb < num_kb; ++kb) {
    __syncthreads();
    load_tile<D>(ks, k + khead, kstride, kb * kB, sh.skv);
    load_tile<D>(vs, v + khead, kstride, kb * kB, sh.skv);
    __syncthreads();

    rows_times_tile_t<D>(fs + warp * 16 * P::f, P::f,
                         qs + warp * 16 * P::h, ks);
    rows_times_tile_t<D>(dps + warp * 16 * P::s, P::s,
                         dos + warp * 16 * P::h, vs);
    __syncwarp();

    // dS = P (dP - D), P recomputed from the saved logsumexp.
    const int c0 = half * (kB / 2);
    for (int c = c0; c < c0 + kB / 2; ++c) {
      const float pv = visible(sh, qi, kb * kB + c)
                           ? __expf(fs[row * P::f + c] * sh.scale - lse_r)
                           : 0.f;
      dss[row * P::p + c] =
          __float2bfloat16(pv * (dps[row * P::s + c] - delta_r));
    }
    __syncwarp();
    accumulate<DO, P::h>(acc, dss + warp * 16 * P::p, ks + col0);  // dS K
  }
  store_rows<DO>(acc, sh.scale, fs, dq + qhead + col0, qstride, q0, sh.sq);
}

// ---------------------------------------------------------------------------
// Kernel 8: backward, dk and dv (one block per 64 keys of a kv head, a loop
// over the group's query heads and the query tiles that see those keys)
// ---------------------------------------------------------------------------

template <int D>
struct DkvSmem {
  using P = Pitch<D>;
  static constexpr size_t k = 0, v = k + P::tile, q = v + P::tile,
                          dout = q + P::tile, pt = dout + P::tile,
                          dst = pt + P::ptile, f = dst + P::ptile,
                          dp = f + P::ftile, lse = dp + P::stile,
                          delta = lse + kB * 4, bytes = delta + kB * 4;
};

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, const bf16* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, bf16* __restrict__ dk,
                     bf16* __restrict__ dv, Shape sh) {
  using P = Pitch<D>;
  using L = DkvSmem<D>;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* ks = reinterpret_cast<bf16*>(smem + L::k);
  bf16* vs = reinterpret_cast<bf16*>(smem + L::v);
  bf16* qs = reinterpret_cast<bf16*>(smem + L::q);
  bf16* dos = reinterpret_cast<bf16*>(smem + L::dout);
  bf16* pts = reinterpret_cast<bf16*>(smem + L::pt);
  bf16* dsts = reinterpret_cast<bf16*>(smem + L::dst);
  float* fs = reinterpret_cast<float*>(smem + L::f);
  float* dps = reinterpret_cast<float*>(smem + L::dp);
  float* lses = reinterpret_cast<float*>(smem + L::lse);
  float* deltas = reinterpret_cast<float*>(smem + L::delta);

  const int group = sh.h / sh.hkv;
  const int bi = blockIdx.x / sh.hkv, kvh = blockIdx.x % sh.hkv;
  const size_t qstride = (size_t)sh.h * D, kstride = (size_t)sh.hkv * D;
  const size_t khead = (size_t)bi * sh.skv * kstride + (size_t)kvh * D;
  constexpr int DO = kCols<D>;
  const int k0 = blockIdx.y * kB;
  const int col0 = blockIdx.z * DO;  // this block's slab of dk and dv
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  load_tile<D>(ks, k + khead, kstride, k0, sh.skv);
  load_tile<D>(vs, v + khead, kstride, k0, sh.skv);

  // This lane's key row of S^T, and half of the 64 query columns.
  const int row = warp * 16 + (lane >> 1);
  const int half = lane & 1;
  const int kj = k0 + row;

  FragC dk_acc[DO / 16], dv_acc[DO / 16];
#pragma unroll
  for (int n = 0; n < DO / 16; ++n) {
    wmma::fill_fragment(dk_acc[n], 0.f);
    wmma::fill_fragment(dv_acc[n], 0.f);
  }

  const int num_qb = (sh.sq + kB - 1) / kB;
  // the first query row that sees key k0: i >= k0 - (skv - sq)
  const int start_qb =
      sh.causal ? max(k0 - (sh.skv - sh.sq), 0) / kB : 0;
  for (int g = 0; g < group; ++g) {
    const int hi = kvh * group + g;
    const size_t qhead = (size_t)bi * sh.sq * qstride + (size_t)hi * D;
    const size_t stat = ((size_t)bi * sh.h + hi) * sh.sq;
    for (int qb = start_qb; qb < num_qb; ++qb) {
      const int q0 = qb * kB;
      __syncthreads();  // the previous tile's Q/dO and statistics consumed
      load_tile<D>(qs, q + qhead, qstride, q0, sh.sq);
      load_tile<D>(dos, dout + qhead, qstride, q0, sh.sq);
      if (threadIdx.x < kB) {
        const int qi = q0 + threadIdx.x;
        lses[threadIdx.x] = qi < sh.sq ? lse[stat + qi] : 0.f;
        deltas[threadIdx.x] = qi < sh.sq ? delta[stat + qi] : 0.f;
      }
      __syncthreads();

      // S^T = K_w Q^T and dP^T = V_w dO^T for this warp's 16 keys.
      rows_times_tile_t<D>(fs + warp * 16 * P::f, P::f,
                           ks + warp * 16 * P::h, qs);
      rows_times_tile_t<D>(dps + warp * 16 * P::s, P::s,
                           vs + warp * 16 * P::h, dos);
      __syncwarp();

      const int c0 = half * (kB / 2);
      for (int c = c0; c < c0 + kB / 2; ++c) {
        const int qi = q0 + c;
        const float pv =
            (qi < sh.sq && visible(sh, qi, kj))
                ? __expf(fs[row * P::f + c] * sh.scale - lses[c])
                : 0.f;
        pts[row * P::p + c] = __float2bfloat16(pv);
        dsts[row * P::p + c] =
            __float2bfloat16(pv * (dps[row * P::s + c] - deltas[c]));
      }
      __syncwarp();
      // dv += P^T dO, dk += dS^T Q (this block's slab)
      accumulate<DO, P::h>(dv_acc, pts + warp * 16 * P::p, dos + col0);
      accumulate<DO, P::h>(dk_acc, dsts + warp * 16 * P::p, qs + col0);
    }
  }
  store_rows<DO>(dk_acc, sh.scale, fs, dk + khead + col0, kstride, k0,
                 sh.skv);
  store_rows<DO>(dv_acc, 1.f, fs, dv + khead + col0, kstride, k0, sh.skv);
}

// ---------------------------------------------------------------------------
// Launchers
// ---------------------------------------------------------------------------

template <typename Kernel>
cudaError_t prepare(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

template <int D>
int launch_fwd(const void* q, const void* k, const void* v, void* o,
               void* lse, const Shape& sh, cudaStream_t stream) {
  const size_t bytes = FwdSmem<D>::bytes;
  cudaError_t err = prepare(flash_fwd_kernel<D>, bytes);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(sh.b * sh.h, (sh.sq + kB - 1) / kB, D / kCols<D>);
  flash_fwd_kernel<D><<<grid, kThreads, bytes, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(o),
      static_cast<float*>(lse), sh);
  return (int)cudaGetLastError();
}

template <int D>
int launch_dq(const void* q, const void* k, const void* v, const void* dout,
              const void* lse, const void* delta, void* dq, const Shape& sh,
              cudaStream_t stream) {
  const size_t bytes = DqSmem<D>::bytes;
  cudaError_t err = prepare(flash_bwd_dq_kernel<D>, bytes);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(sh.b * sh.h, (sh.sq + kB - 1) / kB, D / kCols<D>);
  flash_bwd_dq_kernel<D><<<grid, kThreads, bytes, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<bf16*>(dq), sh);
  return (int)cudaGetLastError();
}

template <int D>
int launch_dkv(const void* q, const void* k, const void* v, const void* dout,
               const void* lse, const void* delta, void* dk, void* dv,
               const Shape& sh, cudaStream_t stream) {
  const size_t bytes = DkvSmem<D>::bytes;
  cudaError_t err = prepare(flash_bwd_dkv_kernel<D>, bytes);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(sh.b * sh.hkv, (sh.skv + kB - 1) / kB, D / kCols<D>);
  flash_bwd_dkv_kernel<D><<<grid, kThreads, bytes, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<bf16*>(dk), static_cast<bf16*>(dv), sh);
  return (int)cudaGetLastError();
}

}  // namespace wmma_body
}  // namespace flash
