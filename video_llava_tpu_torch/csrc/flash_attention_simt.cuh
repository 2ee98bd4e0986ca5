// A SIMT body of kernels 7 and 8 (flash forward, dq, dk/dv) for operands of
// type T, bf16 or f32, with every product and the softmax in f32 FMAs.
//
// Replaces video_llava_tpu/ops/attention.py::_flash_forward (kernel 7) and
// ::_flash_backward (kernel 8) where the other bodies do not reach:
//   * kernel 8 on f32 operands at every head dim (flash_attention_f32.cu's
//     vlt_flash_bwd_dq_f32 and vlt_flash_bwd_dkv_f32): the JAX package's
//     backward takes f32 operands with f32 products;
//   * kernels 7 and 8 past head dim 256, bf16 and f32 (the wrappers pad d
//     to a multiple of 128 there), which the JAX package's Pallas body
//     takes for any d % 8 == 0.
// The function is flash_attention.cu's (see its header): p = exp(s * scale
// - lse) recomputed under the same causal or kv-length mask, D = rowsum(dO
// o) from the caller, dS = p (dP - D), dq = scale dS K, dk = scale dS^T Q
// and dv = p^T dO per query head, summed over each kv head's group inside
// the block; outputs in T. P stays f32 for the second product, as the f32
// Pallas body keeps it (the bf16 Pallas body rounds it to bf16: this body
// is closer to the plain f32 version than that).
//
// The design, chosen to be simple and right at any d: a block of 256
// threads (16 x 16) owns 64 rows (queries; keys in the dk/dv kernel) of
// one head and a slab of up to 128 output columns (grid z; slab width
// 16 * NJ). The scores of a 64 x 64 tile accumulate over d in chunks of 32
// columns: each chunk of both operands is loaded into shared memory as
// f32 (a pitch of 33 floats, so a warp's reads are broadcasts or distinct
// banks), and each thread keeps 4 x 4 scores in registers (rows ty + 16i,
// columns tx + 16j). The tile's probabilities (or dS) go to shared memory
// and the slab's 64 x slab outputs accumulate in registers, 4 x NJ a
// thread, against a slab of V (dO and Q, or K) loaded whole. So shared
// memory and registers do not grow with d: a wider d only takes more
// chunks, and more slabs, each recomputing the scores (at d 512, four
// times the first products' work). Loads are scalar and synchronous.
//
// What bounds it: operations, at the f32 FMA rate (67 TFLOP/s dense) at
// best; the tensor cores are not used.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace flash_simt {

constexpr int kB = 64;          // rows of a tile
constexpr int kThreads = 256;   // 16 x 16
constexpr int kC = 32;          // columns of a chunk of the first products
constexpr int kPc = kC + 1;     // chunk pitch (floats)
constexpr int kPs = kB + 1;     // score tile pitch
constexpr float kSentinel = 1e30f;

struct Shape {
  int b, sq, skv, h, hkv, d, causal;
  float scale;
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ bool visible(const Shape& sh, int qi, int kj) {
  return kj < sh.skv && (!sh.causal || kj <= qi + sh.skv - sh.sq);
}

// Key tiles a query tile starting at q0 reads: all, or (causal) up to the
// key its last real row sees.
__device__ __forceinline__ int key_tiles(const Shape& sh, int q0) {
  int n = (sh.skv + kB - 1) / kB;
  if (sh.causal) {
    const int last = min(q0 + kB, sh.sq) - 1 + sh.skv - sh.sq;
    n = min(n, last / kB + 1);
  }
  return n;
}

// dst[r][c] (pitch `pitch`, f32) = src[row0 + r][col0 + c] for 64 rows and
// `cols` columns of one head of a BSHD tensor (rows `stride` elements
// apart); rows at or past `rows` and columns at or past `d` are zero.
template <typename T>
__device__ __forceinline__ void load(float* dst, int pitch, const T* src,
                                     size_t stride, int row0, int rows,
                                     int col0, int cols, int d) {
  for (int e = threadIdx.x; e < kB * cols; e += kThreads) {
    const int r = e / cols, c = e % cols;
    float x = 0.f;
    if (row0 + r < rows && col0 + c < d)
      x = to_f32(src[(size_t)(row0 + r) * stride + col0 + c]);
    dst[r * pitch + c] = x;
  }
}

// s[i][j] += sum_c a[ty + 16i][c] b[tx + 16j][c] over a chunk.
__device__ __forceinline__ void chunk_product(float (&s)[4][4],
                                              const float* a,
                                              const float* b) {
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
#pragma unroll 8
  for (int c = 0; c < kC; ++c) {
    float av[4], bv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) av[i] = a[(ty + 16 * i) * kPc + c];
#pragma unroll
    for (int j = 0; j < 4; ++j) bv[j] = b[(tx + 16 * j) * kPc + c];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = fmaf(av[i], bv[j], s[i][j]);
  }
}

// acc[i][j] += sum_k p[ty + 16i][k] t[k][tx + 16j] over a 64-row tile.
template <int NJ>
__device__ __forceinline__ void slab_product(float (&acc)[4][NJ],
                                             const float* p, const float* t,
                                             int pitch) {
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
#pragma unroll 4
  for (int k = 0; k < kB; ++k) {
    float pv[4], tv[NJ];
#pragma unroll
    for (int i = 0; i < 4; ++i) pv[i] = p[(ty + 16 * i) * kPs + k];
#pragma unroll
    for (int j = 0; j < NJ; ++j) tv[j] = t[k * pitch + tx + 16 * j];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < NJ; ++j) acc[i][j] = fmaf(pv[i], tv[j], acc[i][j]);
  }
}

// Store scale * acc rows [row0, row0 + 64) of the slab at col0 into one head
// of a BSHD tensor; rows past `rows` and columns past d are not written.
template <typename T, int NJ>
__device__ __forceinline__ void store(const float (&acc)[4][NJ], float scale,
                                      T* dst, size_t stride, int row0,
                                      int rows, int col0, int d) {
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = row0 + ty + 16 * i;
    if (r >= rows) continue;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int c = col0 + tx + 16 * j;
      if (c < d) dst[(size_t)r * stride + c] = from_f32<T>(acc[i][j] * scale);
    }
  }
}

template <int NJ>
struct Smem {
  static constexpr int slab = 16 * NJ;
  static constexpr int pt = slab;  // slab tile pitch (floats)
  static constexpr size_t chunk = (size_t)kB * kPc;
  static constexpr size_t score = (size_t)kB * kPs;
  static constexpr size_t tile = (size_t)kB * pt;
  // forward: two chunks, V's slab, P, and m, l, alpha a row
  static constexpr size_t fwd = (2 * chunk + tile + score + 3 * kB) * 4;
  // dq: four chunks, K's slab, dS, lse and D a row
  static constexpr size_t dq = (4 * chunk + tile + score + 2 * kB) * 4;
  // dk/dv: four chunks, Q's and dO's slabs, P^T, dS^T, lse and D a query
  static constexpr size_t dkv =
      (4 * chunk + 2 * tile + 2 * score + 2 * kB) * 4;
};

// ---------------------------------------------------------------------------
// Kernel 7: forward. Block (b*h, query tile, slab).
// ---------------------------------------------------------------------------

template <typename T, int NJ>
__global__ void __launch_bounds__(kThreads)
fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
           const T* __restrict__ v, T* __restrict__ o,
           float* __restrict__ lse, Shape sh) {
  using L = Smem<NJ>;
  extern __shared__ __align__(16) float sm[];
  float* qc = sm;
  float* kc = qc + L::chunk;
  float* vs = kc + L::chunk;
  float* ps = vs + L::tile;
  float* ms = ps + L::score;
  float* ls = ms + kB;
  float* as = ls + kB;

  const int d = sh.d;
  const int bi = blockIdx.x / sh.h, hi = blockIdx.x % sh.h;
  const int kvh = hi / (sh.h / sh.hkv);
  const size_t qstride = (size_t)sh.h * d, kstride = (size_t)sh.hkv * d;
  const size_t qhead = (size_t)bi * sh.sq * qstride + (size_t)hi * d;
  const size_t khead = (size_t)bi * sh.skv * kstride + (size_t)kvh * d;
  const int q0 = blockIdx.y * kB;
  const int col0 = blockIdx.z * L::slab;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;

  if (threadIdx.x < kB) {
    ms[threadIdx.x] = -INFINITY;
    ls[threadIdx.x] = 0.f;
  }
  float acc[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;

  const int num_kb = key_tiles(sh, q0);
  for (int kb = 0; kb < num_kb; ++kb) {
    const int k0 = kb * kB;
    float s[4][4] = {};
    for (int c0 = 0; c0 < d; c0 += kC) {
      __syncthreads();  // the previous chunk (and tile) fully consumed
      load(qc, kPc, q + qhead, qstride, q0, sh.sq, c0, kC, d);
      load(kc, kPc, k + khead, kstride, k0, sh.skv, c0, kC, d);
      __syncthreads();
      chunk_product(s, qc, kc);
    }
    load(vs, L::pt, v + khead, kstride, k0, sh.skv, col0, L::slab, d);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = ty + 16 * i, c = tx + 16 * j;
        ps[r * kPs + c] =
            visible(sh, q0 + r, k0 + c) ? s[i][j] * sh.scale : -INFINITY;
      }
    __syncthreads();

    // Online softmax: 4 lanes a row, 16 columns each.
    {
      const int row = threadIdx.x / 4, part = threadIdx.x % 4;
      float* srow = ps + row * kPs + part * 16;
      float mx = -INFINITY;
#pragma unroll
      for (int c = 0; c < 16; ++c) mx = fmaxf(mx, srow[c]);
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_old = ms[row];
      const float m_new = fmaxf(m_old, mx);
      const float alpha = m_new == -INFINITY ? 1.f : expf(m_old - m_new);
      float sum = 0.f;
#pragma unroll
      for (int c = 0; c < 16; ++c) {
        const float p = m_new == -INFINITY ? 0.f : expf(srow[c] - m_new);
        srow[c] = p;
        sum += p;
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      __syncwarp();
      if (part == 0) {
        ls[row] = alpha * ls[row] + sum;
        ms[row] = m_new;
        as[row] = alpha;
      }
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float alpha = as[ty + 16 * i];
#pragma unroll
      for (int j = 0; j < NJ; ++j) acc[i][j] *= alpha;
    }
    slab_product(acc, ps, vs, L::pt);
  }

  __syncthreads();
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i, qi = q0 + r;
    if (qi >= sh.sq) continue;
    const float inv = 1.f / fmaxf(ls[r], 1e-30f);
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int c = col0 + tx + 16 * j;
      if (c < d)
        o[qhead + (size_t)qi * qstride + c] = from_f32<T>(acc[i][j] * inv);
    }
  }
  if (blockIdx.z == 0 && threadIdx.x < kB && q0 + threadIdx.x < sh.sq) {
    const float x = ms[threadIdx.x] + logf(fmaxf(ls[threadIdx.x], 1e-30f));
    lse[(size_t)blockIdx.x * sh.sq + q0 + threadIdx.x] =
        isfinite(x) ? x : kSentinel;
  }
}

// ---------------------------------------------------------------------------
// Kernel 8: dq. Block (b*h, query tile, slab), a loop over key tiles.
// ---------------------------------------------------------------------------

template <typename T, int NJ>
__global__ void __launch_bounds__(kThreads)
dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
          const T* __restrict__ v, const T* __restrict__ dout,
          const float* __restrict__ lse, const float* __restrict__ delta,
          T* __restrict__ dq, Shape sh) {
  using L = Smem<NJ>;
  extern __shared__ __align__(16) float sm[];
  float* qc = sm;
  float* kc = qc + L::chunk;
  float* dc = kc + L::chunk;
  float* vc = dc + L::chunk;
  float* ks = vc + L::chunk;
  float* dss = ks + L::tile;
  float* lses = dss + L::score;
  float* deltas = lses + kB;

  const int d = sh.d;
  const int bi = blockIdx.x / sh.h, hi = blockIdx.x % sh.h;
  const int kvh = hi / (sh.h / sh.hkv);
  const size_t qstride = (size_t)sh.h * d, kstride = (size_t)sh.hkv * d;
  const size_t qhead = (size_t)bi * sh.sq * qstride + (size_t)hi * d;
  const size_t khead = (size_t)bi * sh.skv * kstride + (size_t)kvh * d;
  const int q0 = blockIdx.y * kB;
  const int col0 = blockIdx.z * L::slab;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;

  if (threadIdx.x < kB) {
    const int qi = q0 + threadIdx.x;
    const size_t stat = (size_t)blockIdx.x * sh.sq + qi;
    lses[threadIdx.x] = qi < sh.sq ? lse[stat] : 0.f;
    deltas[threadIdx.x] = qi < sh.sq ? delta[stat] : 0.f;
  }
  float acc[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;

  const int num_kb = key_tiles(sh, q0);
  for (int kb = 0; kb < num_kb; ++kb) {
    const int k0 = kb * kB;
    float s[4][4] = {}, dp[4][4] = {};
    for (int c0 = 0; c0 < d; c0 += kC) {
      __syncthreads();
      load(qc, kPc, q + qhead, qstride, q0, sh.sq, c0, kC, d);
      load(kc, kPc, k + khead, kstride, k0, sh.skv, c0, kC, d);
      load(dc, kPc, dout + qhead, qstride, q0, sh.sq, c0, kC, d);
      load(vc, kPc, v + khead, kstride, k0, sh.skv, c0, kC, d);
      __syncthreads();
      chunk_product(s, qc, kc);
      chunk_product(dp, dc, vc);
    }
    load(ks, L::pt, k + khead, kstride, k0, sh.skv, col0, L::slab, d);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = ty + 16 * i, c = tx + 16 * j, qi = q0 + r;
        const float p = qi < sh.sq && visible(sh, qi, k0 + c)
                            ? expf(s[i][j] * sh.scale - lses[r])
                            : 0.f;
        dss[r * kPs + c] = p * (dp[i][j] - deltas[r]);
      }
    __syncthreads();
    slab_product(acc, dss, ks, L::pt);  // dS K
  }
  store<T, NJ>(acc, sh.scale, dq + qhead, qstride, q0, sh.sq, col0, d);
}

// ---------------------------------------------------------------------------
// Kernel 8: dk and dv. Block (b*h_kv, key tile, slab), a loop over the
// group's query heads and the query tiles that see those keys.
// ---------------------------------------------------------------------------

template <typename T, int NJ>
__global__ void __launch_bounds__(kThreads)
dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
           const T* __restrict__ v, const T* __restrict__ dout,
           const float* __restrict__ lse, const float* __restrict__ delta,
           T* __restrict__ dk, T* __restrict__ dv, Shape sh) {
  using L = Smem<NJ>;
  extern __shared__ __align__(16) float sm[];
  float* kc = sm;
  float* vc = kc + L::chunk;
  float* qc = vc + L::chunk;
  float* dc = qc + L::chunk;
  float* qs = dc + L::chunk;
  float* dos = qs + L::tile;
  float* pts = dos + L::tile;
  float* dsts = pts + L::score;
  float* lses = dsts + L::score;
  float* deltas = lses + kB;

  const int d = sh.d;
  const int group = sh.h / sh.hkv;
  const int bi = blockIdx.x / sh.hkv, kvh = blockIdx.x % sh.hkv;
  const size_t qstride = (size_t)sh.h * d, kstride = (size_t)sh.hkv * d;
  const size_t khead = (size_t)bi * sh.skv * kstride + (size_t)kvh * d;
  const int k0 = blockIdx.y * kB;
  const int col0 = blockIdx.z * L::slab;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;

  float dk_acc[4][NJ], dv_acc[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) dk_acc[i][j] = dv_acc[i][j] = 0.f;

  const int num_qb = (sh.sq + kB - 1) / kB;
  // the first query row that sees key k0: i >= k0 - (skv - sq)
  const int start_qb = sh.causal ? max(k0 - (sh.skv - sh.sq), 0) / kB : 0;
  for (int g = 0; g < group; ++g) {
    const int hi = kvh * group + g;
    const size_t qhead = (size_t)bi * sh.sq * qstride + (size_t)hi * d;
    const size_t stat = ((size_t)bi * sh.h + hi) * sh.sq;
    for (int qb = start_qb; qb < num_qb; ++qb) {
      const int q0 = qb * kB;
      // S^T (keys x queries) and dP^T over the chunks of d
      float st[4][4] = {}, dpt[4][4] = {};
      for (int c0 = 0; c0 < d; c0 += kC) {
        __syncthreads();
        load(kc, kPc, k + khead, kstride, k0, sh.skv, c0, kC, d);
        load(vc, kPc, v + khead, kstride, k0, sh.skv, c0, kC, d);
        load(qc, kPc, q + qhead, qstride, q0, sh.sq, c0, kC, d);
        load(dc, kPc, dout + qhead, qstride, q0, sh.sq, c0, kC, d);
        __syncthreads();
        chunk_product(st, kc, qc);
        chunk_product(dpt, vc, dc);
      }
      load(qs, L::pt, q + qhead, qstride, q0, sh.sq, col0, L::slab, d);
      load(dos, L::pt, dout + qhead, qstride, q0, sh.sq, col0, L::slab, d);
      if (threadIdx.x < kB) {
        const int qi = q0 + threadIdx.x;
        lses[threadIdx.x] = qi < sh.sq ? lse[stat + qi] : 0.f;
        deltas[threadIdx.x] = qi < sh.sq ? delta[stat + qi] : 0.f;
      }
      __syncthreads();
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int r = ty + 16 * i, c = tx + 16 * j, qi = q0 + c;
          const float p = qi < sh.sq && visible(sh, qi, k0 + r)
                              ? expf(st[i][j] * sh.scale - lses[c])
                              : 0.f;
          pts[r * kPs + c] = p;
          dsts[r * kPs + c] = p * (dpt[i][j] - deltas[c]);
        }
      __syncthreads();
      slab_product(dv_acc, pts, dos, L::pt);  // P^T dO
      slab_product(dk_acc, dsts, qs, L::pt);  // dS^T Q
    }
  }
  store<T, NJ>(dk_acc, sh.scale, dk + khead, kstride, k0, sh.skv, col0, d);
  store<T, NJ>(dv_acc, 1.f, dv + khead, kstride, k0, sh.skv, col0, d);
}

// ---------------------------------------------------------------------------
// Launchers: slabs of 64 columns at d <= 64, else of 128.
// ---------------------------------------------------------------------------

template <typename Kernel>
cudaError_t prepare(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

inline dim3 grid_of(int rows_heads, int rows, int d, int slab) {
  return dim3(rows_heads, (rows + kB - 1) / kB, (d + slab - 1) / slab);
}

template <typename T, int NJ>
int launch_fwd_nj(const void* q, const void* k, const void* v, void* o,
                  void* lse, const Shape& sh, cudaStream_t st) {
  auto kernel = fwd_kernel<T, NJ>;
  const size_t bytes = Smem<NJ>::fwd;
  cudaError_t err = prepare(kernel, bytes);
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid_of(sh.b * sh.h, sh.sq, sh.d, 16 * NJ), kThreads, bytes, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), static_cast<float*>(lse),
      sh);
  return (int)cudaGetLastError();
}

template <typename T, int NJ>
int launch_dq_nj(const void* q, const void* k, const void* v,
                 const void* dout, const void* lse, const void* delta,
                 void* dq, const Shape& sh, cudaStream_t st) {
  auto kernel = dq_kernel<T, NJ>;
  const size_t bytes = Smem<NJ>::dq;
  cudaError_t err = prepare(kernel, bytes);
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid_of(sh.b * sh.h, sh.sq, sh.d, 16 * NJ), kThreads, bytes, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<T*>(dq), sh);
  return (int)cudaGetLastError();
}

template <typename T, int NJ>
int launch_dkv_nj(const void* q, const void* k, const void* v,
                  const void* dout, const void* lse, const void* delta,
                  void* dk, void* dv, const Shape& sh, cudaStream_t st) {
  auto kernel = dkv_kernel<T, NJ>;
  const size_t bytes = Smem<NJ>::dkv;
  cudaError_t err = prepare(kernel, bytes);
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid_of(sh.b * sh.hkv, sh.skv, sh.d, 16 * NJ), kThreads, bytes,
           st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<T*>(dk), static_cast<T*>(dv), sh);
  return (int)cudaGetLastError();
}

inline bool takes(int d) { return d > 0 && d % 16 == 0; }

template <typename T>
int launch_fwd(const void* q, const void* k, const void* v, void* o,
               void* lse, const Shape& sh, cudaStream_t st) {
  if (!takes(sh.d)) return (int)cudaErrorInvalidValue;
  return sh.d <= 64 ? launch_fwd_nj<T, 4>(q, k, v, o, lse, sh, st)
                    : launch_fwd_nj<T, 8>(q, k, v, o, lse, sh, st);
}

template <typename T>
int launch_dq(const void* q, const void* k, const void* v, const void* dout,
              const void* lse, const void* delta, void* dq, const Shape& sh,
              cudaStream_t st) {
  if (!takes(sh.d)) return (int)cudaErrorInvalidValue;
  return sh.d <= 64
             ? launch_dq_nj<T, 4>(q, k, v, dout, lse, delta, dq, sh, st)
             : launch_dq_nj<T, 8>(q, k, v, dout, lse, delta, dq, sh, st);
}

template <typename T>
int launch_dkv(const void* q, const void* k, const void* v, const void* dout,
               const void* lse, const void* delta, void* dk, void* dv,
               const Shape& sh, cudaStream_t st) {
  if (!takes(sh.d)) return (int)cudaErrorInvalidValue;
  return sh.d <= 64
             ? launch_dkv_nj<T, 4>(q, k, v, dout, lse, delta, dk, dv, sh, st)
             : launch_dkv_nj<T, 8>(q, k, v, dout, lse, delta, dk, dv, sh, st);
}

}  // namespace flash_simt
