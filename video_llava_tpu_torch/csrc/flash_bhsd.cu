// Non-causal flash attention over head-major, once-padded CLIP tensors.
//
// Replaces video_llava_tpu/ops/attention.py::flash_attention_bhsd (Pallas
// body _flash_fwd_kernel / _flash_fwd_one). Computes, for every head of
// q, k, v (bh, s, d) bf16:
//     o = softmax(q k^T * scale, keys >= kv_len masked) v      (bf16 out)
// for all s rows, with the softmax state (row max m, row sum l,
// accumulator) in f32.
//
// What bounds it on Hopper: at the CLIP shape (1,600 heads x 272 rows, 257
// keys, d 64) q and o at 272 rows and k and v at the 257 keys it reads are
// 217 MB (0.065 ms at 3.35 TB/s) and the products 2.9e10 operations (0.029
// ms at 989 TFLOP/s): bytes, with the softmax's exponentials (one a score;
// an SM's special function units give 16 a clock) not far behind.
//
// The design, for head dims 64 and 128 (the Hopper body): a block owns one
// head, and heads run along grid x. Two consumer warpgroups run the head's
// 64-row query tiles (warpgroup g takes tiles g, g + 2, ...) against its
// keys, which come as 64-key K and V tiles that TMA writes into shared
// memory: a 4-D map {d, rows, bh, 1} of the tensor, 128-byte swizzle; the
// K/V map's row count is kv_len, so pad keys arrive as zeros and only the
// ragged last tile is masked; the Q map's is s, so the last query tile's
// rows past s are zeros, and its store stops at s. One producer warp
// issues every copy under mbarrier full/empty pairs. K and V stream
// through a ring of as many stages as leave room for two blocks an SM (4
// at d 64), once for each pair of query tiles, and each warpgroup's query
// tiles through two buffers. Two blocks (four consumer warpgroups) share
// an SM, so one block's copies overlap the other's products. Keeping a
// head's K and V resident instead lost at 336 px (one block an SM) and
// gained 3% at 224 px, not worth a second copy mode (PERF.md, PR 8). Every
// product is wgmma m64nNk16, bf16 in, f32 accumulated in registers: S from
// two shared operands, then P converted to bf16 in registers and fed back
// as the A operand of P V (the m64nN accumulator layout is the A fragment
// layout). The online softmax runs on the accumulator registers (a row
// lives in the four lanes of a quad: two shuffles a reduction). Only the
// output goes back through shared memory (the warpgroup's own query
// buffer), out with 16-byte stores. At d 64 a consumer needs about 100
// registers, so the block runs without setmaxnreg, at up to 112 registers
// a thread; at d 128 (about 160) one block fits an SM.
//
// Other head dims (multiples of 16 up to 128) take the first, WMMA body
// below; the C entry chooses by head dim alone.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <mma.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

// ---------------------------------------------------------------------------
// The WMMA body (head dims other than 64 and 128): one block of 4 warps per
// 64 query rows of a head; K/V tiles loaded synchronously into padded
// shared tiles; WMMA 16x16x16 products with S, P and the partial P V
// staged in shared memory.
// ---------------------------------------------------------------------------
namespace wmma_body {

using namespace nvcuda;

constexpr int kBQ = 64;       // query rows per block (16 per warp)
constexpr int kBK = 64;       // keys per tile
constexpr int kThreads = 128;

struct Layout {
  int ldh, ldp, ldf, ldo;
  size_t q, k, v, p, f, o, bytes;
};

__host__ __device__ inline Layout make_layout(int d) {
  Layout L;
  L.ldh = d + 8;                              // bf16 q/k/v tiles
  L.ldp = kBK + 8;                            // bf16 probabilities
  L.ldf = (d > kBK ? d : kBK) + 4;            // f32 scores, reused for P.V
  L.ldo = d + 4;                              // f32 output accumulator
  L.q = 0;
  L.k = L.q + (size_t)kBQ * L.ldh * 2;
  L.v = L.k + (size_t)kBK * L.ldh * 2;
  L.p = L.v + (size_t)kBK * L.ldh * 2;
  L.f = L.p + (size_t)kBQ * L.ldp * 2;
  L.o = L.f + (size_t)kBQ * L.ldf * 4;
  L.bytes = L.o + (size_t)kBQ * L.ldo * 4;
  return L;
}

// Copy rows [row0, row0 + 64) of a (s, d) head into a padded tile; rows at
// or past `valid` are zero so masked keys never carry junk into P.V.
__device__ inline void load_tile(__nv_bfloat16* dst, int ld,
                                 const __nv_bfloat16* src, int row0,
                                 int valid, int d) {
  const int vec = d / 8;
  for (int i = threadIdx.x; i < kBQ * vec; i += kThreads) {
    const int r = i / vec, c = (i % vec) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < valid)
      val = *reinterpret_cast<const uint4*>(src + (size_t)(row0 + r) * d + c);
    *reinterpret_cast<uint4*>(dst + r * ld + c) = val;
  }
}

__global__ void __launch_bounds__(kThreads)
flash_bhsd_kernel(const __nv_bfloat16* __restrict__ q,
                  const __nv_bfloat16* __restrict__ k,
                  const __nv_bfloat16* __restrict__ v,
                  __nv_bfloat16* __restrict__ o, int s, int d, int kv_len,
                  float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  const Layout L = make_layout(d);
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem + L.q);
  __nv_bfloat16* ks = reinterpret_cast<__nv_bfloat16*>(smem + L.k);
  __nv_bfloat16* vs = reinterpret_cast<__nv_bfloat16*>(smem + L.v);
  __nv_bfloat16* ps = reinterpret_cast<__nv_bfloat16*>(smem + L.p);
  float* fs = reinterpret_cast<float*>(smem + L.f);
  float* os = reinterpret_cast<float*>(smem + L.o);

  const size_t head = (size_t)blockIdx.x * s * d;
  const int q0 = blockIdx.y * kBQ;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  load_tile(qs, L.ldh, q + head, q0, s, d);
  for (int i = threadIdx.x; i < kBQ * L.ldo; i += kThreads) os[i] = 0.f;

  // Softmax ownership: two lanes per row, each half of the columns.
  const int row = warp * 16 + (lane >> 1);
  const int half = lane & 1;
  float m = -INFINITY, l = 0.f;

  const int num_kb = (kv_len + kBK - 1) / kBK;
  for (int kb = 0; kb < num_kb; ++kb) {
    __syncthreads();  // previous tile's K/V fully consumed
    load_tile(ks, L.ldh, k + head, kb * kBK, kv_len, d);
    load_tile(vs, L.ldh, v + head, kb * kBK, kv_len, d);
    __syncthreads();

    // S(16 x 64) = Q_w K^T for this warp's 16 rows.
    for (int n = 0; n < kBK / 16; ++n) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::fill_fragment(acc, 0.f);
      for (int kk = 0; kk < d; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                       wmma::row_major> a;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                       wmma::col_major> b;
        wmma::load_matrix_sync(a, qs + warp * 16 * L.ldh + kk, L.ldh);
        wmma::load_matrix_sync(b, ks + n * 16 * L.ldh + kk, L.ldh);
        wmma::mma_sync(acc, a, b, acc);
      }
      wmma::store_matrix_sync(fs + warp * 16 * L.ldf + n * 16, acc, L.ldf,
                              wmma::mem_row_major);
    }
    __syncwarp();

    // Online softmax on this lane's half row. P is rounded to bf16 for the
    // second product, and the row sum adds the rounded values so the
    // normalisation matches what is multiplied.
    float* srow = fs + row * L.ldf;
    const int c0 = half * (kBK / 2);
    float mx = -INFINITY;
    for (int c = c0; c < c0 + kBK / 2; ++c) {
      const float x = (kb * kBK + c < kv_len) ? srow[c] * scale : -INFINITY;
      srow[c] = x;
      mx = fmaxf(mx, x);
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    const float m_new = fmaxf(m, mx);  // finite: key 0 is always valid
    const float alpha = __expf(m - m_new);
    float sum = 0.f;
    for (int c = c0; c < c0 + kBK / 2; ++c) {
      const __nv_bfloat16 pb = __float2bfloat16(__expf(srow[c] - m_new));
      ps[row * L.ldp + c] = pb;
      sum += __bfloat162float(pb);
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    l = alpha * l + sum;
    m = m_new;
    __syncwarp();

    // PV(16 x d) = P_w V, staged in the (now free) score rows.
    for (int n = 0; n < d / 16; ++n) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::fill_fragment(acc, 0.f);
      for (int kk = 0; kk < kBK; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                       wmma::row_major> a;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                       wmma::row_major> b;
        wmma::load_matrix_sync(a, ps + warp * 16 * L.ldp + kk, L.ldp);
        wmma::load_matrix_sync(b, vs + kk * L.ldh + n * 16, L.ldh);
        wmma::mma_sync(acc, a, b, acc);
      }
      wmma::store_matrix_sync(fs + warp * 16 * L.ldf + n * 16, acc, L.ldf,
                              wmma::mem_row_major);
    }
    __syncwarp();
    const int d0 = half * (d / 2);
    for (int c = d0; c < d0 + d / 2; ++c)
      os[row * L.ldo + c] = alpha * os[row * L.ldo + c] + srow[c];
    __syncwarp();
  }

  if (q0 + row < s) {
    const float inv = 1.f / fmaxf(l, 1e-30f);
    __nv_bfloat16* orow = o + head + (size_t)(q0 + row) * d;
    const int d0 = half * (d / 2);
    for (int c = d0; c < d0 + d / 2; ++c)
      orow[c] = __float2bfloat16(os[row * L.ldo + c] * inv);
  }
}

int launch(const void* q, const void* k, const void* v, void* o, int bh,
           int s, int d, int kv_len, float scale, cudaStream_t stream) {
  const Layout L = make_layout(d);
  cudaError_t err = cudaFuncSetAttribute(
      flash_bhsd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)L.bytes);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(bh, (s + kBQ - 1) / kBQ);
  flash_bhsd_kernel<<<grid, kThreads, L.bytes, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o),
      s, d, kv_len, scale);
  return (int)cudaGetLastError();
}

}  // namespace wmma_body

// ---------------------------------------------------------------------------
// The Hopper body (head dims 64 and 128): a block a head
// ---------------------------------------------------------------------------
namespace hopper_body {

using namespace flash::hopper;

constexpr int kConsumers = 2;                    // warpgroups, 64 rows each
constexpr int kThreads = 128 * kConsumers + 32;  // and the producer warp
constexpr int kTile = 64;                        // rows of every tile
constexpr float kLog2e = 1.4426950408889634f;
// Dynamic shared memory a block may take (227 KB), and what each of two
// blocks may take when they share an SM's 228 KB (1 KB reserved a block).
constexpr uint32_t kSmemBlock = 232448;
constexpr uint32_t kSmemPair = 233472 / 2 - 1024;
constexpr int kQbufs = 2;  // query buffers a warpgroup

struct Dims {
  int s, kv_len;  // rows of a head (s_pad) and the keys it sees
  int n_kv;       // key tiles
  int n_pass;     // passes: one query tile a warpgroup each
  int stages;     // K/V stages of the ring
  float scale;
};

// Query buffers (kConsumers x kQbufs tiles), then the K/V stages (K, V a
// stage), then the barriers: full and empty a stage, qfull and qempty a
// query buffer.
template <int D>
struct Layout {
  static constexpr uint32_t tile = kTile * D * 2;
  static constexpr uint32_t ring = kConsumers * kQbufs * tile;
  __host__ __device__ static uint32_t bars(int stages) {
    return ring + stages * 2 * tile;
  }
  __host__ __device__ static uint32_t bytes(int stages) {
    return bars(stages) + 8 * (2 * stages + 2 * kConsumers * kQbufs);
  }
};

// Order this thread's generic-proxy shared memory accesses before later
// async-proxy (TMA) writes to the same bytes.
__device__ inline void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// Online softmax of one tile of raw scores (a warpgroup's 64 x kTile
// accumulator) into P as bf16 A fragments; keys at or past `keys` (the
// last tile's valid keys, kTile elsewhere) are masked. Updates the row
// maxima (log2 units) and this lane's partial sums of its two rows (a:
// 16w + lane / 4, b: 8 below), and returns in al_a, al_b the factor that
// moves O from the old max to the new one. Key 0 is valid and tile 0 comes
// first, so the maxima are finite from the first tile on.
__device__ __forceinline__ void softmax_tile(float (&sc)[kTile / 2],
                                             uint32_t (&pa)[kTile / 4],
                                             float& m_a, float& m_b,
                                             float& l_a, float& l_b,
                                             float& al_a, float& al_b,
                                             int keys, float sl) {
  const int lane = threadIdx.x % 32;
  float mx_a = -INFINITY, mx_b = -INFINITY;
#pragma unroll
  for (int i = 0; i < kTile / 2; ++i) {
    if (keys < kTile && acc_col(i, lane) >= keys) sc[i] = -INFINITY;
    if (i & 2)
      mx_b = fmaxf(mx_b, sc[i]);
    else
      mx_a = fmaxf(mx_a, sc[i]);
  }
  const float mn_a = fmaxf(m_a, quad_max(mx_a) * sl);
  const float mn_b = fmaxf(m_b, quad_max(mx_b) * sl);
  al_a = ex2(m_a - mn_a);
  al_b = ex2(m_b - mn_b);
  m_a = mn_a;
  m_b = mn_b;
  float su_a = 0.f, su_b = 0.f;
#pragma unroll
  for (int i = 0; i < kTile / 2; ++i) {
    const float p = ex2(fmaf(sc[i], sl, (i & 2) ? -mn_b : -mn_a));
    sc[i] = p;
    if (i & 2)
      su_b += p;
    else
      su_a += p;
  }
  l_a = l_a * al_a + su_a;  // this lane's columns; summed at the end
  l_b = l_b * al_b + su_b;
  to_a_fragments(sc, pa);
}

template <int D>
__global__ void __launch_bounds__(kThreads, D == 64 ? 2 : 1)
bhsd_kernel(const __grid_constant__ CUtensorMap qmap,
            const __grid_constant__ CUtensorMap kmap,
            const __grid_constant__ CUtensorMap vmap, bf16* __restrict__ o,
            Dims dm) {
  using L = Layout<D>;
  unsigned char* smem = aligned_smem();
  const uint32_t base = smem_addr(smem);
  const int ns = dm.stages;
  const uint32_t ring = base + L::ring;
  const uint32_t full = base + L::bars(ns), empty = full + 8 * ns;
  const uint32_t qfull = empty + 8 * ns;  // [warpgroup][buffer]
  const uint32_t qempty = qfull + 8 * kConsumers * kQbufs;
  const int head = blockIdx.x;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int s = 0; s < ns; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 4 * kConsumers);  // lane 0 of each warp
    }
    for (int i = 0; i < kConsumers * kQbufs; ++i) {
      mbar_init(qfull + 8 * i, 1);
      mbar_init(qempty + 8 * i, 1);  // one thread of the warpgroup
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (warp == 4 * kConsumers) {  // the producer
    if (lane != 0) return;
    for (int p = 0; p < dm.n_pass; ++p) {
      for (int g = 0; g < kConsumers; ++g) {
        const int row0 = (p * kConsumers + g) * kTile;
        if (row0 >= dm.s) break;
        const int i = g * kQbufs + p % kQbufs;
        mbar_wait(qempty + 8 * i, ((p / kQbufs) & 1) ^ 1);
        mbar_expect_tx(qfull + 8 * i, L::tile);
        for (int c = 0; c < D / 64; ++c)
          tma_load(base + i * L::tile + c * kTile * 128, &qmap,
                   qfull + 8 * i, c * 64, row0, head, 0);
      }
      for (int t = 0; t < dm.n_kv; ++t) {
        const int seq = p * dm.n_kv + t;  // the ring's sequence
        const int s = seq % ns;
        mbar_wait(empty + 8 * s, ((seq / ns) & 1) ^ 1);
        const uint32_t kt = ring + s * 2 * L::tile, vt = kt + L::tile;
        mbar_expect_tx(full + 8 * s, 2 * L::tile);
        for (int c = 0; c < D / 64; ++c) {
          tma_load(kt + c * kTile * 128, &kmap, full + 8 * s, c * 64,
                   t * kTile, head, 0);
          tma_load(vt + c * kTile * 128, &vmap, full + 8 * s, c * 64,
                   t * kTile, head, 0);
        }
      }
    }
    return;
  }

  const int wg = warp / 4;
  const float sl = dm.scale * kLog2e;  // scores in log2 units
  const int last_keys = dm.kv_len - (dm.n_kv - 1) * kTile;
  bf16* out = o + (size_t)head * dm.s * D;
  for (int p = 0; p < dm.n_pass; ++p) {
    const int row0 = (p * kConsumers + wg) * kTile;
    const bool active = row0 < dm.s;  // uniform over the warpgroup
    const int i = wg * kQbufs + p % kQbufs;
    const uint32_t qt = base + i * L::tile;
    if (active) mbar_wait(qfull + 8 * i, (p / kQbufs) & 1);

    float acc[D / 2];
#pragma unroll
    for (int j = 0; j < D / 2; ++j) acc[j] = 0.f;
    float m_a = -INFINITY, m_b = -INFINITY, l_a = 0.f, l_b = 0.f;
    for (int t = 0; t < dm.n_kv; ++t) {
      const int seq = p * dm.n_kv + t;
      const int s = seq % ns;
      mbar_wait(full + 8 * s, (seq / ns) & 1);
      if (active) {
        const uint32_t kt = ring + s * 2 * L::tile;
        float sc[kTile / 2];
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk)  // S = Q K^T
          mma_ss(sc, desc_k(qt, kTile, kk), desc_k(kt, kTile, kk), kk > 0);
        wgmma_commit();
        wgmma_wait();
        fence_regs(sc);
        uint32_t pa[kTile / 4];
        float al_a, al_b;
        softmax_tile(sc, pa, m_a, m_b, l_a, l_b, al_a, al_b,
                     t == dm.n_kv - 1 ? last_keys : kTile, sl);
#pragma unroll
        for (int j = 0; j < D / 2; ++j) acc[j] *= (j & 2) ? al_b : al_a;
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kTile / 16; ++kk)  // O += P V
          mma_rs<D, 1>(acc, pa + 4 * kk, desc_mn(kt + L::tile, kTile, kk), 1);
        wgmma_commit();
        wgmma_wait();
        fence_regs(acc);
        fence_regs(pa);
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + 8 * s);
    }
    if (!active) continue;  // past the last query tile: this was the last pass

    const float l_ta = fmaxf(quad_sum(l_a), 1e-30f);
    const float l_tb = fmaxf(quad_sum(l_b), 1e-30f);
    unsigned char* tile = smem + i * L::tile;  // its query buffer, now free
    stage_rows<D>(tile, acc, 1.f / l_ta, 1.f / l_tb);
    warpgroup_sync(wg);
    copy_out<D>(tile, out, D, row0, dm.s, threadIdx.x % 128);
    fence_proxy_async();  // before the producer's next copy into the buffer
    warpgroup_sync(wg);
    if (threadIdx.x % 128 == 0) mbar_arrive(qempty + 8 * i);
  }
}

// A head-major (bh, s_pad, D) bf16 tensor as TMA reads it: dimensions {D,
// rows, bh, 1}, innermost first, with heads s_pad rows apart; `rows` is
// s_pad for Q and kv_len for K and V. A box is 64 columns of 64 rows of
// one head, 128-byte swizzled; rows past `rows` come in as zeros.
inline bool bhsd_map(CUtensorMap* map, const void* ptr, int bh, int s_pad,
                     int rows, int d) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)d, (cuuint64_t)rows,
                              (cuuint64_t)bh, 1};
  const cuuint64_t strides[3] = {(cuuint64_t)d * 2,
                                 (cuuint64_t)s_pad * d * 2,
                                 (cuuint64_t)bh * s_pad * d * 2};
  const cuuint32_t box[4] = {64, kTile, 1, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                const_cast<void*>(ptr), dims, strides, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// Two blocks an SM at d 64 (four consumer warpgroups; at d 128 a consumer
// needs some 160 registers, so one): K and V stream through as many
// stages as leave room for them, at most a head's n_kv.
template <int D>
Dims plan(int s, int kv_len, float scale) {
  using L = Layout<D>;
  const uint32_t room = (D == 64 ? kSmemPair : kSmemBlock) - 1024;
  Dims dm;
  dm.s = s;
  dm.kv_len = kv_len;
  dm.n_kv = (kv_len + kTile - 1) / kTile;
  dm.n_pass = ((s + kTile - 1) / kTile + kConsumers - 1) / kConsumers;
  dm.scale = scale;
  dm.stages = 1;
  while (dm.stages < dm.n_kv && L::bytes(dm.stages + 1) <= room)
    ++dm.stages;
  return dm;
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* o, int bh,
           int s, int kv_len, float scale, cudaStream_t stream) {
  using L = Layout<D>;
  const Dims dm = plan<D>(s, kv_len, scale);
  CUtensorMap qm, km, vm;
  if (!bhsd_map(&qm, q, bh, s, s, D) || !bhsd_map(&km, k, bh, s, kv_len, D) ||
      !bhsd_map(&vm, v, bh, s, kv_len, D))
    return (int)cudaErrorInvalidValue;
  auto kernel = bhsd_kernel<D>;
  const size_t bytes = L::bytes(dm.stages) + 1024;
  cudaError_t err = prepare(kernel, bytes);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               (int)cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return (int)err;
  kernel<<<bh, kThreads, bytes, stream>>>(qm, km, vm, static_cast<bf16*>(o),
                                          dm);
  return (int)cudaGetLastError();
}

}  // namespace hopper_body

}  // namespace

extern "C" int vlt_flash_bhsd(const void* q, const void* k, const void* v,
                              void* o, int bh, int s, int d, int kv_len,
                              float scale, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  switch (d) {
    case 64:
      return hopper_body::launch<64>(q, k, v, o, bh, s, kv_len, scale, st);
    case 128:
      return hopper_body::launch<128>(q, k, v, o, bh, s, kv_len, scale, st);
    default:
      return wmma_body::launch(q, k, v, o, bh, s, d, kv_len, scale, st);
  }
}
