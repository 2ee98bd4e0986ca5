// Causal / GQA flash attention, forward and backward, over BSHD tensors.
//
// Replaces video_llava_tpu/ops/attention.py::_flash_forward (kernel 7,
// Pallas body _flash_fwd_one) and ::_flash_backward (kernel 8: the dq
// kernel _flash_bwd_dq_kernel and the dk/dv kernel _flash_bwd_dkv_kernel).
// For q (b, sq, h, d) and k/v (b, skv, h_kv, d), bf16, query head hi reads
// kv head hi / (h / h_kv):
//   forward   o = softmax(q k^T * scale) v  (bf16), lse = m + log(l) (f32,
//             (b, h, sq); 1e30 where not finite, so exp(s - lse) is 0)
//   dq        = scale * sum_j p_ij (dP_ij - D_i) k_j
//   dk, dv    = scale * sum_i dS_ij q_i,  sum_i p_ij dO_i, summed over the
//               query heads of each kv head inside the block
// with p = exp(s * scale - lse) recomputed, dP = dO v^T and D = rowsum(dO o)
// (D comes in from the caller, as it sits outside the pallas_call in the
// JAX package). Masks: keys at or past skv; with `causal`, key j is seen by
// query i iff j <= i + skv - sq (the right-aligned convention).
//
// What bounds it on Hopper: at the training shape (b 4, s 1024, h 32,
// d 128, causal) the forward is 3.4e10 operations (0.035 ms at 989 TFLOP/s)
// over 134 MB of q/k/v/o (0.040 ms at 3.35 TB/s): bytes by a hair; the
// backward is 1.2e11 operations (the dq kernel's three products and the
// dk/dv kernel's four over the visible pairs; 0.12 ms): operations. Both
// want the tensor cores at their bf16 rate, which on this card only wgmma
// reaches.
//
// The design, for head dims 64 and 128 (the Hopper body below): a block
// owns 128 rows (queries; keys in the dk/dv kernel) as two consumer
// warpgroups of 64 rows, plus a producer warpgroup of which one warp
// issues the copies. The block's own rows sit in shared memory, loaded
// once; the rows it streams over (K/V in the forward and dq kernels, Q/dO
// with lse and D in the dk/dv kernel) pass through a ring of tiles that
// TMA fills (cp.async.bulk.tensor over a 4-D map of the BSHD tensor,
// 128-byte swizzle; rows past the end come in as zeros) under mbarrier
// full/empty pairs, so the next tile's copy overlaps the current tile's
// products. Every product is wgmma m64nNk16, bf16 in, f32 accumulated in
// registers: scores from two shared-memory operands, then P (or dS)
// converted to bf16 in registers and fed back as the A operand of the
// second product (the m64nN accumulator layout is the A fragment layout),
// against a tile read transposed. The online softmax runs on the
// accumulator registers (a row lives in the four lanes of a quad: two
// shuffles per reduction), and the mask is applied only on the diagonal
// and ragged tiles. The forward's output and the gradients go out through
// the block's own (by then free) shared rows with 16-byte stores. Causal
// blocks run longest first (the forward and dq kernels walk query tiles in
// reverse). Two backward kernels and no atomics, as on the TPU: the
// gradient is deterministic. setmaxnreg moves registers from the producer
// (24 a thread) to the consumers (240): at d 128 the forward holds O and S
// (64 each), the dk/dv kernel dK and dV (64 each) beside S^T and dP^T (32
// each).
//
// Other head dims (multiples of 16 up to 128) take the first, WMMA body
// (flash_attention_wmma.cuh); the C entries choose by head dim alone.

#include <math.h>

#include "flash_attention_simt.cuh"
#include "flash_attention_wmma.cuh"
#include "hopper.cuh"

namespace flash {
namespace hopper {

constexpr int kWarpgroups = 2;                  // consumers, 64 rows each
constexpr int kRows = 64 * kWarpgroups;         // rows a block owns
constexpr int kProducerWarp = 4 * kWarpgroups;  // first warp of the producer
constexpr int kThreads = 128 * (kWarpgroups + 1);
constexpr int kTile = 64;  // rows of a streamed tile (keys; queries in dk/dv)
// Registers a thread after setmaxnreg: 168 at launch (65,536 over 384
// threads); the producer warpgroup gives back what the consumers take.
constexpr int kProducerRegs = 24, kConsumerRegs = 240;
static_assert(kWarpgroups * kConsumerRegs + kProducerRegs ==
                  (kWarpgroups + 1) * 168,
              "the register budget of a block of 384 threads");
constexpr float kLog2e = 1.4426950408889634f;

// ---------------------------------------------------------------------------
// Shared pieces of the three kernels
// ---------------------------------------------------------------------------

// Key tiles that query rows up to `last` read: all, or (causal) up to the
// last key row `last` sees.
__device__ inline int key_tiles(const Shape& sh, int last) {
  int n = (sh.skv + kTile - 1) / kTile;
  if (sh.causal) n = min(n, (last + sh.skv - sh.sq) / kTile + 1);
  return n;
}

// ---------------------------------------------------------------------------
// Kernel 7: forward. Block: 128 query rows of one head; ring: K and V tiles
// of 64 keys.
// ---------------------------------------------------------------------------

// The running max (log2 units) and this lane's partial sums of a lane's two
// rows (a: 16w + lane / 4, b: 8 below).
struct RowStats {
  float m_a, m_b, l_a, l_b;
};

// Online softmax of one tile of raw scores (a warpgroup's 64 x kTile
// accumulator; keys from k0; masked only on an edge tile) into P as bf16 A
// fragments. Updates the row statistics and returns in al_a, al_b the
// factor that moves O from the old max to the new one. Key 0 is seen by
// every row (sq <= skv under the causal mask) and tile 0 comes first, so m
// is finite from the first tile on.
__device__ __forceinline__ void softmax_tile(float (&sc)[kTile / 2],
                                             uint32_t (&pa)[kTile / 4],
                                             RowStats& st, float& al_a,
                                             float& al_b, const Shape& sh,
                                             int k0, int ra, int rb,
                                             bool edge, float sl) {
  const int lane = threadIdx.x % 32, off = sh.skv - sh.sq;
  float mx_a = -INFINITY, mx_b = -INFINITY;
#pragma unroll
  for (int i = 0; i < kTile / 2; ++i) {
    if (edge) {
      const int kj = k0 + acc_col(i, lane);
      const int qi = (i & 2) ? rb : ra;
      if (kj >= sh.skv || (sh.causal && kj > qi + off)) sc[i] = -INFINITY;
    }
    if (i & 2)
      mx_b = fmaxf(mx_b, sc[i]);
    else
      mx_a = fmaxf(mx_a, sc[i]);
  }
  const float mn_a = fmaxf(st.m_a, quad_max(mx_a) * sl);
  const float mn_b = fmaxf(st.m_b, quad_max(mx_b) * sl);
  al_a = ex2(st.m_a - mn_a);
  al_b = ex2(st.m_b - mn_b);
  st.m_a = mn_a;
  st.m_b = mn_b;
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
  st.l_a = st.l_a * al_a + su_a;  // this lane's columns; summed at the end
  st.l_b = st.l_b * al_b + su_b;
  to_a_fragments(sc, pa);
}

// S = A B^T over the head dim, committed as one group: A the warpgroup's
// 64 rows at `at`, B a streamed tile at `bt` (both K-major).
template <int D>
__device__ __forceinline__ void issue_scores(float (&sc)[kTile / 2],
                                             uint32_t at, uint32_t bt) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    mma_ss(sc, desc_k(at, 64, kk), desc_k(bt, kTile, kk), kk > 0);
  wgmma_commit();
}

template <int D, int STAGES>
struct FwdLayout {
  static constexpr uint32_t half = 64 * D * 2;  // one warpgroup's rows
  static constexpr uint32_t kv = kTile * D * 2;  // one K or V tile
  static constexpr uint32_t q = 0;
  static constexpr uint32_t ring = q + kWarpgroups * half;  // K, V a stage
  static constexpr uint32_t bars = ring + STAGES * 2 * kv;  // full, empty, q
  static constexpr uint32_t bytes = bars + 8 * (2 * STAGES + 1);
};

template <int D, int STAGES>
__global__ void __launch_bounds__(kThreads, 1)
fwd_kernel(const __grid_constant__ CUtensorMap qmap,
           const __grid_constant__ CUtensorMap kmap,
           const __grid_constant__ CUtensorMap vmap, bf16* __restrict__ o,
           float* __restrict__ lse, Shape sh) {
  using L = FwdLayout<D, STAGES>;
  unsigned char* smem = aligned_smem();
  const uint32_t base = smem_addr(smem);
  const uint32_t full = base + L::bars, empty = full + 8 * STAGES,
                 qbar = empty + 8 * STAGES;
  const int bi = blockIdx.x / sh.h, hi = blockIdx.x % sh.h;
  const int kvh = hi / (sh.h / sh.hkv);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kRows;  // longest first
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int n_tiles = key_tiles(sh, min(q0 + kRows, sh.sq) - 1);

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 4 * kWarpgroups);  // lane 0 of each warp
    }
    mbar_init(qbar, 1);
    fence_barrier_init();
  }
  __syncthreads();

  if (warp >= kProducerWarp) {
    setmaxnreg_dec<kProducerRegs>();
    if (warp == kProducerWarp && lane == 0) {
      mbar_expect_tx(qbar, kRows * D * 2);
      for (int g = 0; g < kWarpgroups; ++g)
        for (int c = 0; c < D / 64; ++c)
          tma_load(base + L::q + g * L::half + c * 64 * 128, &qmap, qbar,
                   c * 64, hi, q0 + 64 * g, bi);
      for (int t = 0; t < n_tiles; ++t) {
        const int s = t % STAGES;
        mbar_wait(empty + 8 * s, ((t / STAGES) & 1) ^ 1);
        const uint32_t kt = base + L::ring + s * 2 * L::kv, vt = kt + L::kv;
        mbar_expect_tx(full + 8 * s, 2 * L::kv);
        for (int c = 0; c < D / 64; ++c) {
          tma_load(kt + c * kTile * 128, &kmap, full + 8 * s, c * 64, kvh,
                   t * kTile, bi);
          tma_load(vt + c * kTile * 128, &vmap, full + 8 * s, c * 64, kvh,
                   t * kTile, bi);
        }
      }
    }
    return;
  }

  setmaxnreg_inc<kConsumerRegs>();
  const int wg = warp / 4, w = warp % 4;
  const int r0 = q0 + 64 * wg;  // this warpgroup's first row
  const int ra = r0 + 16 * w + lane / 4, rb = ra + 8;
  const int off = sh.skv - sh.sq;
  const int n_own =
      r0 < sh.sq ? key_tiles(sh, min(r0 + 64, sh.sq) - 1) : 0;
  const float sl = sh.scale * kLog2e;  // scores in log2 units
  const uint32_t qt = base + L::q + wg * L::half;

  const auto kv_tile = [&](int t) {
    return base + L::ring + (t % STAGES) * 2 * L::kv;  // K; V follows
  };
  const auto edge = [&](int k0) {
    return (sh.causal && k0 + kTile - 1 > r0 + off) || k0 + kTile > sh.skv;
  };

  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  RowStats st{-INFINITY, -INFINITY, 0.f, 0.f};

  mbar_wait(qbar, 0);
  int t = 0;
  for (; t < n_own; ++t) {
    const uint32_t kt = kv_tile(t);
    mbar_wait(full + 8 * (t % STAGES), (t / STAGES) & 1);
    float sc[kTile / 2];
    wgmma_fence();
    issue_scores<D>(sc, qt, kt);  // S = Q K^T
    wgmma_wait();
    fence_regs(sc);
    uint32_t pa[kTile / 4];
    float al_a, al_b;
    softmax_tile(sc, pa, st, al_a, al_b, sh, t * kTile, ra, rb,
                 edge(t * kTile), sl);
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] *= (i & 2) ? al_b : al_a;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kTile / 16; ++kk)  // O += P V
      mma_rs<D, 1>(acc, pa + 4 * kk, desc_mn(kt + L::kv, kTile, kk), 1);
    wgmma_commit();
    wgmma_wait();
    fence_regs(acc);
    fence_regs(pa);
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + 8 * (t % STAGES));
  }
  for (; t < n_tiles; ++t) {  // tiles past this warpgroup's last key
    mbar_wait(full + 8 * (t % STAGES), (t / STAGES) & 1);
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + 8 * (t % STAGES));
  }

  if (r0 >= sh.sq) return;  // the whole warpgroup: rows past the end
  const float l_a = fmaxf(quad_sum(st.l_a), 1e-30f);
  const float l_b = fmaxf(quad_sum(st.l_b), 1e-30f);
  unsigned char* tile = smem + L::q + wg * L::half;  // its Q rows, now free
  stage_rows<D>(tile, acc, 1.f / l_a, 1.f / l_b);
  warpgroup_sync(wg);
  const size_t stride = (size_t)sh.h * D;
  copy_out<D>(tile, o + (size_t)bi * sh.sq * stride + (size_t)hi * D, stride,
              r0, sh.sq, threadIdx.x % 128);
  if (lane % 4 == 0) {
    float* row_lse = lse + ((size_t)bi * sh.h + hi) * sh.sq;
    const float xa = (st.m_a + log2f(l_a)) / kLog2e;
    const float xb = (st.m_b + log2f(l_b)) / kLog2e;
    if (ra < sh.sq) row_lse[ra] = isfinite(xa) ? xa : kSentinel;
    if (rb < sh.sq) row_lse[rb] = isfinite(xb) ? xb : kSentinel;
  }
}

// ---------------------------------------------------------------------------
// Kernel 8: backward, dq. Block: 128 query rows of one head (Q and dO
// resident); ring: K and V tiles of kTile keys.
// ---------------------------------------------------------------------------

// lse (log2 units) and D of a lane's two rows.
struct RowGrad {
  float lse_a, lse_b, dl_a, dl_b;
};

// dS = P (dP - D) of one tile (keys from k0) from its S and dP
// accumulators, P recomputed from the saved logsumexp and masked only on
// an edge tile, as bf16 A fragments.
__device__ __forceinline__ void grad_scores(float (&sc)[kTile / 2],
                                            const float (&dp)[kTile / 2],
                                            uint32_t (&ds)[kTile / 4],
                                            const RowGrad& rows,
                                            const Shape& sh, int k0, int ra,
                                            int rb, bool edge, float sl) {
  const int lane = threadIdx.x % 32, off = sh.skv - sh.sq;
#pragma unroll
  for (int i = 0; i < kTile / 2; ++i) {
    float p = ex2(fmaf(sc[i], sl, (i & 2) ? -rows.lse_b : -rows.lse_a));
    if (edge) {
      const int kj = k0 + acc_col(i, lane);
      const int qi = (i & 2) ? rb : ra;
      if (kj >= sh.skv || (sh.causal && kj > qi + off)) p = 0.f;
    }
    sc[i] = p * (dp[i] - ((i & 2) ? rows.dl_b : rows.dl_a));
  }
  to_a_fragments(sc, ds);
}

template <int D, int STAGES>
struct DqLayout {
  static constexpr uint32_t half = 64 * D * 2;
  static constexpr uint32_t kv = kTile * D * 2;
  static constexpr uint32_t q = 0;
  static constexpr uint32_t dout = q + kWarpgroups * half;
  static constexpr uint32_t ring = dout + kWarpgroups * half;
  static constexpr uint32_t bars = ring + STAGES * 2 * kv;
  static constexpr uint32_t bytes = bars + 8 * (2 * STAGES + 1);
};

template <int D, int STAGES>
__global__ void __launch_bounds__(kThreads, 1)
dq_kernel(const __grid_constant__ CUtensorMap qmap,
          const __grid_constant__ CUtensorMap dmap,
          const __grid_constant__ CUtensorMap kmap,
          const __grid_constant__ CUtensorMap vmap,
          const float* __restrict__ lse, const float* __restrict__ delta,
          bf16* __restrict__ dq, Shape sh) {
  using L = DqLayout<D, STAGES>;
  unsigned char* smem = aligned_smem();
  const uint32_t base = smem_addr(smem);
  const uint32_t full = base + L::bars, empty = full + 8 * STAGES,
                 qbar = empty + 8 * STAGES;
  const int bi = blockIdx.x / sh.h, hi = blockIdx.x % sh.h;
  const int kvh = hi / (sh.h / sh.hkv);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kRows;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int n_tiles = key_tiles(sh, min(q0 + kRows, sh.sq) - 1);

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 4 * kWarpgroups);
    }
    mbar_init(qbar, 1);
    fence_barrier_init();
  }
  __syncthreads();

  if (warp >= kProducerWarp) {
    setmaxnreg_dec<kProducerRegs>();
    if (warp == kProducerWarp && lane == 0) {
      mbar_expect_tx(qbar, 2 * kRows * D * 2);
      for (int g = 0; g < kWarpgroups; ++g)
        for (int c = 0; c < D / 64; ++c) {
          const uint32_t at = g * L::half + c * 64 * 128;
          tma_load(base + L::q + at, &qmap, qbar, c * 64, hi, q0 + 64 * g,
                   bi);
          tma_load(base + L::dout + at, &dmap, qbar, c * 64, hi,
                   q0 + 64 * g, bi);
        }
      for (int t = 0; t < n_tiles; ++t) {
        const int s = t % STAGES;
        mbar_wait(empty + 8 * s, ((t / STAGES) & 1) ^ 1);
        const uint32_t kt = base + L::ring + s * 2 * L::kv, vt = kt + L::kv;
        mbar_expect_tx(full + 8 * s, 2 * L::kv);
        for (int c = 0; c < D / 64; ++c) {
          tma_load(kt + c * kTile * 128, &kmap, full + 8 * s, c * 64, kvh,
                   t * kTile, bi);
          tma_load(vt + c * kTile * 128, &vmap, full + 8 * s, c * 64, kvh,
                   t * kTile, bi);
        }
      }
    }
    return;
  }

  setmaxnreg_inc<kConsumerRegs>();
  const int wg = warp / 4, w = warp % 4;
  const int r0 = q0 + 64 * wg;
  const int ra = r0 + 16 * w + lane / 4, rb = ra + 8;
  const int off = sh.skv - sh.sq;
  const int n_own =
      r0 < sh.sq ? key_tiles(sh, min(r0 + 64, sh.sq) - 1) : 0;
  const float sl = sh.scale * kLog2e;
  const uint32_t qt = base + L::q + wg * L::half;
  const uint32_t dt = base + L::dout + wg * L::half;
  const size_t stat = ((size_t)bi * sh.h + hi) * sh.sq;
  const RowGrad rows{ra < sh.sq ? lse[stat + ra] * kLog2e : 0.f,
                     rb < sh.sq ? lse[stat + rb] * kLog2e : 0.f,
                     ra < sh.sq ? delta[stat + ra] : 0.f,
                     rb < sh.sq ? delta[stat + rb] : 0.f};

  const auto kv_tile = [&](int t) {
    return base + L::ring + (t % STAGES) * 2 * L::kv;  // K; V follows
  };
  const auto edge = [&](int k0) {
    return (sh.causal && k0 + kTile - 1 > r0 + off) || k0 + kTile > sh.skv;
  };
  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;

  mbar_wait(qbar, 0);
  int t = 0;
  for (; t < n_own; ++t) {
    const uint32_t kt = kv_tile(t);
    mbar_wait(full + 8 * (t % STAGES), (t / STAGES) & 1);
    float sc[kTile / 2], dp[kTile / 2];
    wgmma_fence();
    issue_scores<D>(sc, qt, kt);          // S = Q K^T
    issue_scores<D>(dp, dt, kt + L::kv);  // dP = dO V^T
    wgmma_wait();
    fence_regs(sc);
    fence_regs(dp);
    uint32_t da[kTile / 4];
    grad_scores(sc, dp, da, rows, sh, t * kTile, ra, rb, edge(t * kTile),
                sl);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kTile / 16; ++kk)  // dq += dS K
      mma_rs<D, 1>(acc, da + 4 * kk, desc_mn(kt, kTile, kk), 1);
    wgmma_commit();
    wgmma_wait();
    fence_regs(acc);
    fence_regs(da);
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + 8 * (t % STAGES));
  }
  for (; t < n_tiles; ++t) {  // tiles past this warpgroup's last key
    mbar_wait(full + 8 * (t % STAGES), (t / STAGES) & 1);
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + 8 * (t % STAGES));
  }

  if (r0 >= sh.sq) return;
  unsigned char* tile = smem + L::q + wg * L::half;
  stage_rows<D>(tile, acc, sh.scale, sh.scale);
  warpgroup_sync(wg);
  const size_t stride = (size_t)sh.h * D;
  copy_out<D>(tile, dq + (size_t)bi * sh.sq * stride + (size_t)hi * D,
              stride, r0, sh.sq, threadIdx.x % 128);
}

// ---------------------------------------------------------------------------
// Kernel 8: backward, dk and dv. Block: 128 keys of one kv head (K and V
// resident); ring: Q and dO tiles of kTile rows with their lse and D, over
// the group's query heads and the query tiles that see those keys. In the
// transposed frame, keys are M: S^T = K Q^T, dP^T = V dO^T, dV += P^T dO,
// dK += dS^T Q.
// ---------------------------------------------------------------------------

template <int D, int STAGES>
struct DkvLayout {
  static constexpr uint32_t half = 64 * D * 2;
  static constexpr uint32_t qd = kTile * D * 2;  // one Q or dO tile
  static constexpr uint32_t k = 0;
  static constexpr uint32_t v = k + kWarpgroups * half;
  static constexpr uint32_t ring = v + kWarpgroups * half;  // Q, dO a stage
  static constexpr uint32_t stats = ring + STAGES * 2 * qd;  // lse, D a stage
  static constexpr uint32_t bars = stats + STAGES * 2 * kTile * 4;
  static constexpr uint32_t bytes = bars + 8 * (2 * STAGES + 1);
};

template <int D, int STAGES>
__global__ void __launch_bounds__(kThreads, 1)
dkv_kernel(const __grid_constant__ CUtensorMap kmap,
           const __grid_constant__ CUtensorMap vmap,
           const __grid_constant__ CUtensorMap qmap,
           const __grid_constant__ CUtensorMap dmap,
           const float* __restrict__ lse, const float* __restrict__ delta,
           bf16* __restrict__ dk, bf16* __restrict__ dv, Shape sh) {
  using L = DkvLayout<D, STAGES>;
  unsigned char* smem = aligned_smem();
  const uint32_t base = smem_addr(smem);
  const uint32_t full = base + L::bars, empty = full + 8 * STAGES,
                 kvbar = empty + 8 * STAGES;
  const int group = sh.h / sh.hkv;
  const int bi = blockIdx.x / sh.hkv, kvh = blockIdx.x % sh.hkv;
  const int k0 = blockIdx.y * kRows;  // causal: the first keys do the most
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int off = sh.skv - sh.sq;
  const int num_qb = (sh.sq + kTile - 1) / kTile;
  // the first query row that sees key k0: i >= k0 - (skv - sq)
  const int start_qb = sh.causal ? max(k0 - off, 0) / kTile : 0;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      // lane 0's expect_tx, and each producer lane once its lse and D
      // copies have landed
      mbar_init(full + 8 * s, 1 + 32);
      mbar_init(empty + 8 * s, 4 * kWarpgroups);
    }
    mbar_init(kvbar, 1);
    fence_barrier_init();
  }
  __syncthreads();

  if (warp >= kProducerWarp) {
    setmaxnreg_dec<kProducerRegs>();
    if (warp != kProducerWarp) return;
    if (lane == 0) {
      mbar_expect_tx(kvbar, 2 * kRows * D * 2);
      for (int g = 0; g < kWarpgroups; ++g)
        for (int c = 0; c < D / 64; ++c) {
          const uint32_t at = g * L::half + c * 64 * 128;
          tma_load(base + L::k + at, &kmap, kvbar, c * 64, kvh, k0 + 64 * g,
                   bi);
          tma_load(base + L::v + at, &vmap, kvbar, c * 64, kvh, k0 + 64 * g,
                   bi);
        }
    }
    int t = 0;
    for (int g = 0; g < group; ++g) {
      const int hi = kvh * group + g;
      const size_t stat = ((size_t)bi * sh.h + hi) * sh.sq;
      for (int qb = start_qb; qb < num_qb; ++qb, ++t) {
        const int s = t % STAGES;
        mbar_wait(empty + 8 * s, ((t / STAGES) & 1) ^ 1);
        // lse and D of the tile's rows (zeros past sq), kTile floats each
        const uint32_t ls = base + L::stats + s * 2 * kTile * 4;
        for (int j = lane; j < kTile; j += 32) {
          const int qi = qb * kTile + j;
          const size_t at = stat + (qi < sh.sq ? qi : 0);
          cp_async4(ls + 4 * j, lse + at, qi < sh.sq);
          cp_async4(ls + 4 * (kTile + j), delta + at, qi < sh.sq);
        }
        cp_async_arrive(full + 8 * s);
        if (lane == 0) {
          const uint32_t qt = base + L::ring + s * 2 * L::qd, dt = qt + L::qd;
          mbar_expect_tx(full + 8 * s, 2 * L::qd);
          for (int c = 0; c < D / 64; ++c) {
            tma_load(qt + c * kTile * 128, &qmap, full + 8 * s, c * 64, hi,
                     qb * kTile, bi);
            tma_load(dt + c * kTile * 128, &dmap, full + 8 * s, c * 64, hi,
                     qb * kTile, bi);
          }
        }
      }
    }
    return;
  }

  setmaxnreg_inc<kConsumerRegs>();
  const int wg = warp / 4, w = warp % 4;
  const int kw = k0 + 64 * wg;  // this warpgroup's first key
  const int ka = kw + 16 * w + lane / 4, kb = ka + 8;
  const float sl = sh.scale * kLog2e;
  const uint32_t kt = base + L::k + wg * L::half;
  const uint32_t vt = base + L::v + wg * L::half;

  float dk_acc[D / 2], dv_acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dk_acc[i] = dv_acc[i] = 0.f;

  mbar_wait(kvbar, 0);
  int t = 0;
  for (int g = 0; g < group; ++g) {
    for (int qb = start_qb; qb < num_qb; ++qb, ++t) {
      const int s = t % STAGES;
      mbar_wait(full + 8 * s, (t / STAGES) & 1);
      const int q0 = qb * kTile;
      // keys past the end, or (causal) no query of the tile sees the
      // warpgroup's first key
      const bool active =
          kw < sh.skv && !(sh.causal && q0 + kTile - 1 + off < kw);
      if (active) {
        const uint32_t qt = base + L::ring + s * 2 * L::qd, dt = qt + L::qd;
        const float* ls = reinterpret_cast<const float*>(
            smem + L::stats + s * 2 * kTile * 4);
        float st[kTile / 2], dpt[kTile / 2];
        wgmma_fence();
        issue_scores<D>(st, kt, qt);   // S^T = K Q^T
        issue_scores<D>(dpt, vt, dt);  // dP^T = V dO^T
        wgmma_wait();
        fence_regs(st);
        fence_regs(dpt);

        const bool edge =
            (sh.causal && kw + 63 > q0 + off) || q0 + kTile > sh.sq;
#pragma unroll
        for (int i = 0; i < kTile / 2; ++i) {
          const int c = acc_col(i, lane);
          float p = ex2(fmaf(st[i], sl, -ls[c] * kLog2e));
          if (edge) {
            const int kj = (i & 2) ? kb : ka;
            if (q0 + c >= sh.sq || (sh.causal && kj > q0 + c + off)) p = 0.f;
          }
          st[i] = p;
          dpt[i] = p * (dpt[i] - ls[kTile + c]);
        }
        uint32_t pa[kTile / 4], da[kTile / 4];
        to_a_fragments(st, pa);
        to_a_fragments(dpt, da);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kTile / 16; ++kk)  // dv += P^T dO
          mma_rs<D, 1>(dv_acc, pa + 4 * kk, desc_mn(dt, kTile, kk), 1);
#pragma unroll
        for (int kk = 0; kk < kTile / 16; ++kk)  // dk += dS^T Q
          mma_rs<D, 1>(dk_acc, da + 4 * kk, desc_mn(qt, kTile, kk), 1);
        wgmma_commit();
        wgmma_wait();
        fence_regs(dv_acc);
        fence_regs(dk_acc);
        fence_regs(pa);
        fence_regs(da);
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + 8 * s);
    }
  }

  if (kw >= sh.skv) return;
  unsigned char* ktile = smem + L::k + wg * L::half;  // its K and V rows
  unsigned char* vtile = smem + L::v + wg * L::half;
  stage_rows<D>(ktile, dk_acc, sh.scale, sh.scale);
  stage_rows<D>(vtile, dv_acc, 1.f, 1.f);
  warpgroup_sync(wg);
  const size_t stride = (size_t)sh.hkv * D;
  const size_t head = (size_t)bi * sh.skv * stride + (size_t)kvh * D;
  const int tid = threadIdx.x % 128;
  copy_out<D>(ktile, dk + head, stride, kw, sh.skv, tid);
  copy_out<D>(vtile, dv + head, stride, kw, sh.skv, tid);
}

// ---------------------------------------------------------------------------
// Launchers
// ---------------------------------------------------------------------------

// Ring depths by head dim, as deep as the block's own rows leave room for
// in 227 KB: 4 tiles, 3 in the backward kernels at d 128. (The forward
// measured the same with tiles of 128 keys.)
constexpr int kFwdStages = 4;
template <int D>
constexpr int kBwdStages = D == 128 ? 3 : 4;

template <int D>
int launch_fwd(const void* q, const void* k, const void* v, void* o,
               void* lse, const Shape& sh, cudaStream_t stream) {
  using L = FwdLayout<D, kFwdStages>;
  CUtensorMap qm, km, vm;
  if (!bshd_map(&qm, q, sh.b, sh.sq, sh.h, D, 64) ||
      !bshd_map(&km, k, sh.b, sh.skv, sh.hkv, D, kTile) ||
      !bshd_map(&vm, v, sh.b, sh.skv, sh.hkv, D, kTile))
    return (int)cudaErrorInvalidValue;
  auto kernel = fwd_kernel<D, kFwdStages>;
  const size_t bytes = L::bytes + 1024;
  cudaError_t err = prepare(kernel, bytes);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(sh.b * sh.h, (sh.sq + kRows - 1) / kRows);
  kernel<<<grid, kThreads, bytes, stream>>>(qm, km, vm, static_cast<bf16*>(o),
                                            static_cast<float*>(lse), sh);
  return (int)cudaGetLastError();
}

template <int D>
int launch_dq(const void* q, const void* k, const void* v, const void* dout,
              const void* lse, const void* delta, void* dq, const Shape& sh,
              cudaStream_t stream) {
  using L = DqLayout<D, kBwdStages<D>>;
  CUtensorMap qm, dm, km, vm;
  if (!bshd_map(&qm, q, sh.b, sh.sq, sh.h, D, 64) ||
      !bshd_map(&dm, dout, sh.b, sh.sq, sh.h, D, 64) ||
      !bshd_map(&km, k, sh.b, sh.skv, sh.hkv, D, kTile) ||
      !bshd_map(&vm, v, sh.b, sh.skv, sh.hkv, D, kTile))
    return (int)cudaErrorInvalidValue;
  auto kernel = dq_kernel<D, kBwdStages<D>>;
  const size_t bytes = L::bytes + 1024;
  cudaError_t err = prepare(kernel, bytes);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(sh.b * sh.h, (sh.sq + kRows - 1) / kRows);
  kernel<<<grid, kThreads, bytes, stream>>>(
      qm, dm, km, vm, static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<bf16*>(dq), sh);
  return (int)cudaGetLastError();
}

template <int D>
int launch_dkv(const void* q, const void* k, const void* v, const void* dout,
               const void* lse, const void* delta, void* dk, void* dv,
               const Shape& sh, cudaStream_t stream) {
  using L = DkvLayout<D, kBwdStages<D>>;
  CUtensorMap km, vm, qm, dm;
  if (!bshd_map(&km, k, sh.b, sh.skv, sh.hkv, D, 64) ||
      !bshd_map(&vm, v, sh.b, sh.skv, sh.hkv, D, 64) ||
      !bshd_map(&qm, q, sh.b, sh.sq, sh.h, D, kTile) ||
      !bshd_map(&dm, dout, sh.b, sh.sq, sh.h, D, kTile))
    return (int)cudaErrorInvalidValue;
  auto kernel = dkv_kernel<D, kBwdStages<D>>;
  const size_t bytes = L::bytes + 1024;
  cudaError_t err = prepare(kernel, bytes);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(sh.b * sh.hkv, (sh.skv + kRows - 1) / kRows);
  kernel<<<grid, kThreads, bytes, stream>>>(
      km, vm, qm, dm, static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<bf16*>(dk),
      static_cast<bf16*>(dv), sh);
  return (int)cudaGetLastError();
}

}  // namespace hopper
}  // namespace flash

// Head dims 64 and 128 take the Hopper body, the other multiples of 16 up
// to 128 and 256 the WMMA body, multiples of 16 past 256 the SIMT body
// (flash_attention_simt.cuh; the wrappers pad d there to a multiple of 128).
#define VLT_WMMA_HEAD_DIMS(X) X(16) X(32) X(48) X(80) X(96) X(112) X(256)

extern "C" int vlt_flash_fwd(const void* q, const void* k, const void* v,
                             void* o, void* lse, int b, int sq, int skv,
                             int h, int hkv, int d, int causal, float scale,
                             void* stream) {
  const flash::Shape sh{b, sq, skv, h, hkv, causal, scale};
  const cudaStream_t st = (cudaStream_t)stream;
  switch (d) {
    case 64:
      return flash::hopper::launch_fwd<64>(q, k, v, o, lse, sh, st);
    case 128:
      return flash::hopper::launch_fwd<128>(q, k, v, o, lse, sh, st);
#define VLT_CASE(D) \
  case D:           \
    return flash::wmma_body::launch_fwd<D>(q, k, v, o, lse, sh, st);
      VLT_WMMA_HEAD_DIMS(VLT_CASE)
#undef VLT_CASE
    default: {
      if (d <= 256) return (int)cudaErrorInvalidValue;
      const flash_simt::Shape wide{b, sq, skv, h, hkv, d, causal, scale};
      return flash_simt::launch_fwd<__nv_bfloat16>(q, k, v, o, lse, wide, st);
    }
  }
}

extern "C" int vlt_flash_bwd_dq(const void* q, const void* k, const void* v,
                                const void* dout, const void* lse,
                                const void* delta, void* dq, int b, int sq,
                                int skv, int h, int hkv, int d, int causal,
                                float scale, void* stream) {
  const flash::Shape sh{b, sq, skv, h, hkv, causal, scale};
  const cudaStream_t st = (cudaStream_t)stream;
  switch (d) {
    case 64:
      return flash::hopper::launch_dq<64>(q, k, v, dout, lse, delta, dq, sh,
                                          st);
    case 128:
      return flash::hopper::launch_dq<128>(q, k, v, dout, lse, delta, dq, sh,
                                           st);
#define VLT_CASE(D)                                                       \
  case D:                                                                 \
    return flash::wmma_body::launch_dq<D>(q, k, v, dout, lse, delta, dq, \
                                          sh, st);
      VLT_WMMA_HEAD_DIMS(VLT_CASE)
#undef VLT_CASE
    default: {
      if (d <= 256) return (int)cudaErrorInvalidValue;
      const flash_simt::Shape wide{b, sq, skv, h, hkv, d, causal, scale};
      return flash_simt::launch_dq<__nv_bfloat16>(q, k, v, dout, lse, delta,
                                                  dq, wide, st);
    }
  }
}

extern "C" int vlt_flash_bwd_dkv(const void* q, const void* k, const void* v,
                                 const void* dout, const void* lse,
                                 const void* delta, void* dk, void* dv, int b,
                                 int sq, int skv, int h, int hkv, int d,
                                 int causal, float scale, void* stream) {
  const flash::Shape sh{b, sq, skv, h, hkv, causal, scale};
  const cudaStream_t st = (cudaStream_t)stream;
  switch (d) {
    case 64:
      return flash::hopper::launch_dkv<64>(q, k, v, dout, lse, delta, dk, dv,
                                           sh, st);
    case 128:
      return flash::hopper::launch_dkv<128>(q, k, v, dout, lse, delta, dk,
                                            dv, sh, st);
#define VLT_CASE(D)                                                         \
  case D:                                                                   \
    return flash::wmma_body::launch_dkv<D>(q, k, v, dout, lse, delta, dk, \
                                           dv, sh, st);
      VLT_WMMA_HEAD_DIMS(VLT_CASE)
#undef VLT_CASE
    default: {
      if (d <= 256) return (int)cudaErrorInvalidValue;
      const flash_simt::Shape wide{b, sq, skv, h, hkv, d, causal, scale};
      return flash_simt::launch_dkv<__nv_bfloat16>(q, k, v, dout, lse, delta,
                                                   dk, dv, wide, st);
    }
  }
}
