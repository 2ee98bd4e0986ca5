// Flash attention forward in f32, over BSHD tensors: kernel 7's body for
// f32 operands, and kernel 1's (vlt_flash_bhsd_f32, at the end: head-major
// operands with a key-length mask).
//
// Replaces video_llava_tpu/ops/attention.py::_flash_forward (kernel 7)
// where its operands are f32, as the JAX package's Whisper `base` (f32
// parameters) gives them in the chat CLI's --use_asr transcriber. The
// function is flash_attention.cu's forward: for q (b, sq, h, d) and k/v
// (b, skv, h_kv, d), query head hi reading kv head hi / (h / h_kv),
//   o = softmax((q * scale) k^T) v  (f32),
//   lse = m + log(l)                (f32, (b, h, sq); 1e30 where not finite)
// with keys at or past skv masked and, with `causal`, key j seen by query
// i iff j <= i + skv - sq. As in the Pallas body, q is scaled before the
// first product and P stays f32 for the second.
//
// Every product runs on the tensor cores as 3xTF32: each operand x is
// split into hi = x rounded to TF32 (as cvt.rna: 10 mantissa bits) and
// lo = x - hi, and x y is taken as lo_x hi_y + hi_x lo_y + hi_x hi_y
// (small terms first; lo lo dropped), each an m16n8k8 TF32 mma.sync
// accumulating in f32. A product keeps about 21 bits, near f32: the
// result differs from the plain f32 version by a few f32 ulps (2.5e-6 at
// two 30 s chunks), where one TF32 pass would keep about 10 bits
// (2.4e-4 to 2.8e-4 measured).
//
// What bounds it: at Whisper base's encoder shape (1, 1500, 8, 64) the two
// products are 4.6e9 operations, three times over as 3xTF32: 1.38e10 at
// 495 TFLOP/s (TF32, dense) is 0.028 ms; the same work as f32 FMAs would
// be 0.069 ms at 67 TFLOP/s; the 12.3 MB of q/k/v/o move in 0.004 ms at
// 3.35 TB/s. Operations bound it, and mma.sync reaches about half of
// the TF32 rate (wgmma's): the two extra products of 3xTF32 took 0.059
// of 0.123 ms (against a one-pass variant), 8-9 cycles an m16n8k8 on
// each quarter of an SM that runs two blocks.
//
// The design (FA2 on mma.sync): a block of 4 warps owns 64 query rows of
// one (b, head), 16 rows a warp; b*h runs along grid x, the query tiles
// along y (longest first under the causal mask). A warp's Q rows are
// loaded once from global memory, scaled, and held as A fragments in
// registers (split into hi and lo once at d <= 64; at larger d, where
// that would take 2d registers, split at each use). K and V tiles of 64
// keys stream through a ring of 3 stages (2 at d > 64) filled by 16-byte
// cp.async copies, rows past skv zeroed; the pitch d + 4 floats (a pitch
// of 4 mod 8 words) makes every fragment load below conflict-free. K's
// fragments come four at a time by ldmatrix (a row of 4 f32 is a row of
// 8 b16). Each warp splits the K and V elements as it loads its
// fragments (splitting each tile once into hi and lo halves in shared
// memory measured 0-4% slower). S = Q K^T lands in the m16n8
// accumulator, where a row lives in the 4 lanes of a quad: the online
// softmax takes two shuffles a row for the max, and the row sums stay
// per lane until the end. P is then the A operand of P V
// with no trip through shared memory: the accumulator holds keys
// {2t, 2t+1} of each 8 where the TF32 A fragment wants {t, t+4}, and a sum
// over keys does not depend on their order, so P stays where it is and
// V's B fragment is read from key rows 2t and 2t + 1. The causal mask
// skips the tiles past the diagonal and is applied only on the diagonal
// and ragged tiles. At d 64 a block takes 102 KB of shared memory: two
// blocks an SM. Head dims: multiples of 16 up to 128, and 256 (the
// wrapper pads d % 16 == 8, and d in (128, 256] to 256). Past 256 (padded
// to a multiple of 128) the entry takes the SIMT body of
// flash_attention_simt.cuh, which also gives kernel 8's f32 entries at the
// end of this file.
//
// At d 256 neither Q's fragments (128 registers a lane) nor O's
// accumulators over all 256 columns (another 128) fit beside the scores,
// and 64-key tiles of K and V in two stages would take 266 KB. So there:
// Q, scaled, sits in shared memory (66.5 KB at a pitch of 260 floats,
// conflict-free for the fragment loads as K's pitch is) and its fragments
// are read and split at each use; the output columns split into slabs of
// 128 along grid z, each block recomputing S over the whole d and reading
// only its slab of V; and the tiles hold 32 keys. A block then takes 163
// KB, one an SM.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "async_ring.cuh"
#include "flash_attention_simt.cuh"
#include "hopper.cuh"  // ex2, quad_max, quad_sum, smem_addr

namespace flash_f32 {

using flash::hopper::ex2;
using flash::hopper::quad_max;
using flash::hopper::quad_sum;

constexpr int kRows = 64;      // query rows a block owns, 16 a warp
constexpr int kThreads = 128;  // 4 warps
constexpr float kSentinel = 1e30f;

// skv: K's and V's rows a batch entry (their addressing); kv_len <= skv:
// the keys seen (rows at or past kv_len are masked and never read).
struct Shape {
  int b, sq, skv, h, hkv, causal;
  float scale;
  int kv_len;
};

template <int D>
struct Layout {
  static constexpr bool wide = D > 128;  // Q in shared memory, slabs of O
  static constexpr int cols = wide ? 128 : D;  // output columns a block
  static constexpr int keys = wide ? 32 : 64;  // keys a tile
  static constexpr int pitch = D + 4;  // floats; pitch / 4 is odd
  static constexpr int vpitch = cols + 4;  // V's slab
  static constexpr int stages = D <= 64 ? 3 : 2;
  static constexpr size_t ktile = (size_t)keys * pitch;  // floats
  static constexpr size_t stage = ktile + (size_t)keys * vpitch;
  static constexpr size_t qtile = wide ? (size_t)kRows * pitch : 0;
  static constexpr size_t bytes = (stages * stage + qtile) * 4;
};

// x rounded to TF32 as cvt.rna.tf32.f32 rounds a finite x: to nearest,
// ties away from zero, the 13 low mantissa bits cleared.
__device__ __forceinline__ uint32_t to_tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// x = hi + lo: hi TF32, lo = x - hi (exact in f32) as it is; the tensor
// core reads a TF32 operand's top 19 bits, so lo is truncated there
// (rounding it first measured the same error, 7-11% slower).
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = to_tf32(x);
  lo = __float_as_uint(x - __uint_as_float(hi));
}

constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a b in 3xTF32: a = ah + al, b = (bh0, bh1) + (bl0, bl1).
__device__ __forceinline__ void mma_3x(float (&d)[4], const uint32_t (&ah)[4],
                                       const uint32_t (&al)[4], uint32_t bh0,
                                       uint32_t bh1, uint32_t bl0,
                                       uint32_t bl1) {
  mma_tf32(d, al, bh0, bh1);
  mma_tf32(d, ah, bl0, bl1);
  mma_tf32(d, ah, bh0, bh1);
}

// Four blocks of 8 rows x 4 f32 of shared memory (each an 8 x 8 b16
// matrix to ldmatrix), lane l giving the address of row l % 8 of block
// l / 8: r[i] is block i's element (row lane / 4, column lane % 4), a
// tf32 B fragment's b0 or b1.
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const float* p) {
  const uint32_t a = flash::hopper::smem_addr(p);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

// Key tile `kb` (rows `stride` floats apart) into ring slot `slot`: K's d
// columns, then V's slab (vh points at its first column), 16-byte copies;
// rows at or past skv are zeroed (a zero V row times p = 0 adds nothing,
// where stale shared memory could hold a NaN).
template <int D>
__device__ __forceinline__ void load_tile(float* smem, int slot,
                                          const float* kh, const float* vh,
                                          size_t stride, int kb, int skv) {
  using L = Layout<D>;
  constexpr int kVec = D / 4, vVec = L::cols / 4;
  float* ks = smem + (size_t)slot * L::stage;
  float* vs = ks + L::ktile;
  const int k0 = kb * L::keys;
  for (int i = threadIdx.x; i < L::keys * kVec; i += kThreads) {
    const int r = i / kVec, c = (i % kVec) * 4;
    float* dk = ks + r * L::pitch + c;
    if (k0 + r < skv)
      ring::cp_async16(dk, kh + (size_t)(k0 + r) * stride + c);
    else
      *reinterpret_cast<float4*>(dk) = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  for (int i = threadIdx.x; i < L::keys * vVec; i += kThreads) {
    const int r = i / vVec, c = (i % vVec) * 4;
    float* dv = vs + r * L::vpitch + c;
    if (k0 + r < skv)
      ring::cp_async16(dv, vh + (size_t)(k0 + r) * stride + c);
    else
      *reinterpret_cast<float4*>(dv) = make_float4(0.f, 0.f, 0.f, 0.f);
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads, 2)
fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
           const float* __restrict__ v, float* __restrict__ o,
           float* __restrict__ lse, Shape sh) {
  using L = Layout<D>;
  constexpr int P = L::pitch, PV = L::vpitch, S = L::stages;
  constexpr int KS = D / 8;        // k-steps of Q K^T
  constexpr int NT = L::cols / 8;  // n-tiles of the block's output slab
  constexpr int NJ = L::keys / 8;  // n-tiles of S, k-steps of P V
  // At d <= 64 Q's fragments are held split, and each tile's P V is
  // summed apart and then folded into O by an IEEE f32 FMA: the tensor
  // core's sums do not round to nearest, and 24 tiles of 24 sums each
  // into one accumulator drifted 5x further from the plain version
  // (1.2e-5 against 2.5e-6 at two 30 s chunks, for 1.6% more time).
  // Wider d has no registers for either; past 128, Q's fragments are read
  // from shared memory at each use.
  constexpr bool kNarrow = D <= 64, kWide = L::wide;
  extern __shared__ __align__(16) float smem[];

  const int bh = blockIdx.x;
  const int bi = bh / sh.h, hi = bh % sh.h;
  const int kvh = hi / (sh.h / sh.hkv);
  const size_t qstride = (size_t)sh.h * D, kstride = (size_t)sh.hkv * D;
  const size_t qhead = (size_t)bi * sh.sq * qstride + (size_t)hi * D;
  const size_t khead = (size_t)bi * sh.skv * kstride + (size_t)kvh * D;
  const int col0 = blockIdx.z * L::cols;  // this block's slab of o and V
  const float* kh = k + khead;
  const float* vh = v + khead + col0;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kRows;  // longest first
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;  // quad, lane in the quad
  const int r0 = q0 + warp * 16 + g, r1 = r0 + 8;  // this lane's rows
  const int off = sh.skv - sh.sq;
  // This lane's row address for ldsm_x4 over K: the blocks are keys
  // 8j + (0-7) at dims 8kk + (0-3), 8kk + (4-7), then keys 8(j + 1) + ..
  const int ldsm_at =
      ((lane >> 4) * 8 + (lane & 7)) * P + ((lane >> 3) & 1) * 4;

  // Key tiles these rows see: all, or (causal) up to the key the last
  // real row sees. Key 0 is seen by every row (sq <= skv under the causal
  // mask), so m is finite after the first tile.
  int num_kb = (sh.kv_len + L::keys - 1) / L::keys;
  if (sh.causal)
    num_kb = min(num_kb, (min(q0 + kRows, sh.sq) - 1 + off) / L::keys + 1);

#pragma unroll
  for (int s = 0; s < S - 1; ++s) {
    if (s < num_kb) load_tile<D>(smem, s, kh, vh, kstride, s, sh.kv_len);
    ring::commit();
  }

  // Q's A fragments, scaled: a0 (r0, 8kk + t), a1 (r1, 8kk + t),
  // a2 (r0, 8kk + t + 4), a3 (r1, 8kk + t + 4); rows past sq are zero.
  // kWide: the block's 64 rows, scaled, into shared memory past the ring
  // (read after the first tile's barrier).
  float* qsm = smem + S * L::stage;
  if constexpr (kWide) {
    for (int i = threadIdx.x; i < kRows * (D / 4); i += kThreads) {
      const int r = i / (D / 4), c = (i % (D / 4)) * 4;
      float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
      if (q0 + r < sh.sq)
        x = __ldg(reinterpret_cast<const float4*>(
            q + qhead + (size_t)(q0 + r) * qstride + c));
      *reinterpret_cast<float4*>(qsm + r * P + c) = make_float4(
          x.x * sh.scale, x.y * sh.scale, x.z * sh.scale, x.w * sh.scale);
    }
  }
  const float* qw = qsm + (warp * 16 + g) * P + t;  // this lane's a0
  float qf[kWide ? 1 : KS][4];
  if constexpr (!kWide) {
    const float* q_r0 = q + qhead + (size_t)r0 * qstride;
    const float* q_r1 = q + qhead + (size_t)r1 * qstride;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      const int c = 8 * kk + t;
      qf[kk][0] = r0 < sh.sq ? __ldg(q_r0 + c) * sh.scale : 0.f;
      qf[kk][1] = r1 < sh.sq ? __ldg(q_r1 + c) * sh.scale : 0.f;
      qf[kk][2] = r0 < sh.sq ? __ldg(q_r0 + c + 4) * sh.scale : 0.f;
      qf[kk][3] = r1 < sh.sq ? __ldg(q_r1 + c + 4) * sh.scale : 0.f;
    }
  }
  uint32_t qs[kNarrow ? KS : 1][2][4];
  if constexpr (kNarrow) {
#pragma unroll
    for (int kk = 0; kk < KS; ++kk)
#pragma unroll
      for (int i = 0; i < 4; ++i) split(qf[kk][i], qs[kk][0][i], qs[kk][1][i]);
  }

  float acc[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};

  for (int kb = 0; kb < num_kb; ++kb) {
    ring::wait<S - 2>();  // this thread's copies of tile kb have landed
    __syncthreads();      // ... everyone's; and tile kb - 1 is consumed
    if (kb + S - 1 < num_kb)
      load_tile<D>(smem, (kb + S - 1) % S, kh, vh, kstride, kb + S - 1,
                   sh.kv_len);
    ring::commit();
    const float* ks = smem + (size_t)(kb % S) * L::stage;
    const float* vs = ks + L::ktile;
    const int k0 = kb * L::keys;

    // S = (Q scale) K^T: s[j] holds keys 8j + 2t, 8j + 2t + 1 of rows r0
    // (s[j][0..1]) and r1 (s[j][2..3]).
    float s[NJ][4];
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      uint32_t ah[4], al[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if constexpr (kNarrow) {
          ah[i] = qs[kk][0][i];
          al[i] = qs[kk][1][i];
        } else if constexpr (kWide) {
          // a_i at row + 8 (i odd), column + 4 (i >= 2)
          split(qw[(i & 1) * 8 * P + (i >> 1) * 4 + 8 * kk], ah[i], al[i]);
        } else {
          split(qf[kk][i], ah[i], al[i]);
        }
      }
#pragma unroll
      for (int j = 0; j < NJ; j += 2) {
        // B (8 dims x 8 keys) of keys 8j' + g: b0 K[8j' + g][8kk + t],
        // b1 K[8j' + g][8kk + t + 4], for j' = j, j + 1
        uint32_t kr[4];
        ldsm_x4(kr, ks + ldsm_at + 8 * j * P + 8 * kk);
#pragma unroll
        for (int jj = 0; jj < 2; ++jj) {
          uint32_t bh0, bl0, bh1, bl1;
          split(__uint_as_float(kr[2 * jj]), bh0, bl0);
          split(__uint_as_float(kr[2 * jj + 1]), bh1, bl1);
          mma_3x(s[j + jj], ah, al, bh0, bh1, bl0, bl1);
        }
      }
    }

    if (k0 + L::keys > sh.kv_len ||
        (sh.causal && k0 + L::keys - 1 > q0 + off)) {
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kj = k0 + 8 * j + 2 * t + (e & 1);
          const int qi = e < 2 ? r0 : r1;
          if (!(kj < sh.kv_len && (!sh.causal || kj <= qi + off)))
            s[j][e] = -INFINITY;
        }
    }

    // Online softmax, row r0 (i = 0) and r1 (i = 1): a row's scores of
    // the tile over the quad; the row sum stays a per-lane partial. exp(x)
    // as 2^(x log2 e).
    float alpha[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < NJ; ++j)
        mx = fmaxf(mx, fmaxf(s[j][2 * i], s[j][2 * i + 1]));
      const float m_new = fmaxf(m[i], quad_max(mx));
      const float mb = m_new * kLog2e;
      alpha[i] = ex2((m[i] - m_new) * kLog2e);
      m[i] = m_new;
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int e = 2 * i; e < 2 * i + 2; ++e) {
          s[j][e] = ex2(fmaf(s[j][e], kLog2e, -mb));
          sum += s[j][e];
        }
      l[i] = alpha[i] * l[i] + sum;
    }
    float pv[kNarrow ? NT : 1][4];
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if constexpr (kNarrow)
          pv[n][e] = 0.f;
        else
          acc[n][e] *= alpha[e >> 1];
      }

    // O += P V over the tile's steps of 8 keys. P's A fragment in key
    // order (2t, 2t + 1) for the logical columns (t, t + 4).
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      uint32_t ah[4], al[4];
      split(s[j][0], ah[0], al[0]);  // (r0, key 2t)
      split(s[j][2], ah[1], al[1]);  // (r1, key 2t)
      split(s[j][1], ah[2], al[2]);  // (r0, key 2t + 1)
      split(s[j][3], ah[3], al[3]);  // (r1, key 2t + 1)
      const float* vp = vs + (8 * j + 2 * t) * PV + g;
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        // B (8 keys x 8 dims): b0 V[8j + 2t][8n + g], b1 V[8j + 2t + 1][..]
        uint32_t bh0, bl0, bh1, bl1;
        split(vp[8 * n], bh0, bl0);
        split(vp[PV + 8 * n], bh1, bl1);
        if constexpr (kNarrow)
          mma_3x(pv[n], ah, al, bh0, bh1, bl0, bl1);
        else
          mma_3x(acc[n], ah, al, bh0, bh1, bl0, bl1);
      }
    }
    if constexpr (kNarrow) {
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          acc[n][e] = fmaf(acc[n][e], alpha[e >> 1], pv[n][e]);
    }
  }

  // acc[n] holds columns 8n + 2t, 8n + 2t + 1 of rows r0 and r1.
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float lc = fmaxf(quad_sum(l[i]), 1e-30f);
    const int qi = i ? r1 : r0;
    if (qi >= sh.sq) continue;
    float* orow = o + qhead + (size_t)qi * qstride + col0 + 2 * t;
#pragma unroll
    for (int n = 0; n < NT; ++n)
      *reinterpret_cast<float2*>(orow + 8 * n) =
          make_float2(acc[n][2 * i] / lc, acc[n][2 * i + 1] / lc);
    if (lse != nullptr && t == 0 && blockIdx.z == 0) {
      const float x = m[i] + logf(lc);
      lse[(size_t)bh * sh.sq + qi] = isfinite(x) ? x : kSentinel;
    }
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* o, void* lse,
           const Shape& sh, cudaStream_t stream) {
  auto kernel = fwd_kernel<D>;
  const size_t bytes = Layout<D>::bytes;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               (int)cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(sh.b * sh.h, (sh.sq + kRows - 1) / kRows, D / Layout<D>::cols);
  kernel<<<grid, kThreads, bytes, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o),
      static_cast<float*>(lse), sh);
  return (int)cudaGetLastError();
}

}  // namespace flash_f32

extern "C" int vlt_flash_fwd_f32(const void* q, const void* k, const void* v,
                                 void* o, void* lse, int b, int sq, int skv,
                                 int h, int hkv, int d, int causal,
                                 float scale, void* stream) {
  const flash_f32::Shape sh{b, sq, skv, h, hkv, causal, scale, skv};
  const cudaStream_t st = (cudaStream_t)stream;
  switch (d) {
#define VLT_CASE(D) \
  case D:           \
    return flash_f32::launch<D>(q, k, v, o, lse, sh, st);
    VLT_CASE(16) VLT_CASE(32) VLT_CASE(48) VLT_CASE(64) VLT_CASE(80)
    VLT_CASE(96) VLT_CASE(112) VLT_CASE(128) VLT_CASE(256)
#undef VLT_CASE
    default: {
      // past 256: the SIMT body (flash_attention_simt.cuh)
      if (d <= 256) return (int)cudaErrorInvalidValue;
      const flash_simt::Shape wide{b, sq, skv, h, hkv, d, causal, scale};
      return flash_simt::launch_fwd<float>(q, k, v, o, lse, wide, st);
    }
  }
}

// Kernel 1 on f32 operands (JAX flash_attention_bhsd, ops/attention.py:360,
// where the grounding crop filter's ViT-B/32 gives it f32): non-causal
// attention over head-major, once-padded (bh, s, d) q, k, v -> o, keys at
// or past kv_len masked, no lse. Head-major is BSHD with one head, so the
// body above runs it as b = bh, h = h_kv = 1; the pad rows of q are
// computed as every row is, and k's and v's pad rows are never read. Head
// dims: multiples of 16 up to 128, as kernel 1's bf16 entry takes.
extern "C" int vlt_flash_bhsd_f32(const void* q, const void* k,
                                  const void* v, void* o, int bh, int s,
                                  int d, int kv_len, float scale,
                                  void* stream) {
  if (kv_len < 1 || kv_len > s) return (int)cudaErrorInvalidValue;
  const flash_f32::Shape sh{bh, s, s, 1, 1, 0, scale, kv_len};
  const cudaStream_t st = (cudaStream_t)stream;
  switch (d) {
#define VLT_CASE(D) \
  case D:           \
    return flash_f32::launch<D>(q, k, v, o, nullptr, sh, st);
    VLT_CASE(16) VLT_CASE(32) VLT_CASE(48) VLT_CASE(64) VLT_CASE(80)
    VLT_CASE(96) VLT_CASE(112) VLT_CASE(128)
#undef VLT_CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// Kernel 8 on f32 operands, at every head dim the wrappers give (multiples
// of 16 up to 128, 256, multiples of 128 past it): the SIMT body of
// flash_attention_simt.cuh, f32 throughout.
extern "C" int vlt_flash_bwd_dq_f32(const void* q, const void* k,
                                    const void* v, const void* dout,
                                    const void* lse, const void* delta,
                                    void* dq, int b, int sq, int skv, int h,
                                    int hkv, int d, int causal, float scale,
                                    void* stream) {
  const flash_simt::Shape sh{b, sq, skv, h, hkv, d, causal, scale};
  return flash_simt::launch_dq<float>(q, k, v, dout, lse, delta, dq, sh,
                                      (cudaStream_t)stream);
}

extern "C" int vlt_flash_bwd_dkv_f32(const void* q, const void* k,
                                     const void* v, const void* dout,
                                     const void* lse, const void* delta,
                                     void* dk, void* dv, int b, int sq,
                                     int skv, int h, int hkv, int d,
                                     int causal, float scale, void* stream) {
  const flash_simt::Shape sh{b, sq, skv, h, hkv, d, causal, scale};
  return flash_simt::launch_dkv<float>(q, k, v, dout, lse, delta, dk, dv, sh,
                                       (cudaStream_t)stream);
}
