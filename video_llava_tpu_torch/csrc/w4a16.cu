// W4A16: activations in bf16 (no activation quantization) against an int4
// nibble-packed weight, dequantized in the kernel, accumulated in f32.
//
// Replaces the W4A16 branches of video_llava_tpu/ops/quant4.py::
// int4_matmul_pallas, reached there under VLT_INT4_A8=0 / VLT_INT4_A8_BLOCK=0:
//   vlt_w4a16_matvec: one row, the VPU matvec (body _w4_matvec_kernel):
//     y[f] = sum_g sw[g, f] * (sum_{k in g} x[k] q[k, f])       (f32 x)
//   vlt_w4a16_block: two or more rows, the bf16 block matmul (body
//     _w4_matmul_kernel): the same with x rounded to bf16 and every
//     group's dot on the bf16 tensor cores.
// Packed (Dh, F) int8, D = 2 Dh: byte [i, f] holds q[i] + 8 in its low nibble
// and q[Dh + i] (two's complement) in its high nibble; scales sw (G, F) bf16,
// groups [0, G/2) over the low half and [G/2, G) over the high half; with
// G == 1 one scale row serves both halves. Every f32 group partial is
// scaled after its dot, as the Pallas kernels do.
//
// What bounds the matvec on Hopper: the packed bytes, read once (25.2 MB
// for Vicuna-7B's fused wqkv, 7.5 us at 3.35 TB/s), and in practice the
// issue around them: an I2F a nibble runs at 16 a clock an SM, which alone
// takes longer than the bytes, and even a LOP3 and two f32 FMAs a nibble
// kept the SMs busier than the bytes. The design: a block of 256 threads
// owns 128 columns, a warp a 32-column strip of half the block's rows, in
// k-steps of 16 packed rows; its lanes keep kMvDepth steps in flight with
// cp.async (16 bytes a lane) in a ring of shared memory, and one
// ldmatrix.trans a step gives every lane the bytes of two rows x two
// columns that the m16n8k16 A fragment holds (A = the weights, B = x). Two
// nibbles become a bf16 pair by bit arithmetic, one LOP3 into the mantissa
// of bf16 128 and one bf16x2 FMA subtracting 136 (unpack_pairs), exact for
// -8..7; the tensor cores form the products (exact: bf16 x times a small
// integer) and sum them in f32; each group's low- and high-half sums are
// scaled with scales loaded at the group's first step. K is split over
// blocks so that the column tiles fill the card (ops/quant4.py
// w4a16_rows_per_split), and add_splits_kernel adds the (split, F) f32
// partials in split order (measured faster here than a last-block merge
// behind an arrival counter, whose fences each block waits on).
// The block matmul: bf16 multiply-adds (2 nb D F, 138.5 G at 768 rows of
// the 7B gate_up) against 989 TFLOP/s; mma.sync m16n8k16 on 64 x 64 output
// tiles (4 warps of 32 x 32); a 32-row packed tile is unpacked to bf16
// (exact for -8..7) and transposed into shared memory, and feeds the
// low-half K slice (rows k against activation columns k) and the high-half
// one (rows Dh + k). Later work there: cp.async/TMA double buffering, wgmma.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "async_ring.cuh"
#include "int4_out.cuh"

namespace {

// Byte j of w as the low (offset-binary) and high (two's complement) nibble.
__device__ inline void nibbles(int w, int j, float& lo, float& hi) {
  const int b = (int)(int8_t)(w >> (8 * j));
  lo = (float)((b & 15) - 8);
  hi = (float)(b >> 4);
}

// m16n8k16 bf16 product, f32 accumulate: c += a b.
__device__ inline void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// ---------------------------------------------------------------------------
// matvec
// ---------------------------------------------------------------------------

constexpr int kMvThreads = 256;                       // 8 warps
constexpr int kMvStrips = 4;                          // 32-column strips a block
constexpr int kMvCols = 32 * kMvStrips;               // = W4A16_COLS in quant4.py
constexpr int kMvRowGroups = kMvThreads / 32 / kMvStrips;  // warps down a strip
constexpr int kMvK = 16;                              // packed rows a k-step
constexpr int kMvDepth = 8;                           // k-steps in flight a warp
constexpr int kMvStage = kMvK * 32;                   // bytes: 16 rows x 32 columns
constexpr size_t kMvRingBytes = (size_t)kMvThreads / 32 * kMvDepth * kMvStage;
static_assert(kMvRingBytes >= kMvRowGroups * kMvCols * sizeof(float),
              "the ring holds the block's reduction");

template <int Lut>
__device__ inline uint32_t lop3(uint32_t a, uint32_t b, uint32_t c) {
  uint32_t d;
  asm("lop3.b32 %0, %1, %2, %3, %4;" : "=r"(d) : "r"(a), "r"(b), "r"(c), "n"(Lut));
  return d;
}

// bf16x2 a - 136 (exact for 128 + u, u in 0..15).
__device__ inline uint32_t minus136(uint32_t a) {
  uint32_t d;
  asm("fma.rn.bf16x2 %0, %1, %2, %3;" : "=r"(d) : "r"(a), "r"(0x3F803F80u), "r"(0xC308C308u));
  return d;
}

// R from ldmatrix.trans holds the bytes [W[k][c], W[k][c+1], W[k+1][c],
// W[k+1][c+1]] of two packed rows k, k + 1 and two columns c, c + 1. ->
// lo[p], hi[p]: the bf16 pair (q at row k, q at row k + 1) of column c + p,
// low half (rows k of x) and high half (rows Dh + k), by bit arithmetic:
// each nibble ORed into the mantissa of bf16 128 (0x4300, unit steps) reads
// 128 + u, the high nibbles' sign bits flipped on the way (two's complement
// to offset binary, LOP3 0x6A: mask ? a ^ c : c), then one bf16x2 FMA
// subtracts 136 from both halves: q exactly.
__device__ inline void unpack_pairs(uint32_t r, uint32_t (&lo)[2],
                                    uint32_t (&hi)[2]) {
  lo[0] = minus136(lop3<0xEA>(r, 0x000F000Fu, 0x43004300u));
  lo[1] = minus136(lop3<0xEA>(r >> 8, 0x000F000Fu, 0x43004300u));
  hi[0] = minus136(lop3<0x6A>(r >> 4, 0x000F000Fu, 0x43084308u));
  hi[1] = minus136(lop3<0x6A>(r >> 12, 0x000F000Fu, 0x43084308u));
}

// 16 bytes global -> shared, zeros (and nothing read) when !valid.
__device__ inline void cp_async16_zfill(void* smem, const void* gmem, bool valid) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ inline void ldmatrix_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}

// One block: columns [blockIdx.x * kMvCols, +kMvCols), packed rows [k0, k1)
// = [blockIdx.y * rows, +rows), rows a multiple of 2 kMvK. Warp w takes the
// 32-column strip w % 4 and row group w / 4 (half of the block's rows), in
// k-steps of 16 rows: its 32 lanes copy the step's 16 x 32 bytes into their
// ring stage (16 bytes a lane, cp.async), one ldmatrix.trans hands each lane
// the (row pair, column pair) bytes the m16n8k16 A fragment wants (A = the
// weights, 16 columns x 16 rows; B = x, replicated over n), and four
// products (2 x 16 columns, low and high half) accumulate the group in f32.
// D row m is column 2 (m % 8) + m / 8 of a 16-column half-strip; every n
// holds the same sum. With one split the block writes out, else its f32
// partial (split, F) for add_splits_kernel.
template <typename TOut>
__global__ void __launch_bounds__(kMvThreads)
w4a16_matvec_kernel(const __nv_bfloat16* __restrict__ x,
                    const int8_t* __restrict__ packed,
                    const __nv_bfloat16* __restrict__ sw, TOut* __restrict__ out,
                    float* __restrict__ partial, int dh, int f, int n_groups,
                    int gr, int rows) {
  extern __shared__ __align__(16) unsigned char smem[];
  // (warps, kMvDepth, kMvStage) ring, then x of the rows: low, high half
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(smem + kMvRingBytes);
  const int gh = dh / gr;  // groups a half
  const int k0 = blockIdx.y * rows, k1 = min(k0 + rows, dh);
  const int nrows = k1 - k0;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gid = lane / 4, tig = lane % 4;
  const int strip = warp % kMvStrips, rg = warp / kMvStrips;
  const int c0 = blockIdx.x * kMvCols + strip * 32;  // the strip's first column
  const int half_rows = rows / kMvRowGroups;
  const int r0 = k0 + rg * half_rows, r1 = min(r0 + half_rows, k1);
  const int nk = r1 > r0 ? (r1 - r0) / kMvK : 0;
  unsigned char* stages = smem + (size_t)warp * kMvDepth * kMvStage;

  // The lane's copy: row lane / 2 of the step, 16 bytes (lane % 2) of the
  // strip, the halves of rows 4-7 and 12-15 swapped (ldmatrix then reads
  // without bank conflicts).
  const int crow = lane / 2, chalf = lane % 2;
  const bool cvalid = c0 + 16 * chalf < f;  // f % 16 == 0
  const int8_t* csrc = packed + (size_t)(r0 + crow) * f + c0 + 16 * chalf;
  const int cdst = crow * 32 + 16 * (chalf ^ ((crow >> 2) & 1));
  // Step i's copy into its stage, one commit group a step (empty past the
  // warp's rows), so every lane counts the same groups.
  auto fetch = [&](int i) {
    if (i < nk)
      cp_async16_zfill(stages + (i % kMvDepth) * kMvStage + cdst,
                       cvalid ? csrc + (size_t)i * kMvK * f : packed, cvalid);
    ring::commit();
  };
#pragma unroll
  for (int i = 0; i < kMvDepth; ++i) fetch(i);
  for (int k = 2 * threadIdx.x; k < nrows; k += 2 * kMvThreads) {
    *reinterpret_cast<uint32_t*>(xs + k) =
        *reinterpret_cast<const uint32_t*>(x + k0 + k);
    *reinterpret_cast<uint32_t*>(xs + rows + k) =
        *reinterpret_cast<const uint32_t*>(x + dh + k0 + k);
  }
  __syncthreads();

  // ldmatrix: lane l addresses row l % 8 (+8 for matrices 1, 3) of half l / 16
  const int lrow = lane % 8 + 8 * ((lane / 8) & 1), lhalf = lane / 16;
  const uint32_t laddr = (uint32_t)__cvta_generic_to_shared(stages) + lrow * 32 +
                         16 * (lhalf ^ ((lrow >> 2) & 1));
  const __nv_bfloat16* xl = xs + (r0 - k0) + 2 * tig;
  const __nv_bfloat16* xh = xl + rows;

  float d[2][2][4];  // [16-column half][low, high half] group sums
  float tot[2][2] = {{0.f, 0.f}, {0.f, 0.f}};  // [half-strip][column parity]
  uint32_t slo[2], shi[2];  // the group's scales of the lane's columns
  auto flush = [&]() {
#pragma unroll
    for (int cg = 0; cg < 2; ++cg) {
      const float2 sl = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&slo[cg]));
      const float2 sh = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&shi[cg]));
      tot[cg][0] += sl.x * d[cg][0][0] + sh.x * d[cg][1][0];
      tot[cg][1] += sl.y * d[cg][0][2] + sh.y * d[cg][1][2];
    }
  };
  int gend = r0;  // where the group of the current step ends
  for (int i = 0; i < nk; ++i) {
    const int row = r0 + i * kMvK;
    if (row == gend) {  // a group starts: its scales, its sums at 0
      if (i > 0) flush();
      const int gi = row / gr;
      gend = (gi + 1) * gr;
      const int gl = n_groups > 1 ? gi : 0, ghi = n_groups > 1 ? gi + gh : 0;
#pragma unroll
      for (int cg = 0; cg < 2; ++cg) {
        const int col = c0 + cg * 16 + 2 * gid;
        slo[cg] = col < f ? __ldg(reinterpret_cast<const uint32_t*>(sw + (size_t)gl * f + col)) : 0u;
        shi[cg] = col < f ? __ldg(reinterpret_cast<const uint32_t*>(sw + (size_t)ghi * f + col)) : 0u;
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int e = 0; e < 4; ++e) d[cg][h][e] = 0.f;
      }
    }
    ring::wait<kMvDepth - 1>();  // step i has landed
    __syncwarp();                 // every lane's copy of it
    uint32_t r[4];
    ldmatrix_x4_trans(r, laddr + (i % kMvDepth) * kMvStage);
    __syncwarp();                 // read before any lane refills the stage
    fetch(i + kMvDepth);
    const int kk = i * kMvK;
    const uint32_t blo0 = *reinterpret_cast<const uint32_t*>(xl + kk);
    const uint32_t blo1 = *reinterpret_cast<const uint32_t*>(xl + kk + 8);
    const uint32_t bhi0 = *reinterpret_cast<const uint32_t*>(xh + kk);
    const uint32_t bhi1 = *reinterpret_cast<const uint32_t*>(xh + kk + 8);
#pragma unroll
    for (int cg = 0; cg < 2; ++cg) {
      uint32_t lt[2], ht[2], lb[2], hb[2];  // rows 2tig.. (top), 2tig+8.. (bottom)
      unpack_pairs(r[2 * cg], lt, ht);
      unpack_pairs(r[2 * cg + 1], lb, hb);
      const uint32_t alo[4] = {lt[0], lt[1], lb[0], lb[1]};
      const uint32_t ahi[4] = {ht[0], ht[1], hb[0], hb[1]};
      mma_bf16(d[cg][0], alo, blo0, blo1);
      mma_bf16(d[cg][1], ahi, bhi0, bhi1);
    }
  }
  if (nk > 0) flush();
  ring::wait<0>();
  __syncthreads();  // the ring is free: the row groups' sums go there

  float* red = reinterpret_cast<float*>(smem);  // (kMvRowGroups, kMvCols)
  if (tig == 0) {
#pragma unroll
    for (int cg = 0; cg < 2; ++cg)
#pragma unroll
      for (int p = 0; p < 2; ++p)
        red[rg * kMvCols + strip * 32 + cg * 16 + 2 * gid + p] = tot[cg][p];
  }
  __syncthreads();
  const int col = threadIdx.x, gc = blockIdx.x * kMvCols + col;
  if (col < kMvCols && gc < f) {
    float s = 0.f;
#pragma unroll
    for (int g = 0; g < kMvRowGroups; ++g) s += red[g * kMvCols + col];
    if (gridDim.y > 1)
      partial[(size_t)blockIdx.y * f + gc] = s;
    else
      store(out + gc, s);
  }
}

template <typename TOut>
int launch_matvec(const void* x, const void* packed, const void* scales,
                  void* out, void* partial, int dh, int f, int n_groups,
                  int rows, cudaStream_t stream) {
  const int gr = n_groups > 1 ? 2 * dh / n_groups : dh;
  const int splits = (dh + rows - 1) / rows;
  const size_t smem = kMvRingBytes + 2 * (size_t)rows * sizeof(__nv_bfloat16);
  auto kernel = w4a16_matvec_kernel<TOut>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((f + kMvCols - 1) / kMvCols, splits);
  kernel<<<grid, kMvThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const int8_t*>(packed),
      static_cast<const __nv_bfloat16*>(scales), static_cast<TOut*>(out),
      static_cast<float*>(partial), dh, f, n_groups, gr, rows);
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return (int)err;
  add_splits_kernel<TOut><<<(f + 255) / 256, 256, 0, stream>>>(
      static_cast<const float*>(partial), static_cast<TOut*>(out), f, splits);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// block matmul
// ---------------------------------------------------------------------------

constexpr int kBM = 64, kBN = 64, kKP = 32;  // output tile, packed rows/step
constexpr int kLds = kKP + 8;  // shared row stride in bf16: conflict-free
constexpr int kBlkThreads = 128;


template <typename TOut>
__global__ void __launch_bounds__(kBlkThreads)
w4a16_block_kernel(const __nv_bfloat16* __restrict__ x,
                   const int8_t* __restrict__ packed,
                   const __nv_bfloat16* __restrict__ sw, TOut* __restrict__ out,
                   int nb, int dh, int f, int n_groups, int gr) {
  // [m][k] activation tiles and [n][k] unpacked weight tiles, low and high
  __shared__ __align__(16) __nv_bfloat16 a_lo[kBM * kLds], a_hi[kBM * kLds];
  __shared__ __align__(16) __nv_bfloat16 b_lo[kBN * kLds], b_hi[kBN * kLds];

  const int d = 2 * dh, gh = dh / gr;
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wm = (warp >> 1) * 32, wn = (warp & 1) * 32;
  const int gid = lane >> 2, tig = lane & 3;

  float acc_lo[2][4][4], acc_hi[2][4][4], facc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        acc_lo[i][j][e] = acc_hi[i][j][e] = facc[i][j][e] = 0.f;

  for (int k0 = 0; k0 < dh; k0 += kKP) {
    {  // activations: 64 rows x 32 columns of each half, 2 x 16 bytes a thread
      const int r = tid >> 1, ch = (tid & 1) * 16, gm = m0 + r;
      uint4 lo[2], hi[2];
#pragma unroll
      for (int u = 0; u < 2; ++u) lo[u] = hi[u] = make_uint4(0u, 0u, 0u, 0u);
      if (gm < nb) {
        const __nv_bfloat16* src = x + (size_t)gm * d + k0 + ch;
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          lo[u] = *reinterpret_cast<const uint4*>(src + 8 * u);
          hi[u] = *reinterpret_cast<const uint4*>(src + dh + 8 * u);
        }
      }
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        *reinterpret_cast<uint4*>(a_lo + r * kLds + ch + 8 * u) = lo[u];
        *reinterpret_cast<uint4*>(a_hi + r * kLds + ch + 8 * u) = hi[u];
      }
    }
    {  // weights: 32 packed rows x 64 columns, unpacked and transposed
      const int kr = tid >> 2, ch = (tid & 3) * 16, gn = n0 + ch;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (gn < f)
        v = __ldg(reinterpret_cast<const uint4*>(
            packed + (size_t)(k0 + kr) * f + gn));
      const int* words = reinterpret_cast<const int*>(&v);
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        float lo, hi;
        nibbles(words[j >> 2], j & 3, lo, hi);
        b_lo[(ch + j) * kLds + kr] = __float2bfloat16(lo);
        b_hi[(ch + j) * kLds + kr] = __float2bfloat16(hi);
      }
    }
    __syncthreads();

#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const __nv_bfloat16* as = half ? a_hi : a_lo;
      const __nv_bfloat16* bs = half ? b_hi : b_lo;
#pragma unroll
      for (int kk = 0; kk < kKP; kk += 16) {
        uint32_t a[2][4];
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const __nv_bfloat16* p = as + (wm + i * 16 + gid) * kLds + kk + tig * 2;
          a[i][0] = *reinterpret_cast<const uint32_t*>(p);
          a[i][1] = *reinterpret_cast<const uint32_t*>(p + 8 * kLds);
          a[i][2] = *reinterpret_cast<const uint32_t*>(p + 8);
          a[i][3] = *reinterpret_cast<const uint32_t*>(p + 8 * kLds + 8);
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const __nv_bfloat16* p = bs + (wn + j * 8 + gid) * kLds + kk + tig * 2;
          const uint32_t b0 = *reinterpret_cast<const uint32_t*>(p);
          const uint32_t b1 = *reinterpret_cast<const uint32_t*>(p + 8);
#pragma unroll
          for (int i = 0; i < 2; ++i)
            mma_bf16(half ? acc_hi[i][j] : acc_lo[i][j], a[i], b0, b1);
        }
      }
    }
    __syncthreads();

    if ((k0 + kKP) % gr == 0) {  // end of group: scale the f32 partials
      const int gi = k0 / gr;
      const int gl = n_groups > 1 ? gi : 0, ghi = n_groups > 1 ? gi + gh : 0;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = n0 + wn + j * 8 + tig * 2;
        float sl[2], sh[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const bool ok = c + e < f;
          sl[e] = ok ? __bfloat162float(sw[(size_t)gl * f + c + e]) : 0.f;
          sh[e] = ok ? __bfloat162float(sw[(size_t)ghi * f + c + e]) : 0.f;
        }
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            facc[i][j][e] += sl[e & 1] * acc_lo[i][j][e] +
                             sh[e & 1] * acc_hi[i][j][e];
            acc_lo[i][j][e] = acc_hi[i][j][e] = 0.f;
          }
      }
    }
  }

  // accumulator element e: row gid (+8 for e >= 2), column tig * 2 + (e & 1)
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int e = 0; e < 4; e += 2) {
      const int r = m0 + wm + i * 16 + gid + (e ? 8 : 0);
      if (r >= nb) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = n0 + wn + j * 8 + tig * 2;
        if (c < f) store(out + (size_t)r * f + c, facc[i][j][e]);
        if (c + 1 < f) store(out + (size_t)r * f + c + 1, facc[i][j][e + 1]);
      }
    }
}

template <typename TOut>
int launch_block(const void* x, const void* packed, const void* scales,
                 void* out, int nb, int dh, int f, int n_groups,
                 cudaStream_t stream) {
  const int gr = n_groups > 1 ? 2 * dh / n_groups : dh;
  dim3 grid((f + kBN - 1) / kBN, (nb + kBM - 1) / kBM);
  w4a16_block_kernel<TOut><<<grid, kBlkThreads, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const int8_t*>(packed),
      static_cast<const __nv_bfloat16*>(scales), static_cast<TOut*>(out), nb,
      dh, f, n_groups, gr);
  return (int)cudaGetLastError();
}

}  // namespace

// x: (1, 2 dh) bf16; packed: (dh, f) int8; scales: (n_groups, f) bf16;
// out: (1, f) f32 (out_bf16 = 0) or bf16; with ceil(dh / rows) > 1 splits,
// partial: (splits, f) f32 scratch, else unused. rows a multiple of 32, a group's packed rows (2 dh /
// n_groups, or dh when n_groups == 1) a multiple of 16, f % 16 == 0.
extern "C" int vlt_w4a16_matvec(const void* x, const void* packed,
                                const void* scales, void* out, void* partial,
                                int dh, int f, int n_groups, int rows,
                                int out_bf16, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int gr = n_groups > 1 ? 2 * dh / n_groups : dh;
  if (rows < 1 || rows % (kMvRowGroups * kMvK) || gr % kMvK || f % 16 ||
      (rows < dh && !partial))
    return (int)cudaErrorInvalidValue;
  if (out_bf16)
    return launch_matvec<__nv_bfloat16>(x, packed, scales, out, partial, dh,
                                        f, n_groups, rows, st);
  return launch_matvec<float>(x, packed, scales, out, partial, dh, f,
                              n_groups, rows, st);
}

// x: (nb, 2 dh) bf16; packed: (dh, f) int8; scales: (n_groups, f) bf16;
// out: (nb, f) f32 (out_bf16 = 0) or bf16. Every group's packed rows
// (2 dh / n_groups, or dh when n_groups == 1) a multiple of 32; f % 16 == 0.
extern "C" int vlt_w4a16_block(const void* x, const void* packed,
                               const void* scales, void* out, int nb, int dh,
                               int f, int n_groups, int out_bf16,
                               void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int gr = n_groups > 1 ? 2 * dh / n_groups : dh;
  if (nb < 1 || gr % kKP || f % 16) return (int)cudaErrorInvalidValue;
  if (out_bf16)
    return launch_block<__nv_bfloat16>(x, packed, scales, out, nb, dh, f,
                                       n_groups, st);
  return launch_block<float>(x, packed, scales, out, nb, dh, f, n_groups, st);
}
