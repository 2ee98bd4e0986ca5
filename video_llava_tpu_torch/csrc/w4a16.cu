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
// the 7B gate_up, 0.140 ms at 989 TFLOP/s); at a few rows (decode windows
// of 2-8, serving's 36-row verifies) the packed weight's bytes (25.2 MB
// for wqkv, 7.5 us). A first body (mma.sync on 64 x 64 tiles, each 32-row
// step loaded synchronously and unpacked a byte at a time into transposed
// shared tiles) ran at 0.09 of the operations bound. The design is kernel
// B's (csrc/w4a8_block.cu) in bf16: the swapped product out^T = W^T x^T,
// the weight as the register A operand of wgmma m64nNk16 (64 output
// columns a warpgroup; one ldmatrix.x4.trans a 32-row piece and
// unpack_pairs make the fragments of two k-steps of both halves, exact),
// x (nb, D), K-major as it lies, the shared B operand (N = a tile of 8 to
// 128 activation rows, chosen from nb). A block of two consumer
// warpgroups and a producer warpgroup owns 128 columns x one row tile
// over a K range; the producer's one thread keeps a ring of stages in
// flight by TMA under full/empty mbarriers: 128 packed rows x 128 columns
// and the two halves' 128-column x tiles (128-byte swizzle; rows past nb,
// columns past F and rows past Dh come in as zeros). Each group's sums
// start afresh (scale-d 0 at a run's first k-step) and are folded into the
// f32 total with one FMA an element, the low half with sw[g], the high
// half with sw[g + G/2]; at 128 rows the two warpgroups take turns
// issuing, so one folds while the other's products run. K is split over
// blocks in whole groups where the output tiles alone leave the waves
// uneven (ops/quant4.py w4a16_block_plan), and add_splits_kernel adds the
// (split, nb, F) f32 partials in order: deterministic, no atomics.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "async_ring.cuh"
#include "hopper.cuh"
#include "int4_out.cuh"

namespace {

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

using namespace flash::hopper;

constexpr int kBlkCols = 128;  // columns a block (= quant4.W4A16_BLOCK_COLS)
constexpr int kBlkStep = 128;  // packed rows a stage (= quant4.W4A16_BLOCK_STEP)
constexpr int kConsumers = 2;  // warpgroups, 64 columns each
constexpr int kBlkThreads = 128 * (kConsumers + 1);
constexpr int kProducerRegs = 40, kConsumerRegs = 232;
static_assert(kConsumers * kConsumerRegs + kProducerRegs ==
                  (kConsumers + 1) * 168,
              "the register budget of a block of 384 threads");
constexpr uint32_t kPackedTile = kBlkCols * kBlkStep;  // bytes
constexpr int kOutStride = 68;  // floats a row of the staged output tile
constexpr int kAllConsumers = 3;  // named barrier of both warpgroups

// = quant4.w4a16_block_stage_bytes: the packed tile, then x's low- and
// high-half tiles (bn rows x 128 bf16 each, two 64-column chunks).
__host__ __device__ constexpr uint32_t blk_stage_bytes(int bn) {
  return kPackedTile + 4u * bn * kBlkStep;
}

// = quant4.w4a16_block_smem_bytes: the ring, its full and empty barriers,
// and 1 KB to align the ring to the swizzle's period.
__host__ __device__ constexpr size_t blk_smem(int bn, int stages) {
  return (size_t)stages * blk_stage_bytes(bn) + 16 * stages + 1024;
}

struct BlkArgs {
  int nb, dh, f, n_groups, gr, stages, rows_per_split;
};

// One block: a tile of BN activation rows x kBlkCols columns (blockIdx.x),
// packed rows [k_begin, k_end) of split blockIdx.z. Warpgroup wg owns
// columns 64 wg..64 wg + 63 of the block, its warp w the 16 from
// 64 wg + 16 w as the M rows of the swapped product out^T = W^T x^T: M
// row gid is column 2 gid, row gid + 8 column 2 gid + 1, so accumulator
// register i of lane (gid, tig) is column 2 gid + (i / 2) % 2 and
// activation row 8 (i / 4) + 2 tig + i % 2.
template <int BN, typename TOut>
__global__ void __launch_bounds__(kBlkThreads, 1)
w4a16_block_kernel(const __grid_constant__ CUtensorMap pmap,
                   const __grid_constant__ CUtensorMap xmap,
                   const __nv_bfloat16* __restrict__ sw,
                   TOut* __restrict__ out, float* __restrict__ partial,
                   BlkArgs a) {
  constexpr uint32_t kStage = blk_stage_bytes(BN);
  constexpr uint32_t kHalf = 2u * BN * kBlkStep;  // one half's x tile
  // 32-row pieces a run: up to a whole stage (runs of 2 pieces measured
  // 1.2x slower at 768 and 1100 rows, PERF.md)
  constexpr int kRun = 4;
  static_assert(2 * BN * kOutStride * 4 <= 2 * kStage,
                "the epilogue stages both warpgroups' tiles in the ring");
  unsigned char* smem = aligned_smem();
  const uint32_t base = smem_addr(smem);
  const int ns = a.stages;
  const uint32_t full = base + ns * kStage, empty = full + 8 * ns;
  // blockIdx.x: row tiles fastest (they share the packed tile in L2),
  // then column tiles
  const int row_tiles = (a.nb + BN - 1) / BN;
  const int row0 = (int)(blockIdx.x % row_tiles) * BN;
  const int col0 = (int)(blockIdx.x / row_tiles) * kBlkCols;
  const int k_begin = blockIdx.z * a.rows_per_split;
  const int k_end = min(a.dh, k_begin + a.rows_per_split);
  const int n_st = (k_end - k_begin + kBlkStep - 1) / kBlkStep;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int s = 0; s < ns; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 4 * kConsumers);  // lane 0 of each warp
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (warp >= 4 * kConsumers) {  // the producer
    setmaxnreg_dec<kProducerRegs>();
    if (warp == 4 * kConsumers && lane == 0) {
      for (int t = 0; t < n_st; ++t) {
        const int s = t % ns, k = k_begin + t * kBlkStep;
        const uint32_t st = base + s * kStage, bar = full + 8 * s;
        mbar_wait(empty + 8 * s, ((t / ns) & 1) ^ 1);
        mbar_expect_tx(bar, kStage);
        tma_load_2d(st, &pmap, bar, col0, k);
        for (int h = 0; h < 2; ++h)  // x's low (k) and high (dh + k) half
          for (int c = 0; c < 2; ++c)  // two 64-column chunks
            tma_load_2d(st + kPackedTile + h * kHalf + c * BN * 128, &xmap,
                        bar, h * a.dh + k + 64 * c, row0);
      }
    }
    return;
  }

  setmaxnreg_inc<kConsumerRegs>();
  const int wg = warp / 4, w = warp % 4, gid = lane / 4, tig = lane % 4;
  const int colw = 64 * wg + 16 * w;  // the warp's columns in the block
  const int col = col0 + colw + 2 * gid;  // this lane's two: col, col + 1
  const bool col_ok = col < a.f;
  // ldmatrix.x4.trans: lane l addresses packed row l of a 32-row piece in
  // the warp's 16-byte unit of the 128-byte-swizzled tile (each 8-row
  // matrix reads 8 distinct units: no bank conflict); register j holds
  // rows 8 j..8 j + 7, so registers 2 j and 2 j + 1 are k-step j's top and
  // bottom rows.
  const uint32_t laddr = lane * 128 + (((colw / 16) ^ (lane % 8)) * 16);
  const int gh = a.n_groups > 1 ? a.n_groups / 2 : 0;

  float acc[BN / 2], acc2[BN / 2], facc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = acc2[i] = facc[i] = 0.f;
  // facc += a run's f32 sums scaled by the group's scale of each column
  const auto fold = [&](const float (&sums)[BN / 2], uint32_t swp) {
    const float sx = __uint_as_float(swp << 16);
    const float sy = __uint_as_float(swp & 0xFFFF0000u);
#pragma unroll
    for (int i = 0; i < BN / 2; ++i)
      facc[i] = fmaf((i & 2) ? sy : sx, sums[i], facc[i]);
  };

  int turns = 0;  // (128 rows) runs' halves issued: warpgroup 0 waits from
                  // its second
  for (int t = 0; t < n_st; ++t) {
    const int s = t % ns, k = k_begin + t * kBlkStep;
    const uint32_t st = base + s * kStage;
    const uint32_t xlo = st + kPackedTile, xhi = xlo + kHalf;
    const int n_pieces = min(4, (k_end - k) / 32);
    mbar_wait(full + 8 * s, (t / ns) & 1);
    for (int u0 = 0; u0 < n_pieces;) {
      // a run: pieces of one scale group (a group's rows are a multiple
      // of 32, and with G == 1 the group is the whole half)
      const int kr = k + 32 * u0;
      const int gend = (kr / a.gr + 1) * a.gr;
      const int us = min(min(kRun, n_pieces - u0), (gend - kr) / 32);
      const int g = kr / a.gr;
      const int gl = a.n_groups > 1 ? g : 0, ghi = a.n_groups > 1 ? g + gh : 0;
      const uint32_t swl = col_ok ? __ldg(reinterpret_cast<const unsigned*>(
                                        sw + (size_t)gl * a.f + col))
                                  : 0u;
      const uint32_t swh = col_ok ? __ldg(reinterpret_cast<const unsigned*>(
                                        sw + (size_t)ghi * a.f + col))
                                  : 0u;
      uint32_t lo[kRun][2][4], hi[kRun][2][4];  // [piece][k-step][register]
#pragma unroll
      for (int q = 0; q < kRun; ++q) {
        if (q < us) {
          uint32_t r[4];
          ldmatrix_x4_trans(r, st + laddr + (u0 + q) * 32 * 128);
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            uint32_t lt[2], ht[2], lb[2], hb[2];
            unpack_pairs(r[2 * j], lt, ht);
            unpack_pairs(r[2 * j + 1], lb, hb);
            lo[q][j][0] = lt[0];
            lo[q][j][1] = lt[1];
            lo[q][j][2] = lb[0];
            lo[q][j][3] = lb[1];
            hi[q][j][0] = ht[0];
            hi[q][j][1] = ht[1];
            hi[q][j][2] = hb[0];
            hi[q][j][3] = hb[1];
          }
        }
      }
      // issue one half's products of the run: k-step 2 (u0 + q) + j of
      // the stage; the run's first starts its sums afresh
      const auto issue = [&](float (&d)[BN / 2], uint32_t (&frag)[kRun][2][4],
                             uint32_t xt) {
#pragma unroll
        for (int q = 0; q < kRun; ++q)
#pragma unroll
          for (int j = 0; j < 2; ++j)
            if (q < us)
              mma_rs<BN, 0>(d, frag[q][j], desc_k(xt, BN, 2 * (u0 + q) + j),
                            q > 0 || j > 0);
      };
      const auto settle = [&](float (&d)[BN / 2],
                              uint32_t (&frag)[kRun][2][4]) {
        fence_regs(d);
#pragma unroll
        for (int q = 0; q < kRun; ++q)
#pragma unroll
          for (int j = 0; j < 2; ++j) fence_regs(frag[q][j]);  // read until here
      };
      // at 64 rows and fewer both halves' sums fit beside the f32 total:
      // one batch, one wait, and the fold is short, so the warpgroups
      // issue without taking turns (3-8% faster at 2-36 rows, PERF.md); at
      // 128 one set, the halves one after the other, in turns
      if constexpr (BN <= 64) {
        wgmma_fence();
        issue(acc, lo, xlo);
        issue(acc2, hi, xhi);
        wgmma_commit();
        wgmma_wait();
        settle(acc, lo);
        settle(acc2, hi);
        fold(acc, swl);
        fold(acc2, swh);
      } else {
        if (wg == 1 || turns > 0) wait_turn(wg);
        wgmma_fence();  // the low half's run
        issue(acc, lo, xlo);
        wgmma_commit();
        pass_turn(wg);
        wgmma_wait();
        settle(acc, lo);
        fold(acc, swl);
        wait_turn(wg);
        wgmma_fence();  // the high half's
        issue(acc, hi, xhi);
        wgmma_commit();
        pass_turn(wg);
        turns += 2;
        wgmma_wait();
        settle(acc, hi);
        fold(acc, swh);
      }
      u0 += us;
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + 8 * s);
  }

  if (wg == 0 && turns > 0) wait_turn(0);  // warpgroup 1's last hand-over
  // Both warpgroups are past the ring (every stage was consumed): its bytes
  // stage the output tile, BN rows x 64 columns of f32 a warpgroup.
  asm volatile("bar.sync %0, %1;" ::"n"(kAllConsumers), "n"(128 * kConsumers)
               : "memory");
  float* tile = reinterpret_cast<float*>(smem) + wg * BN * kOutStride;
#pragma unroll
  for (int i = 0; i < BN / 2; i += 4)
#pragma unroll
    for (int e = 0; e < 2; ++e)
      *reinterpret_cast<float2*>(
          tile + (8 * (i / 4) + 2 * tig + e) * kOutStride + 16 * w +
          2 * gid) = make_float2(facc[i + e], facc[i + e + 2]);
  warpgroup_sync(wg);
  const bool split = gridDim.z > 1;
  for (int idx = threadIdx.x % 128; idx < BN * 16; idx += 128) {
    const int n = idx / 16, cc = (idx % 16) * 4;
    const int r = row0 + n, c = col0 + 64 * wg + cc;
    if (r >= a.nb || c >= a.f) continue;
    const float4 v = *reinterpret_cast<const float4*>(tile + n * kOutStride + cc);
    if (split)
      store4(partial + ((size_t)blockIdx.z * a.nb + r) * a.f + c, v);
    else
      store4(out + (size_t)r * a.f + c, v);
  }
}

template <int BN, typename TOut>
int launch_block(const void* x, const void* packed, const void* scales,
                 void* out, void* partial, const BlkArgs& a,
                 cudaStream_t stream) {
  CUtensorMap pm, xm;
  if (!tile_map(&pm, packed, a.dh, a.f, kBlkStep,
                CU_TENSOR_MAP_DATA_TYPE_UINT8, 1) ||
      !tile_map(&xm, x, a.nb, 2 * a.dh, BN, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                2))
    return (int)cudaErrorInvalidValue;
  auto kernel = w4a16_block_kernel<BN, TOut>;
  const size_t bytes = blk_smem(BN, a.stages);
  if (bytes > 232448) return (int)cudaErrorInvalidValue;  // the H100's 227 KB
  cudaError_t err = prepare(kernel, bytes);
  if (err != cudaSuccess) return (int)err;
  const int splits = (a.dh + a.rows_per_split - 1) / a.rows_per_split;
  const long long tiles =
      (long long)((a.nb + BN - 1) / BN) * ((a.f + kBlkCols - 1) / kBlkCols);
  if (tiles > 0x7fffffffLL || splits > 65535) return (int)cudaErrorInvalidValue;
  dim3 grid((unsigned)tiles, 1, splits);
  kernel<<<grid, kBlkThreads, bytes, stream>>>(
      pm, xm, static_cast<const __nv_bfloat16*>(scales),
      static_cast<TOut*>(out), static_cast<float*>(partial), a);
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return (int)err;
  const int n = a.nb * a.f;
  add_splits_kernel<TOut><<<(n + 255) / 256, 256, 0, stream>>>(
      static_cast<const float*>(partial), static_cast<TOut*>(out), n, splits);
  return (int)cudaGetLastError();
}

template <typename TOut>
int launch_tile(const void* x, const void* packed, const void* scales,
                void* out, void* partial, int rows_tile, const BlkArgs& a,
                cudaStream_t st) {
  switch (rows_tile) {
    case 8:
      return launch_block<8, TOut>(x, packed, scales, out, partial, a, st);
    case 16:
      return launch_block<16, TOut>(x, packed, scales, out, partial, a, st);
    case 32:
      return launch_block<32, TOut>(x, packed, scales, out, partial, a, st);
    case 48:
      return launch_block<48, TOut>(x, packed, scales, out, partial, a, st);
    case 64:
      return launch_block<64, TOut>(x, packed, scales, out, partial, a, st);
    case 128:
      return launch_block<128, TOut>(x, packed, scales, out, partial, a, st);
  }
  return (int)cudaErrorInvalidValue;
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
// out: (nb, f) f32 (out_bf16 = 0) or bf16; partial: (splits, nb, f) f32
// scratch when rows_per_split < dh (splits = ceil(dh / rows_per_split)),
// else unused. Every group's packed rows (2 dh / n_groups, or dh when
// n_groups == 1) a multiple of 32; f % 16 == 0; rows_tile 8, 16, 32, 48,
// 64 or 128; stages >= 2 within the shared memory; rows_per_split a
// multiple of 128 and, for n_groups > 1, of the group's rows
// (ops/quant4.py w4a16_block_plan).
extern "C" int vlt_w4a16_block(const void* x, const void* packed,
                               const void* scales, void* out, void* partial,
                               int nb, int dh, int f, int n_groups,
                               int rows_tile, int stages, int rows_per_split,
                               int out_bf16, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  BlkArgs a;
  a.nb = nb;
  a.dh = dh;
  a.f = f;
  a.n_groups = n_groups;
  a.gr = n_groups > 1 ? 2 * dh / n_groups : dh;
  a.stages = stages;
  a.rows_per_split = rows_per_split;
  const bool splits = rows_per_split < dh;
  if (nb < 1 || dh < 32 || a.gr % 32 || f % 16 || stages < 2 ||
      rows_per_split < kBlkStep ||
      (splits && (rows_per_split % kBlkStep || !partial ||
                  (n_groups > 1 && rows_per_split % a.gr))))
    return (int)cudaErrorInvalidValue;
  if (out_bf16)
    return launch_tile<__nv_bfloat16>(x, packed, scales, out, partial,
                                      rows_tile, a, st);
  return launch_tile<float>(x, packed, scales, out, partial, rows_tile, a,
                            st);
}
