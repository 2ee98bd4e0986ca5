// W4A8 block matmul: many activation rows against an int4 nibble-packed
// weight, on the int8 tensor cores through wgmma.
//
// Replaces video_llava_tpu/ops/quant4.py::_int4_block_stacked_pallas (body
// _w4a8_block_body) and the a8_block branch of int4_matmul_pallas. For
// x (nb, D) and one layer's packed (Dh, F) int8 (D = 2 Dh; byte [i, f] =
// low nibble q[i] + 8, high nibble q[Dh + i]) with bf16 scales sw (G, F),
// it computes int4_matmul_w4a8_block_xla:
//     sx[b] = max(max_k |x[b, k]|, 1e-8) / 127  (IEEE f32 division)
//     xq[b, k] = clamp(rint(x[b, k] / sx[b]), -127, 127)
//     y[b, f] = sx[b] * sum_g sw[g, f] * (int32 dot of xq and q over group g)
// Groups [0, G/2) cover the low half, [G/2, G) the high half; with G == 1
// one scale row serves both halves.
//
// What bounds it on Hopper: int8 multiply-adds (2 nb D F: 138 G at the
// 768-row Vicuna-7B gate_up, 0.070 ms at 1,979 TOP/s); at serving's 36-row
// verifies, the packed weight's bytes (45 MB there, 0.014 ms). A first
// body (mma.sync on 64 x 64 tiles, each step loaded synchronously and
// unpacked a byte at a time into transposed shared tiles) ran at 6% of
// that rate.
//
// The design. A first small kernel quantizes each row once (16-byte loads;
// the TPU kernel did it at its first grid step, which needs the grid's
// order). The main kernel takes the swapped product out^T = W^T xq^T:
// wgmma on 8-bit types wants both operands K-major and only A may come from
// registers, and the packed weight is F-contiguous, so the weight is the
// register A operand (64 output columns a warpgroup, unpacked in registers,
// csrc/w4a8_frag.cuh) and xq (nb, D), K-major as it lies, the shared B
// operand (N = a tile of 64 or 128 activation rows, chosen from nb). A block
// of two consumer warpgroups and a producer warpgroup owns 128 columns x
// one row tile over a K range; the producer's one thread keeps a ring of
// two stages in flight by TMA under full/empty mbarriers: 128 packed rows x
// 128 columns and the two halves' 128-column xq tiles (128-byte swizzle;
// rows past nb, columns past F and rows past Dh come in as zeros). Each
// packed tile feeds both halves: per run of at most 128 rows inside a
// group, the low halves' wgmma m64nNk32 s8 sum into an int32 accumulator
// that is folded into the f32 one with sw[g] / 16 (one I2F and one FMA an
// element: the fold costs about a third of the kernel's time at 768 rows,
// PERF.md), then the high halves' with sw[g + G/2] / 16. At 128 rows one
// int32 set fits the registers beside the f32 one (setmaxnreg 232 / 40);
// at 64 rows both halves' sets do, and one wait serves both. The two
// warpgroups take turns issuing their products, so that one folds while
// the other's run. The row scale multiplies as the tile goes out through
// shared memory with 8- and 16-byte stores. Where the output tiles alone
// would leave the card's waves uneven (F = 4096 has 32 column tiles), K is
// split over blocks in whole groups (ops/quant4.py w4a8_block_plan) and
// add_splits_kernel adds the (split, nb, F) f32 partials in order:
// deterministic, no atomics.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"
#include "int4_out.cuh"
#include "w4a8_frag.cuh"

namespace {

using namespace flash::hopper;
using namespace w4a8;

constexpr int kCols = 128;  // columns a block (= quant4.BLOCK_COLS)
constexpr int kStep = 128;  // packed rows a stage (= quant4.BLOCK_STEP)
constexpr int kConsumers = 2;  // warpgroups, 64 columns each
constexpr int kThreads = 128 * (kConsumers + 1);
constexpr int kProducerRegs = 40, kConsumerRegs = 232;
static_assert(kConsumers * kConsumerRegs + kProducerRegs ==
                  (kConsumers + 1) * 168,
              "the register budget of a block of 384 threads");
constexpr int kStages = 2;  // = quant4.BLOCK_STAGES (best of 2, 4, 6: PERF.md)
constexpr uint32_t kPackedTile = kCols * kStep;  // bytes
constexpr int kOutStride = 68;  // floats a row of the staged output tile
constexpr int kAllConsumers = 3;  // named barrier of both warpgroups

__host__ __device__ constexpr uint32_t stage_bytes(int bn) {
  return kPackedTile + 2u * bn * kStep;
}

// = quant4.block_smem_bytes: the ring, its full and empty barriers, and
// 1 KB to align the ring to the swizzle's period.
__host__ __device__ constexpr size_t block_smem(int bn) {
  return (size_t)kStages * stage_bytes(bn) + 16 * kStages + 1024;
}

struct Args {
  int nb, dh, f, n_groups, gr, rows_per_split;
};

// wgmma m64nNk32 s8 x s8 -> s32, A (the unpacked weight) from registers,
// B (xq) from shared memory; d = a b, or d += a b when `accumulate`.
__device__ inline void wgmma_s8(uint32_t (&d)[32], const uint32_t (&a)[4],
                              uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]),
        "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]),
        "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(accumulate));
}

__device__ inline void wgmma_s8(uint32_t (&d)[64], const uint32_t (&a)[4],
                              uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]),
        "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]),
        "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
        "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]),
        "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]),
        "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(accumulate));
}

__device__ inline int8_t quantize(float v, float s) {
  const float q = rintf(__fdiv_rn(v, s));
  return (int8_t)fminf(fmaxf(q, -127.f), 127.f);
}

// One block per row: sx[row] and xq[row, :], 8 values (16 bytes) a load;
// d % 8 == 0.
__global__ void __launch_bounds__(256)
quantize_rows_kernel(const __nv_bfloat16* __restrict__ x,
                     int8_t* __restrict__ xq, float* __restrict__ sx, int d) {
  __shared__ float warp_max[8];
  const uint4* xr = reinterpret_cast<const uint4*>(x + (size_t)blockIdx.x * d);
  const int n = d / 8;
  float m = 0.f;
  for (int i = threadIdx.x; i < n; i += 256) {
    const uint4 v = xr[i];
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 p = __bfloat1622float2(h[j]);
      m = fmaxf(m, fmaxf(fabsf(p.x), fabsf(p.y)));
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
  if (threadIdx.x % 32 == 0) warp_max[threadIdx.x / 32] = m;
  __syncthreads();
  m = warp_max[0];
  for (int w = 1; w < 8; ++w) m = fmaxf(m, warp_max[w]);
  const float s = __fdiv_rn(fmaxf(m, 1e-8f), 127.f);
  if (threadIdx.x == 0) sx[blockIdx.x] = s;
  uint2* qr = reinterpret_cast<uint2*>(xq + (size_t)blockIdx.x * d);
  for (int i = threadIdx.x; i < n; i += 256) {
    const uint4 v = xr[i];
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
    uint32_t w[2] = {0u, 0u};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 p = __bfloat1622float2(h[j]);
      const uint32_t lo = (uint8_t)quantize(p.x, s);
      const uint32_t hi = (uint8_t)quantize(p.y, s);
      w[j / 2] |= (lo | hi << 8) << (16 * (j % 2));
    }
    qr[i] = make_uint2(w[0], w[1]);
  }
}

// One block: activation rows [blockIdx.x * BN, +BN), columns
// [blockIdx.y * kCols, +kCols), packed rows [k_begin, k_end) of split
// blockIdx.z. Warpgroup wg owns columns 64 wg..64 wg + 63 of the block,
// its warp w the 16 from 64 wg + 16 w: accumulator register i of lane
// (gid, tig) is column 2 gid + (i / 2) % 2 of them (the M row -> column
// pairing of csrc/w4a8_frag.cuh), activation row 8 (i / 4) + 2 tig + i % 2.
template <int BN, typename TOut>
__global__ void __launch_bounds__(kThreads, 1)
w4a8_block_kernel(const __grid_constant__ CUtensorMap pmap,
                  const __grid_constant__ CUtensorMap xmap,
                  const __nv_bfloat16* __restrict__ sw,
                  const float* __restrict__ sx, TOut* __restrict__ out,
                  float* __restrict__ partial, Args a) {
  constexpr uint32_t kStage = stage_bytes(BN);
  unsigned char* smem = aligned_smem();
  const uint32_t base = smem_addr(smem);
  constexpr int ns = kStages;
  const uint32_t full = base + ns * kStage, empty = full + 8 * ns;
  const int row0 = blockIdx.x * BN, col0 = blockIdx.y * kCols;
  const int k_begin = blockIdx.z * a.rows_per_split;
  const int k_end = min(a.dh, k_begin + a.rows_per_split);
  const int n_st = (k_end - k_begin + kStep - 1) / kStep;
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
        const int s = t % ns, k = k_begin + t * kStep;
        const uint32_t st = base + s * kStage;
        mbar_wait(empty + 8 * s, ((t / ns) & 1) ^ 1);
        mbar_expect_tx(full + 8 * s, kStage);
        tma_load_2d(st, &pmap, full + 8 * s, col0, k);
        tma_load_2d(st + kPackedTile, &xmap, full + 8 * s, k, row0);
        tma_load_2d(st + kPackedTile + BN * kStep, &xmap, full + 8 * s,
                    a.dh + k, row0);
      }
    }
    return;
  }

  setmaxnreg_inc<kConsumerRegs>();
  const int wg = warp / 4, w = warp % 4, gid = lane / 4, tig = lane % 4;
  const int colw = 64 * wg + 16 * w;  // the warp's columns in the block
  const int col = col0 + colw + 2 * gid;  // this lane's two: col, col + 1
  const bool col_ok = col < a.f;
  const int lr = ldsm_row(lane);
  // the lane's ldmatrix row in a stage's 128-byte-swizzled packed tile
  const uint32_t laddr = lr * 128 + (((colw / 16) ^ (lr % 8)) * 16);
  const uint32_t sel0 = frag_sel(tig, 0), sel1 = frag_sel(tig, 1);
  const int gh = a.n_groups > 1 ? a.n_groups / 2 : 0;
  // 32-row steps a run: a group of 32 or 64 rows, else (G == 1, or groups
  // of a multiple of 128 rows) a stage
  const int run_steps = (a.n_groups > 1 && a.gr < kStep) ? a.gr / 32 : 4;

  // the run's int32 sums (at 64 rows a tile, the high half's in acc2)
  uint32_t acc[BN / 2], acc2[BN / 2];
  float facc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) {
    acc[i] = acc2[i] = 0u;
    facc[i] = 0.f;
  }
  // facc += a run's exact sums (16 x) scaled by sw / 16 of each column
  const auto fold = [&](const uint32_t (&sums)[BN / 2], uint32_t swp) {
    const float2 s = scale_pair(swp);
#pragma unroll
    for (int i = 0; i < BN / 2; ++i)
      facc[i] = fmaf((i & 2) ? s.y : s.x, (float)(int)sums[i], facc[i]);
  };

  int turns = 0;  // runs' products issued: warpgroup 0 waits from its second
  for (int t = 0; t < n_st; ++t) {
    const int s = t % ns, k = k_begin + t * kStep;
    const uint32_t st = base + s * kStage;
    const uint32_t xlo = st + kPackedTile, xhi = xlo + BN * kStep;
    const int n_steps = min(4, (k_end - k) / 32);
    mbar_wait(full + 8 * s, (t / ns) & 1);
    for (int u0 = 0; u0 < n_steps; u0 += run_steps) {
      const int us = min(run_steps, n_steps - u0);
      const int g = (k + 32 * u0) / a.gr;
      const int gl = a.n_groups > 1 ? g : 0, ghi = a.n_groups > 1 ? g + gh : 0;
      const uint32_t swl = col_ok ? __ldg(reinterpret_cast<const unsigned*>(
                                        sw + (size_t)gl * a.f + col))
                                  : 0u;
      const uint32_t swh = col_ok ? __ldg(reinterpret_cast<const unsigned*>(
                                        sw + (size_t)ghi * a.f + col))
                                  : 0u;
      uint32_t lo[4][4], hi[4][4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        if (q < us) {
          uint32_t r[4];
          ldsm_x4_trans(r, st + laddr + (u0 + q) * 32 * 128);
          fragments(r, sel0, sel1, lo[q], hi[q]);
        }
      }
      if (wg == 1 || turns > 0) wait_turn(wg);
      if constexpr (BN == 64) {  // both halves' sums fit: one batch, one wait
        wgmma_fence();
#pragma unroll
        for (int q = 0; q < 4; ++q)
          if (q < us) wgmma_s8(acc, lo[q], desc_k(xlo, BN, u0 + q), q > 0);
#pragma unroll
        for (int q = 0; q < 4; ++q)
          if (q < us) wgmma_s8(acc2, hi[q], desc_k(xhi, BN, u0 + q), q > 0);
        wgmma_commit();
        pass_turn(wg);
        ++turns;
        wgmma_wait();
        fence_regs(acc);
        fence_regs(acc2);
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          fence_regs(lo[q]);
          fence_regs(hi[q]);
        }
        fold(acc, swl);
        fold(acc2, swh);
        continue;
      }
      wgmma_fence();  // the low half's run
#pragma unroll
      for (int q = 0; q < 4; ++q)
        if (q < us) wgmma_s8(acc, lo[q], desc_k(xlo, BN, u0 + q), q > 0);
      wgmma_commit();
      pass_turn(wg);
      wgmma_wait();
      fence_regs(acc);
#pragma unroll
      for (int q = 0; q < 4; ++q) fence_regs(lo[q]);  // read until here
      fold(acc, swl);
      wait_turn(wg);
      wgmma_fence();  // the high half's
#pragma unroll
      for (int q = 0; q < 4; ++q)
        if (q < us) wgmma_s8(acc, hi[q], desc_k(xhi, BN, u0 + q), q > 0);
      wgmma_commit();
      pass_turn(wg);
      turns += 2;
      wgmma_wait();
      fence_regs(acc);
#pragma unroll
      for (int q = 0; q < 4; ++q) fence_regs(hi[q]);
      fold(acc, swh);
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
    const float sr = sx[r];
    float4 v = *reinterpret_cast<const float4*>(tile + n * kOutStride + cc);
    v = make_float4(v.x * sr, v.y * sr, v.z * sr, v.w * sr);
    if (split)
      store4(partial + ((size_t)blockIdx.z * a.nb + r) * a.f + c, v);
    else
      store4(out + (size_t)r * a.f + c, v);
  }
}

template <int BN, typename TOut>
int launch(const void* packed, const void* scales, const void* xq,
           const void* sx, void* out, void* partial, const Args& a,
           cudaStream_t stream) {
  CUtensorMap pm, xm;
  if (!tile_map(&pm, packed, a.dh, a.f, kStep, CU_TENSOR_MAP_DATA_TYPE_UINT8,
                1) ||
      !tile_map(&xm, xq, a.nb, 2 * a.dh, BN, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1))
    return (int)cudaErrorInvalidValue;
  auto kernel = w4a8_block_kernel<BN, TOut>;
  const size_t bytes = block_smem(BN);
  cudaError_t err = prepare(kernel, bytes);
  if (err != cudaSuccess) return (int)err;
  const int splits = (a.dh + a.rows_per_split - 1) / a.rows_per_split;
  dim3 grid((a.nb + BN - 1) / BN, (a.f + kCols - 1) / kCols, splits);
  kernel<<<grid, kThreads, bytes, stream>>>(
      pm, xm, static_cast<const __nv_bfloat16*>(scales),
      static_cast<const float*>(sx), static_cast<TOut*>(out),
      static_cast<float*>(partial), a);
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return (int)err;
  const int n = a.nb * a.f;
  add_splits_kernel<TOut><<<(n + 255) / 256, 256, 0, stream>>>(
      static_cast<const float*>(partial), static_cast<TOut*>(out), n, splits);
  return (int)cudaGetLastError();
}

template <typename TOut>
int launch_rows(const void* packed, const void* scales, const void* xq,
                const void* sx, void* out, void* partial, int rows_tile,
                const Args& a, cudaStream_t st) {
  if (rows_tile == 64)
    return launch<64, TOut>(packed, scales, xq, sx, out, partial, a, st);
  return launch<128, TOut>(packed, scales, xq, sx, out, partial, a, st);
}

}  // namespace

// x: (nb, 2 dh) bf16; packed: (dh, f) int8; scales: (n_groups, f) bf16;
// xq: (nb, 2 dh) int8 and sx: (nb,) f32 scratch; out: (nb, f) f32
// (out_bf16 = 0) or bf16; partial: (splits, nb, f) f32 scratch when
// rows_per_split < dh (splits = ceil(dh / rows_per_split)), else unused.
// dh % 32 == 0 and f % 16 == 0; a group's packed rows (2 dh / n_groups, or
// dh when n_groups == 1) a multiple of 32 that divides 128 or that 128
// divides (any for n_groups == 1); rows_tile 64 or 128; rows_per_split a
// multiple of 128 and, for n_groups > 1, of the group's rows
// (ops/quant4.py w4a8_block_plan).
extern "C" int vlt_w4a8_block(const void* x, const void* packed,
                              const void* scales, void* xq, void* sx,
                              void* out, void* partial, int nb, int dh, int f,
                              int n_groups, int rows_tile, int rows_per_split,
                              int out_bf16, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  Args a;
  a.nb = nb;
  a.dh = dh;
  a.f = f;
  a.n_groups = n_groups;
  a.gr = n_groups > 1 ? 2 * dh / n_groups : dh;
  a.rows_per_split = rows_per_split;
  const bool splits = rows_per_split < dh;
  if (nb < 1 || dh < 32 || dh % 32 || f % 16 || a.gr % 32 ||
      (n_groups > 1 && kStep % a.gr && a.gr % kStep) ||
      (rows_tile != 64 && rows_tile != 128) || rows_per_split < kStep ||
      (splits && (rows_per_split % kStep || !partial ||
                  (n_groups > 1 && rows_per_split % a.gr))))
    return (int)cudaErrorInvalidValue;
  quantize_rows_kernel<<<nb, 256, 0, st>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<int8_t*>(xq),
      static_cast<float*>(sx), 2 * dh);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  if (out_bf16)
    return launch_rows<__nv_bfloat16>(packed, scales, xq, sx, out, partial,
                                      rows_tile, a, st);
  return launch_rows<float>(packed, scales, xq, sx, out, partial, rows_tile,
                            a, st);
}
