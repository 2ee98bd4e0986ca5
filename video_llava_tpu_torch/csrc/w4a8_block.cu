// W4A8 block matmul: many activation rows against an int4 nibble-packed
// weight, on the int8 tensor cores.
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
// What bounds it on Hopper: int8 multiply-adds (2 nb D F; 138 G at the
// 768-row Vicuna-7B gate_up), against 1,979 TOP/s of int8 tensor cores;
// the packed weight (45 MB there) is read once per 64-row tile. The design:
// a first small kernel quantizes each row once (the TPU kernel did it at
// its first grid step into VMEM scratch, which needs the grid's order);
// the main kernel runs mma.sync m16n8k32 s8 x s8 -> s32 on 64 x 64 output
// tiles (4 warps of 32 x 32). One 32-row packed tile, unpacked to int8 in
// shared memory, feeds two K slices: rows k (low nibbles) against
// activation columns k, and rows Dh + k (high nibbles) against columns
// Dh + k, into two int32 accumulators. At the end of each 128-deep group
// the exact int32 partials are scaled by sw in f32 (mma.sync's accumulator
// layout names each element's column, so no trip through shared memory);
// the row scale multiplies once at the end. Rows and columns past nb and F
// are masked. Later work: cp.async/TMA double buffering, wgmma.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "int4_out.cuh"

namespace {

constexpr int kBM = 64, kBN = 64, kKP = 32;  // output tile, packed rows/step
constexpr int kLds = kKP + 16;  // shared row stride: conflict-free fragments
constexpr int kThreads = 128;

// One block per row: sx[row] and xq[row, :].
__global__ void __launch_bounds__(256)
quantize_rows_kernel(const __nv_bfloat16* __restrict__ x, int8_t* __restrict__ xq,
                     float* __restrict__ sx, int d) {
  __shared__ float warp_max[8];
  const __nv_bfloat16* xr = x + (size_t)blockIdx.x * d;
  float m = 0.f;
  for (int k = threadIdx.x; k < d; k += 256) m = fmaxf(m, fabsf(__bfloat162float(xr[k])));
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
  if ((threadIdx.x & 31) == 0) warp_max[threadIdx.x >> 5] = m;
  __syncthreads();
  m = warp_max[0];
  for (int w = 1; w < 8; ++w) m = fmaxf(m, warp_max[w]);
  const float s = __fdiv_rn(fmaxf(m, 1e-8f), 127.f);
  if (threadIdx.x == 0) sx[blockIdx.x] = s;
  int8_t* qr = xq + (size_t)blockIdx.x * d;
  for (int k = threadIdx.x; k < d; k += 256) {
    const float q = rintf(__fdiv_rn(__bfloat162float(xr[k]), s));
    qr[k] = (int8_t)fminf(fmaxf(q, -127.f), 127.f);
  }
}

__device__ inline void mma_s8(int (&c)[4], const int (&a)[4], int b0, int b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <typename TOut>
__global__ void __launch_bounds__(kThreads)
w4a8_block_kernel(const int8_t* __restrict__ xq, const float* __restrict__ sx,
                  const int8_t* __restrict__ packed,
                  const __nv_bfloat16* __restrict__ sw, TOut* __restrict__ out,
                  int nb, int dh, int f, int n_groups, int gr) {
  // [m][k] activation tiles and [n][k] unpacked weight tiles, low and high
  __shared__ __align__(16) int8_t a_lo[kBM * kLds], a_hi[kBM * kLds];
  __shared__ __align__(16) int8_t b_lo[kBN * kLds], b_hi[kBN * kLds];

  const int d = 2 * dh, gh = dh / gr;
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wm = (warp >> 1) * 32, wn = (warp & 1) * 32;
  const int gid = lane >> 2, tig = lane & 3;

  int acc_lo[2][4][4], acc_hi[2][4][4];
  float facc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        acc_lo[i][j][e] = acc_hi[i][j][e] = 0;
        facc[i][j][e] = 0.f;
      }

  for (int k0 = 0; k0 < dh; k0 += kKP) {
    {  // activations: 64 rows x 32 columns of each half, 16 bytes a thread
      const int r = tid >> 1, ch = (tid & 1) * 16, gm = m0 + r;
      uint4 lo = make_uint4(0u, 0u, 0u, 0u), hi = lo;
      if (gm < nb) {
        const int8_t* src = xq + (size_t)gm * d + k0 + ch;
        lo = *reinterpret_cast<const uint4*>(src);
        hi = *reinterpret_cast<const uint4*>(src + dh);
      }
      *reinterpret_cast<uint4*>(a_lo + r * kLds + ch) = lo;
      *reinterpret_cast<uint4*>(a_hi + r * kLds + ch) = hi;
    }
    {  // weights: 32 packed rows x 64 columns, unpacked and transposed
      const int kr = tid >> 2, ch = (tid & 3) * 16, gn = n0 + ch;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (gn < f)
        v = __ldg(reinterpret_cast<const uint4*>(
            packed + (size_t)(k0 + kr) * f + gn));
      const int8_t* bytes = reinterpret_cast<const int8_t*>(&v);
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int b = bytes[j];
        b_lo[(ch + j) * kLds + kr] = (int8_t)((b & 15) - 8);
        b_hi[(ch + j) * kLds + kr] = (int8_t)(b >> 4);
      }
    }
    __syncthreads();

#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int8_t* as = half ? a_hi : a_lo;
      const int8_t* bs = half ? b_hi : b_lo;
      int a[2][4];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int8_t* p = as + (wm + i * 16 + gid) * kLds + tig * 4;
        a[i][0] = *reinterpret_cast<const int*>(p);
        a[i][1] = *reinterpret_cast<const int*>(p + 8 * kLds);
        a[i][2] = *reinterpret_cast<const int*>(p + 16);
        a[i][3] = *reinterpret_cast<const int*>(p + 8 * kLds + 16);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int8_t* p = bs + (wn + j * 8 + gid) * kLds + tig * 4;
        const int b0 = *reinterpret_cast<const int*>(p);
        const int b1 = *reinterpret_cast<const int*>(p + 16);
#pragma unroll
        for (int i = 0; i < 2; ++i)
          mma_s8(half ? acc_hi[i][j] : acc_lo[i][j], a[i], b0, b1);
      }
    }
    __syncthreads();

    if ((k0 + kKP) % gr == 0) {  // end of group: scale the exact partials
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
            facc[i][j][e] += sl[e & 1] * (float)acc_lo[i][j][e] +
                             sh[e & 1] * (float)acc_hi[i][j][e];
            acc_lo[i][j][e] = acc_hi[i][j][e] = 0;
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
      const float s = sx[r];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = n0 + wn + j * 8 + tig * 2;
        if (c < f) store(out + (size_t)r * f + c, facc[i][j][e] * s);
        if (c + 1 < f)
          store(out + (size_t)r * f + c + 1, facc[i][j][e + 1] * s);
      }
    }
}

template <typename TOut>
int launch(const void* x, const void* packed, const void* scales, void* xq,
           void* sx, void* out, int nb, int dh, int f, int n_groups,
           cudaStream_t stream) {
  const int d = 2 * dh;
  quantize_rows_kernel<<<nb, 256, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<int8_t*>(xq),
      static_cast<float*>(sx), d);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int gr = n_groups > 1 ? d / n_groups : dh;
  dim3 grid((f + kBN - 1) / kBN, (nb + kBM - 1) / kBM);
  w4a8_block_kernel<TOut><<<grid, kThreads, 0, stream>>>(
      static_cast<const int8_t*>(xq), static_cast<const float*>(sx),
      static_cast<const int8_t*>(packed),
      static_cast<const __nv_bfloat16*>(scales), static_cast<TOut*>(out), nb,
      dh, f, n_groups, gr);
  return (int)cudaGetLastError();
}

}  // namespace

// x: (nb, 2 dh) bf16; packed: (dh, f) int8; scales: (n_groups, f) bf16;
// xq: (nb, 2 dh) int8 and sx: (nb,) f32 scratch; out: (nb, f) f32
// (out_bf16 = 0) or bf16. Every group's packed rows (2 dh / n_groups, or dh
// when n_groups == 1) a multiple of 32; f % 16 == 0.
extern "C" int vlt_w4a8_block(const void* x, const void* packed,
                              const void* scales, void* xq, void* sx,
                              void* out, int nb, int dh, int f, int n_groups,
                              int out_bf16, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int gr = n_groups > 1 ? 2 * dh / n_groups : dh;
  if (nb < 1 || gr % kKP || f % 16) return (int)cudaErrorInvalidValue;
  if (out_bf16)
    return launch<__nv_bfloat16>(x, packed, scales, xq, sx, out, nb, dh, f,
                                 n_groups, st);
  return launch<float>(x, packed, scales, xq, sx, out, nb, dh, f, n_groups,
                       st);
}
