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
// What bounds it on Hopper. The matvec: the packed bytes, read once (25.2 MB
// for Vicuna-7B's fused wqkv); a lane reads 4 columns of a packed row (a
// warp one coalesced 128-byte row segment), unpacks both nibbles in
// registers and multiplies by x from shared memory; warps interleave over
// rows with four rows' loads in flight. Too few column tiles to fill the
// card (F = 4096 gives 32) split K over blocks, whose f32 partials a second
// kernel adds in order, as the W4A8 matvec does. The block matmul: bf16
// multiply-adds (2 nb D F, 138.5 G at 768 rows of the 7B gate_up) against
// 989 TFLOP/s; mma.sync m16n8k16 on 64 x 64 output tiles (4 warps of
// 32 x 32); a 32-row packed tile is unpacked to bf16 (exact for -8..7) and
// transposed into shared memory, and feeds the low-half K slice (rows k
// against activation columns k) and the high-half one (rows Dh + k).
// Later work: cp.async/TMA double buffering, wgmma.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "int4_out.cuh"

namespace {

// Byte j of w as the low (offset-binary) and high (two's complement) nibble.
__device__ inline void nibbles(int w, int j, float& lo, float& hi) {
  const int b = (int)(int8_t)(w >> (8 * j));
  lo = (float)((b & 15) - 8);
  hi = (float)(b >> 4);
}

// ---------------------------------------------------------------------------
// matvec
// ---------------------------------------------------------------------------

constexpr int kMvThreads = 256;
constexpr int kMvWarps = kMvThreads / 32;
constexpr int kMvCols = 128;  // 32 lanes x 4 columns
constexpr int kMvUnroll = 4;  // rows in flight per warp

// One block: columns [blockIdx.x * 128, +128), packed rows
// [blockIdx.y * rows, +rows).
template <typename TOut>
__global__ void __launch_bounds__(kMvThreads)
w4a16_matvec_kernel(const __nv_bfloat16* __restrict__ x,
                    const int8_t* __restrict__ packed,
                    const __nv_bfloat16* __restrict__ sw, TOut* __restrict__ out,
                    float* __restrict__ partial, int dh, int f, int n_groups,
                    int gr, int rows) {
  extern __shared__ float xs[];  // (2, rows): x of the range, low then high
  const int gh = dh / gr;        // groups per half
  const int k0 = blockIdx.y * rows;
  const int k1 = min(k0 + rows, dh);
  const int nrows = k1 - k0;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int k = threadIdx.x; k < nrows; k += kMvThreads) {
    xs[k] = __bfloat162float(x[k0 + k]);
    xs[rows + k] = __bfloat162float(x[dh + k0 + k]);
  }
  __syncthreads();

  const int c = blockIdx.x * kMvCols + lane * 4;
  const bool col_ok = c < f;
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  for (int gi = k0 / gr; gi * gr < k1; ++gi) {
    const int rs = max(k0, gi * gr), re = min(k1, (gi + 1) * gr);
    float pl[4] = {0.f, 0.f, 0.f, 0.f}, ph[4] = {0.f, 0.f, 0.f, 0.f};
    int r = rs + warp;
    for (; r + (kMvUnroll - 1) * kMvWarps < re; r += kMvUnroll * kMvWarps) {
      int w[kMvUnroll];
#pragma unroll
      for (int u = 0; u < kMvUnroll; ++u)
        w[u] = col_ok ? __ldg(reinterpret_cast<const int*>(
                            packed + (size_t)(r + u * kMvWarps) * f + c))
                      : 0;
#pragma unroll
      for (int u = 0; u < kMvUnroll; ++u) {
        const float xl = xs[r + u * kMvWarps - k0];
        const float xh = xs[rows + r + u * kMvWarps - k0];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float lo, hi;
          nibbles(w[u], j, lo, hi);
          pl[j] += lo * xl;
          ph[j] += hi * xh;
        }
      }
    }
    for (; r < re; r += kMvWarps) {
      const int w = col_ok ? __ldg(reinterpret_cast<const int*>(
                                 packed + (size_t)r * f + c))
                           : 0;
      const float xl = xs[r - k0], xh = xs[rows + r - k0];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float lo, hi;
        nibbles(w, j, lo, hi);
        pl[j] += lo * xl;
        ph[j] += hi * xh;
      }
    }
    // this warp's share of group gi, scaled
    const int gl = n_groups > 1 ? gi : 0, ghi = n_groups > 1 ? gi + gh : 0;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (!col_ok) break;
      acc[j] += __bfloat162float(sw[(size_t)gl * f + c + j]) * pl[j] +
                __bfloat162float(sw[(size_t)ghi * f + c + j]) * ph[j];
    }
  }

  // add the 8 warps' results in a fixed order
  __shared__ float red[kMvWarps * kMvCols];
#pragma unroll
  for (int j = 0; j < 4; ++j) red[warp * kMvCols + lane * 4 + j] = acc[j];
  __syncthreads();
  for (int cc = threadIdx.x; cc < kMvCols; cc += kMvThreads) {
    const int gc = blockIdx.x * kMvCols + cc;
    if (gc >= f) continue;
    float s = 0.f;
    for (int w = 0; w < kMvWarps; ++w) s += red[w * kMvCols + cc];
    if (gridDim.y == 1)
      store(out + gc, s);
    else
      partial[(size_t)blockIdx.y * f + gc] = s;
  }
}

template <typename TOut>
int launch_matvec(const void* x, const void* packed, const void* scales,
                  void* out, void* partial, int dh, int f, int n_groups,
                  int rows, cudaStream_t stream) {
  const int gr = n_groups > 1 ? 2 * dh / n_groups : dh;
  const int splits = (dh + rows - 1) / rows;
  const size_t smem = 2 * (size_t)rows * sizeof(float);
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

__device__ inline void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

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
// out: (1, f) f32 (out_bf16 = 0) or bf16; partial: (ceil(dh / rows), f) f32
// scratch when dh > rows, else unused. f % 4 == 0.
extern "C" int vlt_w4a16_matvec(const void* x, const void* packed,
                                const void* scales, void* out, void* partial,
                                int dh, int f, int n_groups, int rows,
                                int out_bf16, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (rows < 1 || f % 4) return (int)cudaErrorInvalidValue;
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
