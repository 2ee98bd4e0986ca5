// W4A8 matvec: a few activation rows against an int4 nibble-packed weight.
//
// Replaces video_llava_tpu/ops/quant4.py::_int4_matvec_stacked_pallas
// (body _w4a8_matvec_body_axor) and the a8 matvec branch of
// int4_matmul_pallas. For x (nb <= 8, D) and one layer's packed (Dh, F)
// int8 (D = 2 Dh; byte [i, f] = low nibble q[i] + 8, high nibble q[Dh + i])
// with bf16 scales sw (G, F), it computes int4_matmul_w4a8_xla per row:
//     xq[r, k] = clamp(rint(x[r, k] / sx[r, a]), -127, 127),
//     sx[r, a] = max(max_{k in a} |x[r, k]|, 1e-8) / 127  (IEEE f32 division)
//     y[r, f]  = sum_g sx[r, g] sw[g, f] * (int32 dot of xq and q over g)
// over activation groups a: the weight's G groups, or the two halves when
// G == 1. Groups [0, G/2) cover the low half, [G/2, G) the high half.
//
// What bounds it on Hopper: the packed bytes, read once (about 101 MB a
// Vicuna-7B layer, 3.2 GB a decode step); the arithmetic is a few integer
// operations a byte. The design keeps the unpack off the critical path with
// the offset-binary trick the TPU kernel uses: a lane loads 4 columns x 4
// packed rows, transposes them with byte permutes into one word per column
// (4 consecutive rows), and with a = word & 0x0F0F0F0F
//     sum x_lo * lo = dp4a(a, x_lo) - 8 * sum x_lo
//     sum x_hi * hi = (dp4a(word, x_hi) - dp4a(a, x_hi)) / 16   (exact)
// so every (row, group) partial is an exact int32, scaled once in f32.
// The TPU kernel quantized x once, at grid step 0, into VMEM scratch; here
// blocks run in no order, so each block quantizes the rows of its own K
// range into shared memory (the absmax of each group it touches is taken
// over the whole group): one launch, no first pass. Block = 128 columns x
// a K range; its 8 warps interleave over 4-row quads and add their f32
// results in a fixed order. When there are too few column tiles to fill
// the card (F = 4096 gives 32), the K range is split over blocks and a
// second kernel adds the splits' (splits, nb, F) f32 partials in order:
// deterministic, no atomics.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kCols = 128;  // 32 lanes x 4 columns

__device__ inline void store(float* p, float v) { *p = v; }
__device__ inline void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

__device__ inline int8_t quantize(float v, float s) {
  const float q = rintf(__fdiv_rn(v, s));
  return (int8_t)fminf(fmaxf(q, -127.f), 127.f);
}

__host__ __device__ inline size_t align16(size_t n) {
  return (n + 15) & ~(size_t)15;
}

struct Smem {
  size_t xq_hi, sxl, sxh, red, bytes;
};

__host__ __device__ inline Smem smem_layout(int nbt, int rows, int maxg) {
  Smem s;
  s.xq_hi = (size_t)nbt * rows;
  s.sxl = align16(2 * (size_t)nbt * rows);
  s.sxh = s.sxl + (size_t)nbt * maxg * 4;
  s.red = align16(s.sxh + (size_t)nbt * maxg * 4);
  s.bytes = s.red + (size_t)kWarps * nbt * kCols * 4;
  return s;
}

// One block: columns [blockIdx.x * 128, +128), packed rows
// [blockIdx.y * rows, +rows). NB: rows of x rounded up to a power of 2
// (rows >= nb are zero).
template <int NB, typename TOut>
__global__ void __launch_bounds__(kThreads)
w4a8_matvec_kernel(const __nv_bfloat16* __restrict__ x, const int8_t* __restrict__ packed,
                   const __nv_bfloat16* __restrict__ sw, TOut* __restrict__ out,
                   float* __restrict__ partial, int nb, int dh, int f,
                   int n_groups, int gr, int rows, int maxg) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Smem L = smem_layout(NB, rows, maxg);
  int8_t* xq_lo = reinterpret_cast<int8_t*>(smem);
  int8_t* xq_hi = reinterpret_cast<int8_t*>(smem + L.xq_hi);
  float* sxl = reinterpret_cast<float*>(smem + L.sxl);
  float* sxh = reinterpret_cast<float*>(smem + L.sxh);
  float* red = reinterpret_cast<float*>(smem + L.red);

  const int d = 2 * dh;
  const int gh = dh / gr;  // groups per half
  const int k0 = blockIdx.y * rows;
  const int k1 = min(k0 + rows, dh);
  const int g0 = k0 / gr, g1 = (k1 - 1) / gr + 1;
  const int ng = g1 - g0;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  // 1. activation scales of every (row, group, half) this range touches
  for (int t = warp; t < NB * ng * 2; t += kWarps) {
    const int r = t / (ng * 2), gi = (t >> 1) % ng, half = t & 1;
    float m = 0.f;
    if (r < nb) {
      const __nv_bfloat16* xr = x + (size_t)r * d + half * dh + (size_t)(g0 + gi) * gr;
      for (int k = lane; k < gr; k += 32) m = fmaxf(m, fabsf(__bfloat162float(xr[k])));
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
    if (lane == 0)
      (half ? sxh : sxl)[r * maxg + gi] = __fdiv_rn(fmaxf(m, 1e-8f), 127.f);
  }
  __syncthreads();

  // 2. int8 activations of the range, both halves
  const int nrows = k1 - k0;
  for (int t = threadIdx.x; t < NB * nrows; t += kThreads) {
    const int r = t / nrows, k = t % nrows;
    int8_t ql = 0, qh = 0;
    if (r < nb) {
      const int gi = (k0 + k) / gr - g0;
      const __nv_bfloat16* xr = x + (size_t)r * d + k0 + k;
      ql = quantize(__bfloat162float(xr[0]), sxl[r * maxg + gi]);
      qh = quantize(__bfloat162float(xr[dh]), sxh[r * maxg + gi]);
    }
    xq_lo[r * rows + k] = ql;
    xq_hi[r * rows + k] = qh;
  }
  __syncthreads();

  // 3. exact int32 partials per (row, group, column), scaled in f32
  const int c = blockIdx.x * kCols + lane * 4;
  const bool col_ok = c < f;
  float acc[NB][4];
#pragma unroll
  for (int r = 0; r < NB; ++r)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[r][j] = 0.f;

  for (int gi = g0; gi < g1; ++gi) {
    const int qs = max(k0, gi * gr) / 4, qe = min(k1, (gi + 1) * gr) / 4;
    int pl[NB][4], ph[NB][4], rs[NB];
#pragma unroll
    for (int r = 0; r < NB; ++r) {
      rs[r] = 0;
#pragma unroll
      for (int j = 0; j < 4; ++j) pl[r][j] = ph[r][j] = 0;
    }
    for (int q = qs + warp; q < qe; q += 2 * kWarps) {
      const bool two = q + kWarps < qe;
      int w[2][4];
#pragma unroll
      for (int u = 0; u < 2; ++u)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int row = 4 * (q + u * kWarps) + j;
          w[u][j] = (col_ok && (u == 0 || two))
                        ? __ldg(reinterpret_cast<const int*>(
                              packed + (size_t)row * f + c))
                        : 0;
        }
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        if (u == 1 && !two) break;
        const int kq = 4 * (q + u * kWarps) - k0;  // offset in the range
        // 4 rows x 4 columns -> one word per column holding 4 rows
        const int t0 = __byte_perm(w[u][0], w[u][1], 0x5140);
        const int t1 = __byte_perm(w[u][0], w[u][1], 0x7362);
        const int t2 = __byte_perm(w[u][2], w[u][3], 0x5140);
        const int t3 = __byte_perm(w[u][2], w[u][3], 0x7362);
        int col[4], a[4];
        col[0] = __byte_perm(t0, t2, 0x5410);
        col[1] = __byte_perm(t0, t2, 0x7632);
        col[2] = __byte_perm(t1, t3, 0x5410);
        col[3] = __byte_perm(t1, t3, 0x7632);
#pragma unroll
        for (int j = 0; j < 4; ++j) a[j] = col[j] & 0x0F0F0F0F;
#pragma unroll
        for (int r = 0; r < NB; ++r) {
          const int xl = *reinterpret_cast<const int*>(xq_lo + r * rows + kq);
          const int xh = *reinterpret_cast<const int*>(xq_hi + r * rows + kq);
          rs[r] = __dp4a(xl, 0x01010101, rs[r]);
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            pl[r][j] = __dp4a(a[j], xl, pl[r][j]);
            ph[r][j] = __dp4a(col[j], xh, ph[r][j]) - __dp4a(a[j], xh, 0);
          }
        }
      }
    }
    // this warp's exact partials of group gi -> f32
    const int gl = n_groups > 1 ? gi : 0, ghi = n_groups > 1 ? gi + gh : 0;
    float swl[4], swh[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      swl[j] = col_ok ? __bfloat162float(sw[(size_t)gl * f + c + j]) : 0.f;
      swh[j] = col_ok ? __bfloat162float(sw[(size_t)ghi * f + c + j]) : 0.f;
    }
#pragma unroll
    for (int r = 0; r < NB; ++r) {
      const float sl = sxl[r * maxg + gi - g0], sh = sxh[r * maxg + gi - g0];
#pragma unroll
      for (int j = 0; j < 4; ++j)
        acc[r][j] += sl * swl[j] * (float)(pl[r][j] - 8 * rs[r]) +
                     sh * swh[j] * (float)(ph[r][j] >> 4);
    }
  }

  // 4. add the 8 warps' results in a fixed order
#pragma unroll
  for (int r = 0; r < NB; ++r)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      red[(warp * NB + r) * kCols + lane * 4 + j] = acc[r][j];
  __syncthreads();
  for (int t = threadIdx.x; t < nb * kCols; t += kThreads) {
    const int r = t / kCols, cc = t % kCols;
    const int gc = blockIdx.x * kCols + cc;
    if (gc >= f) continue;
    float s = 0.f;
    for (int w = 0; w < kWarps; ++w) s += red[(w * NB + r) * kCols + cc];
    if (gridDim.y == 1)
      store(out + (size_t)r * f + gc, s);
    else
      partial[((size_t)blockIdx.y * nb + r) * f + gc] = s;
  }
}

template <typename TOut>
__global__ void add_splits_kernel(const float* __restrict__ partial,
                                  TOut* __restrict__ out, int n, int splits) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float s = 0.f;
  for (int k = 0; k < splits; ++k) s += partial[(size_t)k * n + i];
  store(out + i, s);
}

template <int NB, typename TOut>
int launch(const void* x, const void* packed, const void* scales, void* out,
           void* partial, int nb, int dh, int f, int n_groups, int rows,
           cudaStream_t stream) {
  const int gr = n_groups > 1 ? 2 * dh / n_groups : dh;
  const int maxg = (rows + gr - 1) / gr + 1;
  const int splits = (dh + rows - 1) / rows;
  const Smem L = smem_layout(NB, rows, maxg);
  auto kernel = w4a8_matvec_kernel<NB, TOut>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L.bytes);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((f + kCols - 1) / kCols, splits);
  kernel<<<grid, kThreads, L.bytes, stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const int8_t*>(packed),
      static_cast<const __nv_bfloat16*>(scales), static_cast<TOut*>(out),
      static_cast<float*>(partial), nb, dh, f, n_groups, gr, rows, maxg);
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return (int)err;
  const int n = nb * f;
  add_splits_kernel<TOut><<<(n + 255) / 256, 256, 0, stream>>>(
      static_cast<const float*>(partial), static_cast<TOut*>(out), n, splits);
  return (int)cudaGetLastError();
}

template <typename TOut>
int launch_nb(const void* x, const void* packed, const void* scales,
              void* out, void* partial, int nb, int dh, int f, int n_groups,
              int rows, cudaStream_t st) {
  if (nb <= 1)
    return launch<1, TOut>(x, packed, scales, out, partial, nb, dh, f,
                               n_groups, rows, st);
  if (nb <= 2)
    return launch<2, TOut>(x, packed, scales, out, partial, nb, dh, f,
                               n_groups, rows, st);
  if (nb <= 4)
    return launch<4, TOut>(x, packed, scales, out, partial, nb, dh, f,
                               n_groups, rows, st);
  return launch<8, TOut>(x, packed, scales, out, partial, nb, dh, f,
                             n_groups, rows, st);
}

}  // namespace

// x: (nb <= 8, 2 dh) bf16; packed: (dh, f) int8; scales: (n_groups, f)
// bf16; out: (nb, f) f32 (out_bf16 = 0) or bf16; partial: (ceil(dh / rows),
// nb, f) f32 scratch when dh > rows, else unused. rows: packed rows per
// block, a multiple of 4; every group's packed rows (2 dh / n_groups, or dh
// when n_groups == 1) a multiple of 4; f % 4 == 0.
extern "C" int vlt_w4a8_matvec(const void* x, const void* packed,
                               const void* scales, void* out, void* partial,
                               int nb, int dh, int f, int n_groups, int rows,
                               int out_bf16, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (nb < 1 || nb > 8 || rows % 4 || f % 4) return (int)cudaErrorInvalidValue;
  if (out_bf16)
    return launch_nb<__nv_bfloat16>(x, packed, scales, out, partial, nb, dh,
                                    f, n_groups, rows, st);
  return launch_nb<float>(x, packed, scales, out, partial, nb, dh, f,
                          n_groups, rows, st);
}
