// W4A8 matvec: a few activation rows against an int4 nibble-packed weight,
// on the int8 tensor cores.
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
// What bounds it on Hopper: the packed bytes, read once (25.2 MB for
// Vicuna-7B's fused wqkv, 7.5 us at 3.35 TB/s); the products are few. A
// first body formed them with dp4a per (row, column), so its instructions
// grew with nb and, with 4-byte loads, kept too few bytes in flight. The
// design: a block of 256 threads owns 128 columns and a K range; warp w
// takes the 32-column strip w % 4 of half the range (w / 4), in steps of
// 32 packed rows that its lanes stream with cp.async (16 bytes a lane,
// csrc/async_ring.cuh) through a ring of MATVEC_DEPTH 1 KB stages. A step's
// weights are the 16-row operand of mma.sync m16n8k32 s8 (two ldmatrix.x4.
// trans and byte permutes, csrc/w4a8_frag.cuh) and the activations the
// 8-row one, so 1 to 8 rows cost one instruction stream. Each block first
// quantizes the activations of its K range into shared memory (the absmax
// of each group it touches over the whole group; the TPU kernel did this
// once at grid step 0, which needs the grid's order); each group's exact
// int32 partials are scaled in f32 at the group's end (every 128 rows at
// most). K is split over blocks so that the column tiles fill the card
// (ops/quant4.py matvec_rows_per_split: whole groups), and
// add_splits_kernel adds the (split, nb, F) f32 partials in split order:
// deterministic, no atomics (a last-block merge measured slower on the
// W4A16 matvec, PERF.md).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "async_ring.cuh"
#include "int4_out.cuh"
#include "w4a8_frag.cuh"

namespace {

using namespace w4a8;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kStrips = 4;               // 32-column strips a block
constexpr int kCols = 32 * kStrips;      // = MATVEC_COLS in quant4.py
constexpr int kK = 32;                   // packed rows a step
constexpr int kDepth = 4;   // = MATVEC_DEPTH: steps in flight a warp (4 of 4, 8)
constexpr int kStage = kK * 32;          // bytes: 32 rows x 32 columns
constexpr size_t kRingBytes = (size_t)kWarps * kDepth * kStage;
constexpr int kRows = 8;                 // activation rows of the product
static_assert(kRingBytes >= 2 * kRows * kCols * sizeof(float),
              "the ring holds the block's reduction");

__device__ inline int8_t quantize(float v, float s) {
  const float q = rintf(__fdiv_rn(v, s));
  return (int8_t)fminf(fmaxf(q, -127.f), 127.f);
}

// 16 bytes global -> shared, zeros (and nothing read) when !valid.
__device__ inline void cp_async16_zfill(void* smem, const void* gmem,
                                        bool valid) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(valid ? 16 : 0)
               : "memory");
}

// The block's shared memory (= quant4.matvec_smem_bytes): the ring, the
// int8 activations of the low and high half (8 rows, `stride` bytes
// apart), the f32 scales of each (row, group) a half, and the weight
// scales of the block's columns, (half, group, column pair) bf16 pairs.
struct Layout {
  int stride, maxg;
  size_t xs, sxl, sxh, sws, bytes;
};

__host__ __device__ inline Layout layout(int rows, int gr) {
  Layout L;
  L.stride = 128 * ((rows + 127) / 128) + 16;
  L.maxg = (rows + gr - 1) / gr + 1;
  L.xs = kRingBytes;
  L.sxl = L.xs + 2 * (size_t)kRows * L.stride;
  L.sxh = L.sxl + (size_t)kRows * L.maxg * 4;
  L.sws = L.sxh + (size_t)kRows * L.maxg * 4;
  L.bytes = L.sws + 2 * (size_t)L.maxg * (kCols / 2) * 4;
  return L;
}

// One block: columns [blockIdx.x * kCols, +kCols), packed rows [k0, k1) =
// [blockIdx.y * rows, +rows). With one split the block writes out, else
// its f32 partial (split, nb, F) for add_splits_kernel.
template <typename TOut>
__global__ void __launch_bounds__(kThreads)
w4a8_matvec_kernel(const __nv_bfloat16* __restrict__ x,
                   const int8_t* __restrict__ packed,
                   const __nv_bfloat16* __restrict__ sw, TOut* __restrict__ out,
                   float* __restrict__ partial, int nb, int dh, int f,
                   int n_groups, int gr, int rows) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout L = layout(rows, gr);
  int8_t* xq_lo = reinterpret_cast<int8_t*>(smem + L.xs);
  int8_t* xq_hi = xq_lo + kRows * L.stride;
  float* sxl = reinterpret_cast<float*>(smem + L.sxl);
  float* sxh = reinterpret_cast<float*>(smem + L.sxh);
  uint32_t* sws = reinterpret_cast<uint32_t*>(smem + L.sws);

  const int d = 2 * dh, gh = dh / gr;  // groups a half
  const int k0 = blockIdx.y * rows, k1 = min(k0 + rows, dh);
  const int g0 = k0 / gr, ng = (k1 - 1) / gr + 1 - g0;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gid = lane / 4, tig = lane % 4;
  const int strip = warp % kStrips, rg = warp / kStrips;
  const int c0 = blockIdx.x * kCols + strip * 32;  // the strip's first column
  const int half_rows = kK * ((rows + 2 * kK - 1) / (2 * kK));
  const int r0 = k0 + rg * half_rows, r1 = min(r0 + half_rows, k1);
  const int nk = r1 > r0 ? (r1 - r0) / kK : 0;
  unsigned char* stages = smem + (size_t)warp * kDepth * kStage;

  // The lane's copies: rows lane / 2 and 16 + lane / 2 of the step, 16
  // bytes (lane % 2) of the strip; the two units of rows 4-7 (mod 8)
  // swapped, so ldmatrix reads without bank conflicts.
  const int crow = lane / 2, cu = lane % 2;
  const bool cvalid = c0 + 16 * cu < f;  // f % 16 == 0
  const int8_t* csrc = packed + (size_t)(r0 + crow) * f + c0 + 16 * cu;
  const int cdst = crow * 32 + 16 * (cu ^ ((crow >> 2) & 1));
  // Step i's copy into its stage, one commit group a step (empty past the
  // warp's rows), so every lane counts the same groups.
  auto fetch = [&](int i) {
    if (i < nk) {
      unsigned char* st = stages + (i % kDepth) * kStage + cdst;
      const int8_t* src = csrc + (size_t)i * kK * f;
      cp_async16_zfill(st, cvalid ? src : packed, cvalid);
      cp_async16_zfill(st + 16 * 32, cvalid ? src + (size_t)16 * f : packed,
                       cvalid);
    }
    ring::commit();
  };
  // The loads the block's set-up waits on go out before the ring's copies
  // queue behind them: each warp's first (row, group, half) of x (a whole
  // group of at most 256 values, one 16-byte load a lane) and up to four
  // bf16 pairs a thread of the block's weight scales.
  const int ntask = nb * ng * 2;
  // a group is one load a lane, and (G > 1) splits are whole groups
  const bool whole = gr <= 256 && n_groups > 1;
  const auto task_x = [&](int t) {  // the task's half of its row, its group
    const int r = t / (ng * 2), gi = (t >> 1) % ng, half = t & 1;
    return x + (size_t)r * d + half * dh + (size_t)(g0 + gi) * gr;
  };
  uint4 v = make_uint4(0u, 0u, 0u, 0u);
  if (whole && warp < ntask && 8 * lane < gr)
    v = __ldg(reinterpret_cast<const uint4*>(task_x(warp) + 8 * lane));
  const int nsw = 2 * ng * (kCols / 2);  // (half, group, column pair)
  const auto sw_src = [&](int j) {
    const int half = j / (ng * (kCols / 2)), gi = (j / (kCols / 2)) % ng;
    const int g = g0 + gi, row = n_groups > 1 ? g + half * gh : 0;
    return sw + (size_t)row * f + blockIdx.x * kCols + 2 * (j % (kCols / 2));
  };
  uint32_t swv[4];
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const int j = threadIdx.x + u * kThreads;
    const bool ok = j < nsw &&
                    blockIdx.x * kCols + 2 * (j % (kCols / 2)) < f;
    swv[u] = ok ? __ldg(reinterpret_cast<const unsigned*>(sw_src(j))) : 0u;
  }
#pragma unroll
  for (int i = 0; i < kDepth; ++i) fetch(i);

  // 1. The activations of the range, a warp a (row, group, half): the
  // group's absmax over all of it, then the group's rows inside [k0, k1)
  // quantized into shared memory; rows past nb are zeros.
  const int zchunks = (kRows - nb) * L.stride / 16;  // stride % 16 == 0
  for (int t = threadIdx.x; t < 2 * zchunks; t += kThreads)
    reinterpret_cast<uint4*>((t < zchunks ? xq_lo : xq_hi) +
                             nb * L.stride)[t % zchunks] =
        make_uint4(0u, 0u, 0u, 0u);
  for (int t = threadIdx.x; t < (kRows - nb) * L.maxg; t += kThreads)
    sxl[nb * L.maxg + t] = sxh[nb * L.maxg + t] = 0.f;
  const auto sw_dst = [&](int j) {  // (half, group) rows maxg apart
    const int half = j / (ng * (kCols / 2)), gi = (j / (kCols / 2)) % ng;
    return sws + (half * L.maxg + gi) * (kCols / 2) + j % (kCols / 2);
  };
#pragma unroll
  for (int u = 0; u < 4; ++u)
    if (threadIdx.x + u * kThreads < nsw)
      *sw_dst(threadIdx.x + u * kThreads) = swv[u];
  for (int j = threadIdx.x + 4 * kThreads; j < nsw; j += kThreads)
    *sw_dst(j) = blockIdx.x * kCols + 2 * (j % (kCols / 2)) < f
                     ? __ldg(reinterpret_cast<const unsigned*>(sw_src(j)))
                     : 0u;
  const auto quantize8 = [](uint4 val, float sc) {  // 8 values -> 8 bytes
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&val);
    uint32_t w[2] = {0u, 0u};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 p = __bfloat1622float2(h[j]);
      const uint32_t lo = (uint8_t)quantize(p.x, sc);
      const uint32_t hi = (uint8_t)quantize(p.y, sc);
      w[j / 2] |= (lo | hi << 8) << (16 * (j % 2));
    }
    return make_uint2(w[0], w[1]);
  };
  const auto absmax8 = [](uint4 val, float m) {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&val);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 p = __bfloat1622float2(h[j]);
      m = fmaxf(m, fmaxf(fabsf(p.x), fabsf(p.y)));
    }
    return m;
  };
  for (int t = warp; t < ntask; t += kWarps) {
    const int r = t / (ng * 2), gi = (t >> 1) % ng, half = t & 1;
    const int gs = (g0 + gi) * gr;  // the group's first row in its half
    const __nv_bfloat16* xg = task_x(t);
    int8_t* dst = (half ? xq_hi : xq_lo) + r * L.stride + gs - k0;
    float m = 0.f;
    if (whole) {  // the group lies inside [k0, k1): splits are whole groups
      if (t != warp && 8 * lane < gr)
        v = __ldg(reinterpret_cast<const uint4*>(xg + 8 * lane));
      m = absmax8(v, m);
    } else {
      for (int k = 8 * lane; k < gr; k += 256)
        m = absmax8(__ldg(reinterpret_cast<const uint4*>(xg + k)), m);
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
    const float sc = __fdiv_rn(fmaxf(m, 1e-8f), 127.f);
    if (lane == 0) (half ? sxh : sxl)[r * L.maxg + gi] = sc;
    if (whole) {
      if (8 * lane < gr)
        *reinterpret_cast<uint2*>(dst + 8 * lane) = quantize8(v, sc);
    } else {
      for (int k = max(gs, k0) - gs + 8 * lane; k < min(gs + gr, k1) - gs;
           k += 256)
        *reinterpret_cast<uint2*>(dst + k) = quantize8(
            __ldg(reinterpret_cast<const uint4*>(xg + k)), sc);
    }
  }
  __syncthreads();

  // 2. the products: a step's 32 columns are two m16n8k32 A operands a
  // half; D element e of column group cg is column c0 + 16 cg + 2 gid +
  // e / 2, activation row 2 tig + e % 2.
  const int lr = ldsm_row(lane);
  const uint32_t ring_base = (uint32_t)__cvta_generic_to_shared(stages);
  uint32_t laddr[2];
#pragma unroll
  for (int cg = 0; cg < 2; ++cg)
    laddr[cg] = ring_base + lr * 32 + 16 * (cg ^ ((lr >> 2) & 1));
  const uint32_t sel0 = frag_sel(tig, 0), sel1 = frag_sel(tig, 1);
  const int8_t* xl = xq_lo + gid * L.stride + (r0 - k0) + 4 * tig;
  const int8_t* xh = xq_hi + gid * L.stride + (r0 - k0) + 4 * tig;

  uint32_t acc_lo[2][4], acc_hi[2][4];
  float tot[2][4];
  float2 swl[2], swh[2];
  int gi = 0;  // the group of the run being summed, from g0
#pragma unroll
  for (int cg = 0; cg < 2; ++cg)
#pragma unroll
    for (int e = 0; e < 4; ++e) tot[cg][e] = 0.f;
  // A run's exact int32 sums (16 x, csrc/w4a8_frag.cuh) -> f32, scaled by
  // sx[row, group] sw[group, column] / 16.
  auto fold = [&]() {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = 2 * tig + (e & 1);
      const float al = sxl[r * L.maxg + gi], ah = sxh[r * L.maxg + gi];
#pragma unroll
      for (int cg = 0; cg < 2; ++cg) {
        const float wl = (e & 2) ? swl[cg].y : swl[cg].x;
        const float wh = (e & 2) ? swh[cg].y : swh[cg].x;
        tot[cg][e] += al * wl * to_f32(acc_lo[cg][e]) +
                      ah * wh * to_f32(acc_hi[cg][e]);
      }
    }
  };
  int next_group = (r0 / gr + 1) * gr;  // where the next group starts
  gi = r0 / gr - g0 - 1;
  for (int i = 0; i < nk; ++i) {
    const int row = r0 + i * kK;
    const bool new_group = i == 0 || row == next_group;
    if (new_group || row % 128 == 0) {  // a run starts
      if (i > 0) fold();
      if (new_group) {
        ++gi;
        if (i > 0) next_group += gr;
      }
#pragma unroll
      for (int cg = 0; cg < 2; ++cg) {
        const int pair = (strip * 32 + cg * 16) / 2 + gid;
        swl[cg] = scale_pair(sws[gi * (kCols / 2) + pair]);
        swh[cg] = scale_pair(sws[(L.maxg + gi) * (kCols / 2) + pair]);
#pragma unroll
        for (int e = 0; e < 4; ++e) acc_lo[cg][e] = acc_hi[cg][e] = 0u;
      }
    }
    ring::wait<kDepth - 1>();  // step i has landed
    __syncwarp();               // every lane's copy of it
    uint32_t r[2][4];
    const uint32_t so = (i % kDepth) * kStage;
#pragma unroll
    for (int cg = 0; cg < 2; ++cg) ldsm_x4_trans(r[cg], laddr[cg] + so);
    __syncwarp();  // read before any lane refills the stage
    fetch(i + kDepth);
    const int kk = i * kK;
    const uint32_t bl0 = *reinterpret_cast<const uint32_t*>(xl + kk);
    const uint32_t bl1 = *reinterpret_cast<const uint32_t*>(xl + kk + 16);
    const uint32_t bh0 = *reinterpret_cast<const uint32_t*>(xh + kk);
    const uint32_t bh1 = *reinterpret_cast<const uint32_t*>(xh + kk + 16);
#pragma unroll
    for (int cg = 0; cg < 2; ++cg) {
      uint32_t lo[4], hi[4];
      fragments(r[cg], sel0, sel1, lo, hi);
      mma_s8(acc_lo[cg], lo, bl0, bl1);
      mma_s8(acc_hi[cg], hi, bh0, bh1);
    }
  }
  if (nk > 0) fold();
  ring::wait<0>();
  __syncthreads();  // the ring is free: the two row groups' sums go there

  float* red = reinterpret_cast<float*>(smem);  // (2, kRows, kCols)
#pragma unroll
  for (int cg = 0; cg < 2; ++cg)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      red[(rg * kRows + 2 * tig + (e & 1)) * kCols + strip * 32 + cg * 16 +
          2 * gid + (e >> 1)] = tot[cg][e];
  __syncthreads();
  for (int t = threadIdx.x; t < nb * kCols; t += kThreads) {
    const int r = t / kCols, cc = t % kCols;
    const int gc = blockIdx.x * kCols + cc;
    if (gc >= f) continue;
    const float s = red[r * kCols + cc] + red[(kRows + r) * kCols + cc];
    if (gridDim.y == 1)
      store(out + (size_t)r * f + gc, s);
    else
      partial[((size_t)blockIdx.y * nb + r) * f + gc] = s;
  }
}

template <typename TOut>
int launch(const void* x, const void* packed, const void* scales, void* out,
           void* partial, int nb, int dh, int f, int n_groups, int rows,
           cudaStream_t stream) {
  const int gr = n_groups > 1 ? 2 * dh / n_groups : dh;
  const int splits = (dh + rows - 1) / rows;
  const Layout L = layout(rows, gr);
  auto kernel = w4a8_matvec_kernel<TOut>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L.bytes);
  if (err == cudaSuccess)  // room for several blocks an SM, not one
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               (int)cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((f + kCols - 1) / kCols, splits);
  kernel<<<grid, kThreads, L.bytes, stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const int8_t*>(packed),
      static_cast<const __nv_bfloat16*>(scales), static_cast<TOut*>(out),
      static_cast<float*>(partial), nb, dh, f, n_groups, gr, rows);
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return (int)err;
  const int n = nb * f;
  add_splits_kernel<TOut><<<(n + 255) / 256, 256, 0, stream>>>(
      static_cast<const float*>(partial), static_cast<TOut*>(out), n, splits);
  return (int)cudaGetLastError();
}

}  // namespace

// x: (nb <= 8, 2 dh) bf16; packed: (dh, f) int8; scales: (n_groups, f)
// bf16; out: (nb, f) f32 (out_bf16 = 0) or bf16; partial: (ceil(dh / rows),
// nb, f) f32 scratch when dh > rows, else unused. rows: packed rows a
// block, a multiple of 64 (or all of dh) and, for G > 1, of the group's
// packed rows (2 dh / n_groups), which are a multiple of 32 (dh when
// n_groups == 1); f % 16 == 0.
extern "C" int vlt_w4a8_matvec(const void* x, const void* packed,
                               const void* scales, void* out, void* partial,
                               int nb, int dh, int f, int n_groups, int rows,
                               int out_bf16, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int gr = n_groups > 1 ? 2 * dh / n_groups : dh;
  if (nb < 1 || nb > kRows || gr % kK || f % 16 || rows < 2 * kK ||
      (rows < dh && (rows % (2 * kK) || (n_groups > 1 && rows % gr) ||
                     !partial)))
    return (int)cudaErrorInvalidValue;
  if (out_bf16)
    return launch<__nv_bfloat16>(x, packed, scales, out, partial, nb, dh, f,
                                 n_groups, rows, st);
  return launch<float>(x, packed, scales, out, partial, nb, dh, f, n_groups,
                       rows, st);
}
