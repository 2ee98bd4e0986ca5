// Multi-scale deformable attention (Deformable DETR / GroundingDINO).
//
// Replaces video_llava_tpu/ops/deformable_pallas.py::
// multi_scale_deformable_attention_pallas (pallas_call at :365) and its
// 2D-tiled twin multi_scale_deformable_attention_pallas_2d (:782), which
// compute the same function. For value (b, sum_hw, nh, hd), sampling
// locations (b, q, nh, L, P, 2) in [0, 1] (x, y) and attention weights
// (b, q, nh, L, P):
//     out[b, q, h, :] = sum_{l, p} a[b, q, h, l, p] *
//                       bilinear(value level l of (b, h), loc[b, q, h, l, p])
// where bilinear is grid_sample(align_corners=False, padding zeros):
// x = loc_x * w_l - 0.5, y = loc_y * h_l - 0.5, four corners, corners off
// the map read as zero. A sample with a non-finite coordinate contributes
// exactly zero, as in the Pallas kernel (deformable_pallas.py:276-280).
// Sums are f32; the output is written in the value dtype.
//
// What bounds it on Hopper: a gather. Each (b, q, head, level, point)
// reads four hd-wide rows of the value map, scattered by the data, and
// does 4 * hd multiply-adds with them; the bound counted for it is each
// input byte read once. The TPU kernel turned the gather into MXU matmuls
// against bilinear "tent" matrices because the TPU has no fast gather;
// Hopper has one, so this kernel gathers. A first body (one warp a
// (b, q, head), a lane a channel, each sample's coordinates broadcast by
// shuffles and recomputed by all 32 lanes, 64 dependent scalar loads a
// lane) ran at 0.08 of the bound, as slow in bf16 as in f32: few loads in
// flight and most issue slots on redundant arithmetic.
//
// The design (msda_vec_kernel), measured step by step (PERF.md §6):
// - A row of the value map is read by a group of LR lanes with 16-byte
//   loads (8 lanes in f32 at hd 32, 4 in bf16), so a warp reads 32 / LR
//   rows an instruction, through the read-only path.
// - A block of 8 warps owns a run of kQueryTile neighbouring queries of
//   one head (blocks in (b, tile, head) order, head fastest): encoder
//   queries are a raster and their samples fall a few pixels apart, so
//   the block's warps meet the same rows in the SM's L1. It first copies the run's locations and weights (the stream
//   the kernel reads from HBM) into shared memory with cp.async, all in
//   flight at once, beside the level table (indexing the launch's
//   parameters by a computed level costs a chain of compares and
//   constant loads a field).
// - A warp takes one query at a time (two where a row needs 4 lanes or
//   fewer). Its lanes compute the samples' corners once, a lane a sample:
//   each corner's offset (-1 when not read) and bilinear x attention
//   weight, into shared memory. Then a query's samples are dealt out to
//   up to 4 lane groups, and each lane issues the corner loads of kSpl
//   samples (16) before it uses any.
// - The groups' partial sums are added by xor-shuffles in a fixed order
//   (deterministic), and one group stores 16 bytes a lane.
// Head dims whose rows are not a power-of-two count of 16-byte chunks up
// to 32 (hd not a multiple of 4 in f32 or of 8 in bf16, or hd 96 in bf16)
// take msda_scalar_kernel, the first body. Level shapes and start rows
// travel by value in the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kMaxLevels = 5;
constexpr int kMaxChunks = 4;  // ceil(hd / 32) channels a lane, hd <= 128
constexpr int kWarps = 8;      // warps per block
constexpr int kSpl = 4;        // samples a lane loads at once (4 corners each)
// Queries of one head a block of the vector path takes (of 32, 64 and 128,
// 64 measured fastest at the encoder and decoder shapes, PERF.md §6). Its
// dynamic shared memory holds the tile's locations and weights, 3 floats a
// sample: at most 24 KB with L * P <= 32.
constexpr int kQueryTile = 64;

struct Levels {
  int h[kMaxLevels];
  int w[kMaxLevels];
  int start[kMaxLevels];
};

__device__ inline float to_f32(float x) { return x; }
__device__ inline float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ inline void store(float* p, float x) { *p = x; }
__device__ inline void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

template <typename T, int C>
__global__ void __launch_bounds__(kWarps * 32)
msda_scalar_kernel(const T* __restrict__ value,
                   const float* __restrict__ locs,
                   const float* __restrict__ weights, T* __restrict__ out,
                   int q, int nh, int hd, int sum_hw, int n_levels,
                   int n_points, Levels lv, long long n_rows) {
  const long long row = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row >= n_rows) return;  // the whole warp leaves together
  const int lane = threadIdx.x & 31;
  const int head = (int)(row % nh);
  const long long bq = row / nh;
  const int b = (int)(bq / q);
  bool mine[C];  // this lane's channels that exist
#pragma unroll
  for (int j = 0; j < C; ++j) mine[j] = j * 32 + lane < hd;
  const int n_samples = n_levels * n_points;

  // lane s holds sample s's (x, y) and weight: one load each per warp
  float2 my_loc = make_float2(0.f, 0.f);
  float my_w = 0.f;
  if (lane < n_samples) {
    my_loc = reinterpret_cast<const float2*>(locs)[row * n_samples + lane];
    my_w = weights[row * n_samples + lane];
  }

  float acc[C];
#pragma unroll
  for (int j = 0; j < C; ++j) acc[j] = 0.f;

  const T* vb = value + ((size_t)b * sum_hw * nh + head) * hd + lane;
  const size_t pix_stride = (size_t)nh * hd;  // one map position
  for (int l = 0; l < n_levels; ++l) {
    const int h = lv.h[l], w = lv.w[l];
    const T* vl = vb + (size_t)lv.start[l] * pix_stride;
    for (int p = 0; p < n_points; ++p) {
      const int s = l * n_points + p;
      const float lx = __shfl_sync(0xffffffffu, my_loc.x, s);
      const float ly = __shfl_sync(0xffffffffu, my_loc.y, s);
      const float a = __shfl_sync(0xffffffffu, my_w, s);
      const float x = lx * (float)w - 0.5f;
      const float y = ly * (float)h - 0.5f;
      // non-finite, or every corner off the map: exactly zero (the
      // comparisons are false for NaN, so test finiteness first)
      if (!isfinite(x) || !isfinite(y) || x <= -1.f || y <= -1.f ||
          x >= (float)w || y >= (float)h)
        continue;
      const float xf = floorf(x), yf = floorf(y);
      const int x0 = (int)xf, y0 = (int)yf;
      const float dx = x - xf, dy = y - yf;
      const bool in_x0 = x0 >= 0, in_x1 = x0 + 1 < w;
      const bool in_y0 = y0 >= 0, in_y1 = y0 + 1 < h;
      // signed offsets: y0 or x0 may be -1 (that corner is not read)
      const long long ps = (long long)pix_stride;
      const T* r00 = vl + ((long long)y0 * w + x0) * ps;
      const T* r10 = r00 + (long long)w * ps;
#pragma unroll
      for (int j = 0; j < C; ++j) {
        const int c = j * 32;
        const bool y0m = in_y0 && mine[j], y1m = in_y1 && mine[j];
        const float v00 = (y0m && in_x0) ? to_f32(r00[c]) : 0.f;
        const float v01 = (y0m && in_x1) ? to_f32(r00[pix_stride + c]) : 0.f;
        const float v10 = (y1m && in_x0) ? to_f32(r10[c]) : 0.f;
        const float v11 = (y1m && in_x1) ? to_f32(r10[pix_stride + c]) : 0.f;
        const float top = v00 * (1.f - dx) + v01 * dx;
        const float bot = v10 * (1.f - dx) + v11 * dx;
        acc[j] += a * (top * (1.f - dy) + bot * dy);
      }
    }
  }
  T* o = out + row * hd + lane;
#pragma unroll
  for (int j = 0; j < C; ++j)
    if (mine[j]) store(o + j * 32, acc[j]);
}

// 16 bytes of the value map through the read-only path.
__device__ inline uint4 ld16(const void* p) {
  return __ldg(reinterpret_cast<const uint4*>(p));
}

// acc[i] += wt * (the 16 bytes' values as f32): 4 f32 or 8 bf16.
__device__ inline void madd(float (&acc)[4], float wt, uint4 v) {
  acc[0] = fmaf(wt, __uint_as_float(v.x), acc[0]);
  acc[1] = fmaf(wt, __uint_as_float(v.y), acc[1]);
  acc[2] = fmaf(wt, __uint_as_float(v.z), acc[2]);
  acc[3] = fmaf(wt, __uint_as_float(v.w), acc[3]);
}
__device__ inline void madd(float (&acc)[8], float wt, uint4 v) {
  const uint32_t u[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    acc[2 * i] = fmaf(wt, __uint_as_float(u[i] << 16), acc[2 * i]);
    acc[2 * i + 1] = fmaf(wt, __uint_as_float(u[i] & 0xFFFF0000u),
                          acc[2 * i + 1]);
  }
}

// 4 f32 or 8 bf16 outputs in one 16-byte store.
__device__ inline void store16(float* p, const float (&acc)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(acc[0], acc[1], acc[2], acc[3]);
}
__device__ inline void store16(__nv_bfloat16* p, const float (&acc)[8]) {
  uint32_t u[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(acc[2 * i], acc[2 * i + 1]);
    u[i] = *reinterpret_cast<const uint32_t*>(&h);
  }
  *reinterpret_cast<uint4*>(p) = make_uint4(u[0], u[1], u[2], u[3]);
}

// Global -> shared copies that bypass registers: 16 bytes (both addresses
// 16-byte aligned) or 4.
__device__ inline void cp_async(void* dst, const void* src, int bytes) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  if (bytes == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(d),
                 "l"(src)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(d),
                 "l"(src)
                 : "memory");
}

// One sample's four corners as the load phase reads them: each corner's
// element offset in its (b, head) value map, -1 for a corner that is not
// read (off the map, or the whole sample zero), and its bilinear x
// attention weight.
struct alignas(16) Corners {
  int4 off;
  float4 wt;
};

// Shared memory of a vector-path block: the level table (indexing the
// launch's parameters by a computed level costs a chain of compares and
// constant loads a field), and each warp's corners of its current pass.
template <int QPW>
struct alignas(16) VecShared {
  int4 lv[kMaxLevels];     // w, h, start * nh * hd
  float2 fwh[kMaxLevels];  // w, h as floats
  Corners corners[kWarps][QPW][32];
};

// Sample (loc, a) of a level (lv: w, h, its first element; fwh: w, h as
// floats) -> its corners; pix elements a map position.
__device__ inline Corners corners(float2 loc, float a, int4 lv, float2 fwh,
                                  int pix) {
  const int w = lv.x, h = lv.y;
  const float x = loc.x * fwh.x - 0.5f;
  const float y = loc.y * fwh.y - 0.5f;
  Corners c;
  // non-finite, or every corner off the map: exactly zero (the
  // comparisons are false for NaN, so test finiteness first)
  if (!isfinite(x) || !isfinite(y) || x <= -1.f || y <= -1.f || x >= fwh.x ||
      y >= fwh.y) {
    c.off = make_int4(-1, -1, -1, -1);
    c.wt = make_float4(0.f, 0.f, 0.f, 0.f);
    return c;
  }
  const float xf = floorf(x), yf = floorf(y);
  const int x0 = (int)xf, y0 = (int)yf;
  const float dx = x - xf, dy = y - yf;
  const int p00 = lv.z + (y0 * w + x0) * pix;
  const bool in_x0 = x0 >= 0, in_x1 = x0 + 1 < w;
  const bool in_y0 = y0 >= 0, in_y1 = y0 + 1 < h;
  c.off = make_int4(in_y0 && in_x0 ? p00 : -1,
                    in_y0 && in_x1 ? p00 + pix : -1,
                    in_y1 && in_x0 ? p00 + w * pix : -1,
                    in_y1 && in_x1 ? p00 + (w + 1) * pix : -1);
  c.wt = make_float4(a * (1.f - dx) * (1.f - dy), a * dx * (1.f - dy),
                     a * (1.f - dx) * dy, a * dx * dy);
  return c;
}

// Block blockIdx.x = (b * n_tiles + tile) * nh + head owns queries
// [tile * kQueryTile, +kQueryTile) of (b, head). It first copies their
// locations and weights into shared memory (cp.async, all in flight at
// once: they are the kernel's stream from HBM), then its warps take the queries, QPW
// at a time: the warp's lanes compute the pass's samples' corners once
// (a lane a sample) into shared memory, then LR lanes read a row (hd
// values, LR x 16 bytes; lane `sub` of its group the values
// sub * VPC..+VPC), GPQ lane groups a query, group gq taking the samples
// gq, gq + GPQ, ...
template <typename T, int LR>
__global__ void __launch_bounds__(kWarps * 32, 4)
msda_vec_kernel(const T* __restrict__ value, const float* __restrict__ locs,
                const float* __restrict__ weights, T* __restrict__ out,
                int q, int nh, int hd, int sum_hw, int n_levels,
                int n_points, Levels lv, int n_tiles) {
  constexpr int VPC = 16 / sizeof(T);  // values a 16-byte chunk
  constexpr int GPW = 32 / LR;         // lane groups a warp
  // lane groups a query: up to 4, or half the warp's (2 queries a pass)
  constexpr int GPQ = GPW / 2 > 4 ? GPW / 2 : (GPW < 4 ? GPW : 4);
  constexpr int QPW = GPW / GPQ;  // queries a warp at a time: 1 or 2
  __shared__ VecShared<QPW> sh;
  extern __shared__ float4 s_dyn[];  // 16-byte aligned for cp.async
  float* const s_tile = reinterpret_cast<float*>(s_dyn);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int grp = lane / LR, sub = lane % LR;
  const int slot = grp / GPQ, gq = grp % GPQ;
  const int n_samples = n_levels * n_points;
  const int pix = nh * hd;  // elements a map position
  const int head = blockIdx.x % nh;
  const int bt = blockIdx.x / nh;
  const int b = bt / n_tiles, q0 = (bt % n_tiles) * kQueryTile;
  const int nq = min(kQueryTile, q - q0);
  const int ls = 2 * n_samples;  // floats of a query's locations
  float* s_loc = s_tile;
  float* s_a = s_tile + kQueryTile * ls;
  const size_t row0 = ((size_t)b * q + q0) * nh + head;  // (b, q0, head)
  // the tile's rows of locations and weights, nh rows apart in global
  if (n_samples % 4 == 0) {
    const int lc = ls / 4, ac = n_samples / 4;  // 16-byte chunks a row
    for (int i = threadIdx.x; i < nq * (lc + ac); i += kWarps * 32) {
      const int j = i / (lc + ac), c = i % (lc + ac);
      const size_t r = row0 + (size_t)j * nh;
      if (c < lc)
        cp_async(s_loc + j * ls + 4 * c, locs + r * ls + 4 * c, 16);
      else
        cp_async(s_a + j * n_samples + 4 * (c - lc),
                 weights + r * n_samples + 4 * (c - lc), 16);
    }
  } else {
    for (int i = threadIdx.x; i < nq * 3 * n_samples; i += kWarps * 32) {
      const int j = i / (3 * n_samples), c = i % (3 * n_samples);
      const size_t r = row0 + (size_t)j * nh;
      if (c < ls)
        cp_async(s_loc + j * ls + c, locs + r * ls + c, 4);
      else
        cp_async(s_a + j * n_samples + c - ls,
                 weights + r * n_samples + c - ls, 4);
    }
  }
  asm volatile("cp.async.commit_group;" ::: "memory");
  if (threadIdx.x < n_levels) {
    const int l = threadIdx.x;
    sh.lv[l] = make_int4(lv.w[l], lv.h[l], lv.start[l] * pix, 0);
    sh.fwh[l] = make_float2((float)lv.w[l], (float)lv.h[l]);
  }
  asm volatile("cp.async.wait_all;" ::: "memory");
  __syncthreads();
  const T* vb = value + ((size_t)b * sum_hw * nh + head) * hd + sub * VPC;
  // this lane's sample in the corners phase, and its level's table entry
  const int my_l = lane < n_samples ? lane / n_points : 0;
  const int4 my_lv = sh.lv[my_l];
  const float2 my_fwh = sh.fwh[my_l];
  Corners (&pass)[QPW][32] = sh.corners[warp];

  // warp-uniform trip count: every lane takes part in the shuffles
  for (int jw = warp * QPW; jw < nq; jw += kWarps * QPW) {
#pragma unroll
    for (int s = 0; s < QPW; ++s)
      if (lane < n_samples && jw + s < nq)
        pass[s][lane] = corners(
            reinterpret_cast<const float2*>(s_loc + (jw + s) * ls)[lane],
            s_a[(jw + s) * n_samples + lane], my_lv, my_fwh, pix);
    __syncwarp();
    const int j = jw + slot;  // the query in the tile
    const bool active = j < nq;
    float acc[VPC];
#pragma unroll
    for (int i = 0; i < VPC; ++i) acc[i] = 0.f;
    if (active) {
      for (int s0 = gq; s0 < n_samples; s0 += GPQ * kSpl) {
        Corners cs[kSpl];
#pragma unroll
        for (int u = 0; u < kSpl; ++u) {
          const int smp = s0 + u * GPQ;
          if (smp < n_samples) {
            cs[u] = pass[slot][smp];
          } else {
            cs[u].off = make_int4(-1, -1, -1, -1);
            cs[u].wt = make_float4(0.f, 0.f, 0.f, 0.f);
          }
        }
        // every corner load issued before any is used
        uint4 v[kSpl][4];
#pragma unroll
        for (int u = 0; u < kSpl; ++u) {
          const int o[4] = {cs[u].off.x, cs[u].off.y, cs[u].off.z, cs[u].off.w};
#pragma unroll
          for (int c = 0; c < 4; ++c)
            v[u][c] = o[c] >= 0 ? ld16(vb + o[c]) : make_uint4(0u, 0u, 0u, 0u);
        }
#pragma unroll
        for (int u = 0; u < kSpl; ++u) {
          madd(acc, cs[u].wt.x, v[u][0]);
          madd(acc, cs[u].wt.y, v[u][1]);
          madd(acc, cs[u].wt.z, v[u][2]);
          madd(acc, cs[u].wt.w, v[u][3]);
        }
      }
    }
    __syncwarp();  // the pass's corners are read before the next pass's
    // the query's groups' sums, lanes LR apart, in a fixed order
#pragma unroll
    for (int o = LR; o < LR * GPQ; o *= 2)
#pragma unroll
      for (int i = 0; i < VPC; ++i)
        acc[i] += __shfl_xor_sync(0xffffffffu, acc[i], o);
    if (active && gq == 0)
      store16(out + (row0 + (size_t)j * nh) * hd + sub * VPC, acc);
  }
}

template <typename T, int C>
cudaError_t launch_typed(const void* value, const float* locs,
                         const float* weights, void* out, int b, int sum_hw,
                         int q, int nh, int hd, int n_levels, int n_points,
                         const Levels& lv, cudaStream_t stream) {
  const long long n_rows = (long long)b * q * nh;
  const long long blocks = (n_rows + kWarps - 1) / kWarps;
  msda_scalar_kernel<T, C><<<(unsigned)blocks, kWarps * 32, 0, stream>>>(
      static_cast<const T*>(value), locs, weights, static_cast<T*>(out), q,
      nh, hd, sum_hw, n_levels, n_points, lv, n_rows);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_scalar(int hd, const void* value, const float* locs,
                          const float* weights, void* out, int b, int sum_hw,
                          int q, int nh, int n_levels, int n_points,
                          const Levels& lv, cudaStream_t stream) {
  switch ((hd + 31) / 32) {
    case 1:
      return launch_typed<T, 1>(value, locs, weights, out, b, sum_hw, q, nh,
                                hd, n_levels, n_points, lv, stream);
    case 2:
      return launch_typed<T, 2>(value, locs, weights, out, b, sum_hw, q, nh,
                                hd, n_levels, n_points, lv, stream);
    case 3:
      return launch_typed<T, 3>(value, locs, weights, out, b, sum_hw, q, nh,
                                hd, n_levels, n_points, lv, stream);
    case 4:
      return launch_typed<T, 4>(value, locs, weights, out, b, sum_hw, q, nh,
                                hd, n_levels, n_points, lv, stream);
  }
  return cudaErrorInvalidValue;
}

template <typename T, int LR>
cudaError_t launch_lanes(const void* value, const float* locs,
                         const float* weights, void* out, int b, int sum_hw,
                         int q, int nh, int hd, int n_levels, int n_points,
                         const Levels& lv, cudaStream_t stream) {
  const int n_tiles = (q + kQueryTile - 1) / kQueryTile;
  const long long blocks = (long long)b * n_tiles * nh;
  const size_t smem =
      (size_t)kQueryTile * n_levels * n_points * 3 * sizeof(float);
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  msda_vec_kernel<T, LR><<<(unsigned)blocks, kWarps * 32, smem, stream>>>(
      static_cast<const T*>(value), locs, weights, static_cast<T*>(out), q,
      nh, hd, sum_hw, n_levels, n_points, lv, n_tiles);
  return cudaGetLastError();
}

// The vector path by lanes a row (hd * sizeof(T) / 16, a power of two up
// to 32).
template <typename T>
cudaError_t launch_vec(int lr, const void* value, const float* locs,
                       const float* weights, void* out, int b, int sum_hw,
                       int q, int nh, int hd, int n_levels, int n_points,
                       const Levels& lv, cudaStream_t stream) {
#define VLT_MSDA_LANES(N)                                                   \
  case N:                                                                   \
    return launch_lanes<T, N>(value, locs, weights, out, b, sum_hw, q, nh, \
                              hd, n_levels, n_points, lv, stream);
  switch (lr) {
    VLT_MSDA_LANES(1)
    VLT_MSDA_LANES(2)
    VLT_MSDA_LANES(4)
    VLT_MSDA_LANES(8)
    VLT_MSDA_LANES(16)
    VLT_MSDA_LANES(32)
  }
#undef VLT_MSDA_LANES
  return cudaErrorInvalidValue;
}

// Lanes a row of the vector path, or 0 for the scalar one: the row's
// bytes a power-of-two count of 16-byte chunks up to 32, and every offset
// into one batch's map an int.
int row_lanes(int hd, int elem, int sum_hw, int nh) {
  const int bytes = hd * elem;
  if (bytes % 16 || (long long)sum_hw * nh * hd >= 0x7fffffffLL) return 0;
  const int chunks = bytes / 16;
  return chunks <= 32 && (chunks & (chunks - 1)) == 0 ? chunks : 0;
}

}  // namespace

// value (b, sum_hw, nh, hd) f32 or bf16; locs (b, q, nh, L, P, 2) f32;
// weights (b, q, nh, L, P) f32; out (b, q, nh * hd) in value's dtype.
// shapes: 2 * L host ints, (h, w) per level. 1 <= hd <= 128, L <= 5,
// L * P <= 32 (the wrapper checks).
extern "C" int vlt_msda(const void* value, const void* locs,
                        const void* weights, void* out, int b, int sum_hw,
                        int q, int nh, int hd, int n_levels, int n_points,
                        const int* shapes, int bf16, cudaStream_t stream) {
  if (n_levels < 1 || n_levels > kMaxLevels || n_points < 1 ||
      n_levels * n_points > 32 || hd < 1 || hd > 32 * kMaxChunks)
    return cudaErrorInvalidValue;
  Levels lv = {};
  int start = 0;
  for (int l = 0; l < n_levels; ++l) {
    lv.h[l] = shapes[2 * l];
    lv.w[l] = shapes[2 * l + 1];
    lv.start[l] = start;
    start += lv.h[l] * lv.w[l];
  }
  if (start != sum_hw) return cudaErrorInvalidValue;
  if ((long long)b * q * nh == 0) return cudaSuccess;
  const float* l = static_cast<const float*>(locs);
  const float* a = static_cast<const float*>(weights);
  const int lr = row_lanes(hd, bf16 ? 2 : 4, sum_hw, nh);
  if (lr)
    return bf16 ? launch_vec<__nv_bfloat16>(lr, value, l, a, out, b, sum_hw,
                                            q, nh, hd, n_levels, n_points, lv,
                                            stream)
                : launch_vec<float>(lr, value, l, a, out, b, sum_hw, q, nh,
                                    hd, n_levels, n_points, lv, stream);
  return bf16 ? launch_scalar<__nv_bfloat16>(hd, value, l, a, out, b, sum_hw,
                                             q, nh, n_levels, n_points, lv,
                                             stream)
              : launch_scalar<float>(hd, value, l, a, out, b, sum_hw, q, nh,
                                     n_levels, n_points, lv, stream);
}
