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
// does 4 * hd multiply-adds with them. The TPU kernel turned the gather
// into MXU matmuls against bilinear "tent" matrices because the TPU has
// no fast gather; Hopper has one, so this kernel gathers. One warp owns
// one (b, q, head): lane c holds channels c, c + 32, ... of the output
// (lanes past hd idle: a head dim under 32, or not a multiple of it),
// so each corner is one coalesced read of a 128-byte (f32, hd = 32) or
// 64-byte (bf16) row. The warp reads the (q, head)'s L * P location
// pairs and weights in one load each (lane s holds sample s) and
// broadcasts them with shuffles. The rows repeat across neighbouring
// queries and mostly hit L2; the bound counted for it is each input byte
// read once. Level shapes and start rows travel by value in the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kMaxLevels = 5;
constexpr int kMaxChunks = 4;  // ceil(hd / 32) channels a lane, hd <= 128
constexpr int kWarps = 8;      // warps per block

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
msda_kernel(const T* __restrict__ value, const float* __restrict__ locs,
            const float* __restrict__ weights, T* __restrict__ out,
            int q, int nh, int hd, int sum_hw, int n_levels, int n_points,
            Levels lv, long long n_rows) {
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

template <typename T, int C>
cudaError_t launch_typed(const void* value, const float* locs,
                         const float* weights, void* out, int b, int sum_hw,
                         int q, int nh, int hd, int n_levels, int n_points,
                         const Levels& lv, cudaStream_t stream) {
  const long long n_rows = (long long)b * q * nh;
  const long long blocks = (n_rows + kWarps - 1) / kWarps;
  msda_kernel<T, C><<<(unsigned)blocks, kWarps * 32, 0, stream>>>(
      static_cast<const T*>(value), locs, weights, static_cast<T*>(out), q,
      nh, hd, sum_hw, n_levels, n_points, lv, n_rows);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_hd(int hd, const void* value, const float* locs,
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
  return bf16 ? launch_hd<__nv_bfloat16>(hd, value, l, a, out, b, sum_hw, q,
                                         nh, n_levels, n_points, lv, stream)
              : launch_hd<float>(hd, value, l, a, out, b, sum_hw, q, nh,
                                 n_levels, n_points, lv, stream);
}
