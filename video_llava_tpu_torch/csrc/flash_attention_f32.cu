// Flash attention forward in f32, over BSHD tensors: kernel 7's body for
// f32 operands.
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
// first product and P stays f32 for the second: every product and sum is
// an f32 FMA, so the result differs from the plain f32 version only by
// the order of the sums.
//
// What bounds it: the f32 operands rule out the bf16 tensor cores, so the
// products run on the FP32 pipes (67 TFLOP/s on H100 SXM). At Whisper
// base's encoder shape (1, 1500, 8, 64) that is 4.6e9 operations, 0.069
// ms, over 12.3 MB of q/k/v/o (0.004 ms): operations.
//
// The design, kept simple: a block of 256 threads owns 64 query rows of
// one head and walks the key tiles (64 keys) that those rows see. The
// threads form a 16 x 16 grid: thread (ty, tx) owns rows ty + 16 i and,
// of each 64-key tile, columns tx + 16 j (i, j < 4), so the 16 lanes
// that share a row sit in one half-warp and reduce the row's max and sum
// with four shuffles. Q (scaled), K and V tiles sit in shared memory,
// Q and K with an odd pitch so that the 16 lanes reading 16 rows at one
// column hit 16 banks. P goes to shared memory (each half-warp writes and
// reads only its own rows: a warp barrier suffices) and the output
// accumulates in registers, columns tx + 16 n of the owned rows.
// Head dims: multiples of 16 up to 128.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace flash_f32 {

constexpr int kRows = 64;     // query rows a block owns
constexpr int kKeys = 64;     // keys a tile
constexpr int kThreads = 256;  // 16 x 16
constexpr int kPitchP = kKeys + 1;
constexpr float kSentinel = 1e30f;

struct Shape {
  int b, sq, skv, h, hkv, causal;
  float scale;
};

template <int D>
struct Smem {
  static constexpr int pq = D + 1;  // Q and K pitch (floats)
  static constexpr int pv = D;      // V pitch
  static constexpr size_t q = 0, k = q + (size_t)kRows * pq,
                          v = k + (size_t)kKeys * pq,
                          p = v + (size_t)kKeys * pv,
                          floats = p + (size_t)kRows * kPitchP,
                          bytes = floats * 4;
};

// Rows [row0, row0 + 64) of one head (rows `stride` floats apart) into a
// tile of pitch `pitch`, times `mul`; rows at or past `valid` are zero.
// 16-byte loads: D / 4 of them a row.
template <int D>
__device__ inline void load_tile(float* dst, int pitch, const float* src,
                                 size_t stride, int row0, int valid,
                                 float mul) {
  constexpr int kVec = D / 4;
  for (int i = threadIdx.x; i < kRows * kVec; i += kThreads) {
    const int r = i / kVec, c = (i % kVec) * 4;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row0 + r < valid)
      x = *reinterpret_cast<const float4*>(src + (size_t)(row0 + r) * stride
                                           + c);
    float* d = dst + r * pitch + c;
    d[0] = x.x * mul;
    d[1] = x.y * mul;
    d[2] = x.z * mul;
    d[3] = x.w * mul;
  }
}

__device__ inline float half_warp_max(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ inline float half_warp_sum(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

template <int D>
__global__ void __launch_bounds__(kThreads)
fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
           const float* __restrict__ v, float* __restrict__ o,
           float* __restrict__ lse, Shape sh) {
  using L = Smem<D>;
  constexpr int kCols = D / 16;  // output columns a thread owns, per row
  extern __shared__ __align__(16) float smem[];
  float* qs = smem + L::q;
  float* ks = smem + L::k;
  float* vs = smem + L::v;
  float* ps = smem + L::p;

  const int bh = blockIdx.x;
  const int bi = bh / sh.h, hi = bh % sh.h;
  const int kvh = hi / (sh.h / sh.hkv);
  const size_t qstride = (size_t)sh.h * D, kstride = (size_t)sh.hkv * D;
  const size_t qhead = (size_t)bi * sh.sq * qstride + (size_t)hi * D;
  const size_t khead = (size_t)bi * sh.skv * kstride + (size_t)kvh * D;
  const int q0 = blockIdx.y * kRows;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;

  load_tile<D>(qs, L::pq, q + qhead, qstride, q0, sh.sq, sh.scale);

  float m[4], l[4], acc[4][kCols];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int n = 0; n < kCols; ++n) acc[i][n] = 0.f;
  }

  // Key tiles these rows see: all, or (causal) up to the key the last
  // real row sees. Key 0 is seen by every row (sq <= skv under the causal
  // mask), so m is finite after the first tile.
  int num_kb = (sh.skv + kKeys - 1) / kKeys;
  if (sh.causal) {
    const int last = min(q0 + kRows, sh.sq) - 1 + sh.skv - sh.sq;
    num_kb = min(num_kb, last / kKeys + 1);
  }
  for (int kb = 0; kb < num_kb; ++kb) {
    const int k0 = kb * kKeys;
    __syncthreads();  // the previous tile's K and V consumed
    load_tile<D>(ks, L::pq, k + khead, kstride, k0, sh.skv, 1.f);
    load_tile<D>(vs, L::pv, v + khead, kstride, k0, sh.skv, 1.f);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int c = 0; c < D; ++c) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = qs[(ty + 16 * i) * L::pq + c];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = ks[(tx + 16 * j) * L::pq + c];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(a[i], b[j], s[i][j]);
    }

    // Online softmax, a row's 64 scores over the 16 lanes of a half-warp.
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qi = q0 + ty + 16 * i;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kj = k0 + tx + 16 * j;
        const bool seen =
            kj < sh.skv && (!sh.causal || kj <= qi + sh.skv - sh.sq);
        s[i][j] = seen ? s[i][j] : -INFINITY;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], half_warp_max(mx));
      const float alpha = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_new);
        ps[(ty + 16 * i) * kPitchP + tx + 16 * j] = p;
        sum += p;
      }
      l[i] = alpha * l[i] + half_warp_sum(sum);
      m[i] = m_new;
#pragma unroll
      for (int n = 0; n < kCols; ++n) acc[i][n] *= alpha;
    }
    __syncwarp();  // P rows are written and read by their own half-warp

#pragma unroll 4
    for (int c = 0; c < kKeys; ++c) {
      float p[4], x[kCols];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = ps[(ty + 16 * i) * kPitchP + c];
#pragma unroll
      for (int n = 0; n < kCols; ++n) x[n] = vs[c * L::pv + tx + 16 * n];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int n = 0; n < kCols; ++n)
          acc[i][n] = fmaf(p[i], x[n], acc[i][n]);
    }
    __syncwarp();  // P read before the next tile's rows overwrite it
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + ty + 16 * i;
    if (qi >= sh.sq) continue;
    const float lc = fmaxf(l[i], 1e-30f);
    float* orow = o + qhead + (size_t)qi * qstride;
#pragma unroll
    for (int n = 0; n < kCols; ++n) orow[tx + 16 * n] = acc[i][n] / lc;
    if (tx == 0) {
      const float x = m[i] + logf(lc);
      lse[(size_t)bh * sh.sq + qi] = isfinite(x) ? x : kSentinel;
    }
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* o, void* lse,
           const Shape& sh, cudaStream_t stream) {
  auto kernel = fwd_kernel<D>;
  const size_t bytes = Smem<D>::bytes;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(sh.b * sh.h, (sh.sq + kRows - 1) / kRows);
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
  const flash_f32::Shape sh{b, sq, skv, h, hkv, causal, scale};
  const cudaStream_t st = (cudaStream_t)stream;
  switch (d) {
#define VLT_CASE(D) \
  case D:           \
    return flash_f32::launch<D>(q, k, v, o, lse, sh, st);
    VLT_CASE(16) VLT_CASE(32) VLT_CASE(48) VLT_CASE(64) VLT_CASE(80)
    VLT_CASE(96) VLT_CASE(112) VLT_CASE(128)
#undef VLT_CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
}
