// Non-causal flash attention over head-major, once-padded CLIP tensors.
//
// Replaces video_llava_tpu/ops/attention.py::flash_attention_bhsd (Pallas
// body _flash_fwd_kernel / _flash_fwd_one). Computes, for every
// (batch*head) row block of q (bh, s, d) bf16:
//     o = softmax(q k^T * scale, keys >= kv_len masked) v      (bf16 out)
// with the softmax state (row max m, row sum l, accumulator) in f32.
//
// What bounds it on Hopper: at the CLIP shape (1600 heads x 272 x 272 x 64)
// the products are small and the block count is large, so the work is
// tensor-core bound in principle but in practice bound by shared-memory
// traffic between the two products (S is staged through shared memory for
// the softmax). The design keeps K/V tiles in shared memory, reused by all
// 64 query rows of a block (4 warps x 16 rows), runs both products on the
// tensor cores through WMMA (bf16 in, f32 accumulate), and never writes S
// or P to device memory. Unlike the TPU kernel, whose blocks must divide
// s_pad, every tile masks its own ragged edge, so any s and kv_len work
// (224 px: s = 272, kv_len = 257; 336 px: s = 640, kv_len = 577).
// Later work: wgmma + TMA, register-resident softmax, no S round trip.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;

namespace {

constexpr int kBQ = 64;       // query rows per block (16 per warp)
constexpr int kBK = 64;       // keys per tile
constexpr int kThreads = 128;

struct Layout {
  int ldh, ldp, ldf, ldo;
  size_t q, k, v, p, f, o, bytes;
};

__host__ __device__ inline Layout make_layout(int d) {
  Layout L;
  L.ldh = d + 8;                              // bf16 q/k/v tiles
  L.ldp = kBK + 8;                            // bf16 probabilities
  L.ldf = (d > kBK ? d : kBK) + 4;            // f32 scores, reused for P.V
  L.ldo = d + 4;                              // f32 output accumulator
  L.q = 0;
  L.k = L.q + (size_t)kBQ * L.ldh * 2;
  L.v = L.k + (size_t)kBK * L.ldh * 2;
  L.p = L.v + (size_t)kBK * L.ldh * 2;
  L.f = L.p + (size_t)kBQ * L.ldp * 2;
  L.o = L.f + (size_t)kBQ * L.ldf * 4;
  L.bytes = L.o + (size_t)kBQ * L.ldo * 4;
  return L;
}

// Copy rows [row0, row0 + 64) of a (s, d) head into a padded tile; rows at
// or past `valid` are zero so masked keys never carry junk into P.V.
__device__ inline void load_tile(__nv_bfloat16* dst, int ld,
                                 const __nv_bfloat16* src, int row0,
                                 int valid, int d) {
  const int vec = d / 8;
  for (int i = threadIdx.x; i < kBQ * vec; i += kThreads) {
    const int r = i / vec, c = (i % vec) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < valid)
      val = *reinterpret_cast<const uint4*>(src + (size_t)(row0 + r) * d + c);
    *reinterpret_cast<uint4*>(dst + r * ld + c) = val;
  }
}

__global__ void __launch_bounds__(kThreads)
flash_bhsd_kernel(const __nv_bfloat16* __restrict__ q,
                  const __nv_bfloat16* __restrict__ k,
                  const __nv_bfloat16* __restrict__ v,
                  __nv_bfloat16* __restrict__ o, int s, int d, int kv_len,
                  float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  const Layout L = make_layout(d);
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem + L.q);
  __nv_bfloat16* ks = reinterpret_cast<__nv_bfloat16*>(smem + L.k);
  __nv_bfloat16* vs = reinterpret_cast<__nv_bfloat16*>(smem + L.v);
  __nv_bfloat16* ps = reinterpret_cast<__nv_bfloat16*>(smem + L.p);
  float* fs = reinterpret_cast<float*>(smem + L.f);
  float* os = reinterpret_cast<float*>(smem + L.o);

  const size_t head = (size_t)blockIdx.y * s * d;
  const int q0 = blockIdx.x * kBQ;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  load_tile(qs, L.ldh, q + head, q0, s, d);
  for (int i = threadIdx.x; i < kBQ * L.ldo; i += kThreads) os[i] = 0.f;

  // Softmax ownership: two lanes per row, each half of the columns.
  const int row = warp * 16 + (lane >> 1);
  const int half = lane & 1;
  float m = -INFINITY, l = 0.f;

  const int num_kb = (kv_len + kBK - 1) / kBK;
  for (int kb = 0; kb < num_kb; ++kb) {
    __syncthreads();  // previous tile's K/V fully consumed
    load_tile(ks, L.ldh, k + head, kb * kBK, kv_len, d);
    load_tile(vs, L.ldh, v + head, kb * kBK, kv_len, d);
    __syncthreads();

    // S(16 x 64) = Q_w K^T for this warp's 16 rows.
    for (int n = 0; n < kBK / 16; ++n) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::fill_fragment(acc, 0.f);
      for (int kk = 0; kk < d; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                       wmma::row_major> a;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                       wmma::col_major> b;
        wmma::load_matrix_sync(a, qs + warp * 16 * L.ldh + kk, L.ldh);
        wmma::load_matrix_sync(b, ks + n * 16 * L.ldh + kk, L.ldh);
        wmma::mma_sync(acc, a, b, acc);
      }
      wmma::store_matrix_sync(fs + warp * 16 * L.ldf + n * 16, acc, L.ldf,
                              wmma::mem_row_major);
    }
    __syncwarp();

    // Online softmax on this lane's half row. P is rounded to bf16 for the
    // second product, and the row sum adds the rounded values so the
    // normalisation matches what is multiplied.
    float* srow = fs + row * L.ldf;
    const int c0 = half * (kBK / 2);
    float mx = -INFINITY;
    for (int c = c0; c < c0 + kBK / 2; ++c) {
      const float x = (kb * kBK + c < kv_len) ? srow[c] * scale : -INFINITY;
      srow[c] = x;
      mx = fmaxf(mx, x);
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    const float m_new = fmaxf(m, mx);  // finite: key 0 is always valid
    const float alpha = __expf(m - m_new);
    float sum = 0.f;
    for (int c = c0; c < c0 + kBK / 2; ++c) {
      const __nv_bfloat16 pb = __float2bfloat16(__expf(srow[c] - m_new));
      ps[row * L.ldp + c] = pb;
      sum += __bfloat162float(pb);
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    l = alpha * l + sum;
    m = m_new;
    __syncwarp();

    // PV(16 x d) = P_w V, staged in the (now free) score rows.
    for (int n = 0; n < d / 16; ++n) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::fill_fragment(acc, 0.f);
      for (int kk = 0; kk < kBK; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                       wmma::row_major> a;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                       wmma::row_major> b;
        wmma::load_matrix_sync(a, ps + warp * 16 * L.ldp + kk, L.ldp);
        wmma::load_matrix_sync(b, vs + kk * L.ldh + n * 16, L.ldh);
        wmma::mma_sync(acc, a, b, acc);
      }
      wmma::store_matrix_sync(fs + warp * 16 * L.ldf + n * 16, acc, L.ldf,
                              wmma::mem_row_major);
    }
    __syncwarp();
    const int d0 = half * (d / 2);
    for (int c = d0; c < d0 + d / 2; ++c)
      os[row * L.ldo + c] = alpha * os[row * L.ldo + c] + srow[c];
    __syncwarp();
  }

  if (q0 + row < s) {
    const float inv = 1.f / fmaxf(l, 1e-30f);
    __nv_bfloat16* orow = o + head + (size_t)(q0 + row) * d;
    const int d0 = half * (d / 2);
    for (int c = d0; c < d0 + d / 2; ++c)
      orow[c] = __float2bfloat16(os[row * L.ldo + c] * inv);
  }
}

}  // namespace

extern "C" int vlt_flash_bhsd(const void* q, const void* k, const void* v,
                              void* o, int bh, int s, int d, int kv_len,
                              float scale, void* stream) {
  const Layout L = make_layout(d);
  cudaError_t err = cudaFuncSetAttribute(
      flash_bhsd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)L.bytes);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((s + kBQ - 1) / kBQ, bh);
  flash_bhsd_kernel<<<grid, kThreads, L.bytes, (cudaStream_t)stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o),
      s, d, kv_len, scale);
  return (int)cudaGetLastError();
}
