// Hopper building blocks shared by the wgmma kernels (csrc/flash_attention.cu,
// kernels 7 and 8; csrc/flash_bhsd.cu, kernel 1; csrc/w4a8_block.cu and the
// W4A16 block matmul in csrc/w4a16.cu): shared addresses, mbarriers, TMA
// loads and the tensor-map encoders, setmaxnreg, the consumer warpgroups'
// turns, wgmma descriptors over 128-byte-swizzled tiles, the m64nNk16
// products, and the quad reductions and tile stores that work on their
// accumulators.

#pragma once

#include <cuda.h>  // CUtensorMap and its enums; the encoder comes from cudart
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace flash {
namespace hopper {

using bf16 = __nv_bfloat16;

// ---------------------------------------------------------------------------
// PTX: shared addresses, mbarriers, TMA, wgmma
// ---------------------------------------------------------------------------

__device__ inline uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ inline void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ inline void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   bar),
               "r"(bytes)
               : "memory");
}

__device__ inline void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar)
               : "memory");
}

// Wait for the completion of the barrier's phase of this parity.
__device__ inline void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.b32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// One box of a 4-D tensor map into shared memory at `dst`; completion
// (its bytes) is reported to `bar`.
__device__ inline void tma_load(uint32_t dst, const CUtensorMap* map,
                                uint32_t bar, int c0, int c1, int c2,
                                int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3)
      : "memory");
}

// One box of a 2-D tensor map (tile_map) into shared memory at `dst`.
__device__ inline void tma_load_2d(uint32_t dst, const CUtensorMap* map,
                                   uint32_t bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

template <int N>
__device__ inline void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(N));
}
template <int N>
__device__ inline void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(N));
}

// 4 bytes from global to shared memory, asynchronously; zeros when
// `valid` is false (src is then not read).
__device__ inline void cp_async4(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(dst),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}
// Arrive on `bar` once this thread's earlier cp.async copies have landed.
__device__ inline void cp_async_arrive(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];" ::"r"(
                   bar)
               : "memory");
}

// A barrier of one consumer warpgroup's 128 threads (id 0 is
// __syncthreads').
__device__ inline void warpgroup_sync(int wg) {
  asm volatile("bar.sync %0, 128;" ::"r"(wg + 1) : "memory");
}

// Two consumer warpgroups taking turns issuing their products (CUTLASS's
// ping-pong; csrc/w4a8_block.cu, csrc/w4a16.cu): a warpgroup waits for its
// turn, issues a run's wgmma and hands the turn over, so that one folds
// its sums while the other's products run. Named barriers kTurn + wg.
constexpr int kTurn = 4;
__device__ inline void wait_turn(int wg) {
  asm volatile("bar.sync %0, 256;" ::"r"(kTurn + wg) : "memory");
}
__device__ inline void pass_turn(int wg) {
  asm volatile("bar.arrive %0, 256;" ::"r"(kTurn + 1 - wg) : "memory");
}

__device__ inline void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ inline void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
__device__ inline void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}

// Pin registers an asynchronous wgmma reads or writes at this point of the
// program, so that the compiler neither reads an accumulator before the
// wait nor reuses an A fragment's registers while the product runs.
template <int R>
__device__ inline void fence_regs(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
template <int R>
__device__ inline void fence_regs(uint32_t (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// wgmma shared-memory descriptor, 128-byte swizzle: start address, leading
// and stride byte offsets (16-byte units).
__device__ inline uint64_t make_desc(uint32_t addr, uint32_t lbo,
                                     uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (1ull << 62);
}

// A tile of `rows` rows x D bf16 columns lies in shared memory as D / 64
// chunks of rows x 128 bytes, 1024-byte aligned, swizzled as TMA's
// 128-byte mode writes it: the 16-byte unit u of row r at unit u ^ (r % 8).
// As a K-major operand (rows are M or N, columns K): k-step kk reads
// columns 16kk..16kk+15, 32 bytes into the chunk's swizzle rows; 8-row
// groups 1024 bytes apart.
__device__ inline uint64_t desc_k(uint32_t tile, int rows, int kk) {
  return make_desc(tile + (kk / 4) * rows * 128 + (kk % 4) * 32, 16, 1024);
}
// As an MN-major operand (rows are K, columns N; the transpose bit): k-step
// kk reads rows 16kk..16kk+15; N chunks of 64 columns `rows` x 128 bytes
// apart.
__device__ inline uint64_t desc_mn(uint32_t tile, int rows, int kk) {
  return make_desc(tile + kk * 2048, rows * 128, 1024);
}

// Byte offset of element (row, col) in such a tile.
__device__ inline uint32_t swizzled(int row, int col, int rows) {
  return (col / 64) * rows * 128 + row * 128 +
         ((((col % 64) / 8) ^ (row % 8)) * 16) + (col % 8) * 2;
}

__device__ inline float ex2(float x) {  // 2^x; 0 at -inf
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ inline uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// The m64nNk16 f32 accumulator of a warpgroup: register i of lane `lane`
// in warp w holds row 16w + lane / 4 + 8 * ((i / 2) % 2), column
// 8 * (i / 4) + 2 * (lane % 4) + i % 2. Converted pairwise to bf16, the
// registers of columns 16kk..16kk+15 are the A fragment of k-step kk.
__device__ inline int acc_col(int i, int lane) {
  return (i / 4) * 8 + (lane % 4) * 2 + (i % 2);
}

template <int R>
__device__ inline void to_a_fragments(const float (&acc)[R],
                                      uint32_t (&a)[R / 2]) {
#pragma unroll
  for (int i = 0; i < R / 2; ++i) a[i] = pack_bf16(acc[2 * i], acc[2 * i + 1]);
}

// wgmma m64n64k16, bf16 in, f32 accumulate: A and B from shared memory
// (both K-major).
__device__ inline void mma_ss(float (&d)[32], uint64_t da, uint64_t db,
                            int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

// wgmma m64nNk16, bf16 in, f32 accumulate, A from registers (a warp's
// m16n8k16 A fragment, rows 16 w..16 w + 15 of the warpgroup) and B from
// shared memory, K-major (kTransB 0) or MN-major (kTransB 1, the
// transpose bit): d = a b, or d += a b when `accumulate`. N is 8, 16, 32,
// 48, 64 or 128.
template <int N, int kTransB>
__device__ inline void mma_rs(float (&d)[N / 2], const uint32_t* a,
                              uint64_t db, int accumulate) {
  static_assert(N == 8 || N == 16 || N == 32 || N == 48 || N == 64 ||
                    N == 128,
                "an N of the W4A16 block's row tiles or a flash head dim");
  if constexpr (N == 8) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %9, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3"
        "}, {%4, %5, %6, %7}, %8, p, 1, 1, %10;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
          "r"(accumulate), "n"(kTransB));
  } else if constexpr (N == 16) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7"
        "}, {%8, %9, %10, %11}, %12, p, 1, 1, %14;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
          "r"(accumulate), "n"(kTransB));
  } else if constexpr (N == 32) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15"
        "}, {%16, %17, %18, %19}, %20, p, 1, 1, %22;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
          "r"(accumulate), "n"(kTransB));
  } else if constexpr (N == 48) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %29, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n48k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23"
        "}, {%24, %25, %26, %27}, %28, p, 1, 1, %30;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
          "r"(accumulate), "n"(kTransB));
  } else if constexpr (N == 64) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31"
        "}, {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
          "r"(accumulate), "n"(kTransB));
  } else if constexpr (N == 128) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, "
        "%40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, "
        "%56, %57, %58, %59, %60, %61, %62, %63"
        "}, {%64, %65, %66, %67}, %68, p, 1, 1, %70;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
          "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
          "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
          "r"(accumulate), "n"(kTransB));
  }
}

// ---------------------------------------------------------------------------
// Tiles in and out
// ---------------------------------------------------------------------------

// The dynamic shared memory, 1024-byte aligned (the swizzle's period); the
// launch asks for 1 KB more than the layout's size.
__device__ inline unsigned char* aligned_smem() {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t a = smem_addr(smem_raw);
  return smem_raw + (((a + 1023) & ~1023u) - a);
}

__device__ inline void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

// scale * acc (a warpgroup's 64 x D accumulator; rows of the second half
// scaled by sb) into a swizzled 64-row tile as bf16.
template <int D>
__device__ inline void stage_rows(unsigned char* tile,
                                  const float (&acc)[D / 2], float sa,
                                  float sb) {
  const int w = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
#pragma unroll
  for (int i = 0; i < D / 2; i += 2) {
    const int row = 16 * w + lane / 4 + ((i & 2) ? 8 : 0);
    const float s = (i & 2) ? sb : sa;
    *reinterpret_cast<uint32_t*>(tile + swizzled(row, acc_col(i, lane), 64)) =
        pack_bf16(acc[i] * s, acc[i + 1] * s);
  }
}

// A swizzled 64-row tile out to rows row0.. of one head of a BSHD tensor
// (rows `stride` elements apart), 16 bytes a thread; rows at or past
// `valid` are not written. `tid`: the thread's index in its warpgroup.
template <int D>
__device__ inline void copy_out(const unsigned char* tile, bf16* dst,
                                size_t stride, int row0, int valid, int tid) {
  for (int i = tid; i < 64 * D / 8; i += 128) {
    const int row = i / (D / 8), col = (i % (D / 8)) * 8;
    if (row0 + row < valid)
      *reinterpret_cast<uint4*>(dst + (size_t)(row0 + row) * stride + col) =
          *reinterpret_cast<const uint4*>(tile + swizzled(row, col, 64));
  }
}

// The quad (four lanes) holding a row: max and sum over it.
__device__ inline float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ inline float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// ---------------------------------------------------------------------------
// Tensor maps and launch set-up
// ---------------------------------------------------------------------------

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled through the runtime's driver entry point, so the
// library does not link libcuda.
inline EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// A BSHD bf16 tensor (b, s, heads, D) as TMA reads it: dimensions {D,
// heads, s, b}, innermost first; a box is 64 columns of `rows` rows of
// one head, 128-byte swizzled; rows past s come in as zeros.
inline bool bshd_map(CUtensorMap* map, const void* ptr, int b, int s,
                     int heads, int d, int rows) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)d, (cuuint64_t)heads,
                              (cuuint64_t)s, (cuuint64_t)b};
  const cuuint64_t strides[3] = {(cuuint64_t)d * 2, (cuuint64_t)heads * d * 2,
                                 (cuuint64_t)s * heads * d * 2};
  const cuuint32_t box[4] = {64, 1, (cuuint32_t)rows, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                const_cast<void*>(ptr), dims, strides, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// A row-major (rows, cols) array of `elem`-byte elements as TMA reads it:
// boxes of 128 bytes of a row (one 128-byte swizzle row) x box_rows rows;
// out-of-range elements come in as zeros.
inline bool tile_map(CUtensorMap* map, const void* ptr, int rows, int cols,
                     int box_rows, CUtensorMapDataType type, int elem) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * elem};
  const cuuint32_t box[2] = {(cuuint32_t)(128 / elem), (cuuint32_t)box_rows};
  const cuuint32_t unit[2] = {1, 1};
  return encode(map, type, 2, const_cast<void*>(ptr), dims, strides, box,
                unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <typename Kernel>
cudaError_t prepare(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

}  // namespace hopper
}  // namespace flash
