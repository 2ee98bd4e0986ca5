// The int4 weight as an int8 tensor-core operand, shared by kernels A and B
// (csrc/w4a8_matvec.cu, csrc/w4a8_block.cu).
//
// Packed byte [k][c] holds q[k] + 8 (offset binary) in its low nibble and
// q[Dh + k] (two's complement) in its high nibble. Both halves become one
// signed byte holding 16 q, with no per-byte arithmetic:
//     low:  ((w << 4) & 0xF0F0F0F0) ^ 0x80808080   (bit 7 flipped: 16 (u - 8))
//     high:  w & 0xF0F0F0F0
// so an int8 product sums 16 x the exact dot; a run of at most 128 rows
// stays below 2^22 (|16 q xq| <= 16,256), and its sum is folded into f32
// with the group's scale over 16 (exact: a power of two).
//
// The m16n8k32 A fragment (the same a warp of a wgmma m64nNk32 holds) puts
// in each register four k of one M row: a0 = (row gid, k 4 tig..+3), a1 =
// (gid + 8, the same k), a2 / a3 the same rows at k + 16. The packed tile
// lies k-major (F contiguous), so the M rows are chosen as column pairs:
// M row gid is column 2 gid, M row gid + 8 column 2 gid + 1 of the warp's
// 16 columns. One ldmatrix.x4.trans over the tile's 16-byte units (b16
// elements: a column pair) hands each lane two rows x its column pair a
// register; the lanes' row addresses are permuted (ldsm_row) so that
// every 8-row matrix reads 8 rows of distinct r % 8 (no bank conflict under
// a 128-byte swizzle or the matvec's own row-pair swap), and two byte
// permutes a register pair give the lane's four fragments.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace w4a8 {

__device__ inline uint32_t prmt(uint32_t a, uint32_t b, uint32_t sel) {
  uint32_t d;
  asm("prmt.b32 %0, %1, %2, %3;" : "=r"(d) : "r"(a), "r"(b), "r"(sel));
  return d;
}

// (a & b) ^ c in one LOP3.
__device__ inline uint32_t and_xor(uint32_t a, uint32_t b, uint32_t c) {
  uint32_t d;
  asm("lop3.b32 %0, %1, %2, %3, 0x6A;" : "=r"(d) : "r"(a), "r"(b), "r"(c));
  return d;
}

__device__ inline void ldsm_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}

// The packed row (0..31 of a 32-row step) whose 16-byte unit lane `lane`
// addresses for ldmatrix: matrix j = lane / 8 covers k half h = j / 2 and
// row pair slot j % 2; its row i = lane % 8 is row e = i % 2 of the pair
// that lane group tg = i / 2 takes there. Lane groups 0, 1 take their
// pairs in order, 2 and 3 swapped, so each matrix's rows have distinct
// r % 8.
__device__ inline int ldsm_row(int lane) {
  const int j = lane / 8, i = lane % 8, tg = i / 2;
  const int pair = (j % 2) ^ (tg >= 2 ? 1 : 0);
  return 16 * (j / 2) + 4 * tg + 2 * pair + i % 2;
}

// The byte-permute selectors that undo ldsm_row's order for this lane:
// fragments of column 2 gid (sel0) and 2 gid + 1 (sel1).
__device__ inline uint32_t frag_sel(int tig, int col) {
  return tig < 2 ? (col ? 0x7531u : 0x6420u) : (col ? 0x3175u : 0x2064u);
}

// ldmatrix's four registers -> the A fragments of the low and high half.
__device__ inline void fragments(const uint32_t (&r)[4], uint32_t sel0,
                                 uint32_t sel1, uint32_t (&lo)[4],
                                 uint32_t (&hi)[4]) {
  const uint32_t a[4] = {prmt(r[0], r[1], sel0), prmt(r[0], r[1], sel1),
                         prmt(r[2], r[3], sel0), prmt(r[2], r[3], sel1)};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    lo[i] = and_xor(a[i] << 4, 0xF0F0F0F0u, 0x80808080u);
    hi[i] = a[i] & 0xF0F0F0F0u;
  }
}

// An int32 below 2^22 in magnitude as f32: an integer add into the
// mantissa of 1.5 * 2^23 and one f32 subtract (an I2F runs at a quarter
// of the f32 rate).
__device__ inline float to_f32(uint32_t v) {
  return __int_as_float((int)v + 0x4B400000) - 12582912.f;
}

// m16n8k32 s8 x s8 -> s32: c += a b.
__device__ inline void mma_s8(uint32_t (&c)[4], const uint32_t (&a)[4],
                              uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two bf16 scales (columns c, c + 1) as f32, over 16.
__device__ inline float2 scale_pair(uint32_t v) {
  const float2 s = make_float2(__uint_as_float(v << 16),
                               __uint_as_float(v & 0xFFFF0000u));
  return make_float2(s.x * 0.0625f, s.y * 0.0625f);
}

}  // namespace w4a8
