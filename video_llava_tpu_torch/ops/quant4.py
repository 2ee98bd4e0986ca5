"""Weights-only int4 quantization (nibble-packed) and the W4A8 matmuls.

Counterpart of video_llava_tpu/ops/quant4.py. The format is the JAX
package's, byte for byte: a kernel (D, F) packs to (D/2, F) int8 where
byte [i, f] holds row i in its LOW nibble, offset-binary (q + 8), and
row i + D/2 in its HIGH nibble, two's-complement; scales are bf16
(G, F) over groups of `group_size` contraction rows, and a group never
straddles the two halves (groups [0, G/2) cover the low half).

The matmuls:

  * :func:`int4_matmul_w4a8_xla` -- plain version of the W4A8 matvec:
    activations quantized to int8 per (row, contraction group),
    sx = max|x| / 127, rounded half to even.
  * :func:`int4_matmul_w4a8_block_xla` -- plain version of the W4A8
    block matmul: one activation scale per row.
  * :func:`int4_matmul_xla` -- the W4A16 twin (bf16 dequantized
    weights), taken for an F that is not a multiple of 128, as the JAX
    package does.
  * :func:`int4_matmul_w4a16_matvec_plain` and
    :func:`int4_matmul_w4a16_block_plain` -- plain versions of the W4A16
    Pallas kernels (activations not quantized; each group's partial
    scaled after its dot).
  * :func:`w4a8_matvec` (csrc/w4a8_matvec.cu), :func:`w4a8_block`
    (csrc/w4a8_block.cu), :func:`w4a16_matvec` and :func:`w4a16_block`
    (csrc/w4a16.cu) -- the kernels; on a CPU tensor each takes its plain
    version, on a CUDA tensor it launches or raises.
  * :func:`int4_matmul` / :func:`int4_matmul_stacked` -- the JAX
    package's dispatch (quant4.py:818-866) over the row count, under
    ``A8_DECODE`` (``VLT_INT4_A8``), ``A8_BLOCK`` (``VLT_INT4_A8_BLOCK``)
    and ``A8_MAX_BATCH`` (``VLT_INT4_A8_MAX_B``), read at import with
    the JAX package's defaults. A layer of a stacked (L, Dh, F) weight is
    a view (a pointer offset), so one kernel serves stacked and
    per-layer weights. ``VLT_INT4_UNPACK`` and ``VLT_INT4_A8_BLOCK_MAX_B``
    choose a TPU formulation or a slice copy of the same function and
    are not ported.
"""

from __future__ import annotations

import math
import os
from typing import Optional, Sequence

import torch

from video_llava_tpu_torch.ops import cuda_lib
from video_llava_tpu_torch.ops.quant import (
    ieee_div,
    leaf_format,
    map_tree,
    quantize_tensor,
)

# The JAX package's switches (quant4.py:818-833): the W4A8 matvec for up
# to A8_MAX_BATCH rows, the W4A8 block matmul past it; either off, the
# W4A16 kernels take its rows.
A8_DECODE = os.environ.get("VLT_INT4_A8", "1") == "1"
A8_BLOCK = os.environ.get("VLT_INT4_A8_BLOCK", "1") == "1"
A8_MAX_BATCH = int(os.environ.get("VLT_INT4_A8_MAX_B", "8"))
MATVEC_MAX_ROWS = 8  # rows the W4A8 matvec kernel takes
if not 0 <= A8_MAX_BATCH <= MATVEC_MAX_ROWS:
    raise ValueError(f"VLT_INT4_A8_MAX_B={A8_MAX_BATCH}: the W4A8 matvec "
                     f"takes 0 to {MATVEC_MAX_ROWS} rows")


# ---------------------------------------------------------------------------
# Packing / quantization
# ---------------------------------------------------------------------------


def pack_int4(q: torch.Tensor) -> torch.Tensor:
    """q (..., D, F) ints in [-8, 7] -> (..., D/2, F) int8:
    byte = (q[i + D/2] << 4) | ((q[i] + 8) & 0xF)."""
    d = q.shape[-2]
    if d % 2:
        raise ValueError(f"contraction dim must be even, got {d}")
    q = q.to(torch.int32)
    lo, hi = q[..., : d // 2, :], q[..., d // 2:, :]
    return ((hi << 4) | ((lo + 8) & 0xF)).to(torch.int8)


def unpack_int4(packed: torch.Tensor) -> torch.Tensor:
    """(..., D/2, F) int8 -> (..., D, F) int32 signed nibble values."""
    p = packed.to(torch.int32)
    return torch.cat([(p & 15) - 8, p >> 4], dim=-2)


def _n_groups(d: int, group_size: Optional[int]) -> int:
    g = group_size or d
    if d % g:
        raise ValueError(f"group_size {g} does not divide D={d}")
    n = d // g
    if n > 1 and (d // 2) % g:
        raise ValueError(f"group_size {g} straddles the lo/hi split of "
                         f"D={d}")
    return n


def quantize_tensor_int4(w: torch.Tensor, group_size: Optional[int] = 128):
    """Symmetric round-to-nearest int4 over contraction-row groups.
    w (..., D, F) -> (packed (..., D/2, F) int8, scales (..., G, F)
    bf16), G = D // group_size (1 for per-channel, group_size=None)."""
    d, f = w.shape[-2], w.shape[-1]
    n = _n_groups(d, group_size)
    grouped = w.float().reshape(w.shape[:-2] + (n, d // n, f))
    absmax = grouped.abs().amax(dim=-2, keepdim=True)
    scales = ieee_div(absmax.clamp_min(1e-8), 7.0).to(torch.bfloat16)
    q = torch.round(grouped / scales.float()).clamp(-7, 7).to(torch.int32)
    return pack_int4(q.reshape(w.shape)), scales[..., 0, :]


def dequantize_int4(packed, scales, dtype=torch.bfloat16) -> torch.Tensor:
    q = unpack_int4(packed).float()
    d, f = q.shape[-2], q.shape[-1]
    n = scales.shape[-2]
    grouped = q.reshape(q.shape[:-2] + (n, d // n, f))
    return (grouped * scales.float()[..., :, None, :]).reshape(
        q.shape).to(dtype)


def quantize_activation_int8(x: torch.Tensor, n_groups: int):
    """x (b, D) -> (int8 (b, D), f32 scales (b, max(n_groups, 1))):
    symmetric absmax / 127 per contraction group of each row, rounded
    half to even. The JAX function takes one row and returns its scales
    as (G, 1)."""
    b, d = x.shape
    n = max(n_groups, 1)
    xg = x.float().reshape(b, n, d // n)
    absmax = xg.abs().amax(dim=-1, keepdim=True)
    sx = ieee_div(absmax.clamp_min(1e-8), 127.0)
    q = torch.round(xg / sx).clamp(-127, 127).to(torch.int8)
    return q.reshape(b, d), sx[..., 0]


def _act_groups(n_groups: int) -> int:
    """Activation groups of the W4A8 matvec: the weight's, or one per
    half when the weight scale is per channel (quant4.py:599,609)."""
    return n_groups if n_groups > 1 else 2


def _weights_f32(packed: torch.Tensor, scales: torch.Tensor):
    """Unpacked (D, F) values and their (D, F) scales, both f32."""
    dh, f = packed.shape
    q = unpack_int4(packed).float()
    n = scales.shape[-2]
    sw = torch.repeat_interleave(scales.float(), 2 * dh // n, dim=-2)
    return q, sw


# ---------------------------------------------------------------------------
# Plain versions (the JAX package's XLA twins, over any number of rows)
# ---------------------------------------------------------------------------


def int4_matmul_xla(x: torch.Tensor, packed: torch.Tensor,
                    scales: torch.Tensor) -> torch.Tensor:
    """W4A16: x (..., D) -> (..., F) f32. Both operands rounded to bf16
    as in the JAX twin, the products summed in f32."""
    dh = packed.shape[0]
    q, sw = _weights_f32(packed, scales)
    w = (q * sw).to(torch.bfloat16).float()
    xb = x.to(torch.bfloat16).float()
    return xb[..., :dh] @ w[:dh] + xb[..., dh:] @ w[dh:]


def _group_partials(xq: torch.Tensor, packed: torch.Tensor,
                    ga: int) -> torch.Tensor:
    """(ga, b, F) f32 dots of activations xq (b, D) with the unpacked
    weight over each of ga contraction groups. For int8 activations the
    operands and sums are integers below 2^24 (127 * 8 * 5504 at
    Vicuna-7B's per-channel worst case), so every partial is exact in
    any order, as the kernels' int32 partials are."""
    b, d = xq.shape
    q = unpack_int4(packed).float().reshape(ga, d // ga, -1)
    return torch.bmm(xq.float().reshape(b, ga, d // ga).transpose(0, 1), q)


def w4a8_nibble_partials(xq: torch.Tensor, packed: torch.Tensor,
                         n_groups: int) -> torch.Tensor:
    """The exact per-group int32 partials as kernels A and B form them:
    xq (b, D) int8, packed (Dh, F) -> (ga, b, F) int32, ga the activation
    groups (:func:`_act_groups`). Each packed byte w gives both halves as
    16 q in one signed byte, the low nibble as ((w << 4) & 0xF0) ^ 0x80
    (offset binary to two's complement), the high one as w & 0xF0; the
    int8 products are summed in int32 over each 32-row step (one tensor
    core product), the steps over runs of at most 128 rows that stay in a
    group (the kernels' folds, a magnitude below 2^22), each run's sum
    shifted right by 4 (exact: a multiple of 16), and the runs of a group
    added in order, low half at group g, high half at g + ga / 2."""
    dh, f = packed.shape
    ga = _act_groups(n_groups)
    gr = _group_rows(dh, n_groups)
    w = packed.to(torch.int32) & 0xFF
    halves = (((w << 4) & 0xF0) ^ 0x80, w & 0xF0)
    out = torch.zeros((ga, xq.shape[0], f), dtype=torch.int32)
    for h, u in enumerate(halves):
        u = torch.where(u > 127, u - 256, u)  # the signed byte
        xh = xq[:, h * dh:(h + 1) * dh].to(torch.int32)
        for k0 in range(0, dh, 32):
            step = xh[:, k0:k0 + 32] @ u[k0:k0 + 32]
            g = k0 // gr
            if k0 % 128 == 0 or k0 % gr == 0:  # a fold run starts
                run = torch.zeros_like(step)
            run += step
            end = k0 + 32
            if end % 128 == 0 or end % gr == 0 or end == dh:
                out[g + h * (ga // 2)] += run >> 4
    return out


def _group_scales(scales: torch.Tensor, ga: int) -> torch.Tensor:
    """Weight scale row of each activation group -> (ga, F) f32."""
    s = scales.float()
    return s if s.shape[0] == ga else s.expand(ga, -1)


def int4_matmul_w4a8_xla(x: torch.Tensor, packed: torch.Tensor,
                         scales: torch.Tensor) -> torch.Tensor:
    """Plain W4A8 matvec math: x (..., D) -> (..., F) f32, activations
    int8 per (row, contraction group), activation error included:
    y[r, f] = sum_g sx[r, g] sw[g, f] * (exact dot over group g)."""
    dh, f = packed.shape
    ga = _act_groups(scales.shape[-2])
    xq, sx = quantize_activation_int8(x.reshape(-1, 2 * dh), ga)
    part = _group_partials(xq, packed, ga) * sx.t()[:, :, None]
    y = (part * _group_scales(scales, ga)[:, None]).sum(0)
    return y.reshape(x.shape[:-1] + (f,))


def int4_matmul_w4a8_block_xla(x: torch.Tensor, packed: torch.Tensor,
                               scales: torch.Tensor) -> torch.Tensor:
    """Plain W4A8 block math: x (..., D) -> (..., F) f32, one int8
    activation scale per row, activation error included:
    y[r, f] = sx[r] * sum_g sw[g, f] * (exact dot over group g)."""
    dh, f = packed.shape
    ga = _act_groups(scales.shape[-2])
    xq, sx = quantize_activation_int8(x.reshape(-1, 2 * dh), 1)
    part = _group_partials(xq, packed, ga)
    y = (part * _group_scales(scales, ga)[:, None]).sum(0) * sx
    return y.reshape(x.shape[:-1] + (f,))


def _w4a16_plain(x: torch.Tensor, packed: torch.Tensor,
                 scales: torch.Tensor) -> torch.Tensor:
    """y[r, f] = sum_g sw[g, f] * (f32 dot of x and q over group g), one
    scale row over the whole contraction when G == 1 (quant4.py:179-182,
    :323-329): x (..., D) -> (..., F) f32."""
    dh, f = packed.shape
    xb = x.float().reshape(-1, 2 * dh)
    if scales.shape[-2] == 1:
        y = (xb @ unpack_int4(packed).float()) * scales.float()
    else:
        part = _group_partials(xb, packed, scales.shape[-2])
        y = (part * scales.float()[:, None]).sum(0)
    return y.reshape(x.shape[:-1] + (f,))


def int4_matmul_w4a16_matvec_plain(x: torch.Tensor, packed: torch.Tensor,
                                   scales: torch.Tensor) -> torch.Tensor:
    """Plain W4A16 matvec math (JAX ``_w4_matvec_kernel``): x (..., D)
    in f32 times the integer nibbles, summed per group, the group's scale
    applied after the sum -> (..., F) f32."""
    return _w4a16_plain(x, packed, scales)


def int4_matmul_w4a16_block_plain(x: torch.Tensor, packed: torch.Tensor,
                                  scales: torch.Tensor) -> torch.Tensor:
    """Plain W4A16 block math (JAX ``_w4_matmul_kernel``): x rounded to
    bf16, a per-group dot in f32, each group's partial scaled -> (..., F)
    f32."""
    return _w4a16_plain(x.to(torch.bfloat16), packed, scales)


# ---------------------------------------------------------------------------
# Kernels A (matvec) and B (block matmul), and the W4A16 pair
# ---------------------------------------------------------------------------

SMEM_LIMIT = 232448  # shared memory a block can use on the H100 (227 KB)


def _group_rows(dh: int, n_groups: int) -> int:
    """Packed rows per contraction group (a whole half when G == 1)."""
    return dh if n_groups == 1 else 2 * dh // n_groups


def _split_unit(dh: int, n_groups: int, step: int) -> int:
    """Packed rows a K split is made of: whole steps of `step` rows and,
    for G > 1, whole groups (each group's partial is exact in one block).
    With G == 1 one scale serves the whole half, and whole steps do."""
    gr = _group_rows(dh, n_groups)
    if n_groups == 1:
        return step
    return step * gr // math.gcd(step, gr)


def _split_rows(dh: int, unit: int, splits: int) -> int:
    """Rows a split takes when [0, dh) is cut into at most `splits`
    pieces of whole units."""
    units = -(-dh // unit)
    return unit * -(-units // max(1, min(splits, units)))


# Kernel A (csrc/w4a8_matvec.cu): a block of 8 warps owns 128 columns, a
# warp a 32-column strip of half the block's rows in 32-row steps, each
# warp's steps streamed through a ring of MATVEC_DEPTH 1 KB stages.
MATVEC_COLS = 128
MATVEC_STEP = 64  # packed rows: two warps down a strip, 32 rows a step
MATVEC_DEPTH = 4
MATVEC_RING = 8 * MATVEC_DEPTH * 1024
MATVEC_BLOCKS_PER_SM = 3  # the plan's target (PERF.md §6)


def matvec_xq_stride(rows: int) -> int:
    """Bytes between two activation rows of the matvec's int8 copy in
    shared memory: a 4-word offset between rows mod the 32 banks, so the
    eight rows' B-fragment words fall in distinct banks."""
    return 128 * -(-rows // 128) + 16


def matvec_smem_bytes(rows: int, dh: int, n_groups: int) -> int:
    """Shared memory of one matvec block reducing `rows` packed rows:
    the ring, then the int8 activations of both halves (8 rows), the f32
    activation scales of each (row, group) a half, and the bf16 weight
    scales of the block's columns, each group a half (csrc/
    w4a8_matvec.cu layout)."""
    maxg = -(-rows // _group_rows(dh, n_groups)) + 1
    return (MATVEC_RING + 2 * 8 * matvec_xq_stride(rows) + 2 * 8 * maxg * 4
            + 2 * maxg * MATVEC_COLS * 2)


def matvec_rows_per_split(dh: int, f: int, n_groups: int,
                          sm_count: int) -> int:
    """Packed rows each matvec block reduces: K cut into as many splits
    (whole groups, whole 64-row steps) as bring the column tiles times
    the splits to about MATVEC_BLOCKS_PER_SM blocks an SM (F = 4096 has
    only 32 column tiles), fewer when the K range is short, more when a
    split's activations would not fit the block's shared memory. The
    row count does not enter: one instruction stream serves 1 to 8."""
    tiles = -(-f // MATVEC_COLS)
    unit = _split_unit(dh, n_groups, MATVEC_STEP)
    rows = _split_rows(dh, unit,
                       -(-MATVEC_BLOCKS_PER_SM * sm_count // tiles))
    while rows > unit and matvec_smem_bytes(rows, dh, n_groups) > SMEM_LIMIT:
        rows -= unit
    return rows


# Kernel B (csrc/w4a8_block.cu): a block of two consumer warpgroups (64
# columns each) and a producer owns 128 columns x a tile of activation
# rows, over a K range streamed in stages of 128 packed rows by TMA.
BLOCK_COLS = 128
BLOCK_STEP = 128
BLOCK_ROW_TILES = (64, 128)  # N of the wgmma, chosen from nb
BLOCK_STAGES = 2  # ring stages (csrc/w4a8_block.cu kStages; PERF.md §6)


def block_stage_bytes(rows_tile: int) -> int:
    """One ring stage: the packed tile, then the activations' low- and
    high-half tiles."""
    return BLOCK_COLS * BLOCK_STEP + 2 * rows_tile * BLOCK_STEP


def block_smem_bytes(rows_tile: int) -> int:
    """Shared memory of one block (csrc/w4a8_block.cu block_smem): the
    ring (also the epilogue's staging), its full and empty barriers, and
    1 KB to align the ring to the swizzle's period."""
    return (BLOCK_STAGES * block_stage_bytes(rows_tile) + 16 * BLOCK_STAGES
            + 1024)


def w4a8_block_plan(nb: int, dh: int, f: int, n_groups: int,
                    sm_count: int):
    """(rows_tile, rows_per_split) of kernel B for x (nb, 2 dh): 64
    activation rows a tile up to 64 rows, else 128; and K splits of
    whole groups and whole 128-row steps where the output tiles alone
    leave the card's waves uneven. The splits are chosen by a
    model of one block an SM: waves of blocks, each block's time its
    128-row steps at the larger of its operations and its bytes, plus
    the splits' f32 partials written and read once more."""
    rows_tile = BLOCK_ROW_TILES[0] if nb <= BLOCK_ROW_TILES[0] else \
        BLOCK_ROW_TILES[1]
    tiles = -(-nb // rows_tile) * -(-f // BLOCK_COLS)
    unit = _split_unit(dh, n_groups, BLOCK_STEP)
    units = -(-dh // unit)
    steps_a_unit = unit // BLOCK_STEP
    sm_ops = 1979e12 / 132 * 0.5  # an SM's int8 rate, at half the peak
    sm_bytes = 3.35e12 / 132
    step_s = max(2 * BLOCK_COLS * rows_tile * 2 * BLOCK_STEP / sm_ops,
                 block_stage_bytes(rows_tile) / sm_bytes)

    def cost(splits):
        waves = -(-tiles * splits // sm_count)
        per_split = -(-units // splits) * steps_a_unit
        partial = (splits > 1) * splits * nb * f * 8 / 3.35e12
        return waves * per_split * step_s + partial

    splits = min(range(1, min(units, 16) + 1), key=cost)
    return rows_tile, _split_rows(dh, unit, splits)


W4A16_COLS = 128  # columns a W4A16 matvec block (csrc/w4a16.cu kMvCols)
W4A16_BLOCKS_PER_SM = 3  # the W4A16 matvec's plan target (PERF.md §6)


def w4a16_rows_per_split(dh: int, f: int, sm_count: int) -> int:
    """Packed rows each W4A16 matvec block reduces: K cut into as many
    splits as keep the column tiles times the splits at most
    W4A16_BLOCKS_PER_SM blocks an SM (one split when the tiles alone come
    near that), in multiples of 32 rows (two warps of 16-row steps down
    a strip)."""
    tiles = -(-f // W4A16_COLS)
    splits = max(1, W4A16_BLOCKS_PER_SM * sm_count // tiles)
    return 32 * -(-dh // (32 * splits))


# The W4A16 block matmul (csrc/w4a16.cu): a block of two consumer
# warpgroups (64 columns each) and a producer owns 128 columns x a tile of
# activation rows (the N of its bf16 wgmma), over a K range streamed in
# stages of 128 packed rows by TMA.
W4A16_BLOCK_COLS = 128
W4A16_BLOCK_STEP = 128
W4A16_ROW_TILES = (8, 16, 32, 48, 64, 128)
W4A16_MAX_STAGES = 4
W4A16_BLOCK_RAMP = 2  # steps a block's ring takes to fill, in the plan's model


def w4a16_block_stage_bytes(rows_tile: int) -> int:
    """One ring stage: the packed tile, then x's low- and high-half tiles
    (rows_tile rows x 128 bf16 each)."""
    return (W4A16_BLOCK_COLS * W4A16_BLOCK_STEP
            + 2 * rows_tile * W4A16_BLOCK_STEP * 2)


def w4a16_block_smem_bytes(rows_tile: int, stages: int) -> int:
    """Shared memory of one block (csrc/w4a16.cu blk_smem): the ring (also
    the epilogue's staging), its full and empty barriers, and 1 KB to
    align the ring to the swizzle's period."""
    return stages * w4a16_block_stage_bytes(rows_tile) + 16 * stages + 1024


def w4a16_block_plan(nb: int, dh: int, f: int, n_groups: int,
                     sm_count: int):
    """(rows_tile, stages, rows_per_split) of the W4A16 block matmul for
    x (nb, 2 dh): the smallest row tile that holds nb (tiles of 128 rows
    past 128), as many ring stages (up to W4A16_MAX_STAGES) as the shared
    memory holds, and K splits of whole groups and whole 128-row steps
    where the output tiles alone leave the card's waves uneven. The
    splits are chosen by a model of one block an SM: waves of blocks,
    each block's time its 128-row steps plus W4A16_BLOCK_RAMP steps of
    filling its ring, a step at the larger of its operations (at half
    the bf16 peak) and its packed bytes (an SM's share of HBM), plus the
    splits' f32 partials written and read once more (`w4a8_sweep.py
    W4A16`, PERF.md)."""
    rows_tile = next((t for t in W4A16_ROW_TILES if t >= nb),
                     W4A16_ROW_TILES[-1])
    stages = max(s for s in range(2, W4A16_MAX_STAGES + 1)
                 if w4a16_block_smem_bytes(rows_tile, s) <= SMEM_LIMIT)
    tiles = -(-nb // rows_tile) * -(-f // W4A16_BLOCK_COLS)
    unit = _split_unit(dh, n_groups, W4A16_BLOCK_STEP)
    units = -(-dh // unit)
    steps_a_unit = unit // W4A16_BLOCK_STEP
    sm_ops = 989e12 / 132 * 0.5
    sm_bytes = 3.35e12 / 132
    step_s = max(2 * W4A16_BLOCK_COLS * rows_tile * 2 * W4A16_BLOCK_STEP
                 / sm_ops, W4A16_BLOCK_COLS * W4A16_BLOCK_STEP / sm_bytes)

    def cost(splits):
        waves = -(-tiles * splits // sm_count)
        per_split = -(-units // splits) * steps_a_unit + W4A16_BLOCK_RAMP
        partial = (splits > 1) * splits * nb * f * 8 / 3.35e12
        return waves * per_split * step_s + partial

    splits = min(range(1, min(units, 16) + 1), key=cost)
    return rows_tile, stages, _split_rows(dh, unit, splits)


def _check_w4a8(x, packed, scales, out_dtype, kernel: str):
    dh, f = packed.shape
    n_groups = scales.shape[0]
    dev = x.device
    if out_dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{kernel}: out_dtype f32 or bf16, got {out_dtype}")
    cuda_lib.require(x, "x", torch.bfloat16, (x.shape[0], 2 * dh), dev)
    cuda_lib.require(packed, "packed", torch.int8, (dh, f), dev)
    cuda_lib.require(scales, "scales", torch.bfloat16, (n_groups, f), dev)
    if n_groups > 1 and (n_groups % 2 or (2 * dh) % n_groups):
        raise ValueError(f"{kernel}: {n_groups} groups do not split "
                         f"D={2 * dh} into halves")
    if f % 16:
        raise ValueError(f"{kernel}: F={f} must be a multiple of 16")
    return dh, f, n_groups


def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def w4a8_matvec(x: torch.Tensor, packed: torch.Tensor, scales: torch.Tensor,
                out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Kernel A: x (nb <= 8, D) x packed (Dh, F) + scales (G, F) ->
    (nb, F) in out_dtype, computing :func:`int4_matmul_w4a8_xla`. On
    CUDA: x bf16 (the LLM's activations), the group's packed rows a
    multiple of 32 (csrc/w4a8_matvec.cu: the products on the int8 tensor
    cores, K split by :func:`matvec_rows_per_split`, the splits'
    partials added in order by a second kernel)."""
    if x.device.type == "cpu":
        return int4_matmul_w4a8_xla(x, packed, scales).to(out_dtype)
    x = x.contiguous()
    nb = x.shape[0]
    if not 1 <= nb <= MATVEC_MAX_ROWS:
        raise ValueError(f"w4a8_matvec: {nb} rows outside [1, "
                         f"{MATVEC_MAX_ROWS}]")
    dh, f, n_groups = _check_w4a8(x, packed, scales, out_dtype,
                                   "w4a8_matvec")
    if _group_rows(dh, n_groups) % 32:
        raise ValueError(f"w4a8_matvec: group of "
                         f"{_group_rows(dh, n_groups)} packed rows is not "
                         "a multiple of 32")
    rows = matvec_rows_per_split(dh, f, n_groups, _sm_count(x.device))
    splits = -(-dh // rows)
    out = torch.empty((nb, f), dtype=out_dtype, device=x.device)
    partial = (torch.empty((splits, nb, f), dtype=torch.float32,
                           device=x.device) if splits > 1 else None)
    cuda_lib.launch(
        "w4a8_matvec", "vlt_w4a8_matvec", x.device,
        cuda_lib.ptr(x), cuda_lib.ptr(packed), cuda_lib.ptr(scales),
        cuda_lib.ptr(out), None if partial is None else cuda_lib.ptr(partial),
        nb, dh, f, n_groups, rows, int(out_dtype == torch.bfloat16),
    )
    return out


def w4a8_block(x: torch.Tensor, packed: torch.Tensor, scales: torch.Tensor,
               out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Kernel B: x (nb, D), any nb, x packed (Dh, F) + scales (G, F) ->
    (nb, F) in out_dtype, computing :func:`int4_matmul_w4a8_block_xla`.
    On CUDA: x bf16, the group's packed rows a multiple of 32 that
    divides 128 or that 128 divides (csrc/w4a8_block.cu: wgmma on the
    int8 tensor cores behind a TMA ring, planned by
    :func:`w4a8_block_plan`, the splits' partials added in order by a
    second kernel)."""
    if x.device.type == "cpu":
        return int4_matmul_w4a8_block_xla(x, packed, scales).to(out_dtype)
    x = x.contiguous()
    dh, f, n_groups = _check_w4a8(x, packed, scales, out_dtype,
                                   "w4a8_block")
    gr = _group_rows(dh, n_groups)
    if gr % 32 or (n_groups > 1 and BLOCK_STEP % gr and gr % BLOCK_STEP):
        raise ValueError(f"w4a8_block: group of {gr} packed rows is not a "
                         f"multiple of 32 that divides {BLOCK_STEP} or "
                         f"that {BLOCK_STEP} divides")
    nb = x.shape[0]
    rows_tile, rows = w4a8_block_plan(nb, dh, f, n_groups,
                                      _sm_count(x.device))
    splits = -(-dh // rows)
    xq = torch.empty((nb, 2 * dh), dtype=torch.int8, device=x.device)
    sx = torch.empty((nb,), dtype=torch.float32, device=x.device)
    out = torch.empty((nb, f), dtype=out_dtype, device=x.device)
    partial = (torch.empty((splits, nb, f), dtype=torch.float32,
                           device=x.device) if splits > 1 else None)
    cuda_lib.launch(
        "w4a8_block", "vlt_w4a8_block", x.device,
        cuda_lib.ptr(x), cuda_lib.ptr(packed), cuda_lib.ptr(scales),
        cuda_lib.ptr(xq), cuda_lib.ptr(sx), cuda_lib.ptr(out),
        None if partial is None else cuda_lib.ptr(partial),
        nb, dh, f, n_groups, rows_tile, rows,
        int(out_dtype == torch.bfloat16),
    )
    return out


def w4a16_matvec(x: torch.Tensor, packed: torch.Tensor,
                 scales: torch.Tensor,
                 out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Kernel 6's W4A16 matvec: x (1, D) x packed (Dh, F) + scales (G, F)
    -> (1, F) in out_dtype, computing
    :func:`int4_matmul_w4a16_matvec_plain`. On CUDA: x bf16, the group's
    packed rows a multiple of 16 (csrc/w4a16.cu: the products on the
    tensor cores, K split by :func:`w4a16_rows_per_split`, the splits'
    partials added in order by a second kernel)."""
    if x.device.type == "cpu":
        return int4_matmul_w4a16_matvec_plain(x, packed, scales).to(
            out_dtype)
    x = x.contiguous()
    if x.shape[0] != 1:
        raise ValueError(f"w4a16_matvec: one row, got {x.shape[0]}")
    dh, f, n_groups = _check_w4a8(x, packed, scales, out_dtype,
                                   "w4a16_matvec")
    if _group_rows(dh, n_groups) % 16:
        raise ValueError(f"w4a16_matvec: group of "
                         f"{_group_rows(dh, n_groups)} packed rows is not "
                         "a multiple of 16")
    rows = w4a16_rows_per_split(dh, f, _sm_count(x.device))
    splits = -(-dh // rows)
    out = torch.empty((1, f), dtype=out_dtype, device=x.device)
    partial = (torch.empty((splits, f), dtype=torch.float32,
                           device=x.device) if splits > 1 else None)
    cuda_lib.launch(
        "w4a16_matvec", "vlt_w4a16_matvec", x.device,
        cuda_lib.ptr(x), cuda_lib.ptr(packed), cuda_lib.ptr(scales),
        cuda_lib.ptr(out), None if partial is None else cuda_lib.ptr(partial),
        dh, f, n_groups, rows, int(out_dtype == torch.bfloat16),
    )
    return out


def w4a16_block(x: torch.Tensor, packed: torch.Tensor, scales: torch.Tensor,
                out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Kernel 6's W4A16 block matmul: x (nb, D), any nb, x packed
    (Dh, F) + scales (G, F) -> (nb, F) in out_dtype, computing
    :func:`int4_matmul_w4a16_block_plain` on the bf16 tensor cores. On
    CUDA: x bf16, the group's packed rows a multiple of 32
    (csrc/w4a16.cu: wgmma with the weight unpacked in registers as A and
    x by TMA as B, planned by :func:`w4a16_block_plan`, the splits'
    partials added in order by a second kernel)."""
    if x.device.type == "cpu":
        return int4_matmul_w4a16_block_plain(x, packed, scales).to(out_dtype)
    x = x.contiguous()
    dh, f, n_groups = _check_w4a8(x, packed, scales, out_dtype,
                                   "w4a16_block")
    if _group_rows(dh, n_groups) % 32:
        raise ValueError(f"w4a16_block: group of "
                         f"{_group_rows(dh, n_groups)} packed rows is not "
                         "a multiple of 32")
    nb = x.shape[0]
    rows_tile, stages, rows = w4a16_block_plan(nb, dh, f, n_groups,
                                               _sm_count(x.device))
    splits = -(-dh // rows)
    out = torch.empty((nb, f), dtype=out_dtype, device=x.device)
    partial = (torch.empty((splits, nb, f), dtype=torch.float32,
                           device=x.device) if splits > 1 else None)
    cuda_lib.launch(
        "w4a16_block", "vlt_w4a16_block", x.device,
        cuda_lib.ptr(x), cuda_lib.ptr(packed), cuda_lib.ptr(scales),
        cuda_lib.ptr(out), None if partial is None else cuda_lib.ptr(partial),
        nb, dh, f, n_groups, rows_tile, stages, rows,
        int(out_dtype == torch.bfloat16),
    )
    return out


# ---------------------------------------------------------------------------
# Dispatch
# ---------------------------------------------------------------------------


def int4_matmul(x: torch.Tensor, packed: torch.Tensor, scales: torch.Tensor,
                out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """x (..., D) -> (..., F) in out_dtype (f32 by default, as the JAX
    package returns), b rows mapped as the JAX package maps them
    (quant4.py:856-866 into :706-797): b <= A8_MAX_BATCH with A8_DECODE:
    the W4A8 matvec; b == 1 otherwise: the W4A16 matvec; b >
    A8_MAX_BATCH with A8_BLOCK: the W4A8 block matmul; everything else:
    the W4A16 block matmul. F not a multiple of 128: the W4A16 twin
    :func:`int4_matmul_xla` (quant4.py:858-859)."""
    lead, d = x.shape[:-1], x.shape[-1]
    f = packed.shape[-1]
    if f % 128:
        return int4_matmul_xla(x, packed, scales).to(out_dtype)
    xb = x.reshape(-1, d)
    b = xb.shape[0]
    if b <= A8_MAX_BATCH and A8_DECODE:
        mm = w4a8_matvec
    elif b == 1:
        mm = w4a16_matvec
    elif b > A8_MAX_BATCH and A8_BLOCK:
        mm = w4a8_block
    else:
        mm = w4a16_block
    return mm(xb, packed, scales, out_dtype).reshape(lead + (f,))


def int4_matmul_stacked(x: torch.Tensor, packed: torch.Tensor,
                        scales: torch.Tensor, layer: int,
                        out_dtype: torch.dtype = torch.float32):
    """int4 matmul against layer `layer` of stacked packed (L, Dh, F) /
    scales (L, G, F): the layer is a view, no copy."""
    return int4_matmul(x, packed[layer], scales[layer], out_dtype)


# ---------------------------------------------------------------------------
# Params transform
# ---------------------------------------------------------------------------


def quantize_params_int4(params, group_size: Optional[int] = 128,
                         min_size: int = 1 << 16,
                         skip_keys: Sequence[str] = ("class_embedding",
                                                     "position_embedding")):
    """int4-quantize every 2D+ kernel leaf of at least `min_size`
    elements whose shape the packing takes (stacked (L, D, F) kernels
    per layer); other kernels and embedding tables become int8
    {qvalues, scales} (quant4.py:1033-1072)."""

    def visit(keys, leaf):
        fmt = leaf_format(keys, leaf.shape, "int4", group_size, min_size,
                          skip_keys)
        if fmt == "int4":
            packed, scales = quantize_tensor_int4(leaf, group_size)
            return {"qvalues_packed": packed, "scales": scales}
        if fmt is None:
            return leaf
        q, s = quantize_tensor(leaf, axis=-2 if fmt == "int8" else 1)
        return {"qvalues": q, "scales": s}

    return map_tree(visit, params)
