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
  * :func:`w4a8_matvec` (csrc/w4a8_matvec.cu) and :func:`w4a8_block`
    (csrc/w4a8_block.cu) -- the kernels; on a CPU tensor each takes its
    plain version, on a CUDA tensor it launches or raises.
  * :func:`int4_matmul` / :func:`int4_matmul_stacked` -- the dispatch:
    up to ``A8_MAX_BATCH`` rows the matvec, more rows the block matmul,
    at any row count. A layer of a stacked (L, Dh, F) weight is a view
    (a pointer offset), so one kernel serves stacked and per-layer
    weights. The JAX package's ``VLT_INT4_*`` switches are not ported.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from video_llava_tpu_torch.ops import cuda_lib
from video_llava_tpu_torch.ops.quant import (
    ieee_div,
    leaf_format,
    map_tree,
    quantize_tensor,
)

A8_MAX_BATCH = 8  # rows the W4A8 matvec takes (quant4.py:822)


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
    """(ga, b, F) f32 dots of int8 activations xq (b, D) with the
    unpacked weight over each of ga contraction groups. Integer
    operands and sums below 2^24 (127 * 8 * 5504 at Vicuna-7B's
    per-channel worst case), so every partial is exact in any order, as
    the kernels' int32 partials are."""
    b, d = xq.shape
    q = unpack_int4(packed).float().reshape(ga, d // ga, -1)
    return torch.bmm(xq.float().reshape(b, ga, d // ga).transpose(0, 1), q)


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


# ---------------------------------------------------------------------------
# Kernels A (matvec) and B (block matmul)
# ---------------------------------------------------------------------------

_MATVEC_COLS = 128  # columns per matvec block (csrc/w4a8_matvec.cu)
_MATVEC_SMEM_X = 96 * 1024  # the matvec's int8 activations in shared memory


def _group_rows(dh: int, n_groups: int) -> int:
    """Packed rows per contraction group (a whole half when G == 1)."""
    return dh if n_groups == 1 else 2 * dh // n_groups


def matvec_rows_per_split(nb: int, dh: int, f: int, sm_count: int) -> int:
    """Packed rows each matvec block reduces: the K range is cut so that
    about four blocks per SM are in flight (F = 4096 has only 32 column
    tiles), in multiples of 4 rows, and the split's int8 activations fit
    the shared memory the kernel gives them."""
    tiles = -(-f // _MATVEC_COLS)
    quads = dh // 4
    nbt = 1 << max(nb - 1, 0).bit_length()
    splits = max(-(-4 * sm_count // tiles),
                 -(-2 * nbt * dh // _MATVEC_SMEM_X))
    splits = max(1, min(splits, quads // 16 or 1))
    return 4 * -(-quads // splits)


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


def w4a8_matvec(x: torch.Tensor, packed: torch.Tensor, scales: torch.Tensor,
                out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Kernel A: x (nb <= 8, D) x packed (Dh, F) + scales (G, F) ->
    (nb, F) in out_dtype, computing :func:`int4_matmul_w4a8_xla`. On
    CUDA: x bf16 (the LLM's activations), the group's packed rows a
    multiple of 4."""
    if x.device.type == "cpu":
        return int4_matmul_w4a8_xla(x, packed, scales).to(out_dtype)
    x = x.contiguous()
    nb = x.shape[0]
    if not 1 <= nb <= A8_MAX_BATCH:
        raise ValueError(f"w4a8_matvec: {nb} rows outside [1, "
                         f"{A8_MAX_BATCH}]")
    dh, f, n_groups = _check_w4a8(x, packed, scales, out_dtype,
                                   "w4a8_matvec")
    if _group_rows(dh, n_groups) % 4:
        raise ValueError(f"w4a8_matvec: group of "
                         f"{_group_rows(dh, n_groups)} packed rows is not "
                         "a multiple of 4")
    rows = matvec_rows_per_split(
        nb, dh, f,
        torch.cuda.get_device_properties(x.device).multi_processor_count)
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
    On CUDA: x bf16, the group's packed rows a multiple of 32."""
    if x.device.type == "cpu":
        return int4_matmul_w4a8_block_xla(x, packed, scales).to(out_dtype)
    x = x.contiguous()
    dh, f, n_groups = _check_w4a8(x, packed, scales, out_dtype,
                                   "w4a8_block")
    if _group_rows(dh, n_groups) % 32:
        raise ValueError(f"w4a8_block: group of "
                         f"{_group_rows(dh, n_groups)} packed rows is not "
                         "a multiple of 32")
    nb = x.shape[0]
    if -(-nb // 64) > 65535:
        raise ValueError(f"w4a8_block: {nb} rows exceed the grid")
    xq = torch.empty((nb, 2 * dh), dtype=torch.int8, device=x.device)
    sx = torch.empty((nb,), dtype=torch.float32, device=x.device)
    out = torch.empty((nb, f), dtype=out_dtype, device=x.device)
    cuda_lib.launch(
        "w4a8_block", "vlt_w4a8_block", x.device,
        cuda_lib.ptr(x), cuda_lib.ptr(packed), cuda_lib.ptr(scales),
        cuda_lib.ptr(xq), cuda_lib.ptr(sx), cuda_lib.ptr(out),
        nb, dh, f, n_groups, int(out_dtype == torch.bfloat16),
    )
    return out


# ---------------------------------------------------------------------------
# Dispatch
# ---------------------------------------------------------------------------


def int4_matmul(x: torch.Tensor, packed: torch.Tensor, scales: torch.Tensor,
                out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """x (..., D) -> (..., F) in out_dtype (f32 by default, as the JAX
    package returns). Up to A8_MAX_BATCH rows: the W4A8 matvec; more
    rows: the W4A8 block matmul; F not a multiple of 128: the W4A16
    plain version (quant4.py:858-859)."""
    lead, d = x.shape[:-1], x.shape[-1]
    f = packed.shape[-1]
    if f % 128:
        return int4_matmul_xla(x, packed, scales).to(out_dtype)
    xb = x.reshape(-1, d)
    mm = w4a8_matvec if xb.shape[0] <= A8_MAX_BATCH else w4a8_block
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
