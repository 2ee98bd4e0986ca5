"""A frozen copy of the number formats the configurations state.

The program quantizes the seeded bf16 weights when it loads them; the
reference works the same values out again here, from the same bf16
tensors, without the program's code:

* which leaf takes which format (:func:`weight_format`);
* int4 weights: symmetric, one bf16 scale per output column and group of
  128 contraction rows, absmax / 7 (one IEEE division), rounded half to
  even, clamped to [-7, 7];
* int8 weights: per output column (a linear) or per row (an embedding
  table), f32 scales absmax / 127;
* int8 activations (W4A8): absmax / 127 per row for a prompt's rows, per
  row and group of 128 for a decode step's rows.

Every function returns the dequantized values in f32.
"""

from __future__ import annotations

import torch

GROUP = 128


def _div(a: torch.Tensor, c: float) -> torch.Tensor:
    """a / c as one IEEE division (not a product by the reciprocal)."""
    return a / torch.full((), c, dtype=a.dtype, device=a.device)


def int4_weight(w: torch.Tensor, group: int = GROUP) -> torch.Tensor:
    """w (in, out) bf16 -> its int4 values times their scales, f32."""
    d, f = w.shape
    g = w.float().reshape(d // group, group, f)
    scales = _div(g.abs().amax(dim=1, keepdim=True).clamp_min(1e-8),
                  7.0).to(torch.bfloat16).float()
    q = torch.round(g / scales).clamp(-7, 7)
    return (q * scales).reshape(d, f)


MIN_SIZE = 1 << 16  # a leaf smaller than this (stacked over layers) stays


def weight_format(shape, group: int = GROUP):
    """The format an int4 configuration stores a linear's weight in, by
    its shape as stored (a decoder layer's stacked over the layers):
    None (kept in bf16) under MIN_SIZE elements, else 'int4' where the
    packing takes the (in, out) shape, else 'int8'."""
    size = 1
    for n in shape:
        size *= int(n)
    if size < MIN_SIZE:
        return None
    d, f = int(shape[-2]), int(shape[-1])
    n = d // group
    if d % 2 or d % group or (n > 1 and (d // 2) % group) or f % 128:
        return "int8"
    return "int4"


def int8_columns(w: torch.Tensor) -> torch.Tensor:
    """w (in, out) -> int8 per output column, dequantized, f32."""
    w32 = w.float()
    s = _div(w32.abs().amax(dim=0, keepdim=True).clamp_min(1e-8), 127.0)
    return torch.round(w32 / s).clamp(-127, 127) * s


def int8_rows(w: torch.Tensor) -> torch.Tensor:
    """w (rows, cols) -> int8 per row, dequantized, f32."""
    w32 = w.float()
    s = _div(w32.abs().amax(dim=1, keepdim=True).clamp_min(1e-8), 127.0)
    return torch.round(w32 / s).clamp(-127, 127) * s


def act_quant(x: torch.Tensor, bits: int, group: int = 0) -> torch.Tensor:
    """Symmetric activation quantization to `bits` (8: int8, 4: int4)
    per row (group 0) or per row and group of `group` columns,
    dequantized, f32."""
    top = float(2 ** (bits - 1) - 1)
    x32 = x.float()
    shape = x32.shape
    if group:
        x32 = x32.reshape(*shape[:-1], shape[-1] // group, group)
    s = _div(x32.abs().amax(dim=-1, keepdim=True).clamp_min(1e-8), top)
    return (torch.round(x32 / s).clamp(-top, top) * s).reshape(shape)


def fp8_rows(x: torch.Tensor) -> torch.Tensor:
    """x rounded to float8 e4m3 with one f32 scale a row (its absmax
    onto 448), back in f32."""
    x32 = x.float()
    s = x32.abs().amax(dim=-1, keepdim=True).clamp_min(1e-12) / 448.0
    return (x32 / s).to(torch.float8_e4m3fn).float() * s
