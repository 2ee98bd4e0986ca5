"""int8 quantization: weights-only, and W8A8 for the CLIP tower.

Counterpart of video_llava_tpu/ops/quant.py (plain torch; the JAX file
has no Pallas kernel). Symmetric absmax / 127 scales over the
contraction axis, values rounded half to even as ``jnp.round`` does.
2D ``kernel`` leaves and embedding tables become ``{'qvalues': int8,
'scales': f32}``; ``models.layers.linear`` and ``embed`` dispatch on
that layout. With ``a8=True`` kernels become ``{'qvalues_a8',
'scales'}``: the activations are quantized per row too and the product
runs on int8 operands with int32 sums (:func:`quantized_matmul_a8`,
``torch._int_mm``: cuBLASLt's int8 GEMM on the card, an exact integer
product on the CPU; the JAX package's is a plain XLA dot, not Pallas).
:func:`dot_f32` carries a gradient, so a frozen int8 LLM passes
gradients to its inputs in training.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import torch


def ieee_div(a: torch.Tensor, c: float) -> torch.Tensor:
    """a / c rounded as one IEEE division on every device. (PyTorch's
    CUDA division by a Python number multiplies by its reciprocal, which
    can land one ulp away and move an int8 rounding tie.)"""
    return a / torch.full((), c, dtype=a.dtype, device=a.device)


def quantize_tensor(w: torch.Tensor, axis: int = 0):
    """Symmetric int8 with scales over `axis` (the reduced axis; scales
    keep it as size 1) -> (int8 values, f32 scales)."""
    w32 = w.float()
    absmax = w32.abs().amax(dim=axis, keepdim=True)
    scales = ieee_div(absmax.clamp_min(1e-8), 127.0)
    q = torch.round(w32 / scales).clamp(-127, 127)
    return q.to(torch.int8), scales


def dequantize(q: torch.Tensor, scales: torch.Tensor,
               dtype=torch.bfloat16) -> torch.Tensor:
    return (q.float() * scales).to(dtype)


def quantize_rows_int8(x: torch.Tensor):
    """Per-row symmetric int8 activations: (..., K) -> (int8 values,
    f32 (..., 1) scales), absmax / 127 rounded half to even (the JAX
    package's TO_NEAREST_EVEN; ``torch.round`` rounds so)."""
    x32 = x.float()
    sx = ieee_div(x32.abs().amax(dim=-1, keepdim=True).clamp_min(1e-8),
                  127.0)
    return torch.round(x32 / sx).clamp(-127, 127).to(torch.int8), sx


def int8_mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(m, k) int8 @ (k, n) int8 -> (m, n) int32, exact, through
    ``torch._int_mm``. On the card that is cuBLASLt's int8 GEMM, which
    takes m > 16, k and n multiples of 8 (every W8A8 product of a CLIP
    tower) and b column-major: the W8A8 tower stores its weights so
    (models/layers.Int8A8Kernel); another b is copied so."""
    if a.is_cuda and b.stride(0) != 1:
        b = b.t().contiguous().t()
    return torch._int_mm(a, b)


def int8_product(x: torch.Tensor, qvalues: torch.Tensor) -> tuple:
    """x (..., in) quantized by rows, times qvalues (in, out) int8 ->
    (int32 sums as f32 (..., out), row scales f32 (..., 1))."""
    xq, sx = quantize_rows_int8(x)
    lead = x.shape[:-1]
    y = int8_mm(xq.reshape(-1, x.shape[-1]), qvalues)
    return y.float().reshape(*lead, qvalues.shape[-1]), sx


def quantized_matmul_a8(x: torch.Tensor, qvalues: torch.Tensor,
                        scales: torch.Tensor) -> torch.Tensor:
    """W8A8: x (..., in) quantized per row, times qvalues (in, out) int8
    per output channel, summed in int32, rescaled by sx * scales in f32
    -> x's dtype (JAX ops/quant.py:63-76)."""
    y, sx = int8_product(x, qvalues)
    return (y * sx * scales.float()[0]).to(x.dtype)


class _DotF32(torch.autograd.Function):
    """(m, in) @ (in, out) -> f32 with the VJP of JAX's dot with
    preferred_element_type=f32: the f32 cotangent against the other
    operand in f32, then cast to the operand's dtype. (``aten::mm.dtype``
    has no derivative of its own.)"""

    @staticmethod
    def forward(ctx, x2, w):
        ctx.save_for_backward(x2, w)
        if x2.is_cuda and x2.dtype in (torch.bfloat16, torch.float16):
            return torch.mm(x2, w.to(x2.dtype), out_dtype=torch.float32)
        return torch.mm(x2.float(), w.float())

    @staticmethod
    def backward(ctx, gy):
        x2, w = ctx.saved_tensors
        gx = gw = None
        if ctx.needs_input_grad[0]:
            gx = torch.mm(gy.float(), w.float().t()).to(x2.dtype)
        if ctx.needs_input_grad[1]:
            gw = torch.mm(x2.float().t(), gy.float()).to(w.dtype)
        return gx, gw


def dot_f32(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x (..., in) @ w (in, out) -> f32, as a dot with
    preferred_element_type=f32: the product is never rounded to a
    narrower type. On CUDA, 16-bit operands go to the GEMM as they are
    and it writes its f32 accumulator (``aten::mm.dtype``), so no f32
    copy of w is made; elsewhere both operands are cast to f32. The
    gradient (for x, and for w where it requires one) is JAX's: f32
    cotangent times the other operand in f32, cast to the operand's
    dtype."""
    lead = x.shape[:-1]
    y = _DotF32.apply(x.reshape(-1, x.shape[-1]), w)
    return y.reshape(*lead, w.shape[-1])


def quantized_matmul(x: torch.Tensor, qvalues: torch.Tensor,
                     scales: torch.Tensor) -> torch.Tensor:
    """x (..., in) @ qvalues (in, out) int8 * scales (1, out) -> x's
    dtype: the weights cast to x's dtype, the product kept in f32
    (:func:`dot_f32`), scaled in f32, then cast once, as the JAX
    package's dot with preferred_element_type=f32 does."""
    y = dot_f32(x, qvalues)
    return (y * scales.float()[0]).to(x.dtype)


def map_tree(fn: Callable, tree, path=()):
    """Apply fn(path_keys, leaf) to every tensor leaf of a nested dict
    (or list) tree; path_keys is the tuple of keys down to the leaf."""
    if isinstance(tree, dict):
        return {k: map_tree(fn, v, path + (str(k),)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_tree(fn, v, path + (str(i),))
                          for i, v in enumerate(tree))
    return fn(path, tree)


def leaf_format(keys: Sequence[str], shape, quant: str,
                group_size: Optional[int] = 128, min_size: int = 1 << 16,
                skip_keys: Sequence[str] = ("class_embedding",
                                            "position_embedding"),
                ) -> Optional[str]:
    """What the JAX package's quantize_params / quantize_params_int4 do
    to a leaf at `keys` of `shape` (stacked layer leaves counted whole):
    None (kept), 'int4' (packed kernel), 'int8' (kernel, contraction
    scales) or 'int8_rows' (embedding table, per-row scales)."""
    size = 1
    for n in shape:
        size *= int(n)
    name = keys[-1] if keys else ""
    if len(shape) < 2 or size < min_size:
        return None
    if any(k in "/".join(keys) for k in skip_keys):
        return None
    if name == "kernel":
        if quant != "int4":
            return "int8"
        d, f = int(shape[-2]), int(shape[-1])
        g = group_size or d
        if d % 2 or d % g or (d // g > 1 and (d // 2) % g) or f % 128:
            return "int8"  # the shapes the int4 packing cannot take
        return "int4"
    if name == "weight" and len(shape) == 2:
        return "int8_rows"
    return None


def quantize_params(params, min_size: int = 1 << 16,
                    skip_keys: Sequence[str] = ("class_embedding",
                                                "position_embedding"),
                    a8: bool = False):
    """int8-quantize every 2D+ kernel (scales over the contraction axis
    -2, so stacked (L, in, out) kernels work) and embedding table
    (per-row scales) of at least `min_size` elements. a8: kernels are
    stored as {'qvalues_a8', 'scales'}, the W8A8 form linear() runs
    through quantized_matmul_a8; embedding tables keep the gather
    layout either way (JAX ops/quant.py:83-123)."""

    def visit(keys, leaf):
        fmt = leaf_format(keys, leaf.shape, "int8", None, min_size,
                          skip_keys)
        if fmt is None:
            return leaf
        q, s = quantize_tensor(leaf, axis=-2 if fmt == "int8" else 1)
        if a8 and fmt == "int8":
            return {"qvalues_a8": q, "scales": s}
        return {"qvalues": q, "scales": s}

    return map_tree(visit, params)
