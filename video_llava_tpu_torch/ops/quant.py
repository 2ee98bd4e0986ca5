"""Weights-only int8 quantization.

Counterpart of video_llava_tpu/ops/quant.py (plain torch; the JAX file
has no Pallas kernel). Symmetric absmax / 127 scales over the
contraction axis, values rounded half to even as ``jnp.round`` does.
2D ``kernel`` leaves and embedding tables become ``{'qvalues': int8,
'scales': f32}``; ``models.layers.linear`` and ``embed`` dispatch on
that layout. The W8A8 (``qvalues_a8``) form for the CLIP tower is not
ported yet.
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


def quantized_matmul(x: torch.Tensor, qvalues: torch.Tensor,
                     scales: torch.Tensor) -> torch.Tensor:
    """x (..., in) @ qvalues (in, out) int8 * scales (1, out) -> x's
    dtype: the weights cast to x's dtype, the product accumulated in
    f32, scaled in f32, then cast. For bf16 x, PyTorch's matmul returns
    the product rounded to bf16, one rounding more than the JAX
    package's f32-accumulated dot."""
    y = torch.matmul(x, qvalues.to(x.dtype)).float()
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
                                                "position_embedding")):
    """int8-quantize every 2D+ kernel (scales over the contraction axis
    -2, so stacked (L, in, out) kernels work) and embedding table
    (per-row scales) of at least `min_size` elements."""

    def visit(keys, leaf):
        fmt = leaf_format(keys, leaf.shape, "int8", None, min_size,
                          skip_keys)
        if fmt is None:
            return leaf
        q, s = quantize_tensor(leaf, axis=-2 if fmt == "int8" else 1)
        return {"qvalues": q, "scales": s}

    return map_tree(visit, params)
