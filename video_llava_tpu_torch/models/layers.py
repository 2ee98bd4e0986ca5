"""Shared building blocks: functions on tensors plus the small parameter
holders the models are built from.

Counterpart of video_llava_tpu/models/layers.py. Kernels are stored
(in_dim, out_dim), as in the JAX package, so a linear is one ``x @ W``
and both packages hold the same bytes. Parameter names mirror the JAX
parameter trees (``kernel``/``bias``, ``scale``, ``weight``), which is
what lets engine/convert.py copy a tree across by name. A quantized
kernel or embedding table is a small module holding the JAX package's
leaves by the same names ({qvalues_packed, scales} int4, {qvalues,
scales} int8), so its state-dict paths are the JAX tree's paths.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from video_llava_tpu_torch.ops.quant import quantized_matmul
from video_llava_tpu_torch.ops.quant4 import int4_matmul


def _param(shape, device, dtype) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape, device=device, dtype=dtype),
                        requires_grad=False)


# -- quantized leaves ---------------------------------------------------------


class Int4Kernel(nn.Module):
    """int4 nibble-packed kernel (ops/quant4.py format): qvalues_packed
    (in/2, out) int8, scales (G, out) bf16."""

    def __init__(self, in_dim: int, out_dim: int, n_groups: int, *,
                 device=None):
        super().__init__()
        self.qvalues_packed = _param((in_dim // 2, out_dim), device,
                                     torch.int8)
        self.scales = _param((n_groups, out_dim), device, torch.bfloat16)


class Int8Kernel(nn.Module):
    """int8 kernel (ops/quant.py format): qvalues (in, out) int8, scales
    (1, out) f32 over the contraction axis. As an embedding table:
    qvalues (vocab, dim), scales (vocab, 1) per row."""

    def __init__(self, rows: int, cols: int, scale_shape, *, device=None):
        super().__init__()
        self.qvalues = _param((rows, cols), device, torch.int8)
        self.scales = _param(scale_shape, device, torch.float32)


# -- linear -----------------------------------------------------------------


def linear(x: torch.Tensor, kernel, bias: Optional[torch.Tensor] = None,
           out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """x (..., in) @ kernel (in, out) [+ bias] -> out_dtype (x's dtype
    by default).

    bf16/f32 kernel: the product accumulates in f32 (cuBLAS and the CPU
    BLAS do for bf16 operands) and the bias joins the f32 sum in the
    GEMM's epilogue, before the single cast; a wider out_dtype than x's
    takes the product in out_dtype, as a dot with preferred_element_type
    does. int4 kernel: the W4A8 matmuls of ops/quant4.py (f32 out, +
    f32 bias, one cast). int8 kernel: ops/quant.quantized_matmul, in x's
    dtype (layers.py:31-65 in the JAX package)."""
    out_dtype = out_dtype or x.dtype
    if isinstance(kernel, Int4Kernel):
        if bias is None:  # the kernel casts on its store
            return int4_matmul(x, kernel.qvalues_packed, kernel.scales,
                               out_dtype=out_dtype)
        y = int4_matmul(x, kernel.qvalues_packed, kernel.scales)
    elif isinstance(kernel, Int8Kernel):
        y = quantized_matmul(x, kernel.qvalues, kernel.scales).float()
    elif out_dtype == x.dtype:
        return F.linear(x, kernel.to(x.dtype).t(),
                        None if bias is None else bias.to(x.dtype))
    else:
        y = torch.matmul(x.to(out_dtype), kernel.to(out_dtype))
    if bias is not None:
        y = y + bias.float()
    return y.to(out_dtype)


def make_kernel(in_dim: int, out_dim: int, fmt: Optional[str] = None,
                n_groups: int = 1, *, device=None, dtype=torch.float32):
    """An empty kernel leaf in format fmt: None (dense), 'int4' or
    'int8' (ops/quant.leaf_format)."""
    if fmt == "int4":
        return Int4Kernel(in_dim, out_dim, n_groups, device=device)
    if fmt == "int8":
        return Int8Kernel(in_dim, out_dim, (1, out_dim), device=device)
    if fmt is not None:
        raise ValueError(f"kernel format {fmt!r}")
    return _param((in_dim, out_dim), device, dtype)


class Linear(nn.Module):
    def __init__(self, in_dim: int, out_dim: int, bias: bool = True, *,
                 fmt: Optional[str] = None, n_groups: int = 1,
                 device=None, dtype=torch.float32):
        super().__init__()
        self.kernel = make_kernel(in_dim, out_dim, fmt, n_groups,
                                  device=device, dtype=dtype)
        self.bias = _param((out_dim,), device, dtype) if bias else None

    def forward(self, x):
        return linear(x, self.kernel, self.bias)


# -- norms ------------------------------------------------------------------


def layer_norm(x, scale, bias, eps: float = 1e-5):
    """LayerNorm in f32, cast back to x's dtype."""
    y = F.layer_norm(x.float(), (x.shape[-1],), scale.float(), bias.float(),
                     eps)
    return y.to(x.dtype)


def rms_norm(x, scale, eps: float = 1e-6):
    """RMSNorm in f32, cast back to x's dtype."""
    x32 = x.float()
    y = x32 * torch.rsqrt(x32.square().mean(dim=-1, keepdim=True) + eps)
    return (y * scale.float()).to(x.dtype)


class LayerNorm(nn.Module):
    def __init__(self, dim: int, eps: float, *, device=None,
                 dtype=torch.float32):
        super().__init__()
        self.eps = eps
        self.scale = _param((dim,), device, dtype)
        self.bias = _param((dim,), device, dtype)

    def forward(self, x):
        return layer_norm(x, self.scale, self.bias, self.eps)


class RMSNorm(nn.Module):
    def __init__(self, dim: int, eps: float, *, device=None,
                 dtype=torch.float32):
        super().__init__()
        self.eps = eps
        self.scale = _param((dim,), device, dtype)

    def forward(self, x):
        return rms_norm(x, self.scale, self.eps)


# -- activations ------------------------------------------------------------


def quick_gelu(x):
    """OpenAI CLIP's gelu approximation: x * sigmoid(1.702 x)."""
    return x * torch.sigmoid(1.702 * x)


ACTIVATIONS = {
    # jax.nn.gelu defaults to the tanh approximation
    "gelu": lambda x: F.gelu(x, approximate="tanh"),
    "quick_gelu": quick_gelu,
}


# -- embeddings -------------------------------------------------------------


def embed(weight, ids: torch.Tensor) -> torch.Tensor:
    """Row gather; an int8 table dequantizes its rows in f32 and returns
    bf16, as the JAX package does (layers.py:119-125)."""
    if isinstance(weight, Int8Kernel):
        rows = F.embedding(ids.long(), weight.qvalues).float()
        scales = F.embedding(ids.long(), weight.scales)
        return (rows * scales).to(torch.bfloat16)
    return F.embedding(ids.long(), weight)


class Embedding(nn.Module):
    def __init__(self, vocab: int, dim: int, *, fmt: Optional[str] = None,
                 device=None, dtype=torch.float32):
        super().__init__()
        if fmt == "int8_rows":
            self.weight = Int8Kernel(vocab, dim, (vocab, 1), device=device)
        elif fmt is None:
            self.weight = _param((vocab, dim), device, dtype)
        else:
            raise ValueError(f"embedding format {fmt!r}")

    def forward(self, ids):
        return embed(self.weight, ids)


# -- rotary position embedding (LLaMA) ---------------------------------------


def rope_cos_sin(positions: torch.Tensor, head_dim: int,
                 theta: float = 10000.0):
    """positions (..., s) int -> cos/sin (..., s, head_dim // 2), f32."""
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=positions.device) / head_dim
    inv_freq = 1.0 / torch.pow(torch.tensor(theta, dtype=torch.float32,
                                            device=positions.device), exps)
    angles = positions.float()[..., None] * inv_freq
    return torch.cos(angles), torch.sin(angles)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor):
    """x (b, s, h, d); cos/sin (b, s, d//2) or (s, d//2). LLaMA
    rotate-half convention: pairs are (x[i], x[i + d/2])."""
    d2 = x.shape[-1] // 2
    if cos.dim() == 2:
        cos, sin = cos[None, :, None, :], sin[None, :, None, :]
    else:
        cos, sin = cos[:, :, None, :], sin[:, :, None, :]
    x1, x2 = x[..., :d2].float(), x[..., d2:].float()
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                     dim=-1).to(x.dtype)
