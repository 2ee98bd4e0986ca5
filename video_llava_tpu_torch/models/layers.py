"""Shared building blocks: functions on tensors plus the small parameter
holders the models are built from.

Counterpart of video_llava_tpu/models/layers.py. Kernels are stored
(in_dim, out_dim), as in the JAX package, so a linear is one ``x @ W``
and both packages hold the same bytes. Parameter names mirror the JAX
parameter trees (``kernel``/``bias``, ``scale``, ``weight``), which is
what lets engine/convert.py copy a tree across by name.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn


def _param(shape, device, dtype) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape, device=device, dtype=dtype),
                        requires_grad=False)


# -- linear -----------------------------------------------------------------


def linear(x: torch.Tensor, kernel: torch.Tensor,
           bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x (..., in) @ kernel (in, out) [+ bias] -> x's dtype. The product
    accumulates in f32 (cuBLAS and the CPU BLAS do for bf16 operands)
    and the bias joins the f32 sum in the GEMM's epilogue, before the
    single cast."""
    return F.linear(x, kernel.to(x.dtype).t(),
                    None if bias is None else bias.to(x.dtype))


class Linear(nn.Module):
    def __init__(self, in_dim: int, out_dim: int, bias: bool = True, *,
                 device=None, dtype=torch.float32):
        super().__init__()
        self.kernel = _param((in_dim, out_dim), device, dtype)
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


def embed(weight: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    return F.embedding(ids.long(), weight)


class Embedding(nn.Module):
    def __init__(self, vocab: int, dim: int, *, device=None,
                 dtype=torch.float32):
        super().__init__()
        self.weight = _param((vocab, dim), device, dtype)

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
