"""Shared building blocks: functions on tensors plus the small parameter
holders the models are built from.

Counterpart of video_llava_tpu/models/layers.py. Kernels are stored
(in_dim, out_dim), as in the JAX package, so a linear is one ``x @ W``
and both packages hold the same bytes. Parameter names mirror the JAX
parameter trees (``kernel``/``bias``, ``scale``, ``weight``), which is
what lets engine/convert.py copy a tree across by name. A quantized
kernel or embedding table is a small module holding the JAX package's
leaves by the same names ({qvalues_packed, scales} int4, {qvalues,
scales} int8, {qvalues_a8, scales} W8A8), so its state-dict paths are
the JAX tree's paths.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from video_llava_tpu_torch.ops.quant import (
    dot_f32,
    ieee_div,
    int8_mm,
    quantized_matmul,
    quantized_matmul_a8,
)
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


class Int8A8Kernel(nn.Module):
    """W8A8 kernel (ops/quant.py a8 format): qvalues_a8 (in, out) int8,
    scales (1, out) f32 over the contraction axis; the activations are
    quantized per row at each product (quantized_matmul_a8). qvalues_a8
    is laid out column-major, as cuBLASLt's int8 GEMM takes its second
    operand."""

    def __init__(self, in_dim: int, out_dim: int, *, device=None):
        super().__init__()
        self.qvalues_a8 = nn.Parameter(
            torch.empty((out_dim, in_dim), device=device,
                        dtype=torch.int8).t(), requires_grad=False)
        self.scales = _param((1, out_dim), device, torch.float32)


# -- linear -----------------------------------------------------------------


def linear(x: torch.Tensor, kernel, bias: Optional[torch.Tensor] = None,
           out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """x (..., in) @ kernel (in, out) [+ bias] -> out_dtype (x's dtype
    by default).

    bf16/f32 kernel: the product accumulates in f32 (cuBLAS and the CPU
    BLAS do for bf16 operands) and the bias joins the f32 sum in the
    GEMM's epilogue, before the single cast; another out_dtype than x's
    takes the f32 product (ops/quant.dot_f32, no f32 copy of the kernel
    on CUDA), as a dot with preferred_element_type does. int4 kernel:
    the W4A8 matmuls of ops/quant4.py (f32 out, + f32 bias, one cast).
    int8 kernel: ops/quant.quantized_matmul, in x's dtype; W8A8 kernel:
    ops/quant.quantized_matmul_a8, in x's dtype; either then + the bias
    in f32 and cast again (layers.py:31-65 in the JAX package)."""
    out_dtype = out_dtype or x.dtype
    if isinstance(kernel, Int4Kernel):
        if bias is None:  # the kernel casts on its store
            return int4_matmul(x, kernel.qvalues_packed, kernel.scales,
                               out_dtype=out_dtype)
        y = int4_matmul(x, kernel.qvalues_packed, kernel.scales)
    elif isinstance(kernel, Int8Kernel):
        y = quantized_matmul(x, kernel.qvalues, kernel.scales).float()
    elif isinstance(kernel, Int8A8Kernel):
        y = quantized_matmul_a8(x, kernel.qvalues_a8, kernel.scales).float()
    elif out_dtype == x.dtype:
        return F.linear(x, kernel.to(x.dtype).t(),
                        None if bias is None else bias.to(x.dtype))
    else:
        y = dot_f32(x, kernel)
    if bias is not None:
        y = y + bias.float()
    return y.to(out_dtype)


def make_kernel(in_dim: int, out_dim: int, fmt: Optional[str] = None,
                n_groups: int = 1, *, device=None, dtype=torch.float32):
    """An empty kernel leaf in format fmt: None (dense), 'int4', 'int8'
    (ops/quant.leaf_format) or 'int8_a8' (W8A8)."""
    if fmt == "int4":
        return Int4Kernel(in_dim, out_dim, n_groups, device=device)
    if fmt == "int8":
        return Int8Kernel(in_dim, out_dim, (1, out_dim), device=device)
    if fmt == "int8_a8":
        return Int8A8Kernel(in_dim, out_dim, device=device)
    if fmt is not None:
        raise ValueError(f"kernel format {fmt!r}")
    return _param((in_dim, out_dim), device, dtype)


def kernel_rows(kernel) -> int:
    """The contraction size of a kernel leaf in any format."""
    if isinstance(kernel, Int4Kernel):
        return 2 * kernel.qvalues_packed.shape[0]
    if isinstance(kernel, Int8Kernel):
        return kernel.qvalues.shape[0]
    if isinstance(kernel, Int8A8Kernel):
        return kernel.qvalues_a8.shape[0]
    return kernel.shape[0]


def use_param(mod: nn.Module, name: str):
    """Parameter `name` of `mod` as a forward uses it: an FSDP leaf
    (parallel/sharding.shard_params sets `mod.fsdp` {name: dim}) is
    gathered over 'data' along its dim, with the gradient summed and
    sliced back in the backward pass (parallel/collectives.gather_param);
    any other as it is."""
    t = getattr(mod, name)
    dim = (mod.fsdp or {}).get(name)
    if dim is None:
        return t
    from video_llava_tpu_torch.parallel import collectives

    return collectives.gather_param(t, mod.mesh, dim)


def a8_row_sharded(x, kernel, mesh) -> torch.Tensor:
    """The f32 W8A8 product (int32 sums times the row and channel
    scales, not yet rounded) of a kernel whose contraction rows are
    sharded over 'model' (CLIP's o and fc2 under a mesh), equal to the
    whole product's: each row's scale from its absmax over every rank's
    columns of x, the int32 partial sums added over 'model' (exact)."""
    x32 = x.float()
    amax = mesh.all_max(x32.abs().amax(dim=-1, keepdim=True))
    sx = ieee_div(amax.clamp_min(1e-8), 127.0)
    xq = torch.round(x32 / sx).clamp(-127, 127).to(torch.int8)
    lead = x.shape[:-1]
    y = int8_mm(xq.reshape(-1, x.shape[-1]), kernel.qvalues_a8)
    y = mesh.all_sum(y).float().reshape(*lead, y.shape[-1])
    return y * sx * kernel.scales.float()[0]


class Linear(nn.Module):
    """A linear layer. Under a mesh (parallel/sharding.shard_params sets
    `mesh`, `tp` and, for an FSDP kernel, `fsdp`) it places its
    collectives: a row-sharded kernel (tp "in") sums its partial product
    over 'model' in f32 before the bias; a whole kernel fed a local input
    (the int4 wo/down) gathers the input first; a column-sharded kernel
    (tp "out") returns this rank's columns. With grad enabled the
    collectives are parallel/collectives' autograd Functions (the input
    of a column-sharded kernel summed over 'model' in the backward
    pass); an FSDP kernel or bias is gathered over 'data' at use."""

    mesh = None
    tp = None
    fsdp = None

    def __init__(self, in_dim: int, out_dim: int, bias: bool = True, *,
                 fmt: Optional[str] = None, n_groups: int = 1,
                 device=None, dtype=torch.float32):
        super().__init__()
        self.kernel = make_kernel(in_dim, out_dim, fmt, n_groups,
                                  device=device, dtype=dtype)
        self.bias = _param((out_dim,), device, dtype) if bias else None

    def forward(self, x):
        mesh = self.mesh
        if mesh is None or mesh.world == 1:
            return linear(x, self.kernel, self.bias)
        from video_llava_tpu_torch.parallel import collectives

        kernel = use_param(self, "kernel")
        bias = None if self.bias is None else use_param(self, "bias")
        if mesh.size == 1:
            return linear(x, kernel, bias)
        if self.tp == "in":
            if isinstance(kernel, Int8A8Kernel):  # as quantized_matmul_a8
                y = a8_row_sharded(x, kernel, mesh).to(x.dtype).float()
            else:
                y = collectives.reduce_from(
                    linear(x, kernel, out_dtype=torch.float32), mesh)
            if bias is not None:
                y = y + bias.float()
            return y.to(x.dtype)
        if self.tp == "out":
            x = collectives.copy_to(x, mesh)
        elif x.shape[-1] != kernel_rows(kernel):
            x = collectives.gather(x, mesh)
        return linear(x, kernel, bias)


def dense(p, x):
    """linear() of a parameter dict {'kernel', optional 'bias'}: the
    grounding models keep the JAX package's nested-dict trees."""
    return linear(x, p["kernel"], p.get("bias"))


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


def norm(p, x, eps: float = 1e-5):
    """layer_norm() of a parameter dict {'scale', 'bias'}."""
    return layer_norm(x, p["scale"], p["bias"], eps)


class TreeInit:
    """Random parameter trees (nested dicts of tensors, in the JAX
    package's layout) drawn from one seeded generator on `device`."""

    def __init__(self, seed: int = 0, device=None, dtype=torch.float32):
        self.device = torch.device(device or "cpu")
        self.dtype = dtype
        self.g = (None if self.device.type == "meta"
                  else torch.Generator(device=self.device).manual_seed(seed))

    def normal(self, shape, std: float = 1.0):
        if self.g is None:
            return torch.empty(shape, device=self.device, dtype=self.dtype)
        x = torch.randn(shape, generator=self.g, device=self.device,
                        dtype=torch.float32)
        return (x * std).to(self.dtype)

    def uniform(self, shape, lo: float, hi: float):
        if self.g is None:
            return torch.empty(shape, device=self.device, dtype=self.dtype)
        x = torch.rand(shape, generator=self.g, device=self.device,
                       dtype=torch.float32)
        return (lo + (hi - lo) * x).to(self.dtype)

    def full(self, shape, value: float):
        return torch.full(shape, value, device=self.device, dtype=self.dtype)

    def zeros(self, shape):
        return self.full(shape, 0.0)

    def linear(self, d_in: int, d_out: int, std: Optional[float] = None,
               bias: bool = True):
        """{'kernel': (d_in, d_out) normal * std (d_in ** -0.5 by
        default, as the JAX package's linear_init), 'bias': zeros}."""
        p = {"kernel": self.normal((d_in, d_out),
                                   d_in ** -0.5 if std is None else std)}
        if bias:
            p["bias"] = self.zeros((d_out,))
        return p

    def layer_norm(self, dim: int):
        return {"scale": self.full((dim,), 1.0), "bias": self.zeros((dim,))}


class StateDictView:
    """A checkpoint's state dict (torch tensors or numpy arrays) read by
    key under `prefix`, each entry a tensor on `device` in `dtype`: what
    the grounding models' converters read (the JAX package's
    convert_* functions take numpy arrays, the port's loaders give
    tensors)."""

    def __init__(self, sd, device=None, dtype=torch.float32,
                 prefix: str = ""):
        self.sd, self.device, self.dtype, self.prefix = (sd, device, dtype,
                                                         prefix)

    def __contains__(self, key: str) -> bool:
        return self.prefix + key in self.sd

    def __call__(self, key: str) -> torch.Tensor:
        v = self.sd[self.prefix + key]
        t = v if isinstance(v, torch.Tensor) else torch.from_numpy(
            np.array(v))
        return t.to(device=self.device, dtype=self.dtype)

    def t(self, key: str) -> torch.Tensor:
        """A 2-D weight (out, in) as a kernel (in, out)."""
        return self(key).t().contiguous()

    def linear(self, prefix: str) -> dict:
        """torch Linear `prefix`weight / bias -> {'kernel' (in, out),
        'bias' when saved}."""
        p = {"kernel": self.t(prefix + "weight")}
        if prefix + "bias" in self:
            p["bias"] = self(prefix + "bias")
        return p

    def norm(self, prefix: str) -> dict:
        return {"scale": self(prefix + "weight"), "bias": self(prefix + "bias")}


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
    """RMSNorm; under FSDP (the LLM's layer norms) the scale is gathered
    over 'data' at use."""

    mesh = None
    fsdp = None

    def __init__(self, dim: int, eps: float, *, device=None,
                 dtype=torch.float32):
        super().__init__()
        self.eps = eps
        self.scale = _param((dim,), device, dtype)

    def forward(self, x):
        return rms_norm(x, use_param(self, "scale"), self.eps)


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
    """An embedding table. Vocab-sharded under a mesh (tp "rows"): each
    rank looks up the ids of its own row range, zeros the others, and the
    ranks' rows are summed over 'model' (exact: one rank holds each
    id; with grad enabled through parallel/collectives.reduce_from).
    An FSDP table (its columns on 'data') is gathered at use."""

    mesh = None
    tp = None
    fsdp = None

    def __init__(self, vocab: int, dim: int, *, fmt: Optional[str] = None,
                 device=None, dtype=torch.float32):
        super().__init__()
        if fmt == "int8_rows":
            self.weight = Int8Kernel(vocab, dim, (vocab, 1), device=device)
        elif fmt is None:
            self.weight = _param((vocab, dim), device, dtype)
        else:
            raise ValueError(f"embedding format {fmt!r}")

    @property
    def rows(self) -> int:
        return kernel_rows(self.weight)

    def forward(self, ids):
        weight = use_param(self, "weight")
        if self.tp != "rows" or self.mesh.size == 1:
            return embed(weight, ids)
        from video_llava_tpu_torch.parallel import collectives

        rows = self.rows
        local = ids.long() - self.mesh.rank * rows
        valid = (local >= 0) & (local < rows)
        out = embed(weight, local.clamp(0, rows - 1))
        out = torch.where(valid[..., None], out, out.new_zeros(()))
        return collectives.reduce_from(out, self.mesh)


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
