"""TinyViT-5M image encoder: MobileSAM's.

Counterpart of video_llava_tpu/models/tiny_vit.py: conv stem, one MBConv
stage, three window-attention stages with dense (heads, N, N) attention
biases, the final patch merge at stride 1 (a 1024 px input gives SAM's
64 x 64 grid) and the SAM neck. Convolutions are BatchNorm-folded, with
kernels in the JAX package's HWIO layout; activations are NHWC.
convert_tiny_vit reads the official mobile_sam.pt image_encoder.* keys,
folding each BatchNorm into its convolution.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

from video_llava_tpu_torch.models.layers import (
    StateDictView,
    TreeInit,
    dense,
    norm,
)


@dataclasses.dataclass(frozen=True)
class TinyViTConfig:
    image_size: int = 1024
    embed_dims: Tuple[int, ...] = (64, 128, 160, 320)
    depths: Tuple[int, ...] = (2, 2, 6, 2)
    num_heads: Tuple[int, ...] = (2, 4, 5, 10)
    window_sizes: Tuple[int, ...] = (7, 7, 14, 7)
    mlp_ratio: float = 4.0
    mbconv_expand: float = 4.0
    local_conv_size: int = 3
    output_channels: int = 256
    layer_norm_eps: float = 1e-5

    @property
    def grid(self) -> int:
        return self.image_size // 16

    def merge_stride(self, i: int) -> int:
        """Patch merge i feeds stage i + 1; the last one keeps stride 1."""
        return 1 if i == len(self.embed_dims) - 2 else 2

    @classmethod
    def tiny_test(cls):
        return cls(image_size=64, embed_dims=(8, 12, 16, 20),
                   depths=(1, 1, 2, 1), num_heads=(2, 2, 2, 2),
                   window_sizes=(2, 2, 2, 2), output_channels=16)


def conv_nhwc(x, kernel, bias=None, stride: int = 1, groups: int = 1):
    """NHWC conv with an HWIO kernel (HWI1O for depthwise), pad k // 2."""
    k = kernel.shape[0]
    y = F.conv2d(x.permute(0, 3, 1, 2), kernel.to(x.dtype).permute(3, 2, 0, 1),
                 None, stride, k // 2, 1, groups)
    y = y.permute(0, 2, 3, 1)
    return y if bias is None else y + bias


def _conv(p, x, stride: int = 1):
    if p["kernel"].dim() == 2:  # 1x1: a matmul
        return dense(p, x)
    groups = x.shape[-1] if p["kernel"].shape[2] == 1 else 1
    return conv_nhwc(x, p["kernel"], p["bias"], stride, groups)


def _mbconv(p, x):
    h = F.gelu(_conv(p["conv1"], x))
    h = F.gelu(_conv(p["conv2"], h))
    return F.gelu(x + _conv(p["conv3"], h))


def _patch_merge(p, x, stride: int):
    x = F.gelu(_conv(p["conv1"], x))
    x = F.gelu(_conv(p["conv2"], x, stride))
    return _conv(p["conv3"], x)


def _window_attention(p, x, num_heads: int, eps: float):
    nw, n, c = x.shape
    hd = c // num_heads
    qkv = dense(p["qkv"], norm(p["norm"], x, eps)).reshape(nw, n, num_heads, 3,
                                                           hd)
    q, k, v = qkv[..., 0, :], qkv[..., 1, :], qkv[..., 2, :]
    logits = (torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
              * hd ** -0.5 + p["bias"].float())
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    out = torch.einsum("bhqk,bkhd->bqhd", probs, v).to(x.dtype)
    return dense(p["proj"], out.reshape(nw, n, c))


def _block(p, x, window: int, num_heads: int, eps: float):
    b, hh, ww, c = x.shape
    if hh == window and ww == window:
        a = _window_attention(p["attn"], x.reshape(b, hh * ww, c), num_heads,
                              eps).reshape(b, hh, ww, c)
    else:
        ph, pw = -hh % window, -ww % window
        h = F.pad(x, (0, 0, 0, pw, 0, ph)) if ph or pw else x
        hp, wp = hh + ph, ww + pw
        wins = h.reshape(b, hp // window, window, wp // window, window,
                         c).permute(0, 1, 3, 2, 4, 5).reshape(-1,
                                                              window ** 2, c)
        wins = _window_attention(p["attn"], wins, num_heads, eps)
        h = wins.reshape(b, hp // window, wp // window, window, window,
                         c).permute(0, 1, 3, 2, 4, 5).reshape(b, hp, wp, c)
        a = h[:, :hh, :ww]
    x = _conv(p["local_conv"], x + a)
    t = x.reshape(b, hh * ww, c)
    h = norm(p["mlp"]["norm"], t, eps)
    h = dense(p["mlp"]["fc2"], F.gelu(dense(p["mlp"]["fc1"], h)))
    return (t + h).reshape(b, hh, ww, c)


def encoder(params, pixels: torch.Tensor, cfg: TinyViTConfig) -> torch.Tensor:
    """(b, S, S, 3) normalized pixels -> (b, grid, grid, out_c)."""
    eps = cfg.layer_norm_eps
    x = pixels.to(params["patch_embed"]["conv1"]["kernel"].dtype)
    x = F.gelu(_conv(params["patch_embed"]["conv1"], x, 2))
    x = _conv(params["patch_embed"]["conv2"], x, 2)
    for bp in params["stage0"]:
        x = _mbconv(bp, x)
    x = _patch_merge(params["merges"][0], x, cfg.merge_stride(0))
    for si, stage in enumerate(params["stages"]):
        for bp in stage:
            x = _block(bp, x, cfg.window_sizes[si + 1], cfg.num_heads[si + 1],
                       eps)
        if si < len(params["merges"]) - 1:
            x = _patch_merge(params["merges"][si + 1], x,
                             cfg.merge_stride(si + 1))
    neck = params["neck"]
    x = norm(neck["ln1"], torch.matmul(x, neck["conv1"].to(x.dtype)), 1e-6)
    x = conv_nhwc(x, neck["conv2"])
    return norm(neck["ln2"], x, 1e-6)


def attention_bias_index(window: int):
    """(N, N) offset-class index and the class count (official TinyViT
    construction, itertools.product order)."""
    pts = [(i, j) for i in range(window) for j in range(window)]
    offsets: dict = {}
    idxs = []
    for p1 in pts:
        for p2 in pts:
            off = (abs(p1[0] - p2[0]), abs(p1[1] - p2[1]))
            if off not in offsets:
                offsets[off] = len(offsets)
            idxs.append(offsets[off])
    n = len(pts)
    return np.asarray(idxs, np.int64).reshape(n, n), len(offsets)


def init_params(init: TreeInit, cfg: TinyViTConfig):
    """Random BN-folded parameters, drawn as the JAX package's
    tiny_vit.init_params draws them."""

    def conv(ci, co, k=1):
        if k > 1:
            kern = init.normal((k, k, ci, co), 0.4 / np.sqrt(k * k * ci))
        else:
            kern = init.normal((ci, co), 1 / np.sqrt(ci))
        return {"kernel": kern, "bias": init.zeros((co,))}

    def dw(c, k=3):
        return {"kernel": init.normal((k, k, 1, c), 0.4 / k),
                "bias": init.zeros((c,))}

    dims = cfg.embed_dims
    e = int(dims[0] * cfg.mbconv_expand)
    oc = cfg.output_channels
    params = {
        "patch_embed": {"conv1": conv(3, dims[0] // 2, 3),
                        "conv2": conv(dims[0] // 2, dims[0], 3)},
        "stage0": [{"conv1": conv(dims[0], e), "conv2": dw(e),
                    "conv3": conv(e, dims[0])} for _ in range(cfg.depths[0])],
        "merges": [{"conv1": conv(dims[i], dims[i + 1]),
                    "conv2": dw(dims[i + 1]),
                    "conv3": conv(dims[i + 1], dims[i + 1])}
                   for i in range(len(dims) - 1)],
        "stages": [],
        "neck": {"conv1": init.normal((dims[-1], oc), 1 / np.sqrt(dims[-1])),
                 "ln1": init.layer_norm(oc),
                 "conv2": init.normal((3, 3, oc, oc), 0.1 / np.sqrt(9 * oc)),
                 "ln2": init.layer_norm(oc)},
    }
    for i in range(1, len(dims)):
        d, nh, ws = dims[i], cfg.num_heads[i], cfg.window_sizes[i]
        idx, n_off = attention_bias_index(ws)
        mlp = int(d * cfg.mlp_ratio)
        params["stages"].append([{
            "attn": {"norm": init.layer_norm(d), "qkv": init.linear(d, 3 * d),
                     "proj": init.linear(d, d),
                     "bias": init.normal((nh, n_off), 0.02)[
                         :, torch.as_tensor(idx, device=init.device)]},
            "local_conv": dw(d, cfg.local_conv_size),
            "mlp": {"norm": init.layer_norm(d), "fc1": init.linear(d, mlp),
                    "fc2": init.linear(mlp, d)},
        } for _ in range(cfg.depths[i])])
    return params


# -- checkpoint conversion ------------------------------------------------------


def _fold_bn(sd, prefix: str, eps: float = 1e-5):
    """Conv2d_BN `prefix`c / `prefix`bn -> the folded (OIHW weight,
    bias), in numpy f32 on the host as the JAX package folds (the same
    bits)."""
    def a(key):
        v = sd[prefix + key]
        return (v.detach().cpu().float().numpy()
                if isinstance(v, torch.Tensor) else np.asarray(v, np.float32))

    scale = a("bn.weight") / np.sqrt(a("bn.running_var") + eps)
    return (a("c.weight") * scale[:, None, None, None],
            a("bn.bias") - a("bn.running_mean") * scale)


def _folded_conv(sd, prefix: str, device=None,
                 dtype: torch.dtype = torch.float32) -> dict:
    """-> {'kernel', 'bias'} on `device`: (ci, co) for a 1x1, HWIO
    otherwise ((kh, kw, 1, co) for a depthwise conv)."""
    w, b = _fold_bn(sd, prefix)
    w = w[:, :, 0, 0].T if w.shape[2] == w.shape[3] == 1 else w.transpose(
        2, 3, 1, 0)
    return {"kernel": torch.from_numpy(np.ascontiguousarray(w)).to(
                device=device, dtype=dtype),
            "bias": torch.from_numpy(b).to(device=device, dtype=dtype)}


def convert_tiny_vit(sd, cfg: TinyViTConfig, prefix: str = "image_encoder.",
                     device=None, dtype: torch.dtype = torch.float32):
    """The official MobileSAM checkpoint's image encoder (mobile_sam.pt
    image_encoder.* keys: patch_embed.seq.{0,2}, layers.0's MBConv
    blocks, layers.{1,2,3}'s TinyViT blocks, the patch merges, the neck
    neck.{0..3}) -> the parameter tree on `device` (JAX
    convert_tiny_vit's): BatchNorms folded in f32 on the host, each block's
    attention biases gathered to a dense (heads, N, N) table by its
    attention_bias_idxs (or the official construction's index where the
    buffer was not saved)."""
    g = StateDictView(sd, device, dtype, prefix)

    def conv(p):
        return _folded_conv(sd, prefix + p, device, dtype)

    dims = cfg.embed_dims
    params = {
        "patch_embed": {"conv1": conv("patch_embed.seq.0."),
                        "conv2": conv("patch_embed.seq.2.")},
        "stage0": [{f"conv{k}": conv(f"layers.0.blocks.{j}.conv{k}.")
                    for k in (1, 2, 3)} for j in range(cfg.depths[0])],
        "merges": [{f"conv{k}": conv(f"layers.{i}.downsample.conv{k}.")
                    for k in (1, 2, 3)} for i in range(len(dims) - 1)],
        "stages": [],
        "neck": {"conv1": g("neck.0.weight")[:, :, 0, 0].t().contiguous(),
                 "ln1": g.norm("neck.1."),
                 "conv2": g("neck.2.weight").permute(2, 3, 1, 0).contiguous(),
                 "ln2": g.norm("neck.3.")},
    }
    for i in range(1, len(dims)):
        blocks = []
        for j in range(cfg.depths[i]):
            p = f"layers.{i}.blocks.{j}."
            if p + "attn.attention_bias_idxs" in g:
                idx = StateDictView(sd, device, torch.int64, prefix)(
                    p + "attn.attention_bias_idxs")
            else:
                idx = torch.as_tensor(
                    attention_bias_index(cfg.window_sizes[i])[0],
                    device=device)
            blocks.append({
                "attn": {"norm": g.norm(p + "attn.norm."),
                         "qkv": g.linear(p + "attn.qkv."),
                         "proj": g.linear(p + "attn.proj."),
                         "bias": g(p + "attn.attention_biases")[:, idx]},
                "local_conv": conv(p + "local_conv."),
                "mlp": {"norm": g.norm(p + "mlp.norm."),
                        "fc1": g.linear(p + "mlp.fc1."),
                        "fc2": g.linear(p + "mlp.fc2.")},
            })
        params["stages"].append(blocks)
    return params
