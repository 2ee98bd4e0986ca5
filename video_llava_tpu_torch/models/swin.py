"""Swin Transformer backbone: GroundingDINO's Swin-T and the tagger's
Swin-L.

Counterpart of video_llava_tpu/models/swin.py: shifted-window attention
with the relative-position bias, HF's window shrink and right/bottom
padding for maps the window does not divide (at 800 px the stage maps are
200, 100, 50 and 25 wide against a window of 7), and the patch merge that
zero-pads odd maps. Parameters are the JAX package's nested dict;
convert_hf_swin and convert_timm_swin read the HF SwinModel and the timm
(GroundingDINO's backbone.0, RAM's visual_encoder) state dicts into it.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import List, Optional, Tuple

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
class SwinConfig:
    image_size: int = 224
    patch_size: int = 4
    in_channels: int = 3
    embed_dim: int = 96
    depths: Tuple[int, ...] = (2, 2, 6, 2)
    num_heads: Tuple[int, ...] = (3, 6, 12, 24)
    window_size: int = 7
    mlp_ratio: float = 4.0
    layer_norm_eps: float = 1e-5

    @classmethod
    def tiny_test(cls):
        return cls(image_size=64, patch_size=4, embed_dim=24, depths=(2, 2),
                   num_heads=(2, 4), window_size=4)

    @classmethod
    def swin_t(cls):
        return cls()

    @classmethod
    def swin_l(cls):
        return cls(embed_dim=192, depths=(2, 2, 18, 2),
                   num_heads=(6, 12, 24, 48))

    @property
    def num_stages(self) -> int:
        return len(self.depths)

    @property
    def num_features(self) -> int:
        return self.embed_dim * 2 ** (self.num_stages - 1)


def init_params(init: TreeInit, cfg: SwinConfig):
    """Random parameters in the converter's layout, drawn as the JAX
    package's swin.init_params draws them (normal * fan_in ** -0.5
    kernels, 0.02 relative-position tables)."""
    patch_dim = cfg.patch_size ** 2 * cfg.in_channels
    params = {
        "patch_embed": {"kernel": init.normal((patch_dim, cfg.embed_dim),
                                              patch_dim ** -0.5),
                        "bias": init.zeros((cfg.embed_dim,))},
        "patch_norm": init.layer_norm(cfg.embed_dim),
        "stages": [],
        "final_norm": init.layer_norm(cfg.num_features),
    }
    dim = cfg.embed_dim
    n_rel = (2 * cfg.window_size - 1) ** 2
    for s in range(cfg.num_stages):
        mlp = int(dim * cfg.mlp_ratio)
        blocks = [{
            "ln1": init.layer_norm(dim), "qkv": init.linear(dim, 3 * dim),
            "proj": init.linear(dim, dim),
            "rel_bias": init.normal((n_rel, cfg.num_heads[s]), 0.02),
            "ln2": init.layer_norm(dim), "fc1": init.linear(dim, mlp),
            "fc2": init.linear(mlp, dim),
        } for _ in range(cfg.depths[s])]
        stage = {"blocks": blocks}
        if s < cfg.num_stages - 1:
            stage["downsample"] = {
                "norm": init.layer_norm(4 * dim),
                "reduction": init.linear(4 * dim, 2 * dim, bias=False)}
            dim *= 2
        params["stages"].append(stage)
    return params


# -- windows ---------------------------------------------------------------


def _window_partition(x, w):
    """(b, h, w_, c) -> (b * nW, w * w, c)"""
    b, hh, ww, c = x.shape
    x = x.reshape(b, hh // w, w, ww // w, w, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(-1, w * w, c)


def _window_reverse(windows, w, hh, ww):
    b = windows.shape[0] // ((hh // w) * (ww // w))
    x = windows.reshape(b, hh // w, ww // w, w, w, -1).permute(0, 1, 3, 2, 4,
                                                               5)
    return x.reshape(b, hh, ww, -1)


@functools.lru_cache(maxsize=64)
def _relative_position_index(window: int,
                             table_window: Optional[int] = None) -> np.ndarray:
    """(w*w, w*w) rows of the bias table, laid out at the stride of the
    table's own (config) window."""
    tw = window if table_window is None else table_window
    coords = np.stack(np.meshgrid(np.arange(window), np.arange(window),
                                  indexing="ij"))
    flat = coords.reshape(2, -1)
    rel = (flat[:, :, None] - flat[:, None, :]).transpose(1, 2, 0)
    rel[:, :, 0] += tw - 1
    rel[:, :, 1] += tw - 1
    rel[:, :, 0] *= 2 * tw - 1
    return rel.sum(-1)


@functools.lru_cache(maxsize=64)
def _shift_attn_mask(hh: int, ww: int, window: int, shift: int) -> np.ndarray:
    """(nW, w*w, w*w): 0 within a region, -100 across regions."""
    img_mask = np.zeros((1, hh, ww, 1), np.float32)
    cnt = 0
    for h_sl in (slice(0, -window), slice(-window, -shift),
                 slice(-shift, None)):
        for w_sl in (slice(0, -window), slice(-window, -shift),
                     slice(-shift, None)):
            img_mask[:, h_sl, w_sl, :] = cnt
            cnt += 1
    mw = img_mask.reshape(1, hh // window, window, ww // window, window, 1)
    mw = mw.transpose(0, 1, 3, 2, 4, 5).reshape(-1, window * window)
    diff = mw[:, None, :] - mw[:, :, None]
    return np.where(diff != 0, -100.0, 0.0).astype(np.float32)


def _window_attention(p, x, heads, window, shift_mask, table_window=None):
    bw, n, c = x.shape
    hd = c // heads
    qkv = dense(p["qkv"], x).reshape(bw, n, 3, heads, hd)
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    logits = torch.einsum("bnhd,bmhd->bhnm", q.float(), k.float()) * hd ** -0.5
    idx = torch.as_tensor(_relative_position_index(window, table_window),
                          device=x.device).reshape(-1)
    bias = p["rel_bias"][idx].reshape(n, n, heads).permute(2, 0, 1)
    logits = logits + bias[None].float()
    if shift_mask is not None:
        nw = shift_mask.shape[0]
        m = torch.as_tensor(shift_mask, device=x.device)
        logits = (logits.reshape(bw // nw, nw, heads, n, n)
                  + m[None, :, None]).reshape(bw, heads, n, n)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhnm,bmhd->bnhd", probs.to(v.dtype), v).to(x.dtype)
    return dense(p["proj"], out.reshape(bw, n, c))


def _block(p, x, hh, ww, heads, window, shift, eps):
    b, n, c = x.shape
    cfg_window = window
    if min(hh, ww) <= window:
        window, shift = min(hh, ww), 0
    pad_b, pad_r = -hh % window, -ww % window
    hp, wp = hh + pad_b, ww + pad_r
    shortcut = x
    x = norm(p["ln1"], x, eps).reshape(b, hh, ww, c)
    if pad_b or pad_r:
        x = F.pad(x, (0, 0, 0, pad_r, 0, pad_b))
    mask = None
    if shift > 0:
        x = torch.roll(x, (-shift, -shift), dims=(1, 2))
        mask = _shift_attn_mask(hp, wp, window, shift)
    wins = _window_attention(p, _window_partition(x, window), heads, window,
                             mask, table_window=cfg_window)
    x = _window_reverse(wins, window, hp, wp)
    if shift > 0:
        x = torch.roll(x, (shift, shift), dims=(1, 2))
    if pad_b or pad_r:
        x = x[:, :hh, :ww]
    x = shortcut + x.reshape(b, n, c)
    h = norm(p["ln2"], x, eps)
    return x + dense(p["fc2"], F.gelu(dense(p["fc1"], h)))


def _patch_merge(p, x, hh, ww, eps):
    """(b, h*w, c) -> (b, ceil(h/2)*ceil(w/2), 2c), HF ordering; odd maps
    zero-pad first."""
    b, _, c = x.shape
    x = x.reshape(b, hh, ww, c)
    if hh % 2 or ww % 2:
        x = F.pad(x, (0, 0, 0, ww % 2, 0, hh % 2))
    x = torch.cat([x[:, 0::2, 0::2], x[:, 1::2, 0::2], x[:, 0::2, 1::2],
                   x[:, 1::2, 1::2]], dim=-1)
    x = x.reshape(b, x.shape[1] * x.shape[2], 4 * c)
    return dense(p["reduction"], norm(p["norm"], x, eps))


def forward_features(params, pixels: torch.Tensor,
                     cfg: SwinConfig) -> List[torch.Tensor]:
    """pixels (b, H, W, 3) -> per-stage maps [(b, H_s, W_s, C_s)], in the
    parameters' dtype."""
    b, H, W, ci = pixels.shape
    ps = cfg.patch_size
    x = pixels.reshape(b, H // ps, ps, W // ps, ps, ci).permute(
        0, 1, 3, 2, 4, 5).reshape(b, (H // ps) * (W // ps), -1)
    pe = params["patch_embed"]
    x = dense(pe, x.to(pe["kernel"].dtype))
    x = norm(params["patch_norm"], x, cfg.layer_norm_eps)
    hh, ww, dim = H // ps, W // ps, cfg.embed_dim
    outputs = []
    for s, stage in enumerate(params["stages"]):
        for i, blk in enumerate(stage["blocks"]):
            shift = 0 if i % 2 == 0 else cfg.window_size // 2
            x = _block(blk, x, hh, ww, cfg.num_heads[s], cfg.window_size,
                       shift, cfg.layer_norm_eps)
        outputs.append(x.reshape(b, hh, ww, dim))
        if "downsample" in stage:
            x = _patch_merge(stage["downsample"], x, hh, ww,
                             cfg.layer_norm_eps)
            hh, ww, dim = (hh + 1) // 2, (ww + 1) // 2, dim * 2
    return outputs


def forward_pooled(params, pixels: torch.Tensor,
                   cfg: SwinConfig) -> torch.Tensor:
    """Final-stage features, LN'd and mean-pooled: (b, num_features)."""
    feats = forward_features(params, pixels, cfg)[-1]
    b, hh, ww, c = feats.shape
    x = norm(params["final_norm"], feats.reshape(b, hh * ww, c),
             cfg.layer_norm_eps)
    return x.mean(dim=1)


# -- checkpoint conversion ------------------------------------------------------


def _patch_kernel(g: StateDictView, key: str, embed_dim: int) -> torch.Tensor:
    """The patch conv's (C, 3, P, P) weight -> the (P * P * 3, C) kernel
    of forward_features' patch rows."""
    return g(key).permute(2, 3, 1, 0).reshape(-1, embed_dim).contiguous()


def _final_norm(g: StateDictView, key: str, cfg: SwinConfig) -> dict:
    """The final LayerNorm, or the identity where the checkpoint has none
    (GroundingDINO's backbones)."""
    if key + "weight" in g:
        return g.norm(key)
    return {"scale": torch.ones(cfg.num_features, device=g.device,
                                dtype=g.dtype),
            "bias": torch.zeros(cfg.num_features, device=g.device,
                                dtype=g.dtype)}


def convert_hf_swin(sd, cfg: SwinConfig, device=None,
                    dtype: torch.dtype = torch.float32, prefix: str = ""):
    """An HF SwinModel (or SwinBackbone) state dict -> the parameter tree
    (JAX convert_hf_swin's): query / key / value fused into one qkv
    kernel."""
    g = StateDictView(sd, device, dtype, prefix)
    params = {
        "patch_embed": {
            "kernel": _patch_kernel(
                g, "embeddings.patch_embeddings.projection.weight",
                cfg.embed_dim),
            "bias": g("embeddings.patch_embeddings.projection.bias")},
        "patch_norm": g.norm("embeddings.norm."),
        "stages": [],
        "final_norm": _final_norm(g, "layernorm.", cfg),
    }
    for s in range(cfg.num_stages):
        blocks = []
        for i in range(cfg.depths[s]):
            p = f"encoder.layers.{s}.blocks.{i}."
            a = p + "attention.self."
            blocks.append({
                "ln1": g.norm(p + "layernorm_before."),
                "qkv": {"kernel": torch.cat([g.t(a + f"{n}.weight")
                                             for n in ("query", "key",
                                                       "value")], dim=1),
                        "bias": torch.cat([g(a + f"{n}.bias")
                                           for n in ("query", "key",
                                                     "value")])},
                "proj": g.linear(p + "attention.output.dense."),
                "rel_bias": g(a + "relative_position_bias_table"),
                "ln2": g.norm(p + "layernorm_after."),
                "fc1": g.linear(p + "intermediate.dense."),
                "fc2": g.linear(p + "output.dense."),
            })
        stage = {"blocks": blocks}
        dkey = f"encoder.layers.{s}.downsample."
        if dkey + "reduction.weight" in g:
            stage["downsample"] = {"norm": g.norm(dkey + "norm."),
                                   "reduction": g.linear(dkey + "reduction.")}
        params["stages"].append(stage)
    return params


def convert_timm_swin(sd, cfg: SwinConfig, device=None,
                      dtype: torch.dtype = torch.float32, prefix: str = ""):
    """A timm-layout Swin state dict (GroundingDINO's backbone.0, RAM's
    visual_encoder: patch_embed.proj, layers.{s}.blocks.{i}.attn.qkv,
    downsample.reduction, ...; qkv already fused) -> the parameter tree
    (JAX convert_timm_swin's)."""
    g = StateDictView(sd, device, dtype, prefix)
    params = {
        "patch_embed": {"kernel": _patch_kernel(g, "patch_embed.proj.weight",
                                                cfg.embed_dim),
                        "bias": g("patch_embed.proj.bias")},
        "patch_norm": g.norm("patch_embed.norm."),
        "stages": [],
        "final_norm": _final_norm(g, "norm.", cfg),
    }
    for s in range(cfg.num_stages):
        blocks = []
        for i in range(cfg.depths[s]):
            p = f"layers.{s}.blocks.{i}."
            blocks.append({
                "ln1": g.norm(p + "norm1."),
                "qkv": g.linear(p + "attn.qkv."),
                "proj": g.linear(p + "attn.proj."),
                "rel_bias": g(p + "attn.relative_position_bias_table"),
                "ln2": g.norm(p + "norm2."),
                "fc1": g.linear(p + "mlp.fc1."),
                "fc2": g.linear(p + "mlp.fc2."),
            })
        stage = {"blocks": blocks}
        dkey = f"layers.{s}.downsample."
        if dkey + "reduction.weight" in g:
            stage["downsample"] = {"norm": g.norm(dkey + "norm."),
                                   "reduction": g.linear(dkey + "reduction.")}
        params["stages"].append(stage)
    return params


def timm_window_size(sd, prefix: str = "") -> Optional[int]:
    """The window a timm Swin checkpoint was trained with, from its first
    relative-position table ((2w - 1)^2 rows), or None without one."""
    key = prefix + "layers.0.blocks.0.attn.relative_position_bias_table"
    if key not in sd:
        return None
    side = int(round(np.sqrt(np.shape(sd[key])[0])))
    return (side + 1) // 2
