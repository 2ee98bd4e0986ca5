"""SAM: the ViT image encoder, the prompt encoder and the mask decoder
(the last two shared by SAM and MobileSAM).

Counterpart of video_llava_tpu/models/sam.py: the ViT encoder behind
--sam_variant vit_b (windowed and global attention with SAM's decomposed
relative positions, the conv neck), the random-Fourier positional
encoding, box prompts, the two-way transformer, the 4x upscaling and the
hypernetwork mask heads; MobileSAM's TinyViT encoder is models/tiny_vit.py.
Parameters are the JAX package's nested dict; convert_hf_sam reads an HF
SamModel state dict, convert_official_sam_decoder the prompt encoder and
mask decoder of an official segment-anything / MobileSAM checkpoint.
"""

from __future__ import annotations

import dataclasses
import math
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
from video_llava_tpu_torch.models.tiny_vit import conv_nhwc


@dataclasses.dataclass(frozen=True)
class SamVisionConfig:
    image_size: int = 1024
    patch_size: int = 16
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    mlp_dim: int = 3072
    window_size: int = 14
    global_attn_indexes: Tuple[int, ...] = (2, 5, 8, 11)
    output_channels: int = 256
    layer_norm_eps: float = 1e-6

    @property
    def grid(self) -> int:
        return self.image_size // self.patch_size


@dataclasses.dataclass(frozen=True)
class SamConfig:
    vision: SamVisionConfig = dataclasses.field(default_factory=SamVisionConfig)
    prompt_hidden: int = 256
    decoder_heads: int = 8
    decoder_mlp_dim: int = 2048
    num_mask_tokens: int = 4  # 1 "whole" + 3 multimask
    layer_norm_eps: float = 1e-6

    @classmethod
    def tiny_test(cls):
        return cls(
            vision=SamVisionConfig(
                image_size=64, patch_size=8, hidden_size=32, num_layers=2,
                num_heads=2, mlp_dim=64, window_size=2,
                global_attn_indexes=(1,), output_channels=16),
            prompt_hidden=16, decoder_heads=2, decoder_mlp_dim=32)


def init_vision_params(init: TreeInit, cfg: SamVisionConfig):
    """Random ViT image-encoder parameters in the converter's layout:
    normal 0.02 kernels, position embedding and relative-position tables
    (the JAX package draws them through transformers.SamModel, which the
    port does not import), zero biases, unit norms. A global layer's
    tables span the whole grid, a windowed layer's its window."""
    d, hd = cfg.hidden_size, cfg.hidden_size // cfg.num_heads
    lin = lambda i, o: init.linear(i, o, std=0.02)  # noqa: E731
    layers = []
    for i in range(cfg.num_layers):
        size = cfg.grid if i in cfg.global_attn_indexes else cfg.window_size
        layers.append({
            "ln1": init.layer_norm(d), "qkv": lin(d, 3 * d),
            "proj": lin(d, d),
            "rel_pos_h": init.normal((2 * size - 1, hd), 0.02),
            "rel_pos_w": init.normal((2 * size - 1, hd), 0.02),
            "ln2": init.layer_norm(d), "fc1": lin(d, cfg.mlp_dim),
            "fc2": lin(cfg.mlp_dim, d)})
    oc = cfg.output_channels
    return {
        "patch_embed": lin(cfg.patch_size ** 2 * 3, d),
        "pos_embed": init.normal((1, cfg.grid, cfg.grid, d), 0.02),
        "layers": layers,
        "neck": {"conv1": init.normal((d, oc), 0.02),
                 "ln1": init.layer_norm(oc),
                 "conv2": init.normal((3, 3, oc, oc), 0.02),
                 "ln2": init.layer_norm(oc)},
    }


# -- vision encoder -------------------------------------------------------------


def _get_rel_pos(q_size: int, k_size: int,
                 rel_pos: torch.Tensor) -> torch.Tensor:
    """(2 max(q, k) - 1, d) table -> (q, k, d) relative positions
    (SAM's get_rel_pos; a table of another length is resampled linearly
    first, as SAM resamples it)."""
    max_dist = 2 * max(q_size, k_size) - 1
    if rel_pos.shape[0] != max_dist:
        rel_pos = F.interpolate(rel_pos.t()[None].float(), size=max_dist,
                                mode="linear")[0].t().to(rel_pos.dtype)
    dev = rel_pos.device
    q = torch.arange(q_size, device=dev,
                     dtype=torch.float32)[:, None] * max(k_size / q_size, 1.0)
    k = torch.arange(k_size, device=dev,
                     dtype=torch.float32)[None, :] * max(q_size / k_size, 1.0)
    idx = (q - k + (k_size - 1) * max(q_size / k_size, 1.0)).long()
    return rel_pos[idx]


def _vision_attention(p, x: torch.Tensor, num_heads: int) -> torch.Tensor:
    """x (B, H, W, C) -> the same, attention over all H * W positions with
    the decomposed relative positions (q . R_h + q . R_w) added to the
    logits, in f32."""
    b, hh, ww, c = x.shape
    hd = c // num_heads
    qkv = dense(p["qkv"], x.reshape(b, hh * ww, c)).reshape(
        b, hh * ww, 3, num_heads, hd)
    q, k, v = qkv[:, :, 0].float(), qkv[:, :, 1].float(), qkv[:, :, 2]
    scale = hd ** -0.5
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
    rh = _get_rel_pos(hh, hh, p["rel_pos_h"]).float()
    rw = _get_rel_pos(ww, ww, p["rel_pos_w"]).float()
    qg = q.reshape(b, hh, ww, num_heads, hd)
    bias_h = torch.einsum("byxhd,ykd->bhyxk", qg, rh) * scale
    bias_w = torch.einsum("byxhd,xkd->bhyxk", qg, rw) * scale
    logits = logits.reshape(b, num_heads, hh, ww, hh, ww)
    logits += bias_h[..., :, None]
    logits += bias_w[..., None, :]
    probs = torch.softmax(logits.reshape(b, num_heads, hh * ww, hh * ww),
                          dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", probs.to(v.dtype), v).to(x.dtype)
    return dense(p["proj"], out.reshape(b, hh * ww, c)).reshape(b, hh, ww, c)


def _window_partition_pad(x: torch.Tensor, w: int):
    b, hh, ww, c = x.shape
    ph, pw = -hh % w, -ww % w
    if ph or pw:
        x = F.pad(x, (0, 0, 0, pw, 0, ph))
    hp, wp = hh + ph, ww + pw
    wins = x.reshape(b, hp // w, w, wp // w, w, c).permute(0, 1, 3, 2, 4, 5)
    return wins.reshape(-1, w, w, c), (hp, wp)


def _window_unpartition(wins: torch.Tensor, w: int, pad_hw, hw):
    (hp, wp), (hh, ww) = pad_hw, hw
    b = wins.shape[0] // ((hp // w) * (wp // w))
    x = wins.reshape(b, hp // w, wp // w, w, w, -1).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, hp, wp, -1)[:, :hh, :ww]


def vision_encoder(params, pixels: torch.Tensor,
                   cfg: SamVisionConfig) -> torch.Tensor:
    """(b, H, W, 3) normalized pixels -> image embeddings (b, grid, grid,
    out_c), in the parameters' dtype: patch embedding, ViT blocks
    (windowed attention, global at cfg.global_attn_indexes), then the
    neck (1x1 conv, LayerNorm over channels, 3x3 conv, LayerNorm)."""
    ps = cfg.patch_size
    b, H, W, _ = pixels.shape
    pe = params["patch_embed"]
    x = pixels.reshape(b, H // ps, ps, W // ps, ps, 3).permute(
        0, 1, 3, 2, 4, 5).reshape(b, H // ps, W // ps, -1)
    x = dense(pe, x.to(pe["kernel"].dtype))
    x = x + params["pos_embed"][0].to(x.dtype)
    eps = cfg.layer_norm_eps
    for i, lp in enumerate(params["layers"]):
        h = norm(lp["ln1"], x, eps)
        if i in cfg.global_attn_indexes:
            h = _vision_attention(lp, h, cfg.num_heads)
        else:
            wins, pad_hw = _window_partition_pad(h, cfg.window_size)
            h = _window_unpartition(
                _vision_attention(lp, wins, cfg.num_heads), cfg.window_size,
                pad_hw, (x.shape[1], x.shape[2]))
        x = x + h
        h = norm(lp["ln2"], x, eps)
        x = x + dense(lp["fc2"], F.gelu(dense(lp["fc1"], h)))
    neck = params["neck"]
    x = norm(neck["ln1"], torch.matmul(x, neck["conv1"].to(x.dtype)), eps)
    return norm(neck["ln2"], conv_nhwc(x, neck["conv2"]), eps)


def init_decoder_params(init: TreeInit, cfg: SamConfig):
    """Random prompt-encoder + mask-decoder parameters in the converter's
    layout (HF SamModel's init: normal 0.02 linears and tokens, a unit
    normal Fourier matrix), with SAM's two two-way layers and its
    256-wide IoU head."""
    d = cfg.prompt_hidden
    lin = lambda i, o: init.linear(i, o, std=0.02)  # noqa: E731

    def attn(down: int):
        inner = d // down
        return {"q": lin(d, inner), "k": lin(d, inner), "v": lin(d, inner),
                "o": lin(inner, d)}

    def mlp3(i, h, o):
        return {"lin0": lin(i, h), "lin1": lin(h, h), "lin2": lin(h, o)}

    def up(ci, co):
        return {"kernel": init.normal((ci, co, 2, 2), (ci * 4) ** -0.5),
                "bias": init.zeros((co,))}

    return {
        "shared_pe": init.normal((2, d // 2), 1.0),
        "point_embed": init.normal((4, d), 1.0),
        "no_mask_embed": init.normal((1, d), 1.0),
        "mask_decoder": {
            "iou_token": init.normal((1, d), 1.0),
            "mask_tokens": init.normal((cfg.num_mask_tokens, d), 1.0),
            "layers": [{
                "self_attn": attn(1), "ln1": init.layer_norm(d),
                "cross_attn_t2i": attn(2), "ln2": init.layer_norm(d),
                "fc1": lin(d, cfg.decoder_mlp_dim),
                "fc2": lin(cfg.decoder_mlp_dim, d),
                "ln3": init.layer_norm(d), "ln4": init.layer_norm(d),
                "cross_attn_i2t": attn(2),
            } for _ in range(2)],
            "final_attn": attn(2),
            "ln_final": init.layer_norm(d),
            "up1": up(d, d // 4),
            "up_ln": init.layer_norm(d // 4),
            "up2": up(d // 4, d // 8),
            "hyper_mlps": [mlp3(d, d, d // 8)
                           for _ in range(cfg.num_mask_tokens)],
            "iou_head": mlp3(d, 256, cfg.num_mask_tokens),
        },
    }


# -- prompt encoder -----------------------------------------------------------


def _pe_encode(coords: torch.Tensor, gaussian: torch.Tensor) -> torch.Tensor:
    """coords in [0, 1] (..., 2) -> (..., 2 * feat) random-Fourier PE."""
    c = 2.0 * coords - 1.0
    proj = (c @ gaussian.float()) * (2.0 * np.pi)
    return torch.cat([torch.sin(proj), torch.cos(proj)], dim=-1)


def image_positional_embedding(params, grid: int) -> torch.Tensor:
    """(grid, grid, d) encoding of the cell centers."""
    dev = params["shared_pe"].device
    c = (torch.arange(grid, dtype=torch.float32, device=dev) + 0.5) / grid
    ys, xs = torch.meshgrid(c, c, indexing="ij")
    return _pe_encode(torch.stack([xs, ys], dim=-1), params["shared_pe"])


def encode_boxes(params, boxes: torch.Tensor, image_size: int) -> torch.Tensor:
    """boxes (b, n, 4) xyxy input pixels -> (b, 2n, d) sparse embeddings:
    +0.5 pixel-center shift, corner embeddings 2 and 3."""
    b, n, _ = boxes.shape
    pts = (boxes.reshape(b, n, 2, 2) + 0.5) / image_size
    pe = _pe_encode(pts, params["shared_pe"])
    corner = params["point_embed"][2:4].float()  # (2, d)
    return (pe + corner).reshape(b, n * 2, -1)


# -- mask decoder ---------------------------------------------------------------


def _attention(p, q, k, v, num_heads: int):
    b, nq, _ = q.shape
    nk = k.shape[1]
    qh, kh, vh = dense(p["q"], q), dense(p["k"], k), dense(p["v"], v)
    inner = qh.shape[-1]
    hd = inner // num_heads
    logits = torch.einsum("bqhd,bkhd->bhqk",
                          qh.reshape(b, nq, num_heads, hd).float(),
                          kh.reshape(b, nk, num_heads, hd).float())
    probs = torch.softmax(logits / math.sqrt(hd), dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", probs,
                       vh.reshape(b, nk, num_heads, hd).float()).to(q.dtype)
    return dense(p["o"], out.reshape(b, nq, inner))


def _two_way_layer(p, queries, keys, query_pe, key_pe, heads, eps,
                   skip_first_pe: bool):
    if skip_first_pe:
        queries = queries + _attention(p["self_attn"], queries, queries,
                                       queries, heads)
    else:
        q = queries + query_pe
        queries = queries + _attention(p["self_attn"], q, q, queries, heads)
    queries = norm(p["ln1"], queries, eps)
    q, k = queries + query_pe, keys + key_pe
    queries = norm(p["ln2"], queries + _attention(p["cross_attn_t2i"], q, k,
                                                  keys, heads), eps)
    queries = norm(p["ln3"], queries + dense(
        p["fc2"], F.relu(dense(p["fc1"], queries))), eps)
    q, k = queries + query_pe, keys + key_pe
    keys = norm(p["ln4"], keys + _attention(p["cross_attn_i2t"], k, q,
                                            queries, heads), eps)
    return queries, keys


def _mlp3(p, x):
    x = F.relu(dense(p["lin0"], x))
    x = F.relu(dense(p["lin1"], x))
    return dense(p["lin2"], x)


def _conv_t(x, w, bias):
    """Stride-2, kernel-2 transposed conv, w (in, out, 2, 2), NHWC."""
    y = torch.einsum("bhwc,coij->bhiwjo", x.float(), w.float())
    b, hh, _, ww, _, o = y.shape
    return y.reshape(b, hh * 2, ww * 2, o).to(x.dtype) + bias


def decode_masks(params, image_embeddings: torch.Tensor,
                 sparse_prompts: torch.Tensor, cfg: SamConfig,
                 multimask: bool = True):
    """-> (masks (b, n_masks, 4g, 4g) logits, iou_pred (b, n_masks))."""
    dec = params["mask_decoder"]
    b, g, _, d = image_embeddings.shape
    eps = cfg.layer_norm_eps
    out_tokens = torch.cat([dec["iou_token"], dec["mask_tokens"]], dim=0)
    tokens = torch.cat([out_tokens.expand((b,) + out_tokens.shape),
                        sparse_prompts], dim=1)
    src = (image_embeddings + params["no_mask_embed"][0]).reshape(b, g * g, d)
    pos = image_positional_embedding(params, g).reshape(1, g * g, d).expand(
        b, g * g, d).to(src.dtype)
    queries, keys = tokens, src
    for i, lp in enumerate(dec["layers"]):
        queries, keys = _two_way_layer(lp, queries, keys, tokens, pos,
                                       cfg.decoder_heads, eps,
                                       skip_first_pe=(i == 0))
    q, k = queries + tokens, keys + pos
    queries = norm(dec["ln_final"], queries + _attention(
        dec["final_attn"], q, k, keys, cfg.decoder_heads), eps)
    iou_token_out = queries[:, 0]
    mask_tokens_out = queries[:, 1:1 + cfg.num_mask_tokens]

    x = keys.reshape(b, g, g, d)
    x = _conv_t(x, dec["up1"]["kernel"], dec["up1"]["bias"])
    x = F.gelu(norm(dec["up_ln"], x, eps))
    x = F.gelu(_conv_t(x, dec["up2"]["kernel"], dec["up2"]["bias"]))
    hyper = torch.stack([_mlp3(dec["hyper_mlps"][i], mask_tokens_out[:, i])
                         for i in range(cfg.num_mask_tokens)], dim=1)
    masks = torch.einsum("bnc,bhwc->bnhw", hyper.float(), x.float())
    iou = _mlp3(dec["iou_head"], iou_token_out)
    if multimask:
        return masks[:, 1:], iou[:, 1:]
    return masks[:, :1], iou[:, :1]


def predict_from_embeddings(params, emb: torch.Tensor, boxes: torch.Tensor,
                            cfg: SamConfig, multimask: bool = True):
    """emb (b, g, g, d), boxes (b, n, 4) xyxy pixels -> (masks (b, n,
    n_masks, 4g, 4g), iou (b, n, n_masks)); each box decodes alone."""
    b, n, _ = boxes.shape
    sparse = encode_boxes(params, boxes, cfg.vision.image_size).reshape(
        b * n, 2, -1)
    masks, iou = decode_masks(params, emb.repeat_interleave(n, dim=0),
                              sparse.to(emb.dtype), cfg, multimask)
    g4 = emb.shape[1] * 4
    return masks.reshape(b, n, -1, g4, g4), iou.reshape(b, n, -1)


def predict_boxes(params, pixels, boxes, cfg: SamConfig, encode,
                  multimask: bool = True):
    """Encode with `encode(params, pixels)`, then predict_from_embeddings
    (the JAX package's predict_boxes with its encoder passed in)."""
    return predict_from_embeddings(params, encode(params, pixels), boxes,
                                   cfg, multimask)


# -- checkpoint conversion ------------------------------------------------------


def _attn(g: StateDictView, prefix: str) -> dict:
    return {ours: g.linear(f"{prefix}{theirs}_proj.")
            for ours, theirs in (("q", "q"), ("k", "k"), ("v", "v"),
                                 ("o", "out"))}


def _two_way_layers(g: StateDictView, norm_name: str) -> list:
    """The mask decoder's two-way layers, as many as the checkpoint
    has; norm_name 'norm{}' (official) or 'layer_norm{}.' (HF)."""
    layers, i = [], 0
    while f"mask_decoder.transformer.layers.{i}.self_attn.q_proj.weight" in g:
        p = f"mask_decoder.transformer.layers.{i}."
        n = lambda j: g.norm(p + norm_name.format(j))  # noqa: E731
        layers.append({
            "self_attn": _attn(g, p + "self_attn."), "ln1": n(1),
            "cross_attn_t2i": _attn(g, p + "cross_attn_token_to_image."),
            "ln2": n(2), "fc1": g.linear(p + "mlp.lin1."),
            "fc2": g.linear(p + "mlp.lin2."), "ln3": n(3), "ln4": n(4),
            "cross_attn_i2t": _attn(g, p + "cross_attn_image_to_token."),
        })
        i += 1
    return layers


def convert_official_sam_decoder(sd, cfg: SamConfig, device=None,
                                 dtype: torch.dtype = torch.float32) -> dict:
    """An official segment-anything / MobileSAM checkpoint's
    prompt_encoder.* and mask_decoder.* keys (mobile_sam.pt,
    sam_vit_*.pth) -> the non-vision parameters (JAX
    convert_official_sam_decoder's): pe_layer's Gaussian matrix,
    point_embeddings.{i}, norm{1..4}, output_upscaling.{0,1,3}, MLPs as
    layers.{0,1,2}. Pair it with tiny_vit.convert_tiny_vit for
    MobileSAM."""
    g = StateDictView(sd, device, dtype)

    def mlp3(prefix):
        return {f"lin{i}": g.linear(f"{prefix}layers.{i}.") for i in range(3)}

    md = "mask_decoder."
    return {
        "shared_pe": g("prompt_encoder.pe_layer."
                       "positional_encoding_gaussian_matrix"),
        "point_embed": torch.stack([
            g(f"prompt_encoder.point_embeddings.{i}.weight")[0]
            for i in range(4)]),
        "no_mask_embed": g("prompt_encoder.no_mask_embed.weight"),
        "mask_decoder": {
            "iou_token": g(md + "iou_token.weight"),
            "mask_tokens": g(md + "mask_tokens.weight"),
            "layers": _two_way_layers(g, "norm{}."),
            "final_attn": _attn(g, md + "transformer."
                                "final_attn_token_to_image."),
            "ln_final": g.norm(md + "transformer.norm_final_attn."),
            # ConvTranspose2d weights (in, out, kH, kW): _conv_t's layout
            "up1": {"kernel": g(md + "output_upscaling.0.weight"),
                    "bias": g(md + "output_upscaling.0.bias")},
            "up_ln": g.norm(md + "output_upscaling.1."),
            "up2": {"kernel": g(md + "output_upscaling.3.weight"),
                    "bias": g(md + "output_upscaling.3.bias")},
            "hyper_mlps": [mlp3(f"{md}output_hypernetworks_mlps.{i}.")
                           for i in range(cfg.num_mask_tokens)],
            "iou_head": mlp3(md + "iou_prediction_head."),
        },
    }


def convert_hf_sam(sd, cfg: SamConfig, device=None,
                   dtype: torch.dtype = torch.float32) -> dict:
    """An HF SamModel state dict (facebook/sam-vit-*) -> the whole
    parameter tree, the ViT encoder under 'vision' (JAX
    convert_hf_sam's)."""
    g = StateDictView(sd, device, dtype)
    v = cfg.vision
    ve = "vision_encoder."
    layers = []
    for i in range(v.num_layers):
        p = f"{ve}layers.{i}."
        layers.append({
            "ln1": g.norm(p + "layer_norm1."),
            "qkv": g.linear(p + "attn.qkv."),
            "proj": g.linear(p + "attn.proj."),
            "rel_pos_h": g(p + "attn.rel_pos_h"),
            "rel_pos_w": g(p + "attn.rel_pos_w"),
            "ln2": g.norm(p + "layer_norm2."),
            "fc1": g.linear(p + "mlp.lin1."),
            "fc2": g.linear(p + "mlp.lin2."),
        })

    def mlp3(prefix):
        return {"lin0": g.linear(prefix + "proj_in."),
                "lin1": g.linear(prefix + "layers.0."),
                "lin2": g.linear(prefix + "proj_out.")}

    md = "mask_decoder."
    return {
        "vision": {
            "patch_embed": {
                "kernel": g(ve + "patch_embed.projection.weight").permute(
                    2, 3, 1, 0).reshape(-1, v.hidden_size).contiguous(),
                "bias": g(ve + "patch_embed.projection.bias")},
            "pos_embed": g(ve + "pos_embed"),
            "layers": layers,
            "neck": {
                "conv1": g(ve + "neck.conv1.weight")[:, :, 0, 0].t()
                .contiguous(),
                "ln1": g.norm(ve + "neck.layer_norm1."),
                "conv2": g(ve + "neck.conv2.weight").permute(2, 3, 1, 0)
                .contiguous(),
                "ln2": g.norm(ve + "neck.layer_norm2."),
            },
        },
        "shared_pe": g("prompt_encoder.shared_embedding.positional_embedding"),
        "point_embed": torch.stack([
            g(f"prompt_encoder.point_embed.{i}.weight")[0] for i in range(4)]),
        "no_mask_embed": g("prompt_encoder.no_mask_embed.weight"),
        "mask_decoder": {
            "iou_token": g(md + "iou_token.weight"),
            "mask_tokens": g(md + "mask_tokens.weight"),
            "layers": _two_way_layers(g, "layer_norm{}."),
            "final_attn": _attn(g, md + "transformer."
                                "final_attn_token_to_image."),
            "ln_final": g.norm(md + "transformer.layer_norm_final_attn."),
            "up1": {"kernel": g(md + "upscale_conv1.weight"),
                    "bias": g(md + "upscale_conv1.bias")},
            "up2": {"kernel": g(md + "upscale_conv2.weight"),
                    "bias": g(md + "upscale_conv2.bias")},
            "up_ln": g.norm(md + "upscale_layer_norm."),
            "hyper_mlps": [mlp3(f"{md}output_hypernetworks_mlps.{i}.")
                           for i in range(cfg.num_mask_tokens)],
            "iou_head": mlp3(md + "iou_prediction_head."),
        },
    }
