"""Grounding DINO, the open-vocabulary detector of the grounded chat path.

Counterpart of video_llava_tpu/models/grounding_dino.py (HF
GroundingDinoForObjectDetection's architecture and parameter layout):
Swin backbone (three stages plus one stride-2 conv level), BERT text
tower and projection, six encoder layers (bi-attention fusion, text
enhancer, deformable self-attention), two-stage top-900 query selection,
six decoder layers (self-attention, text cross-attention, deformable
cross-attention) with iterative box refinement, and the contrastive class
head. Every deformable attention goes through ops/deformable.py (kernel
12 on CUDA tensors: 6 encoder + 6 decoder launches a forward).
convert_hf_grounding_dino and convert_original_grounding_dino read the
HF and the original-repo (groundingdino_swint_ogc.pth) state dicts.
"""

from __future__ import annotations

import dataclasses
import math
import os
import warnings
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from video_llava_tpu_torch.models import bert as bert_mod
from video_llava_tpu_torch.models import swin as swin_mod
from video_llava_tpu_torch.models.bert import BertConfig
from video_llava_tpu_torch.models.layers import (
    StateDictView,
    TreeInit,
    dense,
    norm,
)
from video_llava_tpu_torch.models.swin import SwinConfig
from video_llava_tpu_torch.ops.deformable import (
    multi_scale_deformable_attention,
)
from video_llava_tpu_torch.ops.image import normalize_clip, resize_bicubic
from video_llava_tpu_torch.ops.topk import stable_topk

# BERT ids for [CLS], [SEP], '.', '?' (prompt phrase separators).
SPECIAL_TOKENS = (101, 102, 1012, 1029)


@dataclasses.dataclass(frozen=True)
class GroundingDinoConfig:
    d_model: int = 256
    num_queries: int = 900
    encoder_layers: int = 6
    decoder_layers: int = 6
    encoder_attention_heads: int = 8
    decoder_attention_heads: int = 8
    encoder_ffn_dim: int = 2048
    decoder_ffn_dim: int = 2048
    encoder_n_points: int = 4
    decoder_n_points: int = 4
    num_feature_levels: int = 4
    max_text_len: int = 256
    layer_norm_eps: float = 1e-5
    positional_embedding_temperature: float = 20.0
    swin: SwinConfig = dataclasses.field(default_factory=SwinConfig.swin_t)
    text: BertConfig = dataclasses.field(default_factory=BertConfig)
    backbone_stage_indices: Tuple[int, ...] = (1, 2, 3)

    @classmethod
    def tiny_test(cls):
        return cls(d_model=32, num_queries=20, encoder_layers=2,
                   decoder_layers=2, encoder_attention_heads=4,
                   decoder_attention_heads=4, encoder_ffn_dim=64,
                   decoder_ffn_dim=64, num_feature_levels=3, max_text_len=32,
                   swin=SwinConfig.tiny_test(), text=BertConfig.tiny_test(),
                   backbone_stage_indices=(0, 1))


# -- random parameters -----------------------------------------------------------


def _deform_init(init: TreeInit, d: int, heads: int, levels: int,
                 points: int):
    """HF's MSDeformAttn init: zero offset kernels whose bias places the
    points on rays around the reference point, uniform attention weights,
    Xavier value/output projections."""
    theta = torch.arange(heads, dtype=torch.float32) * (2.0 * math.pi / heads)
    grid = torch.stack([theta.cos(), theta.sin()], -1)
    grid = grid / grid.abs().max(-1, keepdim=True).values
    grid = grid[:, None, None, :].repeat(1, levels, points, 1)
    grid = grid * torch.arange(1, points + 1, dtype=torch.float32)[
        None, None, :, None]
    xavier = math.sqrt(6.0 / (2 * d))
    n = heads * levels * points
    return {
        "sampling_offsets": {"kernel": init.zeros((d, n * 2)),
                             "bias": grid.reshape(-1).to(init.device,
                                                         init.dtype)},
        "attention_weights": {"kernel": init.zeros((d, n)),
                              "bias": init.zeros((n,))},
        "value_proj": {"kernel": init.uniform((d, d), -xavier, xavier),
                       "bias": init.zeros((d,))},
        "output_proj": {"kernel": init.uniform((d, d), -xavier, xavier),
                        "bias": init.zeros((d,))},
    }


def init_params(init: TreeInit, cfg: GroundingDinoConfig):
    """Random parameters in the converter's layout, drawn as HF's
    GroundingDinoForObjectDetection initializes them (normal 0.02
    linears and embeddings, 1e-4 fusion gates, the deformable init above;
    the Swin backbone as swin.init_params, BERT as bert.init_params)."""
    d = cfg.d_model
    lin = lambda i, o: init.linear(i, o, std=0.02)  # noqa: E731
    ln = init.layer_norm

    def mha():
        return {"q": lin(d, d), "k": lin(d, d), "v": lin(d, d),
                "o": lin(d, d)}

    def mlp(dims):
        return {f"layer{i}": lin(a, b)
                for i, (a, b) in enumerate(zip(dims[:-1], dims[1:]))}

    fd = cfg.encoder_ffn_dim // 2
    enc = [{
        "fusion": {
            "ln_vision": ln(d), "ln_text": ln(d),
            "vision_param": init.full((d,), 1e-4),
            "text_param": init.full((d,), 1e-4),
            "vision_proj": lin(d, fd), "text_proj": lin(d, fd),
            "values_vision_proj": lin(d, fd), "values_text_proj": lin(d, fd),
            "out_vision_proj": lin(fd, d), "out_text_proj": lin(fd, d),
        },
        "text_enhancer": {"attn": mha(),
                          "fc1": lin(d, fd), "fc2": lin(fd, d),
                          "ln1": ln(d), "ln2": ln(d)},
        "deformable": {
            **_deform_init(init, d, cfg.encoder_attention_heads,
                           cfg.num_feature_levels, cfg.encoder_n_points),
            "ln1": ln(d), "fc1": lin(d, cfg.encoder_ffn_dim),
            "fc2": lin(cfg.encoder_ffn_dim, d), "ln2": ln(d)},
    } for _ in range(cfg.encoder_layers)]
    dec = [{
        "self_attn": mha(), "self_attn_ln": ln(d),
        "text_cross_attn": mha(),
        "text_cross_attn_ln": ln(d),
        "deform_cross_attn": _deform_init(init, d, cfg.decoder_attention_heads,
                                          cfg.num_feature_levels,
                                          cfg.decoder_n_points),
        "deform_cross_attn_ln": ln(d),
        "fc1": lin(d, cfg.decoder_ffn_dim), "fc2": lin(cfg.decoder_ffn_dim, d),
        "final_ln": ln(d),
    } for _ in range(cfg.decoder_layers)]

    stage_dims = [cfg.swin.embed_dim * 2 ** i
                  for i in range(cfg.swin.num_stages)]
    n_backbone = len(cfg.backbone_stage_indices)
    input_proj = []
    for i in range(cfg.num_feature_levels):
        if i < n_backbone:
            ci = stage_dims[cfg.backbone_stage_indices[i]]
            kernel = init.uniform((ci, d), -math.sqrt(6 / (ci + d)),
                                  math.sqrt(6 / (ci + d)))
        else:
            ci = stage_dims[cfg.backbone_stage_indices[-1]] if i == n_backbone \
                else d
            bound = math.sqrt(6 / (9 * (ci + d)))
            kernel = init.uniform((3, 3, ci, d), -bound, bound)
        input_proj.append({"conv": {"kernel": kernel, "bias": init.zeros((d,))},
                           "gn": ln(d)})
    return {
        "swin": swin_mod.init_params(init, cfg.swin),
        "backbone_norms": [ln(stage_dims[si])
                           for si in cfg.backbone_stage_indices],
        "input_proj": input_proj,
        "text_backbone": bert_mod.init_params(init, cfg.text),
        "text_projection": lin(cfg.text.hidden_size, d),
        "level_embed": init.normal((cfg.num_feature_levels, d), 1.0),
        "encoder_layers": enc,
        "decoder_layers": dec,
        "enc_output": lin(d, d),
        "enc_output_norm": ln(d),
        "encoder_bbox_head": mlp((d, d, d, 4)),
        "query_embeds": init.normal((cfg.num_queries, d), 1.0),
        "ref_point_head": mlp((2 * d, d, d)),
        "decoder_norm": ln(d),
        "bbox_heads": [mlp((d, d, d, 4)) for _ in range(cfg.decoder_layers)],
    }


# -- host-side text masks ----------------------------------------------------------


def generate_text_masks(input_ids: np.ndarray):
    """Block-diagonal self-attention between special tokens + restarted
    position ids (HF generate_masks_with_special_tokens_and_transfer_map)."""
    b, n = input_ids.shape
    special = np.isin(input_ids, SPECIAL_TOKENS)
    attention_mask = np.eye(n, dtype=bool)[None].repeat(b, axis=0)
    position_ids = np.zeros((b, n), np.int64)
    for row in range(b):
        previous_col = 0
        for col in np.nonzero(special[row])[0]:
            if col == 0 or col == n - 1:
                attention_mask[row, col, col] = True
                position_ids[row, col] = 0
            else:
                attention_mask[row, previous_col + 1:col + 1,
                               previous_col + 1:col + 1] = True
                position_ids[row, previous_col + 1:col + 1] = np.arange(
                    0, col - previous_col)
            previous_col = col
    return attention_mask, position_ids


# -- positional encodings ------------------------------------------------------------


def sine_position_2d(h: int, w: int, d_model: int, temperature: float,
                     device=None) -> torch.Tensor:
    """DETR sine embedding of an unpadded (h, w) map -> (h*w, d_model)."""
    half = d_model // 2
    scale, eps = 2 * math.pi, 1e-6
    y = (torch.arange(h, dtype=torch.float32, device=device) + 1.0) / (
        h + eps) * scale
    x = (torch.arange(w, dtype=torch.float32, device=device) + 1.0) / (
        w + eps) * scale
    dim_t = torch.arange(half, dtype=torch.float32, device=device)
    dim_t = temperature ** (2 * torch.floor(dim_t / 2) / half)
    pos_x, pos_y = x[:, None] / dim_t, y[:, None] / dim_t
    pos_x = torch.stack([pos_x[:, 0::2].sin(), pos_x[:, 1::2].cos()],
                        dim=2).reshape(w, -1)
    pos_y = torch.stack([pos_y[:, 0::2].sin(), pos_y[:, 1::2].cos()],
                        dim=2).reshape(h, -1)
    pos = torch.cat([pos_y[:, None, :].expand(h, w, half),
                     pos_x[None, :, :].expand(h, w, half)], dim=-1)
    return pos.reshape(h * w, d_model)


def get_sine_pos_embed(pos: torch.Tensor, num_pos_feats: int = 128,
                       temperature: float = 10000.0,
                       exchange_xy: bool = True) -> torch.Tensor:
    """(..., n) -> (..., n * num_pos_feats)."""
    dim_t = torch.arange(num_pos_feats, dtype=torch.float32, device=pos.device)
    dim_t = temperature ** (2 * torch.floor(dim_t / 2) / num_pos_feats)

    def sine(x):
        s = x * (2 * math.pi) / dim_t
        return torch.stack([s[..., 0::2].sin(), s[..., 1::2].cos()],
                           dim=-1).reshape(*x.shape[:-1], -1)

    parts = [sine(pos[..., i:i + 1]) for i in range(pos.shape[-1])]
    if exchange_xy and len(parts) >= 2:
        parts[0], parts[1] = parts[1], parts[0]
    return torch.cat(parts, dim=-1)


# -- small modules ---------------------------------------------------------------


def group_norm(p, x, num_groups: int = 32, eps: float = 1e-5):
    """x (b, h, w, c) channel-last GroupNorm, torch semantics."""
    b, h, w, c = x.shape
    g = min(num_groups, c)
    xs = x.reshape(b, h * w, g, c // g).float()
    mean = xs.mean(dim=(1, 3), keepdim=True)
    var = xs.var(dim=(1, 3), keepdim=True, unbiased=False)
    xs = ((xs - mean) * torch.rsqrt(var + eps)).reshape(b, h, w, c)
    return (xs * p["scale"] + p["bias"]).to(x.dtype)


def _mha(p, q, k, v, num_heads: int, bias=None):
    b, nq, d = q.shape
    nk = k.shape[1]
    hd = d // num_heads
    qh = dense(p["q"], q).reshape(b, nq, num_heads, hd)
    kh = dense(p["k"], k).reshape(b, nk, num_heads, hd)
    vh = dense(p["v"], v).reshape(b, nk, num_heads, hd)
    logits = torch.einsum("bqhd,bkhd->bhqk", qh.float(),
                          kh.float()) / math.sqrt(hd)
    if bias is not None:
        logits = logits + bias
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", probs.to(vh.dtype), vh).to(q.dtype)
    return dense(p["o"], out.reshape(b, nq, d))


def _deformable_attention(p, hidden, value_states, pos, reference_points,
                          spatial_shapes, num_heads: int, n_points: int):
    d = hidden.shape[-1]
    n_levels = len(spatial_shapes)
    if pos is not None:
        hidden = hidden + pos
    b, nq, _ = hidden.shape
    value = dense(p["value_proj"], value_states).reshape(b, -1, num_heads,
                                                        d // num_heads)
    offsets = dense(p["sampling_offsets"], hidden).reshape(
        b, nq, num_heads, n_levels, n_points, 2)
    weights = torch.softmax(dense(p["attention_weights"], hidden).reshape(
        b, nq, num_heads, n_levels * n_points), dim=-1).reshape(
            b, nq, num_heads, n_levels, n_points)
    if reference_points.shape[-1] == 2:
        normalizer = torch.tensor([[w, h] for (h, w) in spatial_shapes],
                                  dtype=torch.float32, device=hidden.device)
        locs = (reference_points[:, :, None, :, None, :]
                + offsets / normalizer[None, None, None, :, None, :])
    else:
        locs = (reference_points[:, :, None, :, None, :2]
                + offsets / n_points
                * reference_points[:, :, None, :, None, 2:] * 0.5)
    out = multi_scale_deformable_attention(value, spatial_shapes, locs,
                                           weights)
    return dense(p["output_proj"], out)


def _bi_attention(p, vision, text, text_pad_mask, num_heads: int,
                  head_dim: int):
    """Bidirectional vision <-> text cross attention -> (delta_v, delta_t)."""
    b, nv, _ = vision.shape
    nt = text.shape[1]
    embed_dim = num_heads * head_dim
    vq = (dense(p["vision_proj"], vision) * head_dim ** -0.5).reshape(
        b, nv, num_heads, head_dim)
    tk = dense(p["text_proj"], text).reshape(b, nt, num_heads, head_dim)
    vv = dense(p["values_vision_proj"], vision).reshape(b, nv, num_heads,
                                                        head_dim)
    tv = dense(p["values_text_proj"], text).reshape(b, nt, num_heads,
                                                    head_dim)
    attn = torch.einsum("bvhd,bthd->bhvt", vq.float(), tk.float())
    attn = (attn - attn.max()).clamp(-50000, 50000)
    attn_t = attn.transpose(2, 3)
    attn_t = (attn_t - attn_t.amax(-1, keepdim=True)).clamp(-50000, 50000)
    if text_pad_mask is not None:
        # a row whose text is all padding softmaxes to NaN, as in JAX
        attn = attn.masked_fill(text_pad_mask[:, None, None, :],
                                float("-inf"))
    v_probs = torch.softmax(attn, dim=-1)
    t_probs = torch.softmax(attn_t, dim=-1)
    delta_v = torch.einsum("bhvt,bthd->bvhd", v_probs.to(tv.dtype),
                           tv).to(vision.dtype).reshape(b, nv, embed_dim)
    delta_t = torch.einsum("bhtv,bvhd->bthd", t_probs.to(vv.dtype),
                           vv).to(text.dtype).reshape(b, nt, embed_dim)
    return (dense(p["out_vision_proj"], delta_v),
            dense(p["out_text_proj"], delta_t))


def _encoder_layer(p, cfg: GroundingDinoConfig, vision, text, vision_pos,
                   reference_points, spatial_shapes, text_pad_mask,
                   text_self_mask, text_position_ids):
    eps = cfg.layer_norm_eps
    fu = p["fusion"]
    vn, tn = norm(fu["ln_vision"], vision, eps), norm(fu["ln_text"], text, eps)
    heads = cfg.encoder_attention_heads // 2
    delta_v, delta_t = _bi_attention(fu, vn, tn, text_pad_mask, heads,
                                     cfg.encoder_ffn_dim // 2 // heads)
    vision = vn + fu["vision_param"] * delta_v
    text = tn + fu["text_param"] * delta_t

    te = p["text_enhancer"]
    text_pos = get_sine_pos_embed(text_position_ids[..., None].float(),
                                  num_pos_feats=cfg.d_model,
                                  exchange_xy=False).to(text.dtype)
    q = text + text_pos
    bias = torch.where(text_self_mask[:, None], 0.0, float("-inf"))
    attn = _mha(te["attn"], q, q, text, heads, bias=bias)
    text = norm(te["ln1"], text + attn, eps)
    h = F.relu(dense(te["fc1"], text))
    text = norm(te["ln2"], text + dense(te["fc2"], h), eps)

    de = p["deformable"]
    attn = _deformable_attention(de, vision, vision, vision_pos,
                                 reference_points, spatial_shapes,
                                 cfg.encoder_attention_heads,
                                 cfg.encoder_n_points)
    vision = norm(de["ln1"], vision + attn, eps)
    h = F.relu(dense(de["fc1"], vision))
    vision = norm(de["ln2"], vision + dense(de["fc2"], h), eps)
    return vision, text


def _decoder_layer(p, cfg: GroundingDinoConfig, hidden, query_pos,
                   reference_points_input, spatial_shapes, vision_states,
                   text_states, text_pad_mask):
    eps = cfg.layer_norm_eps
    heads = cfg.decoder_attention_heads
    q = hidden + query_pos
    hidden = norm(p["self_attn_ln"],
                  hidden + _mha(p["self_attn"], q, q, hidden, heads), eps)
    q = hidden + query_pos
    bias = None
    if text_pad_mask is not None:
        bias = torch.where(text_pad_mask[:, None, None, :], -1e9, 0.0)
    attn = _mha(p["text_cross_attn"], q, text_states, text_states, heads,
                bias=bias)
    hidden = norm(p["text_cross_attn_ln"], hidden + attn, eps)
    attn = _deformable_attention(p["deform_cross_attn"], hidden,
                                 vision_states, query_pos,
                                 reference_points_input, spatial_shapes,
                                 heads, cfg.decoder_n_points)
    hidden = norm(p["deform_cross_attn_ln"], hidden + attn, eps)
    h = F.relu(dense(p["fc1"], hidden))
    return norm(p["final_ln"], hidden + dense(p["fc2"], h), eps)


def _mlp_head(p, x, num_layers: int = 3):
    for i in range(num_layers - 1):
        x = F.relu(dense(p[f"layer{i}"], x))
    return dense(p[f"layer{num_layers - 1}"], x)


def _inverse_sigmoid(x, eps=1e-5):
    x = x.clamp(eps, 1 - eps)
    return torch.log(x / (1 - x))


def _contrastive(queries, text, text_token_mask, max_text_len: int):
    out = torch.einsum("bqd,btd->bqt", queries.float(), text.float())
    out = out.masked_fill(~text_token_mask[:, None, :], float("-inf"))
    pad = max_text_len - out.shape[-1]
    if pad > 0:
        out = F.pad(out, (0, pad), value=float("-inf"))
    return out[..., :max_text_len]


# -- the model --------------------------------------------------------------------


def forward(params, cfg: GroundingDinoConfig, pixels: torch.Tensor,
            input_ids: np.ndarray,
            text_attention_mask: Optional[np.ndarray] = None):
    """pixels (b, H, W, 3) normalized, input_ids (b, text_len) host BERT
    ids -> (logits (b, num_queries, max_text_len), boxes cxcywh in [0, 1]
    (b, num_queries, 4)). Text masks come from the token values, on the
    host."""
    input_ids = np.asarray(input_ids)
    if text_attention_mask is None:
        text_attention_mask = np.ones_like(input_ids)
    self_mask, position_ids = generate_text_masks(input_ids)
    dev = pixels.device
    t = lambda a: torch.as_tensor(np.array(a), device=dev)  # noqa: E731
    return _forward_device(params, cfg, pixels, t(input_ids),
                           t(text_attention_mask == 0), t(self_mask),
                           t(position_ids), t(text_attention_mask == 1))


def _forward_device(params, cfg: GroundingDinoConfig, pixels, input_ids,
                    text_pad_mask, text_self_mask, position_ids,
                    text_token_mask, stage: Optional[str] = None):
    # `stage` truncates the forward after a pipeline stage and returns
    # that stage's output, as the JAX package's does — a profiling knob
    # (scripts/profile_gdino.py): successive-prefix timings decompose the
    # forward; stage=None is the shipped forward.
    b = pixels.shape[0]
    d = cfg.d_model
    eps = cfg.layer_norm_eps
    dev = pixels.device

    bert_bias = torch.where(text_self_mask[:, None], 0.0, -1e9)
    text = bert_mod.forward(params["text_backbone"], input_ids, None,
                            cfg.text, attention_bias=bert_bias,
                            position_ids=position_ids)
    text = dense(params["text_projection"], text)
    if stage == "text":
        return text, text

    stages = swin_mod.forward_features(params["swin"], pixels, cfg.swin)
    feature_maps = [norm(params["backbone_norms"][i], stages[si], eps)
                    for i, si in enumerate(cfg.backbone_stage_indices)]
    projected = []
    spatial_shapes: List[Tuple[int, int]] = []
    for i, f in enumerate(feature_maps):
        p = params["input_proj"][i]
        g = group_norm(p["gn"], dense(p["conv"], f))
        projected.append(g)
        spatial_shapes.append((g.shape[1], g.shape[2]))
    src = feature_maps[-1]
    for i in range(len(cfg.backbone_stage_indices), cfg.num_feature_levels):
        p = params["input_proj"][i]
        src = F.conv2d(src.permute(0, 3, 1, 2),
                       p["conv"]["kernel"].permute(3, 2, 0, 1), None, 2,
                       1).permute(0, 2, 3, 1) + p["conv"]["bias"]
        src = group_norm(p["gn"], src)
        projected.append(src)
        spatial_shapes.append((src.shape[1], src.shape[2]))

    sources, pos_embeds = [], []
    for lvl, f in enumerate(projected):
        bb, hh, ww, cc = f.shape
        sources.append(f.reshape(bb, hh * ww, cc))
        pos = sine_position_2d(hh, ww, d, cfg.positional_embedding_temperature,
                               dev).to(f.dtype)
        pos_embeds.append(pos + params["level_embed"][lvl][None])
    vision = torch.cat(sources, dim=1)
    pos_flatten = torch.cat(pos_embeds, dim=0)[None].expand(b, -1, -1)
    if stage == "backbone":
        return vision, pos_flatten

    refs = []
    for hh, ww in spatial_shapes:
        ys = (torch.arange(hh, dtype=torch.float32, device=dev) + 0.5) / hh
        xs = (torch.arange(ww, dtype=torch.float32, device=dev) + 0.5) / ww
        gy, gx = torch.meshgrid(ys, xs, indexing="ij")
        refs.append(torch.stack([gx.reshape(-1), gy.reshape(-1)], dim=-1))
    ref = torch.cat(refs, dim=0)
    reference_points = ref[None, :, None, :].expand(b, ref.shape[0],
                                                    len(spatial_shapes), 2)

    for lp in params["encoder_layers"]:
        vision, text = _encoder_layer(
            lp, cfg, vision, text, pos_flatten, reference_points,
            spatial_shapes, text_pad_mask, text_self_mask, position_ids)
    if stage == "encoder":
        return vision, text

    # two-stage proposals
    proposals = []
    for lvl, (hh, ww) in enumerate(spatial_shapes):
        gy, gx = torch.meshgrid(
            torch.arange(hh, dtype=torch.float32, device=dev),
            torch.arange(ww, dtype=torch.float32, device=dev), indexing="ij")
        scale = torch.tensor([ww, hh], dtype=torch.float32, device=dev)
        center = (torch.stack([gx, gy], dim=-1) + 0.5) / scale
        wh = torch.full_like(center, 0.05 * (2.0 ** lvl))
        proposals.append(torch.cat([center, wh], dim=-1).reshape(hh * ww, 4))
    output_proposals = torch.cat(proposals, dim=0)[None]
    valid = ((output_proposals > 0.01) & (output_proposals < 0.99)).all(
        dim=-1, keepdim=True)
    output_proposals = torch.where(valid, _inverse_sigmoid(output_proposals),
                                   float("inf"))
    object_query = torch.where(valid, vision, 0.0)
    object_query = norm(params["enc_output_norm"],
                        dense(params["enc_output"], object_query), eps)
    enc_logits = _contrastive(object_query, text, text_token_mask,
                              cfg.max_text_len)
    enc_coords = _mlp_head(params["encoder_bbox_head"],
                           object_query) + output_proposals

    topk = cfg.num_queries
    # jax.lax.top_k's order: descending, ties to the lower index (the
    # invalid proposals share one zeroed query and tie)
    _, topk_idx = stable_topk(enc_logits.amax(dim=-1), topk)
    reference = torch.sigmoid(torch.gather(
        enc_coords, 1, topk_idx[:, :, None].expand(b, topk, 4)))
    if stage == "two_stage":
        return reference, reference

    hidden = params["query_embeds"][None].expand(b, topk, d).to(vision.dtype)
    for li, lp in enumerate(params["decoder_layers"]):
        ref_input = reference[:, :, None, :].expand(b, topk,
                                                    len(spatial_shapes), 4)
        query_sine = get_sine_pos_embed(reference, num_pos_feats=d // 2)
        query_pos = _mlp_head(params["ref_point_head"], query_sine,
                              num_layers=2).to(hidden.dtype)
        hidden = _decoder_layer(lp, cfg, hidden, query_pos, ref_input,
                                spatial_shapes, vision, text, text_pad_mask)
        delta = _mlp_head(params["bbox_heads"][li], hidden)
        reference = torch.sigmoid(delta + _inverse_sigmoid(reference))
    hidden = norm(params["decoder_norm"], hidden, eps)
    logits = _contrastive(hidden, text, text_token_mask, cfg.max_text_len)
    return logits, reference


# -- detector adapter ------------------------------------------------------------------


class GroundingDinoDetector:
    """detector(image, prompts) -> (boxes xyxy, scores, class_ids).

    Prompts join as 'a . b .'; a query's class is the argmax over prompt
    token spans and its score the max sigmoid logit. detect_batch runs k
    frames through one forward."""

    def __init__(self, params, cfg: GroundingDinoConfig, tokenize,
                 image_size: int = 800, box_threshold: float = 0.35):
        self.params = params
        self.cfg = cfg
        self.tokenize = tokenize
        self.image_size = image_size
        self.box_threshold = box_threshold
        self.device = next(iter(_leaves(params))).device

    def _preprocess(self, images: torch.Tensor) -> torch.Tensor:
        x = resize_bicubic(images.float(), self.image_size, self.image_size)
        return normalize_clip(torch.clamp(torch.round(x), 0, 255))

    def __call__(self, image, prompts: Sequence[str]):
        return self.detect_batch(image[None], prompts)[0]

    @torch.inference_mode()
    def detect_batch(self, images, prompts: Sequence[str]):
        """images (k, H, W, 3) uint8, numpy or a tensor (the grounded clip
        path passes slices of its one upload) -> per frame (boxes xyxy,
        scores, class_ids) numpy arrays."""
        images = torch.as_tensor(np.asarray(images) if not isinstance(
            images, torch.Tensor) else images, device=self.device)
        k, H, W = images.shape[:3]
        caption = " . ".join(p.strip().lower() for p in prompts) + " ."
        ids1 = self.tokenize(caption)
        ids = np.broadcast_to(np.asarray(ids1, np.int64)[None], (k, len(ids1)))
        logits, boxes = forward(self.params, self.cfg,
                                self._preprocess(images), ids)
        probs_b = torch.sigmoid(logits).cpu().numpy()
        boxes_b = boxes.cpu().numpy()
        spans = self._prompt_spans(np.asarray(ids1), len(prompts))
        return [self._postprocess_frame(probs_b[f], boxes_b[f], spans, H, W)
                for f in range(k)]

    def _postprocess_frame(self, probs, boxes, spans, H, W):
        scores = probs.max(axis=-1)
        keep = scores > self.box_threshold
        if not keep.any():
            return (np.zeros((0, 4), np.float32), np.zeros((0,), np.float32),
                    np.zeros((0,), np.int64))
        kept_boxes, kept_scores, kept_probs = (boxes[keep], scores[keep],
                                               probs[keep])
        class_ids = np.array([
            int(np.argmax([kept_probs[i, s:e].max() if e > s else -1
                           for (s, e) in spans]))
            for i in range(len(kept_boxes))], np.int64)
        cx, cy, w, h = kept_boxes.T
        xyxy = np.stack([(cx - w / 2) * W, (cy - h / 2) * H,
                         (cx + w / 2) * W, (cy + h / 2) * H],
                        axis=1).astype(np.float32)
        return xyxy, kept_scores.astype(np.float32), class_ids

    def _prompt_spans(self, ids: np.ndarray, num_prompts: int):
        spans = []
        start = 1  # skip [CLS]
        for i, tok in enumerate(ids):
            if tok in SPECIAL_TOKENS and i > 0:
                if i > start:
                    spans.append((start, i))
                start = i + 1
        return spans[:num_prompts] if spans else [(0, len(ids))]


# -- checkpoint conversion ----------------------------------------------------


def _deform(g: StateDictView, prefix: str) -> dict:
    return {name: g.linear(f"{prefix}{name}.")
            for name in ("sampling_offsets", "attention_weights",
                         "value_proj", "output_proj")}


def _head_sd(g: StateDictView, prefix: str, n: int = 3) -> dict:
    return {f"layer{i}": g.linear(f"{prefix}layers.{i}.") for i in range(n)}


def _input_proj(g: StateDictView, prefix: str, cfg: GroundingDinoConfig):
    """input_proj.{i}: a conv (1x1 -> (in, out), 3x3 -> HWIO) and its
    GroupNorm, per feature level."""
    out = []
    for i in range(cfg.num_feature_levels):
        cp = f"{prefix}{i}."
        w = g(cp + "0.weight")
        kernel = (w[:, :, 0, 0].t() if w.shape[-1] == 1
                  else w.permute(2, 3, 1, 0)).contiguous()
        out.append({"conv": {"kernel": kernel, "bias": g(cp + "0.bias")},
                    "gn": g.norm(cp + "1.")})
    return out


def convert_hf_grounding_dino(sd, cfg: GroundingDinoConfig, device=None,
                              dtype: torch.dtype = torch.float32):
    """An HF GroundingDinoForObjectDetection state dict (tensors or numpy
    arrays) -> the parameter tree on `device` (JAX
    convert_hf_grounding_dino's)."""
    g = StateDictView(sd, device, dtype)

    def mha(prefix):
        names = (("q", "query."), ("k", "key."), ("v", "value."),
                 ("o", "out_proj.")) if prefix + "query.weight" in g else (
            ("q", "q_proj."), ("k", "k_proj."), ("v", "v_proj."),
            ("o", "out_proj."))
        return {ours: g.linear(prefix + theirs) for ours, theirs in names}

    m = "model."
    enc_layers = []
    for i in range(cfg.encoder_layers):
        p = f"{m}encoder.layers.{i}."
        f = p + "fusion_layer."
        te = p + "text_enhancer_layer."
        dl = p + "deformable_layer."
        enc_layers.append({
            "fusion": {
                "ln_vision": g.norm(f + "layer_norm_vision."),
                "ln_text": g.norm(f + "layer_norm_text."),
                "vision_param": g(f + "vision_param"),
                "text_param": g(f + "text_param"),
                **{name: g.linear(f"{f}attn.{name}.")
                   for name in ("vision_proj", "text_proj",
                                "values_vision_proj", "values_text_proj",
                                "out_vision_proj", "out_text_proj")},
            },
            "text_enhancer": {"attn": mha(te + "self_attn."),
                              "fc1": g.linear(te + "fc1."),
                              "fc2": g.linear(te + "fc2."),
                              "ln1": g.norm(te + "layer_norm_before."),
                              "ln2": g.norm(te + "layer_norm_after.")},
            "deformable": {**_deform(g, dl + "self_attn."),
                           "ln1": g.norm(dl + "self_attn_layer_norm."),
                           "fc1": g.linear(dl + "fc1."),
                           "fc2": g.linear(dl + "fc2."),
                           "ln2": g.norm(dl + "final_layer_norm.")},
        })
    dec_layers = []
    for i in range(cfg.decoder_layers):
        p = f"{m}decoder.layers.{i}."
        dec_layers.append({
            "self_attn": mha(p + "self_attn."),
            "self_attn_ln": g.norm(p + "self_attn_layer_norm."),
            "text_cross_attn": mha(p + "encoder_attn_text."),
            "text_cross_attn_ln": g.norm(p + "encoder_attn_text_layer_norm."),
            "deform_cross_attn": _deform(g, p + "encoder_attn."),
            "deform_cross_attn_ln": g.norm(p + "encoder_attn_layer_norm."),
            "fc1": g.linear(p + "fc1."),
            "fc2": g.linear(p + "fc2."),
            "final_ln": g.norm(p + "final_layer_norm."),
        })
    swin_prefix = f"{m}backbone.conv_encoder.model."
    return {
        "swin": swin_mod.convert_hf_swin(sd, cfg.swin, device, dtype,
                                         prefix=swin_prefix),
        "backbone_norms": [
            g.norm(f"{swin_prefix}hidden_states_norms.stage{si + 1}.")
            for si in cfg.backbone_stage_indices],
        "input_proj": _input_proj(g, f"{m}input_proj_vision.", cfg),
        "text_backbone": bert_mod.convert_hf_bert(
            sd, cfg.text, device, dtype, prefix=f"{m}text_backbone."),
        "text_projection": g.linear(m + "text_projection."),
        "level_embed": g(m + "level_embed"),
        "encoder_layers": enc_layers,
        "decoder_layers": dec_layers,
        "enc_output": g.linear(m + "enc_output."),
        "enc_output_norm": g.norm(m + "enc_output_norm."),
        "encoder_bbox_head": _head_sd(g, m + "encoder_output_bbox_embed."),
        "query_embeds": g(m + "query_position_embeddings.weight"),
        "ref_point_head": _head_sd(g, m + "decoder.reference_points_head.",
                                    n=2),
        "decoder_norm": g.norm(m + "decoder.layer_norm."),
        "bbox_heads": [_head_sd(g, f"bbox_embed.{i}.")
                       for i in range(cfg.decoder_layers)],
    }


def convert_original_grounding_dino(sd, cfg: GroundingDinoConfig,
                                    device=None,
                                    dtype: torch.dtype = torch.float32):
    """An original-repo checkpoint (groundingdino_swint_ogc.pth layout)
    -> the parameter tree (JAX convert_original_grounding_dino's):
    backbone.0 a timm Swin with per-stage norm{i}, bert.* an HF BertModel,
    feat_map the text projection, the encoder's fusion_layers /
    text_layers / layers lists, nn.MultiheadAttention's fused in_proj
    split into q / k / v thirds, tgt_embed the content queries. A box
    head left out of the save (weight-shared heads) reuses head 0."""
    g = StateDictView(sd, device, dtype)

    def mha_fused(prefix):
        w, b = g(prefix + "in_proj_weight"), g(prefix + "in_proj_bias")
        d = w.shape[1]
        return {"q": {"kernel": w[:d].t().contiguous(), "bias": b[:d]},
                "k": {"kernel": w[d:2 * d].t().contiguous(),
                      "bias": b[d:2 * d]},
                "v": {"kernel": w[2 * d:].t().contiguous(), "bias": b[2 * d:]},
                "o": g.linear(prefix + "out_proj.")}

    enc_layers = []
    for i in range(cfg.encoder_layers):
        fus = f"transformer.encoder.fusion_layers.{i}."
        txt = f"transformer.encoder.text_layers.{i}."
        dfm = f"transformer.encoder.layers.{i}."
        enc_layers.append({
            "fusion": {
                "ln_vision": g.norm(fus + "layer_norm_v."),
                "ln_text": g.norm(fus + "layer_norm_l."),
                "vision_param": g(fus + "gamma_v"),
                "text_param": g(fus + "gamma_l"),
                "vision_proj": g.linear(fus + "attn.v_proj."),
                "text_proj": g.linear(fus + "attn.l_proj."),
                "values_vision_proj": g.linear(fus + "attn.values_v_proj."),
                "values_text_proj": g.linear(fus + "attn.values_l_proj."),
                "out_vision_proj": g.linear(fus + "attn.out_v_proj."),
                "out_text_proj": g.linear(fus + "attn.out_l_proj."),
            },
            "text_enhancer": {"attn": mha_fused(txt + "self_attn."),
                              "fc1": g.linear(txt + "linear1."),
                              "fc2": g.linear(txt + "linear2."),
                              "ln1": g.norm(txt + "norm1."),
                              "ln2": g.norm(txt + "norm2.")},
            "deformable": {**_deform(g, dfm + "self_attn."),
                           "ln1": g.norm(dfm + "norm1."),
                           "fc1": g.linear(dfm + "linear1."),
                           "fc2": g.linear(dfm + "linear2."),
                           "ln2": g.norm(dfm + "norm2.")},
        })
    dec_layers = []
    for i in range(cfg.decoder_layers):
        p = f"transformer.decoder.layers.{i}."
        dec_layers.append({
            "self_attn": mha_fused(p + "self_attn."),
            "self_attn_ln": g.norm(p + "norm2."),
            "text_cross_attn": mha_fused(p + "ca_text."),
            "text_cross_attn_ln": g.norm(p + "catext_norm."),
            "deform_cross_attn": _deform(g, p + "cross_attn."),
            "deform_cross_attn_ln": g.norm(p + "norm1."),
            "fc1": g.linear(p + "linear1."),
            "fc2": g.linear(p + "linear2."),
            "final_ln": g.norm(p + "norm3."),
        })
    bbox_heads = []
    for i in range(cfg.decoder_layers):
        bbox_heads.append(_head_sd(g, f"bbox_embed.{i}.")
                          if f"bbox_embed.{i}.layers.0.weight" in g
                          else bbox_heads[0])
    return {
        "swin": swin_mod.convert_timm_swin(sd, cfg.swin, device, dtype,
                                           prefix="backbone.0."),
        "backbone_norms": [g.norm(f"backbone.0.norm{si}.")
                           for si in cfg.backbone_stage_indices],
        "input_proj": _input_proj(g, "input_proj.", cfg),
        "text_backbone": bert_mod.convert_hf_bert(sd, cfg.text, device,
                                                  dtype, prefix="bert."),
        "text_projection": g.linear("feat_map."),
        "level_embed": g("transformer.level_embed"),
        "encoder_layers": enc_layers,
        "decoder_layers": dec_layers,
        "enc_output": g.linear("transformer.enc_output."),
        "enc_output_norm": g.norm("transformer.enc_output_norm."),
        "encoder_bbox_head": _head_sd(g, "transformer.enc_out_bbox_embed."),
        "query_embeds": g("transformer.tgt_embed.weight"),
        "ref_point_head": _head_sd(g, "transformer.decoder.ref_point_head.",
                                    n=2),
        "decoder_norm": g.norm("transformer.decoder.norm."),
        "bbox_heads": bbox_heads,
    }


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def char_tokenize(s: str) -> List[int]:
    """The random-weight detector's tokenizer: [CLS], one id per
    character (ord clipped to [1, 900], at most 30), [SEP]."""
    return [101] + [max(1, min(ord(c), 900)) for c in s][:30] + [102]


def _bert_tokenize(path: str):
    from video_llava_tpu_torch.runtime.tokenizer import BertTokenizer

    if not os.path.isdir(path):
        raise FileNotFoundError(
            f"BERT tokenizer {path!r} is not a local directory (vocab.txt or "
            "tokenizer.json): the port reads no hub name; pass the "
            "bert-base-uncased files' directory as tokenizer_name")
    return BertTokenizer(path).encode


def build_detector(checkpoint_dir: Optional[str] = None,
                   cfg: Optional[GroundingDinoConfig] = None,
                   box_threshold: float = 0.35,
                   tokenizer_name: str = "bert-base-uncased",
                   device="cuda", seed: int = 0) -> GroundingDinoDetector:
    """A detector on `device` (the card unless the caller asks for the
    CPU), as the JAX package's build_detector: from an original-repo
    .pth file (groundingdino_swint_ogc.pth) with the BERT tokenizer in
    the directory `tokenizer_name` (vocab.txt or tokenizer.json; the
    original repo pairs its checkpoints with bert-base-uncased, whose
    hub name the port does not resolve), from an HF
    GroundingDinoForObjectDetection directory with its own tokenizer, or
    with random weights drawn on `device` from `seed` and the character
    tokenizer."""
    from video_llava_tpu_torch.engine.weights import (
        load_checkpoint_dir,
        load_torch_checkpoint_file,
    )

    cfg = cfg or GroundingDinoConfig()
    if checkpoint_dir and os.path.isfile(checkpoint_dir):
        sd = load_torch_checkpoint_file(checkpoint_dir)
        sd = {k.removeprefix("module."): v for k, v in sd.items()}
        params = convert_original_grounding_dino(sd, cfg, device)
        tokenize = _bert_tokenize(tokenizer_name)
    elif checkpoint_dir:
        params = convert_hf_grounding_dino(load_checkpoint_dir(checkpoint_dir),
                                           cfg, device)
        tokenize = _bert_tokenize(checkpoint_dir)
    else:
        warnings.warn("GroundingDINO weights not provided; random init")
        params = init_params(TreeInit(seed, device), cfg)
        tokenize = char_tokenize
    return GroundingDinoDetector(params, cfg, tokenize,
                                 box_threshold=box_threshold)
