"""SAM prompt encoder and mask decoder (shared by SAM and MobileSAM).

Counterpart of video_llava_tpu/models/sam.py:192-390: the random-Fourier
positional encoding, box prompts, the two-way transformer, the 4x
upscaling and the hypernetwork mask heads. The ViT-B image encoder behind
--sam_variant vit_b is not ported; MobileSAM's TinyViT encoder is
models/tiny_vit.py. Parameters are the JAX package's nested dict.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

from video_llava_tpu_torch.models.layers import TreeInit, dense, norm


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
