"""RAM (recognize-anything) image tagging head: the query2label decoder.

Counterpart of video_llava_tpu/models/ram.py. The reference's tagger is
RAM Swin-L (grounding_evaluation/util/image_tagging.py:5-29): a Swin
image encoder whose patch features are queried by one label embedding a
tag through a small post-LN BERT-style decoder (an optional query
self-attention block, a cross-attention block over the projected image
features and an FFN a layer); each tag's query gives one recognition
logit, held against a per-tag threshold. All frames and all tags run in
one batch (the reference loops over frames). Parameters are the JAX
package's nested dict; convert_ram_checkpoint reads a released
ram_swin_large_14m.pth-style state dict.
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from video_llava_tpu_torch.models.layers import (
    StateDictView,
    TreeInit,
    dense,
    norm,
)
from video_llava_tpu_torch.models.swin import (
    SwinConfig,
    convert_timm_swin,
    forward_features,
)


@dataclasses.dataclass(frozen=True)
class RamConfig:
    num_tags: int = 4585  # the released RAM tag vocabulary
    hidden_size: int = 512
    num_heads: int = 4  # q2l_config's num_attention_heads
    decoder_layers: int = 2
    intermediate_size: int = 2048
    layer_norm_eps: float = 1e-12
    default_threshold: float = 0.68  # RAM's class_threshold default


def _attn_block_init(init: TreeInit, d: int) -> dict:
    return {"q": init.linear(d, d), "k": init.linear(d, d),
            "v": init.linear(d, d), "o": init.linear(d, d),
            "ln": init.layer_norm(d)}


def init_params(init: TreeInit, cfg: RamConfig, backbone_features: int,
                self_attention: bool = True) -> dict:
    """Random decoder parameters in the converter's layout, drawn as the
    JAX package's ram.init_params draws them (normal * fan_in ** -0.5
    kernels, 0.02 label embeddings)."""
    d = cfg.hidden_size
    layers = []
    for _ in range(cfg.decoder_layers):
        layer = {"cross": _attn_block_init(init, d),
                 "fc1": init.linear(d, cfg.intermediate_size),
                 "fc2": init.linear(cfg.intermediate_size, d),
                 "ffn_ln": init.layer_norm(d)}
        if self_attention:
            layer["self"] = _attn_block_init(init, d)
        layers.append(layer)
    return {
        "label_embeddings": init.normal((cfg.num_tags, d), 0.02),
        "image_proj": init.linear(backbone_features, d),
        "layers": layers,
        "head": init.linear(d, 1),
    }


def _mha(p, x: torch.Tensor, kv: torch.Tensor, num_heads: int,
         eps: float) -> torch.Tensor:
    """Post-LN attention block: LN(x + O(attention(x, kv))), the softmax
    in f32."""
    b, q_len, d = x.shape
    hd = d // num_heads
    qh = dense(p["q"], x).reshape(b, q_len, num_heads, hd)
    kh = dense(p["k"], kv).reshape(b, kv.shape[1], num_heads, hd)
    vh = dense(p["v"], kv).reshape(b, kv.shape[1], num_heads, hd)
    logits = torch.einsum("bqhd,bkhd->bhqk", qh.float(),
                          kh.float()) / math.sqrt(hd)
    probs = torch.softmax(logits, dim=-1)
    attn = torch.einsum("bhqk,bkhd->bqhd", probs, vh.float()).to(x.dtype)
    return norm(p["ln"], x + dense(p["o"], attn.reshape(b, q_len, d)), eps)


def tag_logits(backbone_params, ram_params, pixels: torch.Tensor,
               swin_cfg: SwinConfig, cfg: RamConfig) -> torch.Tensor:
    """(b, H, W, 3) normalized pixels -> (b, num_tags) recognition
    logits."""
    feats = forward_features(backbone_params, pixels, swin_cfg)[-1]
    b, hh, ww, c = feats.shape
    img = dense(ram_params["image_proj"], feats.reshape(b, hh * ww, c))
    q = ram_params["label_embeddings"][None].expand(
        b, cfg.num_tags, cfg.hidden_size).to(img.dtype)
    eps = cfg.layer_norm_eps
    for lp in ram_params["layers"]:
        if "self" in lp:
            q = _mha(lp["self"], q, q, cfg.num_heads, eps)
        q = _mha(lp["cross"], q, img, cfg.num_heads, eps)
        h = F.gelu(dense(lp["fc1"], q))
        q = norm(lp["ffn_ln"], q + dense(lp["fc2"], h), eps)
    return dense(ram_params["head"], q)[..., 0]


# -- released-checkpoint conversion -------------------------------------------

_CROSS_Q = "tagging_head.encoder.layer.{}.crossattention.self.query.weight"


def infer_ram_config(sd, num_heads: int = 4) -> RamConfig:
    """The decoder's geometry from a RAM state dict: tag count, width,
    layer count, FFN width. The head count is not in the weights' shapes:
    q2l_config's released value (4) is the default."""
    keys = {k.removeprefix("module."): k for k in sd}

    def shape(name):
        return tuple(np.shape(sd[keys[name]]))

    num_tags = shape("label_embed")[0]
    layers = 0
    while _CROSS_Q.format(layers) in keys:
        layers += 1
    return RamConfig(
        num_tags=num_tags, hidden_size=shape("fc.weight")[1],
        num_heads=num_heads, decoder_layers=layers,
        intermediate_size=shape(
            "tagging_head.encoder.layer.0.intermediate.dense.weight")[0])


def convert_ram_checkpoint(sd, swin_cfg: SwinConfig, cfg: RamConfig,
                           device=None, dtype: torch.dtype = torch.float32):
    """A released RAM state dict (ram_swin_large_14m.pth layout;
    a 'module.' prefix dropped) -> (backbone params, decoder params,
    per-tag thresholds as numpy f32), as the JAX package's
    convert_ram_checkpoint:
      visual_encoder.*           timm Swin-L (swin.convert_timm_swin)
      image_proj                 vision width -> hidden
      label_embed                (num_tags, e) textual label embeddings
      wordvec_proj               relu(wordvec_proj(label_embed)) at
                                 inference: folded into the embeddings
                                 here (numpy on the host)
      tagging_head.encoder.layer.{i}.attention / crossattention /
        intermediate / output    BertLayer blocks (self-attention
                                 optional)
      fc                         hidden -> 1, one logit a query
      class_threshold            (num_tags,) thresholds (else
                                 cfg.default_threshold)"""
    sd = {k.removeprefix("module."): v for k, v in sd.items()}
    g = StateDictView(sd, device, dtype)
    backbone = convert_timm_swin(sd, swin_cfg, device, dtype,
                                 prefix="visual_encoder.")

    def host(key):
        v = sd[key]
        return (v.detach().cpu().float().numpy()
                if isinstance(v, torch.Tensor) else np.asarray(v))

    label = host("label_embed")
    if "wordvec_proj.weight" in sd:
        label = label @ host("wordvec_proj.weight").T
        if "wordvec_proj.bias" in sd:
            label = label + host("wordvec_proj.bias")
        label = np.maximum(label, 0.0)

    def block(p):
        return {"q": g.linear(f"{p}.self.query."),
                "k": g.linear(f"{p}.self.key."),
                "v": g.linear(f"{p}.self.value."),
                "o": g.linear(f"{p}.output.dense."),
                "ln": g.norm(f"{p}.output.LayerNorm.")}

    layers, i = [], 0
    while _CROSS_Q.format(i) in sd:
        pre = f"tagging_head.encoder.layer.{i}"
        layer = {"cross": block(f"{pre}.crossattention"),
                 "fc1": g.linear(f"{pre}.intermediate.dense."),
                 "fc2": g.linear(f"{pre}.output.dense."),
                 "ffn_ln": g.norm(f"{pre}.output.LayerNorm.")}
        if f"{pre}.attention.self.query.weight" in sd:
            layer["self"] = block(f"{pre}.attention")
        layers.append(layer)
        i += 1
    ram_params = {
        "label_embeddings": torch.from_numpy(label).to(device=device,
                                                       dtype=dtype),
        "image_proj": g.linear("image_proj."),
        "layers": layers,
        "head": g.linear("fc."),
    }
    thresholds = (host("class_threshold").astype(np.float32)
                  if "class_threshold" in sd
                  else np.full((label.shape[0],), cfg.default_threshold,
                               np.float32))
    return backbone, ram_params, thresholds


def load_tag_list(path: str) -> List[str]:
    """The released vocabulary file (ram_tag_list.txt: one tag a line,
    4,585 of them); blank lines skipped."""
    with open(path, encoding="utf-8") as f:
        return [line.strip() for line in f if line.strip()]


def load_tag_thresholds(path: Optional[str], num_tags: int,
                        default: float = 0.68) -> np.ndarray:
    """Per-tag sigmoid thresholds (ram_tag_list_threshold.txt), or the
    uniform default without a file; a count other than num_tags
    raises."""
    if path is None:
        return np.full((num_tags,), default, np.float32)
    with open(path, encoding="utf-8") as f:
        vals = [float(line.strip()) for line in f if line.strip()]
    if len(vals) != num_tags:
        raise ValueError(f"threshold file has {len(vals)} entries, expected "
                         f"{num_tags}")
    return np.asarray(vals, np.float32)
