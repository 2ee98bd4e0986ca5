"""BERT encoder: GroundingDINO's text backbone.

Counterpart of video_llava_tpu/models/bert.py (post-LN transformer, HF
BertModel layout). Parameters are the JAX package's nested dict of
tensors (engine/convert.py carries one across); convert_hf_bert reads
an HF BertModel state dict into it.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
import torch.nn.functional as F

from video_llava_tpu_torch.models.layers import (
    StateDictView,
    TreeInit,
    dense,
    norm,
)


@dataclasses.dataclass(frozen=True)
class BertConfig:
    vocab_size: int = 30522
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 3072
    max_position_embeddings: int = 512
    type_vocab_size: int = 2
    layer_norm_eps: float = 1e-12

    @classmethod
    def tiny_test(cls):
        return cls(vocab_size=2048, hidden_size=32, num_layers=2, num_heads=2,
                   intermediate_size=64, max_position_embeddings=64)


def init_params(init: TreeInit, cfg: BertConfig):
    """Random parameters in the converter's layout (HF BertModel's init:
    normal 0.02, zero biases)."""
    d, f = cfg.hidden_size, cfg.intermediate_size
    lin = lambda i, o: init.linear(i, o, std=0.02)  # noqa: E731
    return {
        "word_embeddings": {"weight": init.normal((cfg.vocab_size, d), 0.02)},
        "position_embeddings": init.normal((cfg.max_position_embeddings, d),
                                           0.02),
        "token_type_embeddings": init.normal((cfg.type_vocab_size, d), 0.02),
        "embed_ln": init.layer_norm(d),
        "layers": [
            {"q": lin(d, d), "k": lin(d, d), "v": lin(d, d),
             "attn_out": lin(d, d), "attn_ln": init.layer_norm(d),
             "fc1": lin(d, f), "fc2": lin(f, d), "out_ln": init.layer_norm(d)}
            for _ in range(cfg.num_layers)
        ],
    }


def forward(params, input_ids: torch.Tensor,
            attention_mask: Optional[torch.Tensor], cfg: BertConfig,
            token_type_ids: Optional[torch.Tensor] = None,
            attention_bias: Optional[torch.Tensor] = None,
            position_ids: Optional[torch.Tensor] = None) -> torch.Tensor:
    """-> last hidden state (b, s, d). attention_mask (b, s) 1 = keep;
    attention_bias an additive (b, 1|h, s, s) mask; position_ids (b, s)."""
    b, s = input_ids.shape
    dev = input_ids.device
    x = F.embedding(input_ids.long(), params["word_embeddings"]["weight"])
    pos = (position_ids if position_ids is not None
           else torch.arange(s, device=dev))
    x = x + F.embedding(pos.long(), params["position_embeddings"])
    tt = (token_type_ids if token_type_ids is not None
          else torch.zeros_like(input_ids))
    x = x + F.embedding(tt.long(), params["token_type_embeddings"])
    x = norm(params["embed_ln"], x, cfg.layer_norm_eps)

    bias = 0.0
    if attention_mask is not None:
        bias = torch.where(attention_mask[:, None, None, :] > 0, 0.0, -1e9)
    if attention_bias is not None:
        bias = bias + attention_bias

    hd = cfg.hidden_size // cfg.num_heads
    for lp in params["layers"]:
        q = dense(lp["q"], x).reshape(b, s, cfg.num_heads, hd)
        k = dense(lp["k"], x).reshape(b, s, cfg.num_heads, hd)
        v = dense(lp["v"], x).reshape(b, s, cfg.num_heads, hd)
        logits = torch.einsum("bqhd,bkhd->bhqk", q.float(),
                              k.float()) / math.sqrt(hd)
        probs = torch.softmax(logits + bias, dim=-1)
        attn = torch.einsum("bhqk,bkhd->bqhd", probs.to(v.dtype),
                            v).to(x.dtype)
        attn = dense(lp["attn_out"], attn.reshape(b, s, cfg.hidden_size))
        x = norm(lp["attn_ln"], x + attn, cfg.layer_norm_eps)
        h = F.gelu(dense(lp["fc1"], x))
        x = norm(lp["out_ln"], x + dense(lp["fc2"], h), cfg.layer_norm_eps)
    return x


def convert_hf_bert(sd, cfg: BertConfig, device=None,
                    dtype: torch.dtype = torch.float32,
                    prefix: str = ""):
    """An HF BertModel state dict (tensors or numpy arrays; keys under
    `prefix`) -> the parameter tree on `device` in `dtype` (JAX
    convert_hf_bert's tree)."""
    g = StateDictView(sd, device, dtype, prefix)
    layers = []
    for i in range(cfg.num_layers):
        p = f"encoder.layer.{i}."
        layers.append({
            "q": g.linear(p + "attention.self.query."),
            "k": g.linear(p + "attention.self.key."),
            "v": g.linear(p + "attention.self.value."),
            "attn_out": g.linear(p + "attention.output.dense."),
            "attn_ln": g.norm(p + "attention.output.LayerNorm."),
            "fc1": g.linear(p + "intermediate.dense."),
            "fc2": g.linear(p + "output.dense."),
            "out_ln": g.norm(p + "output.LayerNorm."),
        })
    return {
        "word_embeddings": {"weight": g("embeddings.word_embeddings.weight")},
        "position_embeddings": g("embeddings.position_embeddings.weight"),
        "token_type_embeddings": g("embeddings.token_type_embeddings.weight"),
        "embed_ln": g.norm("embeddings.LayerNorm."),
        "layers": layers,
    }
