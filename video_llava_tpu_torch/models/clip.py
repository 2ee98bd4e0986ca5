"""CLIP (ViT-L/14) vision tower.

Counterpart of the vision half of video_llava_tpu/models/clip.py: patch
embedding as a patchify + matmul, pre-LN, the encoder layers, and the
penultimate hidden state without CLS as the feature the pooling reads
(reference video_chatgpt/inference.py:92-94).

The sequence is padded once after the embeddings (257 -> 272 at
224 px, 577 -> 640 at 336 px), q/k/v are produced head-major
(b, h, s_pad, d) and attention runs through
ops.attention.flash_attention_bhsd with the pad keys masked; the pad
rows are sliced off after the last layer.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from video_llava_tpu_torch.config import CLIPVisionConfig
from video_llava_tpu_torch.models.layers import (
    ACTIVATIONS,
    LayerNorm,
    Linear,
    _param,
    linear,
)
from video_llava_tpu_torch.ops.attention import flash_attention_bhsd


def padded_length(s: int) -> int:
    """The once-padded sequence length: a multiple of 16 up to 512,
    of 128 beyond (the JAX package's rule, models/clip.py:275-283)."""
    s_pad = -(-s // 16) * 16
    if s_pad > 512:
        s_pad = -(-s // 128) * 128
    return s_pad


def patchify(pixels: torch.Tensor, patch_size: int) -> torch.Tensor:
    """(b, H, W, 3) -> (b, num_patches, P*P*3), row-major patch order
    matching a stride-P conv + flatten."""
    b, hh, ww, c = pixels.shape
    gh, gw = hh // patch_size, ww // patch_size
    x = pixels.reshape(b, gh, patch_size, gw, patch_size, c)
    x = x.permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, gh * gw, patch_size * patch_size * c)


class EncoderLayer(nn.Module):
    def __init__(self, cfg: CLIPVisionConfig, *, device=None,
                 dtype=torch.float32):
        super().__init__()
        d, f = cfg.hidden_size, cfg.intermediate_size
        kw = dict(device=device, dtype=dtype)
        self.num_heads = cfg.num_heads
        self.act = ACTIVATIONS[cfg.hidden_act]
        self.ln1 = LayerNorm(d, cfg.layer_norm_eps, **kw)
        self.q = Linear(d, d, **kw)
        self.k = Linear(d, d, **kw)
        self.v = Linear(d, d, **kw)
        self.o = Linear(d, d, **kw)
        self.ln2 = LayerNorm(d, cfg.layer_norm_eps, **kw)
        self.fc1 = Linear(d, f, **kw)
        self.fc2 = Linear(f, d, **kw)

    def _heads(self, proj: Linear, x):
        """(b, s, K) -> head-major (b, h, s, hd), contiguous."""
        b, s, _ = x.shape
        y = proj(x).view(b, s, self.num_heads, -1)
        return y.transpose(1, 2).contiguous()

    def forward(self, x, seq_valid: int):
        """x (b, s_pad, d); keys at or past seq_valid are masked."""
        b, s, d = x.shape
        h = self.ln1(x)
        attn = flash_attention_bhsd(
            self._heads(self.q, h), self._heads(self.k, h),
            self._heads(self.v, h), kv_len=seq_valid,
        )
        x = x + self.o(attn.transpose(1, 2).reshape(b, s, d))
        h = self.ln2(x)
        return x + self.fc2(self.act(self.fc1(h)))


class CLIPVisionTower(nn.Module):
    def __init__(self, cfg: CLIPVisionConfig, *, device=None,
                 dtype=torch.float32):
        super().__init__()
        self.cfg = cfg
        d = cfg.hidden_size
        patch_dim = cfg.patch_size * cfg.patch_size * 3
        kw = dict(device=device, dtype=dtype)
        self.class_embedding = _param((d,), device, dtype)
        # (P*P*3, hidden): patchify-matmul form of the stride-P conv
        self.patch_embedding = _param((patch_dim, d), device, dtype)
        self.position_embedding = _param((cfg.num_positions, d), device,
                                         dtype)
        self.pre_layernorm = LayerNorm(d, cfg.layer_norm_eps, **kw)
        self.post_layernorm = LayerNorm(d, cfg.layer_norm_eps, **kw)
        self.layers = nn.ModuleList(
            EncoderLayer(cfg, **kw) for _ in range(cfg.num_layers))

    def embeddings(self, pixels: torch.Tensor) -> torch.Tensor:
        """(b, H, W, 3) normalized -> (b, 1 + num_patches, hidden). The
        patch product runs in f32 (the pixels are f32) and is cast to
        the parameter dtype."""
        pe = self.patch_embedding
        x = linear(patchify(pixels, self.cfg.patch_size).float(), pe.float())
        x = x.to(pe.dtype)
        cls = self.class_embedding.to(x.dtype).expand(x.shape[0], 1, -1)
        return torch.cat([cls, x], dim=1) + self.position_embedding.to(
            x.dtype)

    def forward(self, pixels: torch.Tensor,
                num_layers: Optional[int] = None) -> torch.Tensor:
        """Embeddings + pre-LN + `num_layers` encoder layers -> raw hidden
        states (no post-LN): num_layers = num_layers_total - 1 gives HF
        hidden_states[-2]."""
        num_layers = len(self.layers) if num_layers is None else num_layers
        x = self.pre_layernorm(self.embeddings(pixels))
        s = x.shape[1]
        x = torch.nn.functional.pad(x, (0, 0, 0, padded_length(s) - s))
        for layer in self.layers[:num_layers]:
            x = layer(x, seq_valid=s)
        return x[:, :s]

    def penultimate_patches(self, pixels: torch.Tensor) -> torch.Tensor:
        """hidden_states[-2][:, 1:]: penultimate layer, CLS dropped."""
        return self.forward(pixels, num_layers=len(self.layers) - 1)[:, 1:]

    def encode_frames(self, pixels: torch.Tensor) -> torch.Tensor:
        """(t, H, W, 3) normalized frames -> (t, num_patches, hidden),
        contiguous as the pooling kernel reads it."""
        return self.penultimate_patches(pixels).contiguous()
