"""CLIP vision and text towers.

Counterpart of video_llava_tpu/models/clip.py. The vision tower (any
config: ViT-L/14 for the chat path, ViT-B/32 for the grounding crop
filter): patch embedding as a patchify + matmul, pre-LN, the encoder
layers, and either the penultimate hidden state without CLS as the
feature the pooling reads (reference video_chatgpt/inference.py:92-94)
or the CLS token after post-LN (vision_pooled_embedding, the crop
filter's). The text tower (init_text_params / text_forward) is a
nested-dict parameter tree, as engine/weights.convert_clip_text reads it:
token and position embeddings, causal encoder layers through
ops.attention.multi_head_attention (kernel 7 on CUDA), final LN, the
features at the EOT token, projected.

The sequence is padded once after the embeddings (257 -> 272 at
224 px, 577 -> 640 at 336 px), q/k/v are produced head-major
(b, h, s_pad, d) and attention runs through
ops.attention.flash_attention_bhsd with the pad keys masked; the pad
rows are sliced off after the last layer.

W8A8 (:func:`quantize_a8_`, the JAX package's quantize_params(vision,
a8=True)): the encoder layers' kernels become Int8A8Kernel leaves. The
head projections then run as the JAX package's _proj_heads /
_unproj_heads do (models/clip.py:94-143 there): int32 sums rescaled by
the row and channel scales in f32, the bias added in f32, one cast;
fc1 and fc2 go through layers.linear, which casts once before the bias.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from video_llava_tpu_torch.config import CLIPTextConfig, CLIPVisionConfig
from video_llava_tpu_torch.models.layers import (
    ACTIVATIONS,
    Int8A8Kernel,
    LayerNorm,
    Linear,
    TreeInit,
    _param,
    a8_row_sharded,
    dense,
    embed,
    linear,
    norm,
)
from video_llava_tpu_torch.ops.attention import (
    flash_attention_bhsd,
    multi_head_attention,
)
from video_llava_tpu_torch.ops.quant import (
    int8_product,
    leaf_format,
    quantize_tensor,
)


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

    @staticmethod
    def _project(proj: Linear, x):
        """proj(x) -> x's dtype. A W8A8 kernel: the int32 sums times the
        row and channel scales, + the bias, all in f32, then one cast
        (JAX _proj_heads / _unproj_heads); row-sharded under a mesh, the
        sums added over 'model' first (layers.a8_row_sharded)."""
        kern = proj.kernel
        if not isinstance(kern, Int8A8Kernel):
            return proj(x)
        if proj.tp == "in" and proj.mesh.size > 1:  # o under a mesh
            y = a8_row_sharded(x, kern, proj.mesh)
        else:
            y, sx = int8_product(x, kern.qvalues_a8)
            y = y * sx * kern.scales.float()[0]
        if proj.bias is not None:
            y = y + proj.bias.float()
        return y.to(x.dtype)

    def _heads(self, proj: Linear, x):
        """(b, s, K) -> head-major (b, h, s, hd), contiguous. Under a
        tensor-parallel mesh q, k and v are column-sharded and h is this
        rank's heads (num_heads, set by parallel/sharding.shard_params):
        kernel 1 runs on them, as the JAX package runs its kernel per
        shard (ops/attention.sharded_flash_attention); o and fc2 are
        row-sharded and sum over 'model' (layers.Linear)."""
        b, s, _ = x.shape
        y = self._project(proj, x).view(b, s, self.num_heads, -1)
        return y.transpose(1, 2).contiguous()

    def forward(self, x, seq_valid: int):
        """x (b, s_pad, d); keys at or past seq_valid are masked."""
        b, s, _ = x.shape
        h = self.ln1(x)
        attn = flash_attention_bhsd(
            self._heads(self.q, h), self._heads(self.k, h),
            self._heads(self.v, h), kv_len=seq_valid,
        )
        x = x + self._project(self.o, attn.transpose(1, 2).reshape(b, s, -1))
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

    def encode_frames(self, pixels: torch.Tensor,
                      frame_batch: int = 0) -> torch.Tensor:
        """(t, H, W, 3) normalized frames -> (t, num_patches, hidden),
        contiguous as the pooling kernel reads it. frame_batch > 0
        encodes the frames frame_batch at a time, to bound activation
        memory, where it divides t and is less than t (JAX
        models/clip.py:364-380)."""
        t = pixels.shape[0]
        if frame_batch and t % frame_batch == 0 and t > frame_batch:
            return torch.cat([self.penultimate_patches(c)
                              for c in pixels.split(frame_batch)])
        return self.penultimate_patches(pixels).contiguous()


def a8_kernels_(tower: CLIPVisionTower, paths) -> CLIPVisionTower:
    """Give each Linear of `tower` at a path in `paths` (e.g.
    'layers.0.q') an empty Int8A8Kernel of its shape, on its device."""
    for path in paths:
        mod = tower.get_submodule(path)
        d_in, d_out = mod.kernel.shape
        dev = mod.kernel.device
        del mod.kernel
        mod.kernel = Int8A8Kernel(d_in, d_out, device=dev)
    return tower


@torch.no_grad()
def quantize_a8_(tower: CLIPVisionTower, min_size: int = 1 << 16,
                 skip_keys=("class_embedding", "position_embedding")
                 ) -> CLIPVisionTower:
    """W8A8 in place: what the JAX package's quantize_params(vision,
    min_size, skip_keys, a8=True) does to its tree. An encoder layer's
    kernel counts as the JAX tree holds it, stacked (num_layers, in,
    out), against min_size; the patch embedding is no 'kernel' leaf and
    stays. Each kept kernel is quantized per output channel on its
    device (quantize_tensor over the contraction axis)."""
    n = len(tower.layers)
    for name, mod in list(tower.named_modules()):
        if not (isinstance(mod, Linear)
                and isinstance(mod.kernel, torch.Tensor)):
            continue
        keys = tuple(k for k in name.split(".") if not k.isdigit())
        shape = ((n,) if keys[0] == "layers" else ()) + tuple(
            mod.kernel.shape)
        if leaf_format(keys + ("kernel",), shape, "int8", None, min_size,
                       skip_keys) != "int8":
            continue
        q, s = quantize_tensor(mod.kernel, axis=-2)
        leaf = a8_kernels_(tower, [name]).get_submodule(name).kernel
        leaf.qvalues_a8.copy_(q)
        leaf.scales.copy_(s)
    return tower


def vision_pooled_embedding(tower: CLIPVisionTower,
                            pixels: torch.Tensor) -> torch.Tensor:
    """The whole tower's CLS token after post-LN, (b, hidden): what the
    crop filter projects."""
    h = tower(pixels)[:, 0]
    return tower.post_layernorm(h)


# -- text tower ---------------------------------------------------------------


def init_text_params(init: TreeInit, cfg: CLIPTextConfig) -> dict:
    """A random text tower tree in convert_clip_text's layout: embedding
    tables N(0, 0.02^2), kernels N(0, 1/in), biases 0, norm scales 1."""
    d, f = cfg.hidden_size, cfg.intermediate_size

    def layer():
        return {"ln1": init.layer_norm(d), "q": init.linear(d, d),
                "k": init.linear(d, d), "v": init.linear(d, d),
                "o": init.linear(d, d), "ln2": init.layer_norm(d),
                "fc1": init.linear(d, f), "fc2": init.linear(f, d)}

    return {
        "token_embedding": {"weight": init.normal((cfg.vocab_size, d),
                                                  0.02)},
        "position_embedding": init.normal((cfg.max_position_embeddings, d),
                                          0.02),
        "final_layernorm": init.layer_norm(d),
        "text_projection": init.linear(d, cfg.projection_dim, bias=False),
        "layers": [layer() for _ in range(cfg.num_layers)],
    }


def _text_layer(p, x, cfg: CLIPTextConfig):
    b, s, d = x.shape
    eps = cfg.layer_norm_eps
    h = norm(p["ln1"], x, eps)
    q, k, v = (dense(p[n], h).view(b, s, cfg.num_heads, -1)
               for n in ("q", "k", "v"))
    attn = multi_head_attention(q, k, v, causal=True)
    x = x + dense(p["o"], attn.reshape(b, s, d))
    h = norm(p["ln2"], x, eps)
    return x + dense(p["fc2"], ACTIVATIONS[cfg.hidden_act](dense(p["fc1"],
                                                                 h)))


def text_forward(params, token_ids: torch.Tensor, cfg: CLIPTextConfig,
                 eot_token_id: Optional[int] = None) -> torch.Tensor:
    """token_ids (b, s) -> projected text embeddings (b, projection_dim),
    pooled at the EOT token: the first `eot_token_id` when given, else the
    highest id (OpenAI CLIP's EOT is the largest id), the first of equal
    ones either way."""
    ids = token_ids.to(params["position_embedding"].device).long()
    x = embed(params["token_embedding"]["weight"], ids)
    x = x + params["position_embedding"][:ids.shape[1]].to(x.dtype)
    for layer in params["layers"]:
        x = _text_layer(layer, x, cfg)
    x = norm(params["final_layernorm"], x, cfg.layer_norm_eps)
    if eot_token_id is not None:
        eot = torch.argmax((ids == eot_token_id).int(), dim=-1)
    else:
        eot = torch.argmax(ids, dim=-1)
    pooled = x[torch.arange(x.shape[0], device=x.device), eot]
    return dense(params["text_projection"], pooled)
