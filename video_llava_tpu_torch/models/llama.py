"""LLaMA / Vicuna decoder with a stacked KV cache.

Counterpart of video_llava_tpu/models/llama.py for the chat path: one
module per layer, a static-capacity KV cache stacked over layers
(NL, b, L, h_kv, hd) and updated in place, RoPE from explicit
positions. Prefill (s > 1) attends over the whole cache capacity with
the causal mask at each row's write position (plain torch, as XLA in
the JAX package); decode (s == 1) reads the cache through
ops.attention.decode_attention_stacked.

Quantized layouts (``quant`` "int8" or "int4"): every kernel leaf and
the embedding table take the format the JAX package's quantize_params /
quantize_params_int4 give them (ops/quant.leaf_format), and ``fuse``
merges wq/wk/wv into wqkv and gate/up into gate_up where the members
share a format (fuse_layer_kernels, JAX models/llama.py:435-465). Each
layer holds its own (Dh, F) int4 weight; the W4A8 kernels take a layer
of a stacked weight as a view just the same.

Not ported (no caller on the chat path): the paged cache, vocab
padding, and the forward without a cache.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from video_llava_tpu_torch.config import LlamaConfig
from video_llava_tpu_torch.models.layers import (
    Embedding,
    Linear,
    RMSNorm,
    apply_rope,
    linear,
    rope_cos_sin,
)
from video_llava_tpu_torch.ops.attention import (
    attention_reference,
    decode_attention_stacked,
)
from video_llava_tpu_torch.ops.quant import ieee_div, leaf_format


@dataclasses.dataclass
class KVCache:
    """Stacked KV cache, updated in place.

    k, v: (num_layers, batch, max_len, num_kv_heads, head_dim);
    length: (batch,) int32 valid entries per row. An int8 cache holds
    symmetric per-(position, head) values plus f32 scales
    (num_layers, batch, max_len, num_kv_heads).
    """

    k: torch.Tensor
    v: torch.Tensor
    length: torch.Tensor
    k_scale: Optional[torch.Tensor] = None
    v_scale: Optional[torch.Tensor] = None

    @classmethod
    def create(cls, cfg: LlamaConfig, batch: int, max_len: int,
               dtype=torch.bfloat16, device=None) -> "KVCache":
        shape = (cfg.num_layers, batch, max_len, cfg.num_kv_heads,
                 cfg.head_dim)
        length = torch.zeros((batch,), dtype=torch.int32, device=device)
        if dtype == torch.int8:
            return cls(
                k=torch.zeros(shape, dtype=torch.int8, device=device),
                v=torch.zeros(shape, dtype=torch.int8, device=device),
                length=length,
                k_scale=torch.zeros(shape[:-1], dtype=torch.float32,
                                    device=device),
                v_scale=torch.zeros(shape[:-1], dtype=torch.float32,
                                    device=device),
            )
        return cls(k=torch.zeros(shape, dtype=dtype, device=device),
                   v=torch.zeros(shape, dtype=dtype, device=device),
                   length=length)


def _quantize_kv(x: torch.Tensor):
    """(b, s, h, hd) -> (int8 values, (b, s, h) f32 scales); rounds half
    to even (torch.round), as the JAX package does."""
    x32 = x.float()
    scale = ieee_div(x32.abs().amax(dim=-1, keepdim=True).clamp_min(1e-8),
                     127.0)
    q = torch.round(x32 / scale).clamp(-127, 127)
    return q.to(torch.int8), scale[..., 0]


def _dequantize_kv(q: torch.Tensor, scale: torch.Tensor, dtype):
    """q (..., h, hd) x scale (..., h) -> dequantized values."""
    return (q.float() * scale[..., None]).to(dtype)


def _write(full: torch.Tensor, new: torch.Tensor, pos: torch.Tensor,
           li: int) -> None:
    """Write new (b, s, ...) into full (NL, b, L, ...) at layer li,
    row i, positions [pos_i, pos_i + s), in place (no host sync)."""
    b, s = new.shape[:2]
    rows = torch.arange(b, device=full.device)[:, None]
    cols = (pos.to(full.device).long()[:, None]
            + torch.arange(s, device=full.device)[None, :])
    full[li][rows, cols] = new.to(full.dtype)


FUSED = {"wqkv": ("wq", "wk", "wv"), "gate_up": ("gate", "up")}


def _layout_of(kernel):
    """A kernel leaf's layout: None for a dense array, else the set of
    its quantized leaf names (int8 and int4 never fuse together)."""
    return frozenset(kernel) if isinstance(kernel, dict) else None


def fuse_layer_kernels(params):
    """Merge wq/wk/wv -> wqkv and gate/up -> gate_up in params["layers"]
    (dense, int8 or int4 kernel leaves, concatenated along the output
    axis), where every member shares one layout; others stay as they
    are (JAX models/llama.py:435-465)."""
    layers = dict(params["layers"])
    for fused, members in FUSED.items():
        if not all(m in layers for m in members):
            continue
        kernels = [layers[m]["kernel"] for m in members]
        if len({_layout_of(k) for k in kernels}) != 1:
            continue
        for m in members:
            del layers[m]
        layers[fused] = {"kernel": (
            {key: torch.cat([k[key] for k in kernels], dim=-1)
             for key in kernels[0]}
            if isinstance(kernels[0], dict) else torch.cat(kernels, dim=-1))}
    return {**params, "layers": layers}


def layer_layout(cfg: LlamaConfig, quant: Optional[str] = None,
                 group_size: Optional[int] = 128, fuse: bool = False):
    """{linear name: (in, out, format, n_groups)} of one decoder layer:
    the formats the JAX package's quantize_params(_int4) give the
    layer-stacked (L, in, out) kernels, then fuse_layer_kernels' merge of
    every group whose members share a format."""
    d, hd, f = cfg.hidden_size, cfg.head_dim, cfg.intermediate_size
    dims = {"wq": (d, cfg.num_heads * hd), "wk": (d, cfg.num_kv_heads * hd),
            "wv": (d, cfg.num_kv_heads * hd), "wo": (cfg.num_heads * hd, d),
            "gate": (d, f), "up": (d, f), "down": (f, d)}
    layout = {}
    for name, (i, o) in dims.items():
        fmt = quant and leaf_format(("layers", name, "kernel"),
                                    (cfg.num_layers, i, o), quant, group_size)
        layout[name] = (i, o, fmt or None,
                        i // (group_size or i) if fmt == "int4" else 1)
    if fuse:
        for fused, members in FUSED.items():
            if len({layout[m][2:] for m in members}) == 1:
                i, _, fmt, g = layout[members[0]]
                o = sum(layout.pop(m)[1] for m in members)
                layout[fused] = (i, o, fmt, g)
    return layout


class LlamaLayer(nn.Module):
    """One decoder layer with a linear for each entry of `layout`
    (:func:`layer_layout`)."""

    def __init__(self, cfg: LlamaConfig, layout, *, device=None,
                 dtype=torch.bfloat16):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        d = cfg.hidden_size
        self.cfg = cfg
        self.fused = "wqkv" in layout, "gate_up" in layout
        self.input_norm = RMSNorm(d, cfg.rms_norm_eps, **kw)
        self.post_norm = RMSNorm(d, cfg.rms_norm_eps, **kw)
        for name, (i, o, fmt, g) in layout.items():
            setattr(self, name, Linear(i, o, bias=False, fmt=fmt,
                                       n_groups=g, **kw))

    def attention(self, x, cos, sin, cache: KVCache, li: int,
                  write_pos: torch.Tensor, cache_len: torch.Tensor):
        """Self-attention that writes this layer's k/v into the cache at
        write_pos and attends over the cache masked to cache_len."""
        cfg = self.cfg
        b, s, _ = x.shape
        h, h_kv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
        if self.fused[0]:
            q, k, v = self.wqkv(x).split([h * hd, h_kv * hd, h_kv * hd],
                                         dim=-1)
        else:
            q, k, v = self.wq(x), self.wk(x), self.wv(x)
        q = apply_rope(q.reshape(b, s, h, hd), cos, sin)
        k = apply_rope(k.reshape(b, s, h_kv, hd), cos, sin)
        v = v.reshape(b, s, h_kv, hd)
        if cache.k_scale is not None:  # int8 cache: quantize on write
            kq, ks = _quantize_kv(k)
            vq, vs = _quantize_kv(v)
            _write(cache.k, kq, write_pos, li)
            _write(cache.v, vq, write_pos, li)
            _write(cache.k_scale, ks, write_pos, li)
            _write(cache.v_scale, vs, write_pos, li)
        else:
            _write(cache.k, k, write_pos, li)
            _write(cache.v, v, write_pos, li)
        if s == 1:
            out = decode_attention_stacked(
                q, cache.k, cache.v, li, cache_len,
                k_scale=cache.k_scale, v_scale=cache.v_scale,
            )
        else:
            if cache.k_scale is not None:
                k_read = _dequantize_kv(cache.k[li], cache.k_scale[li],
                                        q.dtype)
                v_read = _dequantize_kv(cache.v[li], cache.v_scale[li],
                                        q.dtype)
            else:
                k_read, v_read = cache.k[li], cache.v[li]
            # row b's queries sit at cache positions [write_pos_b, +s)
            out = attention_reference(
                q, k_read, v_read, causal=True, kv_valid_len=cache_len,
                q_offset=write_pos,
            )
        return self.wo(out.reshape(b, s, h * hd))

    def mlp(self, x):
        if self.fused[1]:
            gate, up = self.gate_up(x).chunk(2, dim=-1)
        else:
            gate, up = self.gate(x), self.up(x)
        return self.down(F.silu(gate) * up)

    def forward(self, x, cos, sin, cache, li, write_pos, cache_len):
        x = x + self.attention(self.input_norm(x), cos, sin, cache, li,
                               write_pos, cache_len)
        return x + self.mlp(self.post_norm(x))


class Llama(nn.Module):
    """quant: None (dense kernels in `dtype`), "int8" or "int4"
    (ops/quant.leaf_format); fuse: the wqkv/gate_up layout. The layout
    is decided here, once: `quant`, `group_size` and `fuse` stay on the
    module, and `layout` is every layer's :func:`layer_layout`."""

    def __init__(self, cfg: LlamaConfig, *, device=None,
                 dtype=torch.bfloat16, quant: Optional[str] = None,
                 group_size: Optional[int] = 128, fuse: bool = False):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.cfg = cfg
        self.quant, self.group_size, self.fuse = quant, group_size, fuse
        self.layout = layer_layout(cfg, quant, group_size, fuse)
        d, vocab = cfg.hidden_size, cfg.vocab_size
        fmt = lambda *keys_shape: quant and leaf_format(  # noqa: E731
            *keys_shape, quant, group_size)
        self.embed_tokens = Embedding(
            vocab, d, fmt=fmt(("embed_tokens", "weight"), (vocab, d)) or None,
            **kw)
        self.layers = nn.ModuleList(
            LlamaLayer(cfg, self.layout, **kw)
            for _ in range(cfg.num_layers))
        self.final_norm = RMSNorm(d, cfg.rms_norm_eps, **kw)
        head = fmt(("lm_head", "kernel"), (d, vocab)) or None
        self.lm_head = Linear(
            d, vocab, bias=False, fmt=head,
            n_groups=d // (group_size or d) if head == "int4" else 1, **kw)

    def forward_hidden(
        self,
        inputs_embeds: torch.Tensor,
        positions: torch.Tensor,
        cache: KVCache,
        new_length: Optional[torch.Tensor] = None,
    ) -> Tuple[torch.Tensor, KVCache]:
        """embeds (b, s, d) + positions (b, s) -> final-normed hidden
        (b, s, d). Writes k/v at cache.length onward and sets
        cache.length to new_length (default length + s)."""
        if cache is None:
            raise ValueError("the port's decoder runs with a KV cache")
        cfg = self.cfg
        cos, sin = rope_cos_sin(positions, cfg.head_dim, cfg.rope_theta)
        write_pos = cache.length
        cache_len = (new_length if new_length is not None
                     else cache.length + inputs_embeds.shape[1])
        cache_len = cache_len.to(torch.int32)
        x = inputs_embeds
        for li, layer in enumerate(self.layers):
            x = layer(x, cos, sin, cache, li, write_pos, cache_len)
        cache.length = cache_len
        return self.final_norm(x), cache

    def logits(self, hidden: torch.Tensor) -> torch.Tensor:
        """lm_head -> (..., vocab) f32 logits: a dense head in f32, an
        int4 head through the W4A8 matmuls, an int8 head in hidden's
        dtype then f32 (JAX models/llama.py:694-706)."""
        return linear(hidden, self.lm_head.kernel, out_dtype=torch.float32)

    def forward(
        self,
        cache: KVCache,
        *,
        input_ids: Optional[torch.Tensor] = None,
        inputs_embeds: Optional[torch.Tensor] = None,
        positions: Optional[torch.Tensor] = None,
        new_length: Optional[torch.Tensor] = None,
    ) -> Tuple[torch.Tensor, KVCache]:
        """Full LM forward -> (logits (b, s, vocab) f32, cache)."""
        if inputs_embeds is None:
            inputs_embeds = self.embed_tokens(input_ids)
        b, s = inputs_embeds.shape[:2]
        if positions is None:
            positions = (torch.arange(s, dtype=torch.int32,
                                      device=inputs_embeds.device)[None, :]
                         + cache.length[:, None]).expand(b, s)
        hidden, cache = self.forward_hidden(inputs_embeds, positions, cache,
                                            new_length)
        return self.logits(hidden), cache

    def decode_step(self, token: torch.Tensor,
                    cache: KVCache) -> Tuple[torch.Tensor, KVCache]:
        """One decode step. token (b,) -> (logits (b, vocab) f32, cache)."""
        logits, cache = self.forward(
            cache, inputs_embeds=self.embed_tokens(token[:, None]),
            positions=cache.length[:, None], new_length=cache.length + 1,
        )
        return logits[:, 0], cache
