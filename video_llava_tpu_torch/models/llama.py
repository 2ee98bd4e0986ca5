"""LLaMA / Vicuna decoder with a stacked or a paged KV cache.

Counterpart of video_llava_tpu/models/llama.py for the chat and serving
paths: one module per layer, RoPE from explicit positions, and either
cache, updated in place: a static-capacity cache stacked over layers
(NL, b, L, h_kv, hd), or a pool of blocks shared by the rows through
their block tables (PagedKVCache, continuous-batching serving). Prefill
and speculative verify (s > 1) attend over the whole row capacity with
the causal mask at each row's write position (plain torch, as XLA in
the JAX package); decode (s == 1) reads the cache through
ops.attention.decode_attention_stacked or decode_attention_paged.

Without a cache (training), every layer attends causally over its own
s tokens through ops.attention.multi_head_attention (kernels 7 and 8 on
CUDA), and ``remat`` recomputes each layer in the backward pass
(torch.utils.checkpoint: only each layer's input is kept, as
jax.checkpoint with nothing_saveable keeps).

Quantized layouts (``quant`` "int8" or "int4"): every kernel leaf and
the embedding table take the format the JAX package's quantize_params /
quantize_params_int4 give them (ops/quant.leaf_format; ``skip_keys``
keeps more leaves dense, as training keeps embed_tokens), and ``fuse``
merges wq/wk/wv into wqkv and gate/up into gate_up where the members
share a format (fuse_layer_kernels, JAX models/llama.py:435-465). Each
layer holds its own (Dh, F) int4 weight; the W4A8 kernels take a layer
of a stacked weight as a view just the same.

Tensor parallel (parallel/sharding.shard_params over a ('data',
'model') mesh): each layer holds its local heads, KV heads and FFN
width (its `cfg` is the local one, so caches are created at the local
head count); wo and down sum their partial products over 'model', or,
where the int4 rule replicates them, gather their input and run whole
(layers.Linear); embed_tokens looks up its own vocab rows and sums
(layers.Embedding); a vocab-sharded lm_head gathers its logits (with
grad enabled through parallel/collectives, so the gather has its
backward pass). Under FSDP every big kernel and the layer norms gather
their 'data' shards at use (layers.use_param). A fused layout does not
shard. :func:`pad_vocab` pads the vocab to a
multiple the mesh divides; :meth:`Llama.logits` masks the padded
columns to -inf (JAX models/llama.py:468-518, :707-711).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from video_llava_tpu_torch.config import LlamaConfig
from video_llava_tpu_torch.models.layers import (
    Embedding,
    Int8Kernel,
    Linear,
    RMSNorm,
    apply_rope,
    linear,
    rope_cos_sin,
    use_param,
)
from video_llava_tpu_torch.ops.attention import (
    attention_reference,
    decode_attention_paged,
    decode_attention_stacked,
    multi_head_attention,
    paged_layer_dense,
)
from video_llava_tpu_torch.ops.quant import ieee_div, leaf_format
from video_llava_tpu_torch.parallel import collectives


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


@dataclasses.dataclass
class PagedKVCache:
    """Block-pooled KV cache for continuous-batching serving, updated in
    place (JAX models/llama.py:88-151).

    k, v: (num_layers, num_blocks, block_size, num_kv_heads, head_dim), a
    pool shared by every row; table: (batch, max_blocks_per_row) int32
    pool block ids mapping each row's logical positions, entries past a
    row's allocation 0 (the pad block, never handed out); length:
    (batch,) int32. An int8 pool holds f32 scales (num_layers,
    num_blocks, block_size, num_kv_heads).
    """

    k: torch.Tensor
    v: torch.Tensor
    length: torch.Tensor
    table: torch.Tensor
    k_scale: Optional[torch.Tensor] = None
    v_scale: Optional[torch.Tensor] = None

    @property
    def block_size(self) -> int:
        return self.k.shape[2]

    @classmethod
    def create(cls, cfg: LlamaConfig, batch: int, num_blocks: int,
               block_size: int, max_blocks_per_row: int,
               dtype=torch.bfloat16, device=None) -> "PagedKVCache":
        shape = (cfg.num_layers, num_blocks, block_size, cfg.num_kv_heads,
                 cfg.head_dim)
        table = torch.zeros((batch, max_blocks_per_row), dtype=torch.int32,
                            device=device)
        length = torch.zeros((batch,), dtype=torch.int32, device=device)
        scales = ({"k_scale": torch.zeros(shape[:-1], dtype=torch.float32,
                                          device=device),
                   "v_scale": torch.zeros(shape[:-1], dtype=torch.float32,
                                          device=device)}
                  if dtype == torch.int8 else {})
        return cls(k=torch.zeros(shape, dtype=dtype, device=device),
                   v=torch.zeros(shape, dtype=dtype, device=device),
                   length=length, table=table, **scales)


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


def _write_paged_cache(full: torch.Tensor, new: torch.Tensor,
                       pos: torch.Tensor, li: int,
                       table: torch.Tensor) -> None:
    """Write new (b, s, ...) into the block pool full (NL, NB, BS, ...)
    at layer li, row i's logical positions [pos_i, pos_i + s) mapped
    through its table row, in place, with one vectorised index write
    (JAX models/llama.py:226-279). Two regimes:
      * s a multiple of BS (a prefill window, pos block-aligned): whole
        blocks;
      * otherwise (decode s=1, a speculative verify s=k+1): token at a
        time, any alignment.
    A logical position at or past MAXB*BS writes to pad block 0, never to
    the row's last real block (a clamped lookup would overwrite the
    row's own valid tail)."""
    bs, maxb = full.shape[2], table.shape[1]
    b, s = new.shape[:2]
    dev = full.device
    pos = pos.to(dev).long()
    tbl = table.to(dev).long()

    def block_of(idx):  # (b, n) logical block ids -> pool block ids
        mapped = torch.gather(tbl, 1, idx.clamp(max=maxb - 1))
        return torch.where(idx < maxb, mapped, torch.zeros_like(mapped))

    if s % bs == 0:
        idx = pos[:, None] // bs + torch.arange(s // bs, device=dev)[None]
        full[li][block_of(idx).reshape(-1)] = new.reshape(
            (b * (s // bs), bs) + tuple(new.shape[2:])).to(full.dtype)
    else:
        p = pos[:, None] + torch.arange(s, device=dev)[None]  # (b, s)
        full[li][block_of(p // bs), p % bs] = new.to(full.dtype)


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


@torch.no_grad()
def pad_vocab(llm, multiple: int):
    """Pad the vocab dim of embed_tokens (rows) and lm_head (output
    columns) of a Llama module with zeros to a multiple, in place (JAX
    models/llama.py:468-518): tensor-parallel vocab sharding needs a
    vocab (32006 with the video tokens) the 'model' axis divides.
    :meth:`Llama.logits` masks the padded columns to -inf, so generation
    never samples a padded id. Raw and int8 leaves; an int8 table's
    padded rows and an int8 head's padded columns take scale 1. Returns
    `llm`."""
    emb = llm.embed_tokens.weight
    rows = llm.embed_tokens.rows
    pad = -(-rows // multiple) * multiple - rows
    if pad == 0:
        return llm

    def padded(x, axis, value=0.0):
        widths = [0, 0] * x.ndim
        widths[2 * (x.ndim - 1 - axis % x.ndim) + 1] = pad
        return nn.Parameter(F.pad(x, widths, value=value),
                            requires_grad=False)

    if isinstance(emb, Int8Kernel):
        emb.qvalues = padded(emb.qvalues, 0)
        emb.scales = padded(emb.scales, 0, 1.0)
    else:
        llm.embed_tokens.weight = padded(emb, 0)
    lm = llm.lm_head.kernel
    if isinstance(lm, Int8Kernel):
        lm.qvalues = padded(lm.qvalues, -1)
        lm.scales = padded(lm.scales, -1, 1.0)
    elif isinstance(lm, torch.Tensor):
        llm.lm_head.kernel = padded(lm, -1)
    else:
        raise ValueError("pad_vocab: unsupported quantized lm_head layout")
    return llm


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


def _shared_input(x, lin: Linear):
    """x as the column-sharded linears of a block (lin and its
    siblings) read it: copied into 'model' once with grad enabled, so
    its gradient is summed over the ranks once for all of them."""
    if lin.tp == "out" and lin.mesh.size > 1:
        return collectives.copy_to(x, lin.mesh)
    return x


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

    def attention(self, x, cos, sin, cache, li: int,
                  write_pos: Optional[torch.Tensor],
                  cache_len: Optional[torch.Tensor]):
        """Self-attention that writes this layer's k/v into the cache (a
        KVCache or a PagedKVCache) at write_pos and attends over the
        cache masked to cache_len: s == 1 through the decode kernel of
        the cache's layout, s > 1 through the plain masked reference over
        the layer (a paged pool gathered into its dense view first).
        Without a cache, causal attention over the s tokens themselves
        (multi_head_attention: the flash kernels on CUDA)."""
        cfg = self.cfg
        b, s, _ = x.shape
        h, h_kv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
        if self.fused[0]:
            q, k, v = self.wqkv(x).split([h * hd, h_kv * hd, h_kv * hd],
                                         dim=-1)
        else:
            x = _shared_input(x, self.wq)
            q, k, v = self.wq(x), self.wk(x), self.wv(x)
        q = apply_rope(q.reshape(b, s, h, hd), cos, sin)
        k = apply_rope(k.reshape(b, s, h_kv, hd), cos, sin)
        v = v.reshape(b, s, h_kv, hd)
        if cache is None:
            out = multi_head_attention(q, k, v, causal=True)
            return self.wo(out.reshape(b, s, h * hd))
        table = getattr(cache, "table", None)
        if table is None:
            write = lambda full, new: _write(  # noqa: E731
                full, new, write_pos, li)
            layer_of = lambda a: a[li]  # noqa: E731
        else:
            write = lambda full, new: _write_paged_cache(  # noqa: E731
                full, new, write_pos, li, table)
            layer_of = lambda a: paged_layer_dense(  # noqa: E731
                a, li, table)
        if cache.k_scale is not None:  # int8 cache: quantize on write
            kq, ks = _quantize_kv(k)
            vq, vs = _quantize_kv(v)
            write(cache.k, kq)
            write(cache.v, vq)
            write(cache.k_scale, ks)
            write(cache.v_scale, vs)
        else:
            write(cache.k, k)
            write(cache.v, v)
        if s == 1:
            scales = dict(k_scale=cache.k_scale, v_scale=cache.v_scale)
            out = (decode_attention_stacked(q, cache.k, cache.v, li,
                                            cache_len, **scales)
                   if table is None else
                   decode_attention_paged(q, cache.k, cache.v, li, table,
                                          cache_len, **scales))
        else:
            if cache.k_scale is not None:
                k_read = _dequantize_kv(layer_of(cache.k),
                                        layer_of(cache.k_scale), q.dtype)
                v_read = _dequantize_kv(layer_of(cache.v),
                                        layer_of(cache.v_scale), q.dtype)
            else:
                k_read, v_read = layer_of(cache.k), layer_of(cache.v)
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
            x = _shared_input(x, self.gate)
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
    module, and `layout` is every layer's :func:`layer_layout`. Under a
    mesh `mesh` is set and `cfg` is the local configuration (the full
    one is `full_cfg`)."""

    mesh = None

    def __init__(self, cfg: LlamaConfig, *, device=None,
                 dtype=torch.bfloat16, quant: Optional[str] = None,
                 group_size: Optional[int] = 128, fuse: bool = False,
                 skip_keys: Tuple[str, ...] = ()):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.cfg = cfg
        self.quant, self.group_size, self.fuse = quant, group_size, fuse
        self.layout = layer_layout(cfg, quant, group_size, fuse)
        d, vocab = cfg.hidden_size, cfg.vocab_size
        skip = ("class_embedding", "position_embedding") + tuple(skip_keys)
        fmt = lambda *keys_shape: quant and leaf_format(  # noqa: E731
            *keys_shape, quant, group_size, skip_keys=skip)
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
        cache=None,
        new_length: Optional[torch.Tensor] = None,
        remat: bool = False,
    ):
        """embeds (b, s, d) + positions (b, s) -> (final-normed hidden
        (b, s, d), cache). Writes k/v into the cache (KVCache or
        PagedKVCache) at cache.length onward and sets cache.length to
        new_length (default length + s). Without a cache, causal
        attention over the s tokens; remat=True then recomputes each
        layer in the backward pass, keeping only its input."""
        cfg = self.cfg
        cos, sin = rope_cos_sin(positions, cfg.head_dim, cfg.rope_theta)
        if cache is None:
            x = inputs_embeds
            for li, layer in enumerate(self.layers):
                if remat and torch.is_grad_enabled():
                    x = checkpoint(layer, x, cos, sin, None, li, None, None,
                                   use_reentrant=False,
                                   preserve_rng_state=False)
                else:
                    x = layer(x, cos, sin, None, li, None, None)
            return self.final_norm(x), None
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
        dtype then f32 (JAX models/llama.py:694-706). A vocab-sharded
        head gathers its columns over 'model'; columns at or past
        cfg.vocab_size (pad_vocab's) are -inf."""
        head = self.lm_head
        sharded = head.tp == "out" and head.mesh.size > 1
        if sharded:
            hidden = collectives.copy_to(hidden, head.mesh)
        logits = linear(hidden, use_param(head, "kernel"),
                        out_dtype=torch.float32)
        if sharded:
            logits = collectives.gather(logits, head.mesh)
        if logits.shape[-1] > self.cfg.vocab_size:
            col = torch.arange(logits.shape[-1], device=logits.device)
            logits = logits.masked_fill(col >= self.cfg.vocab_size,
                                        float("-inf"))
        return logits

    def forward(
        self,
        cache: Optional[KVCache] = None,
        *,
        input_ids: Optional[torch.Tensor] = None,
        inputs_embeds: Optional[torch.Tensor] = None,
        positions: Optional[torch.Tensor] = None,
        new_length: Optional[torch.Tensor] = None,
        remat: bool = False,
    ) -> Tuple[torch.Tensor, Optional[KVCache]]:
        """Full LM forward -> (logits (b, s, vocab) f32, cache); with no
        cache the positions default to 0..s-1 and the cache comes back
        None."""
        if inputs_embeds is None:
            inputs_embeds = self.embed_tokens(input_ids)
        b, s = inputs_embeds.shape[:2]
        if positions is None:
            positions = torch.arange(s, dtype=torch.int32,
                                     device=inputs_embeds.device)[None, :]
            if cache is not None:
                positions = positions + cache.length[:, None]
            positions = positions.expand(b, s)
        hidden, cache = self.forward_hidden(inputs_embeds, positions, cache,
                                            new_length, remat)
        return self.logits(hidden), cache

    def decode_step(self, token: torch.Tensor,
                    cache: KVCache) -> Tuple[torch.Tensor, KVCache]:
        """One decode step. token (b,) -> (logits (b, vocab) f32, cache)."""
        logits, cache = self.forward(
            cache, inputs_embeds=self.embed_tokens(token[:, None]),
            positions=cache.length[:, None], new_length=cache.length + 1,
        )
        return logits[:, 0], cache
