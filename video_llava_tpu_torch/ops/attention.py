"""Attention: plain PyTorch reference + hand-written CUDA kernels.

Counterpart of video_llava_tpu/ops/attention.py for the chat, serving
and training paths:

  * :func:`attention_reference` -- plain torch, f32 softmax. Prefill
    attention into the KV cache runs here, as it runs on XLA in the JAX
    package (``kv_valid_len``/``q_offset`` keep it off the kernels).
  * :func:`flash_attention` -- causal/GQA attention with its gradient
    (the LLaMA forward without a cache, training): forward and backward
    are kernels (csrc/flash_attention.cu); :func:`multi_head_attention`
    is the dispatch.
  * :func:`flash_attention_bhsd` -- CLIP encoder attention over
    head-major, once-padded operands (csrc/flash_bhsd.cu).
  * :func:`decode_attention_stacked` -- one query token against one
    layer of the stacked (NL, b, L, h, d) KV cache, bf16 or int8
    (csrc/decode_attention.cu).
  * :func:`decode_attention_paged` -- the same against one layer of the
    paged (NL, NB, BS, h, d) block pool through a block table (the same
    kernel body, csrc/decode_attention.cu).

Each kernel wrapper takes its plain version (``*_plain``) only for a
tensor on the CPU; for a CUDA tensor it launches the kernel or raises.
Layouts are the JAX package's: BSHD at :func:`attention_reference`,
(b, h, s_pad, d) for CLIP, (b, 1, h, d) queries for decode.
"""

from __future__ import annotations

from typing import Optional

import torch

from video_llava_tpu_torch.ops import cuda_lib

DEFAULT_MASK_VALUE = -1e30


def _repeat_kv(k: torch.Tensor, num_heads: int) -> torch.Tensor:
    """(b, s, h_kv, d) -> (b, s, h, d) by repeating each kv head."""
    h_kv = k.shape[2]
    if h_kv == num_heads:
        return k
    return torch.repeat_interleave(k, num_heads // h_kv, dim=2)


def attention_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = False,
    kv_valid_len: Optional[torch.Tensor] = None,
    q_offset: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Attention with an f32 softmax. q: (b, sq, h, d); k/v: (b, skv,
    h_kv, d) -> (b, sq, h, d) in q's dtype.

    kv_valid_len: optional (b,) int -- keys at positions >= len are
    masked out. q_offset: optional (b,) int absolute position of each
    row's first query among the keys (prefill into a cache); default
    right-aligned (skv - sq). Probabilities are rounded to v's dtype
    before the second product, as in the JAX reference.
    """
    b, sq, h, d = q.shape
    skv = k.shape[1]
    scale = scale if scale is not None else 1.0 / (d**0.5)
    k = _repeat_kv(k, h)
    v = _repeat_kv(v, h)
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if causal:
        if q_offset is None:
            q_offset = torch.full((b,), skv - sq, dtype=torch.int32,
                                  device=q.device)
        qpos = (torch.arange(sq, device=q.device)[None, :, None]
                + q_offset.to(q.device)[:, None, None])  # (b, sq, 1)
        kpos = torch.arange(skv, device=q.device)[None, None, :]
        logits = logits.masked_fill(~(qpos >= kpos)[:, None],
                                    DEFAULT_MASK_VALUE)
    if kv_valid_len is not None:
        kmask = (torch.arange(skv, device=q.device)[None, :]
                 < kv_valid_len.to(q.device)[:, None])  # (b, skv)
        logits = logits.masked_fill(~kmask[:, None, None, :],
                                    DEFAULT_MASK_VALUE)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", probs.to(v.dtype).float(),
                       v.float())
    return out.to(q.dtype)


# ---------------------------------------------------------------------------
# Kernels 7 and 8: flash attention forward and backward (training)
# ---------------------------------------------------------------------------

LSE_SENTINEL = 1e30  # lse of a row that sees no key: exp(s - lse) is 0


def flash_mask(sq: int, skv: int, causal: bool, device) -> torch.Tensor:
    """(sq, skv) bool: key j is seen by query i (all keys, or with
    `causal` j <= i + skv - sq, the right-aligned convention)."""
    if not causal:
        return torch.ones((sq, skv), dtype=torch.bool, device=device)
    qpos = torch.arange(sq, device=device)[:, None] + (skv - sq)
    return qpos >= torch.arange(skv, device=device)[None, :]


def _default_scale(d: int, scale: Optional[float]) -> float:
    return float(scale) if scale is not None else 1.0 / (d**0.5)


def flash_forward_plain(q, k, v, causal: bool = False,
                        scale: Optional[float] = None):
    """Plain version of :func:`flash_forward` (JAX ``_flash_forward``):
    f32 products and softmax, masked keys at DEFAULT_MASK_VALUE, out =
    (p v) / l in q's dtype, lse = m + log(l) (b, h, sq) f32 with
    LSE_SENTINEL where it is not finite."""
    b, sq, h, d = q.shape
    skv = k.shape[1]
    scale = _default_scale(d, scale)
    kk, vv = _repeat_kv(k, h).float(), _repeat_kv(v, h).float()
    s = torch.einsum("bqhd,bkhd->bhqk", q.float() * scale, kk)
    s = s.masked_fill(~flash_mask(sq, skv, causal, q.device),
                      DEFAULT_MASK_VALUE)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    out = torch.einsum("bhqk,bkhd->bhqd", p, vv) / l
    lse = (m + torch.log(l))[..., 0]
    lse = torch.where(torch.isfinite(lse), lse,
                      torch.full_like(lse, LSE_SENTINEL))
    return out.transpose(1, 2).to(q.dtype), lse


def flash_backward_masked(q, k, v, out, lse, g, mask: torch.Tensor,
                          scale: float):
    """The backward of :func:`flash_backward_plain` under an explicit
    (sq, skv) bool `mask` of the keys each query sees."""
    b, sq, h, d = q.shape
    skv, h_kv = k.shape[1], k.shape[2]
    qf, gf = q.float(), g.float()
    kk, vv = _repeat_kv(k, h).float(), _repeat_kv(v, h).float()
    s = torch.einsum("bqhd,bkhd->bhqk", qf, kk) * scale
    p = torch.where(mask, torch.exp(s - lse[..., None]), 0.0)
    dp = torch.einsum("bqhd,bkhd->bhqk", gf, vv)
    ds = p * (dp - flash_delta(out, g)[..., None])
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, kk) * scale
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, qf) * scale
    dv = torch.einsum("bhqk,bqhd->bkhd", p, gf)
    # GQA: sum over the query heads sharing each kv head
    dk = dk.reshape(b, skv, h_kv, h // h_kv, d).sum(dim=3)
    dv = dv.reshape(b, skv, h_kv, h // h_kv, d).sum(dim=3)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def flash_backward_plain(q, k, v, out, lse, g, causal: bool = False,
                         scale: Optional[float] = None):
    """Plain version of :func:`flash_backward` (JAX ``_flash_backward``):
    p = exp(s * scale - lse) recomputed under the same mask, D =
    rowsum(dO * O), dS = p (dP - D); dk and dv per query head, summed
    over each kv head's group; outputs in the inputs' dtypes."""
    scale = _default_scale(q.shape[-1], scale)
    mask = flash_mask(q.shape[1], k.shape[1], causal, q.device)
    return flash_backward_masked(q, k, v, out, lse, g, mask, scale)


def _check_flash(q, k, v, causal: bool):
    """Raise unless the kernels take these operands: bf16, contiguous
    BSHD, h a multiple of h_kv, d a multiple of 16 up to 128, and under
    the causal mask sq <= skv (every query row sees a key)."""
    b, sq, h, d = q.shape
    skv, h_kv = k.shape[1], k.shape[2]
    cuda_lib.require(q, "q", torch.bfloat16, (b, sq, h, d))
    cuda_lib.require(k, "k", torch.bfloat16, (b, skv, h_kv, d), q.device)
    cuda_lib.require(v, "v", torch.bfloat16, (b, skv, h_kv, d), q.device)
    if d % 16 or not 16 <= d <= 128:
        raise ValueError(f"head dim {d}: must be a multiple of 16 <= 128")
    if h % h_kv:
        raise ValueError(f"{h} query heads do not group over {h_kv}")
    if sq < 1 or skv < 1:
        raise ValueError(f"empty sequence: sq {sq}, skv {skv}")
    if causal and sq > skv:
        raise ValueError(f"causal attention with sq {sq} > skv {skv}")
    if b * h > 65535:
        raise ValueError(f"b*h = {b * h} exceeds the grid's y limit")


def flash_forward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  causal: bool = False, scale: Optional[float] = None):
    """Kernel 7. q (b, sq, h, d), k/v (b, skv, h_kv, d) -> (out (b, sq,
    h, d) in q's dtype, lse (b, h, sq) f32). On CUDA: bf16, d a multiple
    of 16 up to 128 (csrc/flash_attention.cu)."""
    b, sq, h, d = q.shape
    scale = _default_scale(d, scale)
    if q.device.type == "cpu":
        return flash_forward_plain(q, k, v, causal, scale)
    _check_flash(q, k, v, causal)
    out = torch.empty_like(q)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    cuda_lib.launch(
        "flash_forward", "vlt_flash_fwd", q.device,
        cuda_lib.ptr(q), cuda_lib.ptr(k), cuda_lib.ptr(v), cuda_lib.ptr(out),
        cuda_lib.ptr(lse), b, sq, k.shape[1], h, k.shape[2], d, int(causal),
        scale,
    )
    return out, lse


def flash_delta(out: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """D = rowsum(dO * O) in f32, (b, h, sq) contiguous: plain torch, as
    the JAX package computes it outside its kernels."""
    return (g.float() * out.float()).sum(dim=-1).transpose(1, 2).contiguous()


def _flash_bwd_args(q, k, v, g, lse, delta, causal: bool, scale: float):
    b, sq, h, d = q.shape
    ins = tuple(cuda_lib.ptr(t) for t in (q, k, v, g, lse, delta))
    return ins, (b, sq, k.shape[1], h, k.shape[2], d, int(causal), scale)


def flash_backward_dq(q, k, v, g, lse, delta, causal: bool, scale: float):
    """Kernel 8's dq kernel on operands :func:`flash_backward` checked."""
    dq = torch.empty_like(q)
    ins, shape = _flash_bwd_args(q, k, v, g, lse, delta, causal, scale)
    cuda_lib.launch("flash_backward_dq", "vlt_flash_bwd_dq", q.device, *ins,
                    cuda_lib.ptr(dq), *shape)
    return dq


def flash_backward_dkv(q, k, v, g, lse, delta, causal: bool, scale: float):
    """Kernel 8's dk/dv kernel (each kv head's group summed in the block)
    on operands :func:`flash_backward` checked."""
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    ins, shape = _flash_bwd_args(q, k, v, g, lse, delta, causal, scale)
    cuda_lib.launch("flash_backward_dkv", "vlt_flash_bwd_dkv", q.device,
                    *ins, cuda_lib.ptr(dk), cuda_lib.ptr(dv), *shape)
    return dk, dv


def flash_backward(q, k, v, out, lse, g, causal: bool = False,
                   scale: Optional[float] = None):
    """Kernel 8 -> (dq, dk, dv) in the inputs' dtypes: D (flash_delta),
    then the dq kernel and the dk/dv kernel (csrc/flash_attention.cu)."""
    b, sq, h, d = q.shape
    scale = _default_scale(d, scale)
    if q.device.type == "cpu":
        return flash_backward_plain(q, k, v, out, lse, g, causal, scale)
    _check_flash(q, k, v, causal)
    dev = q.device
    cuda_lib.require(out, "out", torch.bfloat16, q.shape, dev)
    cuda_lib.require(g, "g", torch.bfloat16, q.shape, dev)
    cuda_lib.require(lse, "lse", torch.float32, (b, h, sq), dev)
    delta = flash_delta(out, g)
    dq = flash_backward_dq(q, k, v, g, lse, delta, causal, scale)
    dk, dv = flash_backward_dkv(q, k, v, g, lse, delta, causal, scale)
    return dq, dk, dv


class _FlashAttention(torch.autograd.Function):
    """JAX ``flash_attention``'s custom VJP: the forward saves (q, k, v,
    out, lse), the backward recomputes p from lse (no stored
    probability matrix)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale):
        out, lse = flash_forward(q, k, v, causal, scale)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.scale = causal, scale
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_backward(q, k, v, out, lse, g.contiguous(),
                                    ctx.causal, ctx.scale)
        return dq, dk, dv, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = False,
                    scale: Optional[float] = None) -> torch.Tensor:
    """Flash attention with its gradient. q (b, sq, h, d); k/v (b, skv,
    h_kv, d) -> (b, sq, h, d). CPU tensors take the plain forward and
    backward; CUDA tensors launch kernels 7 and 8 or raise."""
    scale = _default_scale(q.shape[-1], scale)
    if q.device.type != "cpu":
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    return _FlashAttention.apply(q, k, v, causal, scale)


def multi_head_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = False,
    kv_valid_len: Optional[torch.Tensor] = None,
    q_offset: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Dispatch (JAX ops/attention.py:736-778): the flash kernels for
    CUDA tensors when no key mask or per-row offset is asked for and d %
    8 == 0; the masked reference otherwise. The CPU takes the reference,
    as the JAX package's CPU backend does."""
    plain = kv_valid_len is None and q_offset is None and q.shape[-1] % 8 == 0
    if plain and q.is_cuda:
        return flash_attention(q, k, v, causal, scale)
    return attention_reference(q, k, v, causal=causal,
                               kv_valid_len=kv_valid_len, q_offset=q_offset,
                               scale=scale)


# ---------------------------------------------------------------------------
# Kernel 1: CLIP encoder attention
# ---------------------------------------------------------------------------


def flash_attention_bhsd_plain(q, k, v, *, kv_len=None, scale=None):
    """Plain version of :func:`flash_attention_bhsd`: the masked
    reference over the transposed operands."""
    b, h, s, d = q.shape
    kv_len = s if kv_len is None else kv_len
    lens = torch.full((b,), kv_len, dtype=torch.int32, device=q.device)
    out = attention_reference(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
        kv_valid_len=lens, scale=scale,
    )
    return out.transpose(1, 2)


def flash_attention_bhsd(
    q: torch.Tensor,  # (b, h, s_pad, d)
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    kv_len: Optional[int] = None,  # true kv length (masks the pad tail)
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Non-causal attention over head-major, pre-padded operands ->
    (b, h, s_pad, d); keys at or past `kv_len` are masked. On CUDA:
    bf16 in and out, any s_pad and kv_len, d a multiple of 16 up to
    128 (csrc/flash_bhsd.cu)."""
    b, h, s, d = q.shape
    kv_len = s if kv_len is None else int(kv_len)
    scale = scale if scale is not None else 1.0 / (d**0.5)
    if q.device.type == "cpu":
        return flash_attention_bhsd_plain(q, k, v, kv_len=kv_len,
                                          scale=scale)
    for name, t in (("q", q), ("k", k), ("v", v)):
        cuda_lib.require(t, name, torch.bfloat16, (b, h, s, d), q.device)
    if d % 16 or not 16 <= d <= 128:
        raise ValueError(f"head dim {d}: must be a multiple of 16 <= 128")
    if not 1 <= kv_len <= s:
        raise ValueError(f"kv_len {kv_len} outside [1, {s}]")
    if b * h > 65535:
        raise ValueError(f"b*h = {b * h} exceeds the grid's y limit")
    out = torch.empty_like(q)
    cuda_lib.launch(
        "flash_attention_bhsd", "vlt_flash_bhsd", q.device,
        cuda_lib.ptr(q), cuda_lib.ptr(k), cuda_lib.ptr(v), cuda_lib.ptr(out),
        b * h, s, d, kv_len, float(scale),
    )
    return out


# ---------------------------------------------------------------------------
# Kernel 3: decode attention over the stacked KV cache
# ---------------------------------------------------------------------------


def decode_attention_stacked_plain(q, k_cache, v_cache, layer, cache_len,
                                   k_scale=None, v_scale=None, scale=None):
    """Plain version of :func:`decode_attention_stacked`: slice the
    layer, dequantize to q's dtype, masked reference attention (the JAX
    package's XLA path)."""
    k, v = k_cache[layer], v_cache[layer]
    if k_scale is not None:
        k = (k.float() * k_scale[layer][..., None]).to(q.dtype)
        v = (v.float() * v_scale[layer][..., None]).to(q.dtype)
    return attention_reference(q, k, v, kv_valid_len=cache_len, scale=scale)


def decode_attention_stacked(
    q: torch.Tensor,  # (b, 1, h, d)
    k_cache: torch.Tensor,  # (NL, b, L, h, d) bf16, or int8 with scales
    v_cache: torch.Tensor,
    layer: int,
    cache_len: torch.Tensor,  # (b,) int32
    k_scale: Optional[torch.Tensor] = None,  # (NL, b, L, h) f32 when int8
    v_scale: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """One decode step's attention against layer `layer` of the stacked
    cache -> (b, 1, h, d). Positions at or past a row's length are never
    read. On CUDA: MHA only (h == h_kv), d in {64, 128}, bf16 query
    (csrc/decode_attention.cu)."""
    b, _, h, d = q.shape
    nl, _, L, h_kv = k_cache.shape[:4]
    scale = scale if scale is not None else 1.0 / (d**0.5)
    if q.device.type == "cpu":
        return decode_attention_stacked_plain(
            q, k_cache, v_cache, layer, cache_len, k_scale, v_scale, scale)
    if h_kv != h:
        raise NotImplementedError("decode kernel is MHA-only (h == h_kv)")
    if d not in (64, 128):
        raise ValueError(f"head dim {d}: the decode kernel takes 64 or 128")
    if not 0 <= layer < nl:
        raise IndexError(f"layer {layer} outside [0, {nl})")
    quantized = k_scale is not None
    cdtype = torch.int8 if quantized else torch.bfloat16
    dev = q.device
    cuda_lib.require(q, "q", torch.bfloat16, (b, 1, h, d))
    cuda_lib.require(k_cache, "k_cache", cdtype, (nl, b, L, h, d), dev)
    cuda_lib.require(v_cache, "v_cache", cdtype, (nl, b, L, h, d), dev)
    cuda_lib.require(cache_len, "cache_len", torch.int32, (b,), dev)
    if quantized:
        cuda_lib.require(k_scale, "k_scale", torch.float32, (nl, b, L, h),
                         dev)
        cuda_lib.require(v_scale, "v_scale", torch.float32, (nl, b, L, h),
                         dev)
        ks, vs = cuda_lib.ptr(k_scale), cuda_lib.ptr(v_scale)
    else:
        ks = vs = None
    if (L + 9 * d) * 4 > 227 * 1024:
        raise ValueError(f"cache length {L} exceeds the kernel's shared "
                         "memory for its scores")
    out = torch.empty_like(q)
    cuda_lib.launch(
        "decode_attention_stacked", "vlt_decode_attention", q.device,
        cuda_lib.ptr(q), cuda_lib.ptr(k_cache), cuda_lib.ptr(v_cache),
        ks, vs, cuda_lib.ptr(cache_len), cuda_lib.ptr(out),
        int(layer), b, L, h, d, int(quantized), float(scale),
    )
    return out


# ---------------------------------------------------------------------------
# Kernel 10: decode attention over the paged block pool
# ---------------------------------------------------------------------------


def paged_layer_dense(a: torch.Tensor, li: int,
                      table: torch.Tensor) -> torch.Tensor:
    """Layer li of the paged pool gathered into each row's logically
    contiguous view: (NL, NB, BS, ...) -> (b, MAXB*BS, ...), a copy (JAX
    models/llama.py:282-290). The s > 1 read path of the LLaMA layer and
    the plain version of kernel 10; the kernel reads the blocks in
    place."""
    g = a[li][table.long()]  # (b, MAXB, BS, ...)
    return g.reshape((table.shape[0], -1) + tuple(a.shape[3:]))


def decode_attention_paged_plain(q, k_cache, v_cache, layer, table,
                                 cache_len, k_scale=None, v_scale=None,
                                 scale=None):
    """Plain version of :func:`decode_attention_paged`: gather the rows'
    blocks of the layer into a logically dense (b, MAXB*BS, h, d) view
    through the table (:func:`paged_layer_dense`), dequantize, masked
    reference attention (the JAX package's fallback,
    ops/attention.py:1481-1492)."""
    dense = lambda a: paged_layer_dense(a, layer, table)  # noqa: E731
    k, v = dense(k_cache), dense(v_cache)
    if k_scale is not None:
        k = (k.float() * dense(k_scale)[..., None]).to(q.dtype)
        v = (v.float() * dense(v_scale)[..., None]).to(q.dtype)
    return attention_reference(q, k, v, kv_valid_len=cache_len, scale=scale)


def decode_attention_paged(
    q: torch.Tensor,  # (b, 1, h, d)
    k_cache: torch.Tensor,  # (NL, NB, BS, h, d) bf16, or int8 with scales
    v_cache: torch.Tensor,
    layer: int,
    table: torch.Tensor,  # (b, MAXB) int32 pool block ids
    cache_len: torch.Tensor,  # (b,) int32
    k_scale: Optional[torch.Tensor] = None,  # (NL, NB, BS, h) f32 when int8
    v_scale: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """One decode step's attention against layer `layer` of the paged
    block pool (models/llama.PagedKVCache) -> (b, 1, h, d): position p
    of row i is pool block table[i, p // BS], offset p % BS. Positions
    at or past a row's length, and the table entries that map them, are
    never read; every entry must still be a valid block id (0, the pad
    block, past a row's allocation). On CUDA, under the JAX package's
    dispatch conditions (ops/attention.py:1465-1476): MHA, h*d a
    multiple of 128, BS a multiple of 16 up to 128, and d in {64, 128}
    (csrc/decode_attention.cu); other shapes raise."""
    b, _, h, d = q.shape
    nl, nb, bs, h_kv = k_cache.shape[:4]
    maxb = table.shape[1]
    scale = scale if scale is not None else 1.0 / (d**0.5)
    if q.device.type == "cpu":
        return decode_attention_paged_plain(
            q, k_cache, v_cache, layer, table, cache_len, k_scale, v_scale,
            scale)
    if h_kv != h:
        raise NotImplementedError("paged decode kernel is MHA-only "
                                  "(h == h_kv)")
    if (h * d) % 128 or bs % 16 or bs > 128:
        raise ValueError(f"paged decode kernel: h*d = {h * d} must be a "
                         f"multiple of 128 and the block size {bs} a "
                         "multiple of 16 up to 128")
    if d not in (64, 128):
        raise ValueError(f"head dim {d}: the decode kernel takes 64 or 128")
    if not 0 <= layer < nl:
        raise IndexError(f"layer {layer} outside [0, {nl})")
    quantized = k_scale is not None
    cdtype = torch.int8 if quantized else torch.bfloat16
    dev = q.device
    cuda_lib.require(q, "q", torch.bfloat16, (b, 1, h, d))
    cuda_lib.require(k_cache, "k_cache", cdtype, (nl, nb, bs, h, d), dev)
    cuda_lib.require(v_cache, "v_cache", cdtype, (nl, nb, bs, h, d), dev)
    cuda_lib.require(table, "table", torch.int32, (b, maxb), dev)
    cuda_lib.require(cache_len, "cache_len", torch.int32, (b,), dev)
    if quantized:
        for name, t in (("k_scale", k_scale), ("v_scale", v_scale)):
            cuda_lib.require(t, name, torch.float32, (nl, nb, bs, h), dev)
        ks, vs = cuda_lib.ptr(k_scale), cuda_lib.ptr(v_scale)
    else:
        ks = vs = None
    if (maxb * bs + 9 * d) * 4 + maxb * 4 > 227 * 1024:
        raise ValueError(f"{maxb} blocks of {bs} exceed the kernel's shared "
                         "memory for its scores")
    out = torch.empty_like(q)
    cuda_lib.launch(
        "decode_attention_paged", "vlt_decode_attention_paged", dev,
        cuda_lib.ptr(q), cuda_lib.ptr(k_cache), cuda_lib.ptr(v_cache),
        ks, vs, cuda_lib.ptr(table), cuda_lib.ptr(cache_len),
        cuda_lib.ptr(out), int(layer), b, nb, bs, maxb, h, d,
        int(quantized), float(scale),
    )
    return out
