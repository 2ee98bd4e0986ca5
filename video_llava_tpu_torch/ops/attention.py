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
    (csrc/decode_attention.cu: the MHA split body, its chunks merged in
    the same launch).
  * :func:`decode_attention_paged` -- the same against one layer of the
    paged (NL, NB, BS, h, d) block pool through a block table (kernel
    11's split body, csrc/decode_attention.cu).
  * :func:`decode_attention` -- the flat dispatch over one layer's
    (b, L, h_kv, d) cache: :func:`decode_attention_mxu` (MHA, the same
    kernel body at NL = 1) or :func:`decode_attention_pallas` (grouped
    query heads, kernel 11's split body), or the plain masked reference. The
    stacked and paged wrappers fall through to it for the shapes their
    kernels do not take, as the JAX package's do.

Each kernel wrapper takes its plain version (``*_plain``) only for a
tensor on the CPU; for a CUDA tensor it launches the kernel or raises.
Layouts are the JAX package's: BSHD at :func:`attention_reference`,
(b, h, s_pad, d) for CLIP, (b, 1, h, d) queries for decode.

Module switches, as in the JAX package (ops/attention.py:33-58):
:func:`set_default_impl` -- 'auto' (kernels for CUDA tensors, the plain
reference for CPU ones), 'pallas' (the kernels' plain versions on the
CPU as well) or 'xla' (the plain reference, on CUDA tensors too: the
decode wrappers launch nothing under it, as the JAX package's 'xla' runs
its XLA twin on the accelerator); :func:`enable_paged_kernel` -- off
sends the paged wrapper through the dense gather and the flat dispatch
(the escape hatch).
"""

from __future__ import annotations

import functools
from typing import Optional

import torch

from video_llava_tpu_torch.ops import cuda_lib

DEFAULT_MASK_VALUE = -1e30
_DECODE_HEAD_DIMS = (32, 64, 128)  # what the decode kernels take

_DEFAULT_IMPL = "auto"
_PAGED_KERNEL = True


def set_default_impl(impl: str) -> None:
    """'auto', 'xla' or 'pallas' (see the module docstring)."""
    global _DEFAULT_IMPL
    if impl not in ("auto", "xla", "pallas"):
        raise ValueError(f"unknown attention impl {impl!r}")
    _DEFAULT_IMPL = impl


def enable_paged_kernel(on: bool = True) -> None:
    global _PAGED_KERNEL
    _PAGED_KERNEL = bool(on)


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
    sq, skv = q.shape[1], k.shape[1]
    mask = flash_mask(sq, skv, causal, q.device)
    return flash_forward_masked(q, k, v, mask,
                                _default_scale(q.shape[-1], scale))


def flash_forward_masked(q, k, v, mask: torch.Tensor, scale: float):
    """The forward of :func:`flash_forward_plain` under an explicit
    (sq, skv) bool `mask` of the keys each query sees."""
    h = q.shape[2]
    kk, vv = _repeat_kv(k, h).float(), _repeat_kv(v, h).float()
    s = torch.einsum("bqhd,bkhd->bhqk", q.float() * scale, kk)
    s = s.masked_fill(~mask, DEFAULT_MASK_VALUE)
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


def _check_flash(q, k, v, causal: bool, dtype=torch.bfloat16):
    """Raise unless the kernels take these operands: `dtype`, contiguous
    BSHD, h a multiple of h_kv, d a multiple of 8 up to 128 (the
    wrappers pad d % 16 == 8 to the next multiple of 16), under the
    causal mask sq <= skv (every query row sees a key), and at most
    65,535 tiles of 64 rows along the grid's y (b*h runs along x)."""
    b, sq, h, d = q.shape
    skv, h_kv = k.shape[1], k.shape[2]
    cuda_lib.require(q, "q", dtype, (b, sq, h, d))
    cuda_lib.require(k, "k", dtype, (b, skv, h_kv, d), q.device)
    cuda_lib.require(v, "v", dtype, (b, skv, h_kv, d), q.device)
    if d % 8 or not 8 <= d <= 128:
        raise ValueError(f"head dim {d}: must be a multiple of 8 <= 128")
    if h % h_kv:
        raise ValueError(f"{h} query heads do not group over {h_kv}")
    if sq < 1 or skv < 1:
        raise ValueError(f"empty sequence: sq {sq}, skv {skv}")
    if causal and sq > skv:
        raise ValueError(f"causal attention with sq {sq} > skv {skv}")
    if -(-max(sq, skv) // 64) > 65535:
        raise ValueError(f"{max(sq, skv)} rows exceed the grid's y limit "
                         f"of 65,535 tiles of 64")


def pad_head_dim(t: torch.Tensor, d: int) -> torch.Tensor:
    """`t` zero-padded along its last axis to `d` columns (`t` itself
    when it has them)."""
    n = t.shape[-1]
    return t if n == d else torch.nn.functional.pad(t, (0, d - n))


def flash_forward_padded(fwd, q, k, v, causal: bool = False,
                         scale: Optional[float] = None):
    """`fwd` (kernel 7's wrapper or :func:`flash_forward_plain`) on q, k
    and v zero-padded along d to the next multiple of 16 -> (out sliced
    back to d columns, lse). The scale is the unpadded d's: the zero
    columns add nothing to q k^T, and the padded v columns only give
    output columns that are sliced away, so the result is the unpadded
    function's."""
    d = q.shape[-1]
    scale = _default_scale(d, scale)
    dp = -(-d // 16) * 16
    out, lse = fwd(*(pad_head_dim(t, dp) for t in (q, k, v)), causal, scale)
    return out[..., :d].contiguous(), lse


def flash_backward_padded(bwd, q, k, v, out, lse, g, causal: bool = False,
                          scale: Optional[float] = None):
    """`bwd` (kernel 8's wrapper or :func:`flash_backward_plain`) on its
    operands zero-padded along d as :func:`flash_forward_padded` pads
    them -> (dq, dk, dv) sliced back to d columns. The padded columns of
    q, k, v, out and g are zero, so they add nothing to s, dP or D."""
    d = q.shape[-1]
    scale = _default_scale(d, scale)
    dp = -(-d // 16) * 16
    grads = bwd(*(pad_head_dim(t, dp) for t in (q, k, v, out)), lse,
                pad_head_dim(g, dp), causal, scale)
    return tuple(x[..., :d].contiguous() for x in grads)


def flash_forward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  causal: bool = False, scale: Optional[float] = None):
    """Kernel 7. q (b, sq, h, d), k/v (b, skv, h_kv, d) -> (out (b, sq,
    h, d) in q's dtype, lse (b, h, sq) f32). On CUDA, d a multiple of 8
    up to 128 (d % 16 == 8 zero-padded to the next multiple of 16 by
    :func:`flash_forward_padded`): bf16 operands launch
    csrc/flash_attention.cu's forward, f32 operands
    csrc/flash_attention_f32.cu's (counted as "flash_forward_f32");
    other dtypes raise."""
    b, sq, h, d = q.shape
    scale = _default_scale(d, scale)
    if q.device.type == "cpu":
        return flash_forward_plain(q, k, v, causal, scale)
    f32 = q.dtype == torch.float32
    _check_flash(q, k, v, causal, torch.float32 if f32 else torch.bfloat16)
    if d % 16:
        return flash_forward_padded(flash_forward, q, k, v, causal, scale)
    out = torch.empty_like(q)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    cuda_lib.launch(
        "flash_forward_f32" if f32 else "flash_forward",
        "vlt_flash_fwd_f32" if f32 else "vlt_flash_fwd", q.device,
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
    then the dq kernel and the dk/dv kernel (csrc/flash_attention.cu).
    On CUDA the operands must be bf16: f32 ones raise (the f32 body of
    kernel 7 is a forward only). d % 16 == 8 is zero-padded as in
    :func:`flash_forward` (:func:`flash_backward_padded`)."""
    b, sq, h, d = q.shape
    scale = _default_scale(d, scale)
    if q.device.type == "cpu":
        return flash_backward_plain(q, k, v, out, lse, g, causal, scale)
    _check_flash(q, k, v, causal)
    if d % 16:
        return flash_backward_padded(flash_backward, q, k, v, out, lse, g,
                                     causal, scale)
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
    """Dispatch (JAX ops/attention.py:736-778), decided from the operands
    alone before anything launches: operands off the CPU with no key
    mask, no per-row offset and d % 8 == 0, whatever their dtype, go to
    kernel 7 through :func:`flash_attention` -- bf16 to its bf16 body
    (kernel 8 its gradient), f32 (Whisper `base` as the chat CLI's
    --use_asr builds it) to its f32 body -- as the JAX package sends them
    to its Pallas forward on one TPU chip (d % 16 == 8 zero-padded to
    the next multiple of 16 there); operands that the kernels do not
    take (d past 128, another dtype, mixed dtypes) raise there. A mask,
    an offset, d % 8 != 0 and CPU tensors take the masked reference, as
    the JAX package's CPU backend does."""
    if (q.device.type != "cpu" and kv_valid_len is None
            and q_offset is None and q.shape[-1] % 8 == 0):
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
    bf16 in and out, any b*h, s_pad and kv_len, d a multiple of 16 up
    to 128 (csrc/flash_bhsd.cu: a Hopper body for d 64 and 128, a WMMA
    body for the others)."""
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


MHA_BLOCKS_PER_SM = 4  # kernels 3 and 9's plan target (PERF.md §6)
MHA_SPLITS_MAX = 128  # = kMhaSplitsMax in csrc/decode_attention.cu


def mha_split_plan(L: int, b: int, h: int, sms: int) -> tuple:
    """Kernels 3 and 9's split of a row's [0, L) -> (chunk, splits):
    :func:`gqa_split_plan` at one head a block, about MHA_BLOCKS_PER_SM
    blocks an SM over the b * h (row, head) pairs, and at most
    MHA_SPLITS_MAX chunks (the partials the last block merges)."""
    chunk, _ = gqa_split_plan(L, b, h, sms, per_sm=MHA_BLOCKS_PER_SM)
    least = -(-max(L, 1) // MHA_SPLITS_MAX)
    chunk = max(chunk, -(-least // 16) * 16)
    return chunk, -(-L // chunk)


def _decode_mha(kernel: str, q, k_cache, v_cache, cache_len, layer: int,
                k_scale, v_scale, scale: float) -> torch.Tensor:
    """Launch kernels 3 and 9's body (csrc/decode_attention.cu) on
    operands the caller checked: layer `layer` of a (NL, b, L, h, d)
    cache (a flat cache is NL = 1), split by :func:`mha_split_plan`; a
    block per (row, head, chunk) writes an f32 partial and the last one
    of a (row, head) merges them in split order, in the same launch.
    Counted as `kernel`."""
    b, _, h, d = q.shape
    L = k_cache.shape[-3]
    dev = q.device
    chunk, splits = mha_split_plan(L, b, h, _sm_count(dev.index))
    ws = counters = None
    if splits > 1:
        ws = torch.empty(b * h * splits * (d + 2), dtype=torch.float32,
                         device=dev)
        counters = cuda_lib.counters(dev, b * h)
    quantized = k_scale is not None
    opt = lambda t: None if t is None else cuda_lib.ptr(t)  # noqa: E731
    out = torch.empty_like(q)
    cuda_lib.launch(
        kernel, "vlt_decode_attention", dev,
        cuda_lib.ptr(q), cuda_lib.ptr(k_cache), cuda_lib.ptr(v_cache),
        opt(k_scale), opt(v_scale), cuda_lib.ptr(cache_len),
        cuda_lib.ptr(out), opt(ws), opt(counters),
        int(layer), b, L, h, d, int(quantized), chunk, splits, float(scale),
    )
    return out


def decode_attention_stacked_plain(q, k_cache, v_cache, layer, cache_len,
                                   k_scale=None, v_scale=None, scale=None):
    """Plain version of :func:`decode_attention_stacked`: the layer's
    view through :func:`decode_attention_reference` (the JAX package's
    XLA path)."""
    unit = lambda a: None if a is None else a[layer][..., None]  # noqa
    return decode_attention_reference(q, k_cache[layer], v_cache[layer],
                                      cache_len, unit(k_scale),
                                      unit(v_scale), scale)


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
    read. On CUDA, under the JAX package's conditions
    (ops/attention.py:1320-1331): MHA, h*d a multiple of 128, d in {32,
    64, 128}, bf16 query: kernel 3 (:func:`_decode_mha`, any L). Other
    shapes and CPU tensors take the layer's view through
    :func:`decode_attention` (JAX :1335-1340), and so does every tensor
    under set_default_impl('xla')."""
    b, _, h, d = q.shape
    nl, _, L, h_kv = k_cache.shape[:4]
    scale = scale if scale is not None else 1.0 / (d**0.5)
    if _DEFAULT_IMPL == "xla" or not (
            q.device.type != "cpu" and h == h_kv
            and (h * d) % 128 == 0 and d in _DECODE_HEAD_DIMS):
        unit = lambda a: None if a is None else a[layer][..., None]  # noqa
        return decode_attention(q, k_cache[layer], v_cache[layer],
                                cache_len, k_scale=unit(k_scale),
                                v_scale=unit(v_scale), scale=scale)
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
    return _decode_mha("decode_attention_stacked", q, k_cache, v_cache,
                       cache_len, layer, k_scale, v_scale, scale)


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
    through the table (:func:`paged_layer_dense`), then
    :func:`decode_attention_reference` (the JAX package's fallback,
    ops/attention.py:1481-1492)."""
    dense = lambda a: paged_layer_dense(a, layer, table)  # noqa: E731
    unit = lambda a: None if a is None else dense(a)[..., None]  # noqa
    return decode_attention_reference(q, dense(k_cache), dense(v_cache),
                                      cache_len, unit(k_scale),
                                      unit(v_scale), scale)


PAGED_BLOCKS_PER_SM = 8  # kernel 10's plan target (PERF.md §6)
PAGED_TABLE_MAX = 256  # = kTableMax in csrc/decode_attention.cu


def paged_split_plan(maxb: int, bs: int, b: int, h: int, sms: int) -> tuple:
    """Kernel 10's split of a row's [0, maxb * bs) -> (chunk, splits):
    :func:`gqa_split_plan` with chunks of whole pool blocks (a multiple
    of bs), about PAGED_BLOCKS_PER_SM blocks an SM over the b * h (row,
    head) pairs, and at most PAGED_TABLE_MAX pool blocks a chunk (the
    table entries a block stages)."""
    L = maxb * bs
    chunk, _ = gqa_split_plan(L, b, h, sms, align=bs,
                              per_sm=PAGED_BLOCKS_PER_SM)
    chunk = min(chunk, PAGED_TABLE_MAX * bs)
    return chunk, -(-L // chunk)


def decode_paged_partials_plain(q, k_cache, v_cache, layer, table,
                                cache_len, chunk: int, splits: int,
                                k_scale=None, v_scale=None, scale=None):
    """Plain version of kernel 10's split kernel: the layer's rows
    gathered through the table (:func:`paged_layer_dense`), then
    :func:`decode_gqa_partials_plain` at one head a group -> (m, l, acc)
    of each (row, head, chunk), f32. Positions at or past a row's length
    count for nothing, whatever block the table names there."""
    dense = lambda a: paged_layer_dense(a, layer, table)  # noqa: E731
    unit = lambda a: None if a is None else dense(a)[..., None]  # noqa
    return decode_gqa_partials_plain(q, dense(k_cache), dense(v_cache),
                                     cache_len, chunk, splits,
                                     unit(k_scale), unit(v_scale), scale)


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
    block, past a row's allocation). On CUDA, while enable_paged_kernel
    is on and under the JAX package's conditions (ops/attention.py:
    1465-1477): MHA, h*d a multiple of 128, BS a multiple of 16 up to
    128, d in {32, 64, 128}: kernel 10 (csrc/decode_attention.cu: the
    row's positions split into chunks of whole pool blocks by
    :func:`paged_split_plan`, a block per (row, head, chunk) writing an
    f32 partial, merged in split order; any table length). Other
    shapes, CPU tensors and the kernel switched off gather the rows'
    blocks into the dense view (:func:`paged_layer_dense`) and take
    :func:`decode_attention` (JAX :1478-1492), as does every tensor
    under set_default_impl('xla')."""
    b, _, h, d = q.shape
    nl, nb, bs, h_kv = k_cache.shape[:4]
    maxb = table.shape[1]
    scale = scale if scale is not None else 1.0 / (d**0.5)
    if _DEFAULT_IMPL == "xla" or not (
            _PAGED_KERNEL
            and q.device.type != "cpu" and h == h_kv and (h * d) % 128 == 0
            and bs % 16 == 0 and bs <= 128 and d in _DECODE_HEAD_DIMS):
        dense = lambda a: paged_layer_dense(a, layer, table)  # noqa: E731
        unit = lambda a: None if a is None else dense(a)[..., None]  # noqa
        return decode_attention(q, dense(k_cache), dense(v_cache),
                                cache_len, k_scale=unit(k_scale),
                                v_scale=unit(v_scale), scale=scale)
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
    chunk, splits = paged_split_plan(maxb, bs, b, h, _sm_count(dev.index))
    ws = None
    if splits > 1:
        ws = torch.empty(b * h * splits * (d + 2), dtype=torch.float32,
                         device=dev)
    out = torch.empty_like(q)
    cuda_lib.launch(
        "decode_attention_paged", "vlt_decode_attention_paged", dev,
        cuda_lib.ptr(q), cuda_lib.ptr(k_cache), cuda_lib.ptr(v_cache),
        ks, vs, cuda_lib.ptr(table), cuda_lib.ptr(cache_len),
        cuda_lib.ptr(out), None if ws is None else cuda_lib.ptr(ws),
        int(layer), b, nb, bs, maxb, h, d, int(quantized), chunk, splits,
        float(scale),
    )
    return out


# ---------------------------------------------------------------------------
# Kernels 9 and 11: decode attention over a flat per-layer cache
# ---------------------------------------------------------------------------


def _length_mask(cache_len: torch.Tensor, L: int) -> torch.Tensor:
    """(b, L) bool: position p of row i is below cache_len[i]."""
    pos = torch.arange(L, device=cache_len.device)
    return pos[None, :] < cache_len[:, None]


def _softmax_parts(s: torch.Tensor, mask: torch.Tensor):
    """Masked scores (..., L) -> (p = exp(s - max), l = sum p), both f32."""
    s = s.masked_fill(~mask, DEFAULT_MASK_VALUE)
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    return p, p.sum(dim=-1, keepdim=True)


def decode_attention_reference(q, k_cache, v_cache, cache_len, k_scale=None,
                               v_scale=None, scale=None):
    """The JAX package's XLA decode path (ops/attention.py:835-841): the
    cache dequantized to q's dtype, the masked reference attention.
    k_cache/v_cache (b, L, h_kv, d); scales (b, L, h_kv, 1)."""
    k, v = k_cache, v_cache
    if k_scale is not None:
        k = (k.float() * k_scale).to(q.dtype)
        v = (v.float() * v_scale).to(q.dtype)
    return attention_reference(q, k, v, kv_valid_len=cache_len, scale=scale)


def decode_attention_mxu_plain(q, k_cache, v_cache, cache_len, k_scale=None,
                               v_scale=None, scale=None):
    """Plain version of :func:`decode_attention_mxu`, with the JAX
    kernel's roundings (ops/attention.py:1052-1056, :1000-1020): q * scale
    and the cache rounded to bf16 for the score product; scores times the
    k scales; softmax weights times the v scales rounded to bf16 for the
    value product; the sum of the unscaled weights divides."""
    b, _, h, d = q.shape
    scale = _default_scale(d, scale)
    qs = (q[:, 0].float() * scale).to(torch.bfloat16).float()  # (b, h, d)
    k = k_cache.to(torch.bfloat16).float()
    s = torch.einsum("blhd,bhd->bhl", k, qs)
    if k_scale is not None:
        s = s * k_scale[..., 0].float().transpose(1, 2)
    p, l = _softmax_parts(s, _length_mask(cache_len, k.shape[1])[:, None])
    if v_scale is not None:
        p = p * v_scale[..., 0].float().transpose(1, 2)
    out = torch.einsum("bhl,blhd->bhd", p.to(torch.bfloat16).float(),
                       v_cache.to(torch.bfloat16).float())
    return (out / l.clamp_min(1e-30))[:, None].to(q.dtype)


def _check_decode_flat(q, k_cache, v_cache, cache_len, k_scale, v_scale,
                       name: str):
    """Raise unless the flat decode kernels take these operands; return
    the (ks, vs) pointers (None for a bf16 cache)."""
    b, _, h, d = q.shape
    L, h_kv = k_cache.shape[1:3]
    dev = q.device
    if d not in _DECODE_HEAD_DIMS:
        raise ValueError(f"{name}: head dim {d} not in {_DECODE_HEAD_DIMS}")
    quantized = k_scale is not None
    cdtype = torch.int8 if quantized else torch.bfloat16
    cuda_lib.require(q, "q", torch.bfloat16, (b, 1, h, d))
    cuda_lib.require(k_cache, "k_cache", cdtype, (b, L, h_kv, d), dev)
    cuda_lib.require(v_cache, "v_cache", cdtype, (b, L, h_kv, d), dev)
    cuda_lib.require(cache_len, "cache_len", torch.int32, (b,), dev)
    if not quantized:
        return None, None
    for nm, t in (("k_scale", k_scale), ("v_scale", v_scale)):
        cuda_lib.require(t, nm, torch.float32, (b, L, h_kv, 1), dev)
    return cuda_lib.ptr(k_scale), cuda_lib.ptr(v_scale)


def decode_attention_mxu(
    q: torch.Tensor,  # (b, 1, h, d)
    k_cache: torch.Tensor,  # (b, L, h, d) bf16, or int8 with scales
    v_cache: torch.Tensor,
    cache_len: torch.Tensor,  # (b,) int32
    k_scale: Optional[torch.Tensor] = None,  # (b, L, h, 1) f32 when int8
    v_scale: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Kernel 9: MHA decode over a flat per-layer cache -> (b, 1, h, d)
    (JAX ``decode_attention_mxu``). On CUDA: kernel 3's body at NL = 1
    (:func:`_decode_mha`, any L), which scales the f32 scores as kernel 3
    does and keeps the weights f32 (the plain version rounds q * scale and
    the weights to bf16, as the JAX kernel does); d in {32, 64, 128}."""
    h, d = q.shape[2:]
    h_kv = k_cache.shape[2]
    scale = _default_scale(d, scale)
    if h_kv != h:
        raise ValueError(f"decode_attention_mxu: MHA only, got {h} query "
                         f"heads over {h_kv}")
    if q.device.type == "cpu":
        return decode_attention_mxu_plain(q, k_cache, v_cache, cache_len,
                                          k_scale, v_scale, scale)
    _check_decode_flat(q, k_cache, v_cache, cache_len, k_scale, v_scale,
                       "decode_attention_mxu")
    return _decode_mha("decode_attention_mxu", q, k_cache, v_cache,
                       cache_len, 0, k_scale, v_scale, scale)


def decode_attention_pallas_plain(q, k_cache, v_cache, cache_len,
                                  k_scale=None, v_scale=None, scale=None):
    """Plain version of :func:`decode_attention_pallas`, the JAX kernel's
    math (ops/attention.py:870-934): q * scale in f32, the cache
    dequantized in f32, query head i against KV head i // group, masked
    softmax in f32."""
    b, _, h, d = q.shape
    L, h_kv = k_cache.shape[1:3]
    scale = _default_scale(d, scale)
    qg = q[:, 0].float().reshape(b, h_kv, h // h_kv, d) * scale
    k, v = k_cache.float(), v_cache.float()
    if k_scale is not None:
        k = k * k_scale.float()
        v = v * v_scale.float()
    s = torch.einsum("bkgd,blkd->bkgl", qg, k)
    p, l = _softmax_parts(s, _length_mask(cache_len, L)[:, None, None])
    out = torch.einsum("bkgl,blkd->bkgd", p, v) / l.clamp_min(1e-30)
    return out.reshape(b, 1, h, d).to(q.dtype)


def gqa_split_plan(L: int, b: int, h_kv: int, sms: int, align: int = 16,
                   per_sm: int = 2) -> tuple:
    """The split of [0, L) -> (chunk, splits): `splits` chunks of `chunk`
    positions (a multiple of `align`: 16 for kernel 11, the pool block
    for kernel 10), splits = ceil(L / chunk), so that the b * h_kv *
    splits blocks (at least) come to about `per_sm` an SM where L
    allows. L is the host's: the rows' lengths live on the device."""
    want = -(-per_sm * sms // (b * h_kv))  # chunks a (row, KV head)
    chunk = -(-max(L, 1) // want)
    chunk = -(-chunk // align) * align
    return chunk, -(-L // chunk)


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def decode_gqa_partials_plain(q, k_cache, v_cache, cache_len, chunk: int,
                              splits: int, k_scale=None, v_scale=None,
                              scale=None):
    """Plain version of kernel 11's split kernel: for each chunk c of
    [c * chunk, (c + 1) * chunk), the partial of every (row, query head)
    over its positions below the row's length -> (m (b, h, splits), l
    (b, h, splits), acc (b, h, splits, d)), f32: the chunk's max score,
    sum of exp(s - m) and sum of exp(s - m) [* v_scale] v. An empty chunk
    has m = -inf, l = 0 and acc 0."""
    b, _, h, d = q.shape
    L, h_kv = k_cache.shape[1:3]
    scale = _default_scale(d, scale)
    qg = q[:, 0].float().reshape(b, h_kv, h // h_kv, d) * scale
    k, v = k_cache.float(), v_cache.float()
    if k_scale is not None:
        k = k * k_scale.float()
        v = v * v_scale.float()
    s = torch.einsum("bkgd,blkd->bkgl", qg, k)  # (b, h_kv, group, L)
    pad = splits * chunk - L
    s = torch.nn.functional.pad(s, (0, pad), value=-float("inf"))
    v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad))
    valid = _length_mask(cache_len, splits * chunk)[:, None, None]
    s = s.masked_fill(~valid, -float("inf"))
    s = s.reshape(b, h_kv, h // h_kv, splits, chunk)
    m = s.amax(dim=-1)  # (b, h_kv, group, splits)
    p = torch.exp(s - torch.where(torch.isfinite(m), m, 0.0)[..., None])
    l = p.sum(dim=-1)
    vv = v.reshape(b, splits, chunk, h_kv, d)
    acc = torch.einsum("bkgsc,bsckd->bkgsd", p, vv)
    return (m.reshape(b, h, splits), l.reshape(b, h, splits),
            acc.reshape(b, h, splits, d))


def decode_gqa_combine_plain(m, l, acc, dtype=torch.bfloat16):
    """Plain version of kernel 11's combine kernel: each (row, head)'s
    partials merged, o = sum_j e^(m_j - M) acc_j / sum_j e^(m_j - M) l_j
    with M the largest m_j of a non-empty partial (l_j > 0), 0 where all
    are empty -> (b, 1, h, d) in `dtype`."""
    live = l > 0
    mx = torch.where(live, m, -float("inf")).amax(dim=-1, keepdim=True)
    w = torch.where(live, torch.exp(m - torch.where(live, mx, 0.0)), 0.0)
    lt = (w * l).sum(dim=-1, keepdim=True)
    out = (w[..., None] * torch.where(live[..., None], acc, 0.0)).sum(-2)
    out = torch.where(lt > 0, out / lt.clamp_min(1e-30), 0.0)
    return out[:, None].to(dtype)


def decode_attention_pallas(
    q: torch.Tensor,  # (b, 1, h, d)
    k_cache: torch.Tensor,  # (b, L, h_kv, d) bf16, or int8 with scales
    v_cache: torch.Tensor,
    cache_len: torch.Tensor,  # (b,) int32
    k_scale: Optional[torch.Tensor] = None,  # (b, L, h_kv, 1) f32 when int8
    v_scale: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Kernel 11: grouped-query decode (h_kv divides h) over a flat
    per-layer cache -> (b, 1, h, d) (JAX ``decode_attention_pallas``). On
    CUDA: L split into chunks (:func:`gqa_split_plan`), a block per (row,
    KV head, chunk) reading each position once for its group, then a
    deterministic merge of the chunks' partials in an f32 workspace
    (csrc/decode_attention.cu); any L, d in {32, 64, 128}."""
    b, _, h, d = q.shape
    L, h_kv = k_cache.shape[1:3]
    scale = _default_scale(d, scale)
    if h % h_kv:
        raise ValueError(f"{h} query heads do not group over {h_kv}")
    if q.device.type == "cpu":
        return decode_attention_pallas_plain(q, k_cache, v_cache, cache_len,
                                             k_scale, v_scale, scale)
    ks, vs = _check_decode_flat(q, k_cache, v_cache, cache_len, k_scale,
                                v_scale, "decode_attention_pallas")
    chunk, splits = gqa_split_plan(L, b, h_kv, _sm_count(q.device.index))
    ws = None
    if splits > 1:
        ws = torch.empty(b * h * splits * (d + 2), dtype=torch.float32,
                         device=q.device)
    out = torch.empty_like(q)
    cuda_lib.launch(
        "decode_attention_pallas", "vlt_decode_attention_gqa", q.device,
        cuda_lib.ptr(q), cuda_lib.ptr(k_cache), cuda_lib.ptr(v_cache),
        ks, vs, cuda_lib.ptr(cache_len), cuda_lib.ptr(out),
        None if ws is None else cuda_lib.ptr(ws),
        b, L, h, h_kv, d, int(k_scale is not None), chunk, splits,
        float(scale),
    )
    return out


def decode_attention(
    q: torch.Tensor,  # (b, 1, h, d)
    k_cache: torch.Tensor,  # (b, L, h_kv, d) bf16, or int8 with scales
    v_cache: torch.Tensor,
    cache_len: torch.Tensor,  # (b,) int32, the token just written included
    *,
    k_scale: Optional[torch.Tensor] = None,  # (b, L, h_kv, 1) when int8
    v_scale: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """One decode step over a flat per-layer cache -> (b, 1, h, d): the
    JAX package's dispatch (ops/attention.py:786-841), with "on a TPU"
    read as "a CUDA tensor". 'xla' (on any device, as JAX runs its XLA
    twin on the accelerator) or 'auto' on the CPU: the plain reference,
    no launch. Otherwise MHA with h*d a
    multiple of 128 and L of 16:
    kernel 9 (:func:`decode_attention_mxu`); every other shape, under
    'auto' and 'pallas' alike: kernel 11 (:func:`decode_attention_pallas`,
    where JAX's 'auto' takes its XLA path for GQA: a CUDA tensor here
    launches a kernel or raises). On the CPU the kernels' plain versions
    stand in."""
    b, _, h, d = q.shape
    L, h_kv = k_cache.shape[1:3]
    scales = dict(k_scale=k_scale, v_scale=v_scale, scale=scale)
    if _DEFAULT_IMPL == "xla" or (q.device.type == "cpu"
                                  and _DEFAULT_IMPL != "pallas"):
        return decode_attention_reference(q, k_cache, v_cache, cache_len,
                                          **scales)
    if h == h_kv and (h * d) % 128 == 0 and L % 16 == 0:
        return decode_attention_mxu(q, k_cache, v_cache, cache_len, **scales)
    return decode_attention_pallas(q, k_cache, v_cache, cache_len, **scales)
