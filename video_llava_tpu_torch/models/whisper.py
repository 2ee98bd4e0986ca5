"""Whisper encoder and decoder, and whisper-at's TL-TR tagging head.

Counterpart of video_llava_tpu/models/whisper.py. Parameters are the
JAX package's nested dict, with two changes of layout that
engine/convert.whisper_from_jax makes: the encoder and decoder layers
are lists (one dict a layer) instead of scan-stacked arrays, and the
conv stem's kernels are torch's (out, in, width) under `weight` instead
of the JAX package's (width, in, out) `kernel`.

Attention: the encoder's self-attention and the TL-TR blocks go through
ops/attention.multi_head_attention (kernel 7 for bf16 CUDA operands,
the plain reference otherwise); the decoder's through the plain
reference, masked, as in the JAX package. Whisper's GELU is the tanh
approximation (jax.nn.gelu's default); the TL-TR block's is exact.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from video_llava_tpu_torch.models.layers import TreeInit, dense, embed, norm
from video_llava_tpu_torch.ops.attention import (
    attention_reference,
    multi_head_attention,
)


def _gelu(x):
    """jax.nn.gelu's default: the tanh approximation."""
    return F.gelu(x, approximate="tanh")


@dataclasses.dataclass(frozen=True)
class WhisperConfig:
    n_mels: int = 80
    vocab_size: int = 51865
    d_model: int = 512
    encoder_layers: int = 6
    decoder_layers: int = 6
    num_heads: int = 8
    ffn_dim: int = 2048
    max_source_positions: int = 1500
    max_target_positions: int = 448
    num_audio_tags: int = 527  # AudioSet ontology (whisper-at)

    @classmethod
    def tiny_test(cls):
        return cls(
            n_mels=80, vocab_size=256, d_model=64, encoder_layers=2,
            decoder_layers=2, num_heads=4, ffn_dim=128,
            max_source_positions=1500, max_target_positions=64,
            num_audio_tags=16,
        )

    @classmethod
    def base(cls):
        return cls(d_model=512, encoder_layers=6, decoder_layers=6,
                   num_heads=8, ffn_dim=2048)

    @classmethod
    def large_v2(cls):
        return cls(d_model=1280, encoder_layers=32, decoder_layers=32,
                   num_heads=20, ffn_dim=5120)


def _sinusoids(length: int, channels: int) -> np.ndarray:
    """Whisper's fixed sinusoidal encoder positions, f32."""
    log_timescale = np.log(10000) / (channels // 2 - 1)
    inv = np.exp(-log_timescale * np.arange(channels // 2))
    t = np.arange(length)[:, None] * inv[None, :]
    return np.concatenate([np.sin(t), np.cos(t)], axis=1).astype(np.float32)


def _attn_init(init: TreeInit, d: int):
    return {"q": init.linear(d, d), "k": init.linear(d, d, bias=False),
            "v": init.linear(d, d), "o": init.linear(d, d)}


def init_params(init: TreeInit, cfg: WhisperConfig):
    """Random parameters in the port's layout, drawn at the JAX
    package's scales (normal * 0.02 conv kernels and embeddings, normal
    * fan_in ** -0.5 linears, zero biases), on init's device and dtype.
    The `at_head` is the legacy linear probe, as there."""
    d, f = cfg.d_model, cfg.ffn_dim

    def conv(cin):
        return {"weight": init.normal((d, cin, 3), 0.02),
                "bias": init.zeros((d,))}

    enc_layers = [{
        "ln1": init.layer_norm(d), "attn": _attn_init(init, d),
        "ln2": init.layer_norm(d), "fc1": init.linear(d, f),
        "fc2": init.linear(f, d),
    } for _ in range(cfg.encoder_layers)]
    dec_layers = [{
        "ln1": init.layer_norm(d), "self_attn": _attn_init(init, d),
        "ln2": init.layer_norm(d), "cross_attn": _attn_init(init, d),
        "ln3": init.layer_norm(d), "fc1": init.linear(d, f),
        "fc2": init.linear(f, d),
    } for _ in range(cfg.decoder_layers)]
    return {
        "encoder": {"conv1": conv(cfg.n_mels), "conv2": conv(d),
                    "layers": enc_layers, "ln_post": init.layer_norm(d)},
        "decoder": {
            "token_embedding": {
                "weight": init.normal((cfg.vocab_size, d), 0.02)},
            "position_embedding": init.normal(
                (cfg.max_target_positions, d), 0.02),
            "layers": dec_layers,
            "ln_post": init.layer_norm(d),
        },
        "at_head": {"proj": init.linear(d, cfg.num_audio_tags)},
    }


def _mha(p, x, kv, num_heads: int, causal: bool = False):
    b, s, d = x.shape
    hd = d // num_heads
    skv = kv.shape[1]
    q = dense(p["q"], x).reshape(b, s, num_heads, hd)
    k = dense(p["k"], kv).reshape(b, skv, num_heads, hd)
    v = dense(p["v"], kv).reshape(b, skv, num_heads, hd)
    out = multi_head_attention(q, k, v, causal=causal)
    return dense(p["o"], out.reshape(b, s, d))


def _conv(p, x, stride: int):
    """Conv1d over (b, c, t), padding 1 each side (torch's Conv1d
    padding=1, also at stride 2)."""
    return F.conv1d(x, p["weight"].to(x.dtype), p["bias"].to(x.dtype),
                    stride=stride, padding=1)


def encode(params, mel: torch.Tensor, cfg: WhisperConfig,
           return_layer_states: bool = False):
    """mel (b, n_mels, n_frames) -> encoder states (b, frames // 2, d);
    with return_layer_states also the post-block states of every layer,
    (L, b, T, d)."""
    enc = params["encoder"]
    x = _gelu(_conv(enc["conv1"], mel, 1))
    x = _gelu(_conv(enc["conv2"], x, 2)).transpose(1, 2)  # (b, T, d)
    pos = torch.as_tensor(_sinusoids(x.shape[1], cfg.d_model),
                          device=x.device)
    x = x + pos.to(x.dtype)
    states = []
    for lp in enc["layers"]:
        hn = norm(lp["ln1"], x)
        x = x + _mha(lp["attn"], hn, hn, cfg.num_heads)
        x = x + dense(lp["fc2"], _gelu(dense(lp["fc1"], norm(lp["ln2"], x))))
        if return_layer_states:
            states.append(x)
    out = norm(enc["ln_post"], x)
    if return_layer_states:
        # what whisper-at's TL-TR head reads: one tap per encoder layer
        return out, torch.stack(states)
    return out


class DecoderCache(NamedTuple):
    k: torch.Tensor  # (L, b, max_len, h, hd) self-attention keys, f32
    v: torch.Tensor
    xk: torch.Tensor  # (L, b, src, h, hd) cross-attention keys
    xv: torch.Tensor
    length: torch.Tensor  # (b,) int32


def precompute_cross_kv(params, enc_states: torch.Tensor,
                        cfg: WhisperConfig):
    """Cross-attention K/V depend only on the encoder's output: computed
    once a chunk, stacked over layers -> (L, b, src, h, hd) each."""
    b, src, d = enc_states.shape
    hd = d // cfg.num_heads
    ks, vs = [], []
    for lp in params["decoder"]["layers"]:
        ca = lp["cross_attn"]
        ks.append(dense(ca["k"], enc_states).reshape(b, src, cfg.num_heads,
                                                     hd))
        vs.append(dense(ca["v"], enc_states).reshape(b, src, cfg.num_heads,
                                                     hd))
    return torch.stack(ks), torch.stack(vs)


def _logits(dec, x):
    """Tied output projection, f32 out."""
    w = dec["token_embedding"]["weight"]
    return torch.einsum("bsd,vd->bsv", x.float(), w.float())


def decoder_forward(params, tokens: torch.Tensor, enc_states: torch.Tensor,
                    cfg: WhisperConfig,
                    positions: Optional[torch.Tensor] = None):
    """Teacher-forced decode: tokens (b, s) -> logits (b, s, vocab) f32."""
    dec = params["decoder"]
    s = tokens.shape[1]
    x = embed(dec["token_embedding"]["weight"], tokens)
    pos = (positions if positions is not None
           else torch.arange(s, device=tokens.device))
    x = x + dec["position_embedding"][pos].to(x.dtype)
    for lp in dec["layers"]:
        hn = norm(lp["ln1"], x)
        x = x + _mha(lp["self_attn"], hn, hn, cfg.num_heads, causal=True)
        x = x + _mha(lp["cross_attn"], norm(lp["ln2"], x), enc_states,
                     cfg.num_heads)
        x = x + dense(lp["fc2"], _gelu(dense(lp["fc1"], norm(lp["ln3"], x))))
    return _logits(dec, norm(dec["ln_post"], x))


def audio_tag_logits(params, enc_states: torch.Tensor) -> torch.Tensor:
    """Legacy linear tagging probe: time-pooled last-layer states ->
    (b, num_tags). Superseded by the TL-TR head."""
    return dense(params["at_head"]["proj"], enc_states.mean(dim=1))


# -- whisper-at TL-TR tagging head ---------------------------------------


@dataclasses.dataclass(frozen=True)
class WhisperATConfig:
    """whisper-at's time-and-layer transformer (TL-TR) head: per encoder
    layer, time-pooled representations pass a time transformer and
    mean-pool; the per-layer tokens then pass a layer transformer,
    mean-pool, and a LayerNorm + Linear AudioSet classifier."""

    n_class: int = 527  # AudioSet ontology
    rep_dim: int = 1280  # whisper encoder d_model (large)
    att_dim: int = 512  # low-dim projection variant (tl_down_tr_512)
    num_heads: int = 4
    time_blocks: int = 1
    layer_blocks: int = 1
    pool_stride: int = 20  # 1500 encoder frames -> 75 tokens (0.4 s each)

    @classmethod
    def tiny_test(cls, rep_dim=64):
        return cls(n_class=16, rep_dim=rep_dim, att_dim=32, num_heads=2)


def _tr_block_init(init: TreeInit, d: int, ffn: int):
    return {"norm1": init.layer_norm(d), "qkv": init.linear(d, 3 * d),
            "proj": init.linear(d, d), "norm2": init.layer_norm(d),
            "fc1": init.linear(d, ffn), "fc2": init.linear(ffn, d)}


def init_at_head_tltr(init: TreeInit, atcfg: WhisperATConfig):
    d = atcfg.att_dim
    head = {
        "time_tr": [_tr_block_init(init, d, 4 * d)
                    for _ in range(atcfg.time_blocks)],
        "layer_tr": [_tr_block_init(init, d, 4 * d)
                     for _ in range(atcfg.layer_blocks)],
        "ln": init.layer_norm(d),
        "head": init.linear(d, atcfg.n_class),
    }
    if atcfg.att_dim != atcfg.rep_dim:
        head["down"] = init.linear(atcfg.rep_dim, atcfg.att_dim)
    return head


def _tr_block(p, x, num_heads: int):
    """Pre-LN ViT/timm-style block (the AST/whisper-at Block): fused-qkv
    attention and a 4x MLP with exact (erf) GELU, residuals. q, k and v
    are strided slices of the fused product; the kernel wrapper makes
    them contiguous."""
    b, s, d = x.shape
    hd = d // num_heads
    qkv = dense(p["qkv"], norm(p["norm1"], x)).reshape(b, s, 3, num_heads,
                                                       hd)
    attn = multi_head_attention(qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2],
                                causal=False)
    x = x + dense(p["proj"], attn.reshape(b, s, d))
    return x + dense(p["fc2"], F.gelu(dense(p["fc1"], norm(p["norm2"], x))))


def audio_tag_logits_tltr(at_params, layer_states: torch.Tensor,
                          atcfg: WhisperATConfig, window_tokens: int = 0):
    """TL-TR forward over layer_states (L, b, T, rep_dim) -> (b,
    n_class), or (b, n_windows, n_class) when window_tokens > 0
    (whisper-at's at_time_res: tags for fixed windows of pooled tokens;
    25 tokens = 10 s at the default pool_stride)."""
    L, b, T, D = layer_states.shape
    p = atcfg.pool_stride
    tp = T // p
    x = layer_states[:, :, :tp * p].reshape(L, b, tp, p, D).mean(dim=3)
    if "down" in at_params:
        x = dense(at_params["down"], x)
    d = x.shape[-1]
    if window_tokens:
        nw = tp // window_tokens
        x = x[:, :, :nw * window_tokens].reshape(L, b * nw, window_tokens, d)
    else:
        nw = 1
    # the time transformer: layers fold into the batch
    t = x.reshape(L * b * nw, x.shape[2], d)
    for blk in at_params["time_tr"]:
        t = _tr_block(blk, t, atcfg.num_heads)
    tokens = t.mean(dim=1).reshape(L, b * nw, d).transpose(0, 1)
    for blk in at_params["layer_tr"]:
        tokens = _tr_block(blk, tokens, atcfg.num_heads)
    logits = dense(at_params["head"], norm(at_params["ln"],
                                           tokens.mean(dim=1)))
    if window_tokens:
        return logits.reshape(b, nw, atcfg.n_class)
    return logits


# -- decoding -------------------------------------------------------------


def _decoder_step_cached(params, tokens: torch.Tensor,
                         positions: torch.Tensor, cache: DecoderCache,
                         cfg: WhisperConfig
                         ) -> Tuple[torch.Tensor, DecoderCache]:
    """Decoder forward over a chunk of tokens (b, s) at `positions` (b,
    s), writing each layer's self-attention K/V into the cache at each
    row's length (in the cache's dtype) and reading the precomputed
    cross-attention K/V. Both attentions are the plain masked reference,
    as in the JAX package. Returns (logits (b, s, vocab) f32, cache)."""
    dec = params["decoder"]
    b, s = tokens.shape
    h, hd = cfg.num_heads, cfg.d_model // cfg.num_heads
    x = embed(dec["token_embedding"]["weight"], tokens)
    x = x + dec["position_embedding"][positions].to(x.dtype)
    rows = torch.arange(b, device=tokens.device)[:, None]
    cols = cache.length.long()[:, None] + torch.arange(
        s, device=tokens.device)
    for li, lp in enumerate(dec["layers"]):
        sa = lp["self_attn"]
        hn = norm(lp["ln1"], x)
        q = dense(sa["q"], hn).reshape(b, s, h, hd)
        cache.k[li][rows, cols] = dense(sa["k"], hn).reshape(
            b, s, h, hd).to(cache.k.dtype)
        cache.v[li][rows, cols] = dense(sa["v"], hn).reshape(
            b, s, h, hd).to(cache.v.dtype)
        attn = attention_reference(q, cache.k[li], cache.v[li], causal=True,
                                   kv_valid_len=cache.length + s,
                                   q_offset=cache.length)
        x = x + dense(sa["o"], attn.reshape(b, s, cfg.d_model))
        ca = lp["cross_attn"]
        q = dense(ca["q"], norm(lp["ln2"], x)).reshape(b, s, h, hd)
        attn = attention_reference(q, cache.xk[li], cache.xv[li])
        x = x + dense(ca["o"], attn.reshape(b, s, cfg.d_model))
        x = x + dense(lp["fc2"], _gelu(dense(lp["fc1"], norm(lp["ln3"], x))))
    logits = _logits(dec, norm(dec["ln_post"], x))
    return logits, cache._replace(length=cache.length + s)


@torch.inference_mode()
def greedy_decode_cached(params, enc_states: torch.Tensor,
                         cfg: WhisperConfig, start_tokens: torch.Tensor,
                         max_new_tokens: int, eot_token: int
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """KV-cached greedy decode: prefill the start tokens, then one step a
    token until every row has emitted eot or max_new_tokens are out (the
    JAX package's while_loop, as a host loop here). The self-attention
    cache is f32 whatever the weights' dtype, as there. Returns (tokens
    (b, max_new_tokens) int32 with eot after each row's end, lengths
    (b,) = the non-eot count of each row)."""
    b, s0 = start_tokens.shape
    dev = enc_states.device
    total = s0 + max_new_tokens
    hd = cfg.d_model // cfg.num_heads
    xk, xv = precompute_cross_kv(params, enc_states, cfg)
    shape = (cfg.decoder_layers, b, total, cfg.num_heads, hd)
    cache = DecoderCache(
        k=torch.zeros(shape, device=dev), v=torch.zeros(shape, device=dev),
        xk=xk, xv=xv, length=torch.zeros((b,), dtype=torch.int32,
                                         device=dev))
    start_tokens = start_tokens.to(dev)
    positions = torch.arange(s0, device=dev).expand(b, s0)
    logits, cache = _decoder_step_cached(params, start_tokens, positions,
                                         cache, cfg)
    tok = logits[:, -1].argmax(dim=-1).int()
    buf = torch.full((b, max_new_tokens), eot_token, dtype=torch.int32,
                     device=dev)
    buf[:, 0] = tok
    done = tok == eot_token
    i = 1
    while i < max_new_tokens and not bool(done.all()):
        logits, cache = _decoder_step_cached(
            params, tok[:, None], cache.length.long()[:, None], cache, cfg)
        nxt = logits[:, 0].argmax(dim=-1).int()
        nxt = torch.where(done, eot_token, nxt)
        buf[:, i] = nxt
        done = done | (nxt == eot_token)
        tok = nxt
        i += 1
    return buf, (buf != eot_token).sum(dim=1)


@torch.inference_mode()
def greedy_decode(params, enc_states: torch.Tensor, cfg: WhisperConfig,
                  start_tokens: torch.Tensor, max_new_tokens: int,
                  eot_token: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Greedy decoding by a teacher-forced forward over a fixed buffer
    per token: the oracle for greedy_decode_cached. Returns (tokens (b,
    max_new_tokens), lengths)."""
    b, s0 = start_tokens.shape
    dev = enc_states.device
    total = s0 + max_new_tokens
    buf = torch.full((b, total), eot_token, dtype=torch.int32, device=dev)
    buf[:, :s0] = start_tokens.to(dev)
    done = torch.zeros((b,), dtype=torch.bool, device=dev)
    i = s0
    while i < total and not bool(done.all()):
        logits = decoder_forward(params, buf, enc_states, cfg)
        nxt = logits[:, i - 1].argmax(dim=-1).int()
        nxt = torch.where(done, eot_token, nxt)
        buf[:, i] = nxt
        done = done | (nxt == eot_token)
        i += 1
    return buf[:, s0:], (buf[:, s0:] != eot_token).sum(dim=1)


# -- HF weight conversion -----------------------------------------------------


def _hf_tensors(sd, device, dtype):
    """A torch state dict's tensors on `device`, floating ones in
    `dtype`."""
    def to(v):
        v = torch.as_tensor(v)
        return v.to(device=device, dtype=dtype) if v.is_floating_point() \
            else v.to(device)
    return {k: to(v) for k, v in sd.items()}


def _hf_linear(sd, name: str) -> dict:
    """torch Linear {name}.weight (out, in) [, bias] -> {'kernel' (in,
    out), 'bias'}."""
    p = {"kernel": sd[f"{name}.weight"].t().contiguous()}
    if f"{name}.bias" in sd:
        p["bias"] = sd[f"{name}.bias"]
    return p


def _hf_ln(sd, name: str) -> dict:
    return {"scale": sd[f"{name}.weight"], "bias": sd[f"{name}.bias"]}


def convert_whisper_at(sd, atcfg: WhisperATConfig, device=None,
                       dtype: torch.dtype = torch.float32) -> dict:
    """A whisper-at TL-TR checkpoint (torch state dict, timm-Block names:
    [mlp_down], time_tr.{i} and layer_tr.{i} with norm1, attn.qkv,
    attn.proj, norm2, mlp.fc1, mlp.fc2, then mlp_head.0 (LayerNorm) and
    mlp_head.1 (Linear)) -> the at_head tree (init_at_head_tltr's
    layout) on `device` in `dtype` (JAX convert_whisper_at). A missing
    tensor raises KeyError."""
    sd = _hf_tensors(sd, device, dtype)

    def block(pre):
        return {"norm1": _hf_ln(sd, f"{pre}.norm1"),
                "qkv": _hf_linear(sd, f"{pre}.attn.qkv"),
                "proj": _hf_linear(sd, f"{pre}.attn.proj"),
                "norm2": _hf_ln(sd, f"{pre}.norm2"),
                "fc1": _hf_linear(sd, f"{pre}.mlp.fc1"),
                "fc2": _hf_linear(sd, f"{pre}.mlp.fc2")}

    head = {
        "time_tr": [block(f"time_tr.{i}") for i in range(atcfg.time_blocks)],
        "layer_tr": [block(f"layer_tr.{i}")
                     for i in range(atcfg.layer_blocks)],
        "ln": _hf_ln(sd, "mlp_head.0"),
        "head": _hf_linear(sd, "mlp_head.1"),
    }
    if "mlp_down.weight" in sd:
        head["down"] = _hf_linear(sd, "mlp_down")
    return head


def convert_hf_whisper(sd, cfg: WhisperConfig, device=None,
                       dtype: torch.dtype = torch.float32, at_sd=None,
                       at_cfg: Optional[WhisperATConfig] = None) -> dict:
    """A transformers WhisperModel state dict (the 'model.' prefix of
    WhisperForConditionalGeneration removed) -> the port's Whisper tree
    (init_params' layout) on `device` in `dtype` (JAX
    convert_hf_whisper): linears (in, out), the conv stem kept in
    torch's (out, in, width), k_proj without a bias where HF has none.
    at_sd / at_cfg: an optional whisper-at TL-TR head checkpoint,
    attached as 'at_head' (convert_whisper_at); without it the tree has
    no at_head, so the transcript filter keeps every segment."""
    sd = _hf_tensors(sd, device, dtype)

    def attn(pre):
        return {"q": _hf_linear(sd, pre + "q_proj"),
                "k": _hf_linear(sd, pre + "k_proj"),
                "v": _hf_linear(sd, pre + "v_proj"),
                "o": _hf_linear(sd, pre + "out_proj")}

    enc_layers = [{
        "ln1": _hf_ln(sd, f"encoder.layers.{i}.self_attn_layer_norm"),
        "attn": attn(f"encoder.layers.{i}.self_attn."),
        "ln2": _hf_ln(sd, f"encoder.layers.{i}.final_layer_norm"),
        "fc1": _hf_linear(sd, f"encoder.layers.{i}.fc1"),
        "fc2": _hf_linear(sd, f"encoder.layers.{i}.fc2"),
    } for i in range(cfg.encoder_layers)]
    dec_layers = [{
        "ln1": _hf_ln(sd, f"decoder.layers.{i}.self_attn_layer_norm"),
        "self_attn": attn(f"decoder.layers.{i}.self_attn."),
        "ln2": _hf_ln(sd, f"decoder.layers.{i}.encoder_attn_layer_norm"),
        "cross_attn": attn(f"decoder.layers.{i}.encoder_attn."),
        "ln3": _hf_ln(sd, f"decoder.layers.{i}.final_layer_norm"),
        "fc1": _hf_linear(sd, f"decoder.layers.{i}.fc1"),
        "fc2": _hf_linear(sd, f"decoder.layers.{i}.fc2"),
    } for i in range(cfg.decoder_layers)]
    params = {
        "encoder": {
            "conv1": {"weight": sd["encoder.conv1.weight"],
                      "bias": sd["encoder.conv1.bias"]},
            "conv2": {"weight": sd["encoder.conv2.weight"],
                      "bias": sd["encoder.conv2.bias"]},
            "layers": enc_layers,
            "ln_post": _hf_ln(sd, "encoder.layer_norm"),
        },
        "decoder": {
            "token_embedding": {"weight": sd["decoder.embed_tokens.weight"]},
            "position_embedding": sd["decoder.embed_positions.weight"],
            "layers": dec_layers,
            "ln_post": _hf_ln(sd, "decoder.layer_norm"),
        },
    }
    if at_sd is not None:
        params["at_head"] = convert_whisper_at(
            at_sd, at_cfg or WhisperATConfig(rep_dim=cfg.d_model), device,
            dtype)
    return params
