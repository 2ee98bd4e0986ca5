"""The plain reference of the video-QA model, in float32.

CLIP ViT-L/14 to its penultimate layer (a real stride-P convolution for
the patches, then pre-LN encoder layers with quick-gelu), the
spatio-temporal pooling of PG-Video-LLaVA (each frame's mean over its
patches, then each patch's mean over the frames), the linear projector,
the splice of the projected video tokens into the prompt's embeddings,
and the decoder (RMSNorm, rotary embeddings in the rotate-half form,
grouped-query attention, SwiGLU, an untied head) run teacher-forced over
a prompt and its served tokens. It imports nothing of the program and
nothing of JAX: the weights are drawn again from the seed
(portbench/weights.py) and quantized as the configuration states
(reference/quant.py).

:class:`Precision` says what the reference computes in. ``REFERENCE``
is float32 with the formats the configuration states (int4 weights with
int8 activations in the decoder's linears, int8 embeddings and head).
``CONTROL`` is the same model one step lower: int4 activations in the
W4A8 linears, and float8 e4m3 operands wherever the configuration
states bfloat16 (the tower's and projector's products, the attention
operands and cache, the head's input).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Sequence

import torch
import torch.nn.functional as F

from portbench import weights
from portbench.reference import quant

CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)


@dataclasses.dataclass(frozen=True)
class Precision:
    act_bits: int = 8  # activations into the W4A8 linears
    fp8: bool = False  # bf16 operands rounded to float8 e4m3

    def low(self, x: torch.Tensor) -> torch.Tensor:
        """An operand the configuration states in bfloat16."""
        return quant.fp8_rows(x) if self.fp8 else x.float()

    def a8(self, x: torch.Tensor, prompt: torch.Tensor) -> torch.Tensor:
        """Activations into a W4A8 linear: per row where `prompt` (a
        prefill row), per row and group of 128 elsewhere (a decode
        step's row)."""
        per_row = quant.act_quant(x, self.act_bits)
        per_group = quant.act_quant(x, self.act_bits, quant.GROUP)
        return torch.where(prompt[..., None], per_row, per_group)


REFERENCE = Precision()
CONTROL = Precision(act_bits=4, fp8=True)


def _f32(t: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    return {k: v.float() for k, v in t.items()}


def _layer_norm(x, w, b, eps):
    return F.layer_norm(x, (x.shape[-1],), w, b, eps)


def _rms_norm(x, w, eps):
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * w


# -- vision -------------------------------------------------------------------


def clip_penultimate(seed: int, cfg: dict, frames: torch.Tensor,
                     prec: Precision = REFERENCE) -> torch.Tensor:
    """frames (t, H, W, 3) uint8 at the tower's size -> the penultimate
    layer's patch features (t, patches, hidden), f32."""
    v = cfg["vision_config"]
    dev = frames.device
    eps = v["layer_norm_eps"]
    heads = v["num_attention_heads"]
    units = dict(weights.clip_units(v))
    pre = "vision_model."
    top = _f32(weights.draw_unit(seed, "clip.embed", units["clip.embed"],
                                 dev))
    mean = torch.tensor(CLIP_MEAN, device=dev)
    std = torch.tensor(CLIP_STD, device=dev)
    x = ((frames.float() / 255.0 - mean) / std).permute(0, 3, 1, 2)
    x = F.conv2d(x, top[pre + "embeddings.patch_embedding.weight"],
                 stride=v["patch_size"])
    x = x.flatten(2).transpose(1, 2)  # (t, patches, d)
    cls = top[pre + "embeddings.class_embedding"].expand(x.shape[0], 1, -1)
    x = torch.cat([cls, x], 1) + top[
        pre + "embeddings.position_embedding.weight"]
    x = _layer_norm(x, top[pre + "pre_layrnorm.weight"],
                    top[pre + "pre_layrnorm.bias"], eps)
    t, n, d = x.shape
    hd = d // heads
    for i in range(v["num_hidden_layers"] - 1):
        p = _f32(weights.draw_unit(seed, f"clip.layer.{i}",
                                   units[f"clip.layer.{i}"], dev))
        lp = f"{pre}encoder.layers.{i}."

        def lin(name, h):
            return (prec.low(h) @ p[lp + name + ".weight"].t()
                    + p[lp + name + ".bias"])

        h = _layer_norm(x, p[lp + "layer_norm1.weight"],
                        p[lp + "layer_norm1.bias"], eps)
        q, k, vv = (prec.low(lin(f"self_attn.{m}_proj", h)).view(
            t, n, heads, hd).transpose(1, 2) for m in ("q", "k", "v"))
        w = torch.softmax(q @ k.transpose(-1, -2) / math.sqrt(hd), dim=-1)
        attn = (prec.low(w) @ vv).transpose(1, 2).reshape(t, n, d)
        x = x + lin("self_attn.out_proj", attn)
        h = _layer_norm(x, p[lp + "layer_norm2.weight"],
                        p[lp + "layer_norm2.bias"], eps)
        h = lin("mlp.fc1", h)
        x = x + lin("mlp.fc2", h * torch.sigmoid(1.702 * h))
    return x[:, 1:]


def pool(features: torch.Tensor, max_temporal: int) -> torch.Tensor:
    """(t, s, c) -> (max_temporal + s, c): each frame's mean over its
    patches (zero rows past t), then each patch's mean over frames."""
    t, _, c = features.shape
    temporal = features.mean(1)
    pad = features.new_zeros((max_temporal - t, c))
    return torch.cat([temporal, pad, features.mean(0)], 0)


def project(seed: int, cfg: dict, pooled: torch.Tensor,
            prec: Precision = REFERENCE) -> torch.Tensor:
    units = dict(weights.projector_units(cfg))
    p = _f32(weights.draw_unit(seed, "projector", units["projector"],
                               pooled.device))
    return (prec.low(pooled) @ p["model.mm_projector.weight"].t()
            + p["model.mm_projector.bias"])


def video_tokens(seed: int, cfg: dict, frames: torch.Tensor,
                 prec: Precision = REFERENCE) -> torch.Tensor:
    """One video's frames -> its projected video tokens (n, hidden)."""
    feats = clip_penultimate(seed, cfg, frames, prec)
    return project(seed, cfg, pool(feats, cfg["max_temporal_tokens"]), prec)


# -- the decoder --------------------------------------------------------------


def _grown(w: torch.Tensor, rows: int) -> torch.Tensor:
    """A (vocab, d) bf16 table grown to `rows` rows, the new rows the
    f32 mean of the old ones, rounded to bf16 (a checkpoint's vocab
    resized for the added tokens)."""
    extra = rows - w.shape[0]
    mean = w.float().mean(0, keepdim=True).to(w.dtype)
    return torch.cat([w, mean.expand(extra, -1)], 0)


class _Linear:
    """A decoder linear as the configuration stores and runs it: int4
    weights take W4A8 activations, int8 weights (weight-only) and kept
    bf16 weights take the activations as they are."""

    def __init__(self, w_out_in: torch.Tensor, layers: int):
        w = w_out_in.t()
        self.fmt = quant.weight_format((layers,) + tuple(w.shape))
        self.w = (quant.int4_weight(w) if self.fmt == "int4" else
                  quant.int8_columns(w) if self.fmt == "int8" else w.float())

    def __call__(self, x, prompt, prec: "Precision"):
        x = prec.a8(x, prompt) if self.fmt == "int4" else prec.low(x)
        return x @ self.w


def _rope(x: torch.Tensor, pos: torch.Tensor, theta: float):
    """x (n, h, hd) at positions pos (n,): rotate-half rotary."""
    hd = x.shape[-1]
    inv = 1.0 / theta ** (torch.arange(0, hd, 2, device=x.device,
                                       dtype=torch.float32) / hd)
    ang = pos.float()[:, None] * inv  # (n, hd/2)
    cos, sin = ang.cos()[:, None], ang.sin()[:, None]
    x1, x2 = x[..., :hd // 2], x[..., hd // 2:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], -1)


def _attend(q, k, v):
    """Causal attention of one row: q (n, h, hd), k/v (n, h_kv, hd)."""
    n, h, hd = q.shape
    rep = h // k.shape[1]
    k = k.repeat_interleave(rep, 1).transpose(0, 1)
    v = v.repeat_interleave(rep, 1).transpose(0, 1)
    s = q.transpose(0, 1) @ k.transpose(-1, -2) / math.sqrt(hd)
    mask = torch.ones(n, n, dtype=torch.bool, device=q.device).tril()
    w = torch.softmax(s.masked_fill(~mask, float("-inf")), dim=-1)
    return (w @ v).transpose(0, 1)


def decoder_logits(seed: int, cfg: dict, rows: Sequence[dict],
                   prec: Precision = REFERENCE) -> List[torch.Tensor]:
    """Teacher-forced logits of each row at the positions that served
    its tokens. A row: ``ids`` (n,) long (prompt, then every served
    token but the last), ``prompt_len``, ``video`` (projected video
    tokens for its <vid_patch> positions) and ``at`` (positions whose
    logits are wanted). Returns [(len(at), vocab_served) f32]."""
    dev = rows[0]["ids"].device
    d, eps = cfg["hidden_size"], cfg["rms_norm_eps"]
    h, h_kv, hd = (cfg["num_attention_heads"], cfg["num_key_value_heads"],
                   cfg["head_dim"])
    vocab = cfg["vocab_size_served"]
    top = dict(weights.llm_top_units(cfg))
    table = weights.draw_unit(seed, "llm.embed", top["llm.embed"], dev)[
        "model.embed_tokens.weight"]
    table = quant.int8_rows(_grown(table, vocab))
    lens = [len(r["ids"]) for r in rows]
    s_max = max(lens)
    x = torch.zeros((len(rows), s_max, d), device=dev)
    prompt = torch.zeros((len(rows), s_max), dtype=torch.bool, device=dev)
    for i, r in enumerate(rows):
        e = table[r["ids"]]
        patch = (r["ids"] == cfg["vid_patch_token_id"]).nonzero()[:, 0]
        e[patch] = r["video"][:len(patch)]
        x[i, :lens[i]] = e
        prompt[i, :r["prompt_len"]] = True
    del table
    for li in range(cfg["num_hidden_layers"]):
        p = weights.llm_layer(seed, cfg, li, dev)
        lp = f"model.layers.{li}."
        nl = cfg["num_hidden_layers"]
        w = {n: _Linear(p[lp + k], nl) for n, k in (
            ("q", "self_attn.q_proj.weight"), ("k", "self_attn.k_proj.weight"),
            ("v", "self_attn.v_proj.weight"), ("o", "self_attn.o_proj.weight"),
            ("gate", "mlp.gate_proj.weight"), ("up", "mlp.up_proj.weight"),
            ("down", "mlp.down_proj.weight"))}
        hn = _rms_norm(x, p[lp + "input_layernorm.weight"].float(), eps)
        q, k, v = (w[n](hn, prompt, prec) for n in ("q", "k", "v"))
        attn = torch.zeros((len(rows), s_max, h * hd), device=dev)
        for i, n in enumerate(lens):
            pos = torch.arange(n, device=dev)
            qi = _rope(q[i, :n].view(n, h, hd), pos, cfg["rope_theta"])
            ki = _rope(k[i, :n].view(n, h_kv, hd), pos, cfg["rope_theta"])
            vi = v[i, :n].view(n, h_kv, hd)
            attn[i, :n] = _attend(prec.low(qi), prec.low(ki),
                                  prec.low(vi)).reshape(n, h * hd)
        x = x + w["o"](attn, prompt, prec)
        hn = _rms_norm(x, p[lp + "post_attention_layernorm.weight"].float(),
                       eps)
        g = F.silu(w["gate"](hn, prompt, prec)) * w["up"](hn, prompt, prec)
        x = x + w["down"](g, prompt, prec)
        del p, w, hn, q, k, v, attn, g
    head = weights.draw_unit(seed, "llm.head", top["llm.head"], dev)
    norm_w = head["model.norm.weight"].float()
    lm = _Linear(_grown(head["lm_head.weight"], vocab), 1)
    out = []
    for i, r in enumerate(rows):
        hs = _rms_norm(x[i, r["at"]], norm_w, eps)
        out.append(lm(hs, prompt[i, r["at"]], prec))
    return out


def served_gaps(logits: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """Each served token's distance below the reference's best logit at
    its position: logits (n, vocab), tokens (n,) -> (n,)."""
    return logits.max(-1).values - logits.gather(
        -1, tokens.long()[:, None])[:, 0]
