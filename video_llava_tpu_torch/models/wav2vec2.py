"""wav2vec2-style CTC acoustic model for forced alignment.

Counterpart of video_llava_tpu/models/wav2vec2.py: conv feature
extractor (20 ms frames at 16 kHz) -> conv positional embedding ->
post-LN transformer stack -> CTC log-probs over a character vocabulary.
Parameters are the JAX package's nested dict (the layers a list), with
the conv kernels in torch's (out, in / groups, width) layout instead of
the JAX package's (width, in / groups, out); engine/convert.
wav2vec2_from_jax transposes them.

The forward runs in the audio's dtype (f32): the weights are cast to it
where they are used, as the JAX package promotes bf16 weights against
f32 audio. Attention is a plain einsum softmax, as there (no kernel).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

from video_llava_tpu_torch.models.layers import TreeInit, dense, norm


@dataclasses.dataclass(frozen=True)
class Wav2Vec2Config:
    vocab_size: int = 32
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 3072
    conv_dim: Tuple[int, ...] = (512, 512, 512, 512, 512, 512, 512)
    conv_kernel: Tuple[int, ...] = (10, 3, 3, 3, 3, 2, 2)
    conv_stride: Tuple[int, ...] = (5, 2, 2, 2, 2, 2, 2)
    pos_conv_kernel: int = 128
    pos_conv_groups: int = 16
    blank_id: int = 0  # CTC blank == HF <pad>
    sample_rate: int = 16_000

    @classmethod
    def base(cls):
        return cls()

    @classmethod
    def tiny_test(cls):
        # the strides multiply to base's 320-sample frame stride
        return cls(
            vocab_size=12, hidden_size=32, num_layers=2, num_heads=4,
            intermediate_size=64, conv_dim=(16, 16), conv_kernel=(10, 3),
            conv_stride=(16, 20), pos_conv_kernel=8, pos_conv_groups=4,
        )

    @property
    def frame_stride(self) -> int:
        """Input samples per output frame (320 for base = 20 ms)."""
        s = 1
        for st in self.conv_stride:
            s *= st
        return s

    def num_frames(self, num_samples: int) -> int:
        n = num_samples
        for k, s in zip(self.conv_kernel, self.conv_stride):
            n = (n - k) // s + 1
        return n


def init_params(init: TreeInit, cfg: Wav2Vec2Config):
    """Random parameters at the JAX package's scales (conv kernels
    normal / sqrt(fan_in), linears normal * fan_in ** -0.5, zero biases,
    unit norms), on init's device and dtype."""

    def conv_w(kern, cin, cout, groups=1):
        return init.normal((cout, cin // groups, kern),
                           (kern * cin // groups) ** -0.5)

    convs, cin = [], 1
    for i, (dim, kern) in enumerate(zip(cfg.conv_dim, cfg.conv_kernel)):
        layer = {"w": conv_w(kern, cin, dim)}
        if i == 0:
            layer["gn_scale"] = init.full((dim,), 1.0)
            layer["gn_bias"] = init.zeros((dim,))
        convs.append(layer)
        cin = dim
    d, f = cfg.hidden_size, cfg.intermediate_size
    layers = [{
        "q": init.linear(d, d), "k": init.linear(d, d),
        "v": init.linear(d, d), "o": init.linear(d, d),
        "ln1": init.layer_norm(d), "fc1": init.linear(d, f),
        "fc2": init.linear(f, d), "ln2": init.layer_norm(d),
    } for _ in range(cfg.num_layers)]
    return {
        "convs": convs,
        "proj_ln": init.layer_norm(cfg.conv_dim[-1]),
        "proj": init.linear(cfg.conv_dim[-1], d),
        "pos_conv_w": conv_w(cfg.pos_conv_kernel, d, d, cfg.pos_conv_groups),
        "pos_conv_b": init.zeros((d,)),
        "enc_ln": init.layer_norm(d),
        "layers": layers,
        "lm_head": init.linear(d, cfg.vocab_size),
    }


def _group_norm(x, scale, bias, eps: float = 1e-5):
    """HF's group norm with a group per channel: each channel of x (t, c)
    normalized over the whole time axis, in f32."""
    x32 = x.float()
    mean = x32.mean(dim=0, keepdim=True)
    var = (x32 - mean).square().mean(dim=0, keepdim=True)
    y = (x32 - mean) / torch.sqrt(var + eps) * scale.float() + bias.float()
    return y.to(x.dtype)


def _encoder_layer(p, x, num_heads: int):
    t, d = x.shape
    hd = d // num_heads

    def split(h):
        return h.reshape(t, num_heads, hd).transpose(0, 1)

    q = split(dense(p["q"], x)) / np.sqrt(hd)
    k = split(dense(p["k"], x))
    v = split(dense(p["v"], x))
    a = torch.softmax(torch.einsum("hqd,hkd->hqk", q, k).float(),
                      dim=-1).to(x.dtype)
    o = torch.einsum("hqk,hkd->hqd", a, v).transpose(0, 1).reshape(t, d)
    x = norm(p["ln1"], x + dense(p["o"], o))
    h = F.gelu(dense(p["fc1"], x))
    return norm(p["ln2"], x + dense(p["fc2"], h))


def _conv1d(x, w, b=None, stride: int = 1, groups: int = 1):
    """x (t, cin), w (cout, cin / groups, k) -> (t', cout), no padding."""
    y = F.conv1d(x.T[None], w.to(x.dtype), None if b is None
                 else b.to(x.dtype), stride=stride, groups=groups)
    return y[0].T


@torch.inference_mode()
def forward(params, audio: torch.Tensor, cfg: Wav2Vec2Config):
    """(num_samples,) float32 PCM at 16 kHz -> (frames, vocab) f32
    log-probs."""
    x = audio.float()[:, None]  # (t, 1)
    for i, layer in enumerate(params["convs"]):
        x = _conv1d(x, layer["w"], stride=cfg.conv_stride[i])
        if "gn_scale" in layer:
            x = _group_norm(x, layer["gn_scale"], layer["gn_bias"])
        x = F.gelu(x)
    x = norm(params["proj_ln"], x)
    x = dense(params["proj"], x)
    # conv positional embedding: k // 2 zeros each side, the trailing
    # column dropped for an even kernel; then the post-LN stack
    k = cfg.pos_conv_kernel
    pos = _conv1d(F.pad(x, (0, 0, k // 2, k // 2)), params["pos_conv_w"],
                  params["pos_conv_b"], groups=cfg.pos_conv_groups)
    if k % 2 == 0:
        pos = pos[:-1]
    x = x + F.gelu(pos[:x.shape[0]])
    x = norm(params["enc_ln"], x)
    for lp in params["layers"]:
        x = _encoder_layer(lp, x, cfg.num_heads)
    logits = dense(params["lm_head"], x)
    return torch.log_softmax(logits.float(), dim=-1)


def convert_hf_wav2vec2(sd, cfg: Wav2Vec2Config, device=None,
                        dtype: torch.dtype = torch.float32) -> dict:
    """An HF Wav2Vec2ForCTC state dict (keys with or without the
    'wav2vec2.' prefix) -> the port's tree (init_params' layout) on
    `device` in `dtype` (JAX convert_hf_wav2vec2): conv kernels kept in
    torch's (out, in / groups, width), linears (in, out), the positional
    conv's weight norm folded in (w = g v / ||v||, the norm over (in,
    width) of each output channel, in f32; weight_g / weight_v, or the
    parametrizations.weight.original0 / 1 of newer saves)."""
    sd = {k.removeprefix("wav2vec2."): torch.as_tensor(v).float()
          for k, v in sd.items()}

    def t(name):
        return sd[name].to(device=device, dtype=dtype)

    def lin(pre):
        p = {"kernel": t(f"{pre}.weight").t().contiguous()}
        if f"{pre}.bias" in sd:
            p["bias"] = t(f"{pre}.bias")
        return p

    def ln(pre):
        return {"scale": t(f"{pre}.weight"), "bias": t(f"{pre}.bias")}

    convs = []
    for i in range(len(cfg.conv_dim)):
        pre = f"feature_extractor.conv_layers.{i}"
        layer = {"w": t(f"{pre}.conv.weight")}
        if f"{pre}.layer_norm.weight" in sd:
            layer["gn_scale"] = t(f"{pre}.layer_norm.weight")
            layer["gn_bias"] = t(f"{pre}.layer_norm.bias")
        convs.append(layer)
    pos = "encoder.pos_conv_embed.conv."
    if pos + "weight_g" in sd:
        g, v = sd[pos + "weight_g"], sd[pos + "weight_v"]
    else:  # torch's parametrized weight norm, as newer saves name it
        g = sd[pos + "parametrizations.weight.original0"]
        v = sd[pos + "parametrizations.weight.original1"]
    pos_w = g * v / v.square().sum(dim=(1, 2), keepdim=True).sqrt()
    return {
        "convs": convs,
        "proj_ln": ln("feature_projection.layer_norm"),
        "proj": lin("feature_projection.projection"),
        "pos_conv_w": pos_w.to(device=device, dtype=dtype),
        "pos_conv_b": t("encoder.pos_conv_embed.conv.bias"),
        "enc_ln": ln("encoder.layer_norm"),
        "layers": [{
            "q": lin(f"encoder.layers.{i}.attention.q_proj"),
            "k": lin(f"encoder.layers.{i}.attention.k_proj"),
            "v": lin(f"encoder.layers.{i}.attention.v_proj"),
            "o": lin(f"encoder.layers.{i}.attention.out_proj"),
            "ln1": ln(f"encoder.layers.{i}.layer_norm"),
            "fc1": lin(f"encoder.layers.{i}.feed_forward.intermediate_dense"),
            "fc2": lin(f"encoder.layers.{i}.feed_forward.output_dense"),
            "ln2": ln(f"encoder.layers.{i}.final_layer_norm"),
        } for i in range(cfg.num_layers)],
        "lm_head": lin("lm_head"),
    }
