"""ResNet trunks (inference-mode BN) of the XMem propagation encoders.

Counterpart of video_llava_tpu/models/resnet.py: the reference's DEVA
tracker (grounding_evaluation/grounding_new_api.py:20-24, :285-286) wraps
a ResNet-50 key encoder and a ResNet-18 value encoder (XMem lineage),
each to layer3, features returned at strides 4/8/16. Here the layout is
torch's: NCHW activations, parameter trees of nested dicts with OIHW conv
weights ({'weight', optional 'bias'}) and BN statistics ({'scale',
'bias', 'mean', 'var'}), so a torchvision-style state dict converts
without transposes (convert_torch_trunk). Convolutions are F.conv2d with
torch-style symmetric k // 2 padding.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import torch
import torch.nn.functional as F

from video_llava_tpu_torch.models.layers import TreeInit


@dataclasses.dataclass(frozen=True)
class ResNetTrunkConfig:
    """A 3-stage trunk (conv1 + layer1..layer3, no layer4 or fc)."""

    block: str  # 'basic' (resnet18) | 'bottleneck' (resnet50)
    stage_sizes: Tuple[int, int, int]  # blocks per layer
    in_channels: int = 3

    @classmethod
    def resnet50(cls, in_channels: int = 3):
        return cls("bottleneck", (3, 4, 6), in_channels)

    @classmethod
    def resnet18(cls, in_channels: int = 3):
        return cls("basic", (2, 2, 2), in_channels)

    @property
    def widths(self) -> Tuple[int, int, int]:
        return (64, 128, 256)

    @property
    def out_channels(self) -> Tuple[int, int, int]:
        mult = 4 if self.block == "bottleneck" else 1
        return tuple(w * mult for w in self.widths)


def conv2d(p, x: torch.Tensor, stride: int = 1, padding=None):
    """x (..., C, H, W), leading dims folded into the batch; padding k // 2
    a side by default (torch's, not XLA's asymmetric 'SAME')."""
    w = p["weight"]
    lead = x.shape[:-3]
    x = x.reshape((-1,) + x.shape[-3:])
    if padding is None:
        padding = (w.shape[2] // 2, w.shape[3] // 2)
    bias = p.get("bias")
    y = F.conv2d(x, w.to(x.dtype), None if bias is None else bias.to(x.dtype),
                 stride, padding)
    return y.reshape(lead + y.shape[1:])


def batch_norm(p, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Inference BN on (..., C, H, W): the scale and shift folded in f32,
    applied in x's dtype."""
    inv = torch.rsqrt(p["var"].float() + eps)
    scale = p["scale"].float() * inv
    shift = p["bias"].float() - p["mean"].float() * scale
    return (x * scale.to(x.dtype)[:, None, None]
            + shift.to(x.dtype)[:, None, None])


def max_pool_3x3s2(x: torch.Tensor) -> torch.Tensor:
    lead = x.shape[:-3]
    y = F.max_pool2d(x.reshape((-1,) + x.shape[-3:]), 3, 2, 1)
    return y.reshape(lead + y.shape[1:])


def conv_init(init: TreeInit, kh: int, kw: int, cin: int, cout: int,
              use_bias: bool = False) -> dict:
    """He-normal OIHW weight (std sqrt(2 / fan_in)), zero bias."""
    p = {"weight": init.normal((cout, cin, kh, kw),
                               math.sqrt(2.0 / (kh * kw * cin)))}
    if use_bias:
        p["bias"] = init.zeros((cout,))
    return p


def bn_init(init: TreeInit, c: int) -> dict:
    return {"scale": init.full((c,), 1.0), "bias": init.zeros((c,)),
            "mean": init.zeros((c,)), "var": init.full((c,), 1.0)}


def _block_init(init: TreeInit, block: str, cin: int, width: int,
                stride: int):
    if block == "bottleneck":
        cout = width * 4
        p = {"conv1": conv_init(init, 1, 1, cin, width),
             "bn1": bn_init(init, width),
             "conv2": conv_init(init, 3, 3, width, width),
             "bn2": bn_init(init, width),
             "conv3": conv_init(init, 1, 1, width, cout),
             "bn3": bn_init(init, cout)}
    else:
        cout = width
        p = {"conv1": conv_init(init, 3, 3, cin, width),
             "bn1": bn_init(init, width),
             "conv2": conv_init(init, 3, 3, width, width),
             "bn2": bn_init(init, width)}
    if stride != 1 or cin != cout:
        p["downsample"] = {"conv": conv_init(init, 1, 1, cin, cout),
                           "bn": bn_init(init, cout)}
    return p, cout


def init_trunk_params(init: TreeInit, cfg: ResNetTrunkConfig) -> dict:
    params = {"conv1": conv_init(init, 7, 7, cfg.in_channels, 64),
              "bn1": bn_init(init, 64)}
    cin = 64
    for li, (n, width) in enumerate(zip(cfg.stage_sizes, cfg.widths)):
        blocks = []
        for bi in range(n):
            stride = 2 if (li > 0 and bi == 0) else 1
            bp, cin = _block_init(init, cfg.block, cin, width, stride)
            blocks.append(bp)
        params[f"layer{li + 1}"] = blocks
    return params


def _block_forward(p, x, block: str, stride: int):
    identity = x
    if block == "bottleneck":
        y = F.relu(batch_norm(p["bn1"], conv2d(p["conv1"], x)))
        y = F.relu(batch_norm(p["bn2"], conv2d(p["conv2"], y, stride)))
        y = batch_norm(p["bn3"], conv2d(p["conv3"], y))
    else:
        y = F.relu(batch_norm(p["bn1"], conv2d(p["conv1"], x, stride)))
        y = batch_norm(p["bn2"], conv2d(p["conv2"], y))
    if "downsample" in p:
        identity = batch_norm(p["downsample"]["bn"],
                              conv2d(p["downsample"]["conv"], x, stride))
    return F.relu(y + identity)


def trunk_forward(params, x: torch.Tensor, cfg: ResNetTrunkConfig):
    """x (..., C, H, W) -> (f4, f8, f16), the layer1/2/3 outputs at
    strides 4/8/16 (XMem's skip connections)."""
    y = F.relu(batch_norm(params["bn1"], conv2d(params["conv1"], x, 2)))
    y = max_pool_3x3s2(y)
    feats = []
    for li, n in enumerate(cfg.stage_sizes):
        for bi in range(n):
            stride = 2 if (li > 0 and bi == 0) else 1
            y = _block_forward(params[f"layer{li + 1}"][bi], y, cfg.block,
                               stride)
        feats.append(y)
    return tuple(feats)


# -- torch state dicts --------------------------------------------------------


def torch_conv(sd, name: str, device=None, dtype=torch.float32) -> dict:
    p = {"weight": sd[f"{name}.weight"].to(device=device, dtype=dtype)}
    if f"{name}.bias" in sd:
        p["bias"] = sd[f"{name}.bias"].to(device=device, dtype=dtype)
    return p


def torch_bn(sd, name: str, device=None, dtype=torch.float32) -> dict:
    return {k: sd[f"{name}.{src}"].to(device=device, dtype=dtype)
            for k, src in (("scale", "weight"), ("bias", "bias"),
                           ("mean", "running_mean"),
                           ("var", "running_var"))}


def convert_torch_trunk(sd, cfg: ResNetTrunkConfig, prefix: str = "",
                        device=None, dtype=torch.float32) -> dict:
    """A torchvision-style ResNet state dict (as XMem/DEVA checkpoints
    embed it, e.g. under 'key_encoder.') -> trunk params on `device`."""
    params = {"conv1": torch_conv(sd, f"{prefix}conv1", device, dtype),
              "bn1": torch_bn(sd, f"{prefix}bn1", device, dtype)}
    n_convs = 3 if cfg.block == "bottleneck" else 2
    for li, n in enumerate(cfg.stage_sizes):
        blocks = []
        for bi in range(n):
            b = f"{prefix}layer{li + 1}.{bi}"
            p = {}
            for ci in range(1, n_convs + 1):
                p[f"conv{ci}"] = torch_conv(sd, f"{b}.conv{ci}", device,
                                            dtype)
                p[f"bn{ci}"] = torch_bn(sd, f"{b}.bn{ci}", device, dtype)
            if f"{b}.downsample.0.weight" in sd:
                p["downsample"] = {
                    "conv": torch_conv(sd, f"{b}.downsample.0", device,
                                       dtype),
                    "bn": torch_bn(sd, f"{b}.downsample.1", device, dtype)}
            blocks.append(p)
        params[f"layer{li + 1}"] = blocks
    return params
