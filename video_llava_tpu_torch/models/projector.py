"""mm_projector: maps pooled CLIP features into the LM embedding space.

Counterpart of video_llava_tpu/models/projector.py: 'linear' (the
224 px default), 'mlp{N}x_gelu' or 'identity'. jax.nn.gelu defaults to
the tanh approximation, so the MLP uses gelu(approximate="tanh").
"""

from __future__ import annotations

import re

import torch
import torch.nn.functional as F
from torch import nn

from video_llava_tpu_torch.config import ProjectorConfig
from video_llava_tpu_torch.models.layers import Linear

_MLP_RE = re.compile(r"^mlp(\d+)x_gelu$")


class Projector(nn.Module):
    def __init__(self, cfg: ProjectorConfig, *, device=None,
                 dtype=torch.float32):
        super().__init__()
        t = cfg.projector_type
        kw = dict(device=device, dtype=dtype)
        if t == "identity":
            depth = 0
        elif t == "linear":
            depth = 1
        elif _MLP_RE.match(t):
            depth = int(_MLP_RE.match(t).group(1))
        else:
            raise ValueError(f"Unknown projector type: {t}")
        dims = [cfg.mm_hidden_size] + [cfg.hidden_size] * depth
        self.layers = nn.ModuleList(
            Linear(dims[i], dims[i + 1], **kw) for i in range(depth))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i, layer in enumerate(self.layers):
            if i:
                x = F.gelu(x, approximate="tanh")
            x = layer(x)
        return x
