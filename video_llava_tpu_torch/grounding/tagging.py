"""Frame tagging on the Swin backbone: a linear tag head, or RAM's
label-query decoder (models/ram.py).

Counterpart of video_llava_tpu/grounding/tagging.py (reference
TaggingModule, grounding_evaluation/util/image_tagging.py:8-50): every
frame is tagged at a threshold (0.95, or the RAM release's per-tag
thresholds) in batched forwards, and get_unique_tags returns the
frequency-sorted tags.
"""

from __future__ import annotations

from collections import Counter
from typing import List, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from video_llava_tpu_torch.models import swin as swin_mod
from video_llava_tpu_torch.models.layers import TreeInit, dense, norm
from video_llava_tpu_torch.models.swin import SwinConfig
from video_llava_tpu_torch.ops.image import resize_bicubic

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def init_tag_head(init: TreeInit, num_features: int, num_tags: int):
    """The JAX package's init_tag_head draw: LN, projection, head."""
    return {"norm": init.layer_norm(num_features),
            "proj": init.linear(num_features, num_features),
            "head": init.linear(num_features, num_tags)}


def tag_logits(backbone_params, head_params, pixels: torch.Tensor,
               cfg: SwinConfig) -> torch.Tensor:
    """(b, H, W, 3) -> (b, num_tags). The head's GELU is the tanh one
    (jax.nn.gelu's default), unlike the backbone's exact GELU."""
    feats = swin_mod.forward_features(backbone_params, pixels, cfg)[-1]
    b, hh, ww, c = feats.shape
    x = norm(head_params["norm"], feats.reshape(b, hh * ww, c))
    x = F.gelu(dense(head_params["proj"], x), approximate="tanh").mean(dim=1)
    return dense(head_params["head"], x)


class TaggingModule:
    """Batched frame tagger with a tag vocabulary."""

    def __init__(self, backbone_params, head_params, cfg: SwinConfig,
                 tag_list: Sequence[str], threshold=0.95, logits_fn=None):
        """threshold: a scalar, or (num_tags,) per-tag thresholds (the RAM
        release's class_threshold). logits_fn(backbone, head, pixels) ->
        (b, num_tags); the linear head's tag_logits by default."""
        self.backbone_params = backbone_params
        self.head_params = head_params
        self.cfg = cfg
        self.tag_list = list(tag_list)
        self.threshold = threshold
        self._logits = logits_fn or (
            lambda bp, hp, px: tag_logits(bp, hp, px, cfg))
        self.device = backbone_params["patch_embed"]["kernel"].device

    @classmethod
    def with_ram_decoder(cls, backbone_params, ram_params, swin_cfg: SwinConfig,
                         ram_cfg, tag_list: Sequence[str], threshold=0.95):
        """A tagger with RAM's label-query decoder (models/ram.py) in place
        of the linear head."""
        from video_llava_tpu_torch.models import ram as ram_mod

        return cls(backbone_params, ram_params, swin_cfg, tag_list, threshold,
                   logits_fn=lambda bp, hp, px: ram_mod.tag_logits(
                       bp, hp, px, swin_cfg, ram_cfg))

    @torch.inference_mode()
    def run_on_frames(self, frames) -> List[List[str]]:
        """frames (t, H, W, 3) float, normalized -> per-frame tags."""
        x = torch.as_tensor(np.asarray(frames), device=self.device)
        probs = torch.sigmoid(self._logits(self.backbone_params,
                                           self.head_params, x))
        return self._threshold_rows(probs.cpu().numpy())

    def _threshold_rows(self, probs: np.ndarray) -> List[List[str]]:
        """Each row's tags over their thresholds (a scalar, or one a
        tag)."""
        over = probs > np.asarray(self.threshold)
        return [[self.tag_list[i] for i in np.nonzero(row)[0]]
                for row in over]

    @torch.inference_mode()
    def run_on_frames_raw(self, frames, image_size: int = 384,
                          batch_size: int = 20) -> List[List[str]]:
        """frames (t, H, W, 3) uint8, numpy or a tensor (grounded chat
        shares one clip upload) -> per-frame tags. On the device: / 255,
        antialiased bicubic to image_size, clip to [0, 1], ImageNet
        normalization (RAM's transform). Fixed-size batches; the last
        repeats its last frame."""
        dev = self.device
        frames = (frames if isinstance(frames, torch.Tensor)
                  else torch.as_tensor(np.asarray(frames))).to(dev)
        mean = torch.tensor(IMAGENET_MEAN, device=dev)
        std = torch.tensor(IMAGENET_STD, device=dev)
        dtype = self.backbone_params["patch_embed"]["kernel"].dtype
        rows = []
        for s in range(0, len(frames), batch_size):
            chunk = frames[s:s + batch_size]
            n = len(chunk)
            if n < batch_size:
                chunk = torch.cat([chunk, chunk[-1:].expand(
                    (batch_size - n,) + chunk.shape[1:])])
            x = resize_bicubic(chunk.float() / 255.0, image_size, image_size)
            x = ((x.clamp(0.0, 1.0) - mean) / std).to(dtype)
            probs = torch.sigmoid(self._logits(self.backbone_params,
                                               self.head_params, x))
            rows.append(probs[:n].cpu().numpy())
        return self._threshold_rows(np.concatenate(rows, axis=0))

    def run_on_video(self, frames, top_k: int = 10) -> List[str]:
        raw = (frames.dtype == torch.uint8 if isinstance(frames, torch.Tensor)
               else np.asarray(frames).dtype == np.uint8)
        per_frame = (self.run_on_frames_raw(frames) if raw
                     else self.run_on_frames(frames))
        return get_unique_tags(per_frame)[:top_k]


def get_unique_tags(per_frame_tags: Sequence[Sequence[str]]) -> List[str]:
    """Frequency-sorted unique tags across frames (per-call counts)."""
    counts = Counter()
    for tags in per_frame_tags:
        counts.update(tags)
    return [t for t, _ in counts.most_common()]
