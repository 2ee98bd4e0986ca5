"""Image preprocessing for the CLIP vision tower.

Counterpart of video_llava_tpu/ops/image.py (the chat path's nearest
mode): frames resized to (size, size) with torch nearest semantics,
then rescaled by 1/255 and normalized with the CLIP mean/std, in f32.
"""

from __future__ import annotations

import torch

# OpenAI CLIP normalization constants (HF CLIPImageProcessor defaults).
CLIP_IMAGE_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_IMAGE_STD = (0.26862954, 0.26130258, 0.27577711)


def resize_nearest(frames: torch.Tensor, out_h: int, out_w: int):
    """(..., h, w, c) -> (..., out_h, out_w, c) with
    src = floor(dst * in / out), as torch F.interpolate(mode='nearest')."""
    h, w = frames.shape[-3], frames.shape[-2]
    if (h, w) == (out_h, out_w):
        return frames
    dev = frames.device
    rows = torch.floor(torch.arange(out_h, dtype=torch.float32, device=dev)
                       * (h / out_h)).long()
    cols = torch.floor(torch.arange(out_w, dtype=torch.float32, device=dev)
                       * (w / out_w)).long()
    return frames.index_select(-3, rows).index_select(-2, cols)


def normalize_clip(frames: torch.Tensor, dtype=torch.float32):
    """uint8/float pixels (..., h, w, 3) -> rescale(1/255) -> CLIP
    mean/std normalize, in `dtype`."""
    mean = torch.tensor(CLIP_IMAGE_MEAN, dtype=torch.float32,
                        device=frames.device)
    std = torch.tensor(CLIP_IMAGE_STD, dtype=torch.float32,
                       device=frames.device)
    x = frames.float() * (1.0 / 255.0)
    return ((x - mean) / std).to(dtype)


def preprocess_frames(frames: torch.Tensor, image_size: int,
                      dtype=torch.float32) -> torch.Tensor:
    """(t, h, w, 3) uint8 -> normalized (t, image_size, image_size, 3)."""
    x = resize_nearest(frames, image_size, image_size)
    if x.dtype != torch.uint8:
        x = x.to(torch.uint8)
    return normalize_clip(x, dtype)
