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


def _keys_cubic(x: torch.Tensor) -> torch.Tensor:
    """Keys cubic kernel, a = -0.5 (jax.image.resize's 'bicubic')."""
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = torch.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return torch.where(x >= 2.0, 0.0, out)


def resize_weights(in_size: int, out_size: int, device=None) -> torch.Tensor:
    """(in_size, out_size) f32 weights of one axis of
    jax.image.resize(method='bicubic', antialias=True), built as its
    compute_weight_mat builds them: the kernel widened by the scale when
    downsampling, columns renormalized to sum to one, samples outside the
    input zeroed. (torch's bicubic interpolate is another function: a =
    -0.75 and no antialias.)"""
    inv_scale = torch.tensor(1.0 / (out_size / in_size), dtype=torch.float32)
    kernel_scale = torch.clamp(inv_scale, min=1.0)
    sample = ((torch.arange(out_size, dtype=torch.float32) + 0.5) * inv_scale
              - 0.5)
    rows = torch.arange(in_size, dtype=torch.float32)[:, None]
    w = _keys_cubic((sample[None, :] - rows).abs() / kernel_scale)
    total = w.sum(dim=0, keepdim=True)
    eps = 1000.0 * torch.finfo(torch.float32).eps
    w = torch.where(total.abs() > eps,
                    w / torch.where(total != 0, total, 1.0), 0.0)
    inside = (sample >= -0.5) & (sample <= in_size - 0.5)
    return torch.where(inside[None, :], w, 0.0).to(device)


def resize_bicubic(frames: torch.Tensor, out_h: int, out_w: int):
    """(..., h, w, c) -> (..., out_h, out_w, c) f32: antialiased bicubic
    as jax.image.resize(method='bicubic', antialias=True), one matmul per
    axis that changes (rows first)."""
    h, w = frames.shape[-3], frames.shape[-2]
    x = frames.float()
    if h != out_h:
        x = torch.einsum("...hwc,ho->...owc", x,
                         resize_weights(h, out_h, x.device))
    if w != out_w:
        x = torch.einsum("...hwc,wo->...hoc", x,
                         resize_weights(w, out_w, x.device))
    return x


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
