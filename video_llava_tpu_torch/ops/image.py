"""Image preprocessing for the CLIP vision tower.

Counterpart of video_llava_tpu/ops/image.py: frames resized to (size,
size) with torch nearest semantics (the chat path), or the HF processor's
shortest-edge bicubic resize and center crop, then rescaled by 1/255 and
normalized with the CLIP mean/std, in f32; and the grounding crop
filter's batched box crops, resized as matmuls.
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


def crop_resize_weights(lo: torch.Tensor, hi: torch.Tensor, in_size: int,
                        out_size: int) -> torch.Tensor:
    """(..., in_size, out_size) f32 weights resizing the integer crop
    [lo, hi) of an `in_size` axis to `out_size` in global input
    coordinates: w^T @ axis is resize_bicubic(axis[lo:hi], out_size)
    (the antialiased Keys kernel, columns renormalized), for crop bounds
    of any batch shape in one product."""
    lo_f = lo.float()[..., None, None]
    span = (hi - lo).float()[..., None, None]
    inv_scale = span / out_size
    kernel_scale = torch.clamp(inv_scale, min=1.0)  # antialias
    dev = lo.device
    rows = torch.arange(in_size, dtype=torch.float32, device=dev)[:, None]
    cols = torch.arange(out_size, dtype=torch.float32, device=dev)[None, :]
    sample = (cols + 0.5) * inv_scale - 0.5 + lo_f  # (..., 1, out)
    w = _keys_cubic((sample - rows).abs() / kernel_scale)
    w = w * ((rows >= lo_f) & (rows < lo_f + span))
    total = w.sum(dim=-2, keepdim=True)
    eps = 1000.0 * torch.finfo(torch.float32).eps
    return torch.where(total.abs() > eps,
                       w / torch.where(total != 0, total, 1.0), 0.0)


def crop_resize_bicubic_batch(images: torch.Tensor, boxes: torch.Tensor,
                              out_size: int) -> torch.Tensor:
    """(c, H, W, 3) frames and (c, K, 4) xyxy pixel boxes -> (c, K,
    out_size, out_size, 3) f32 crops, each resize_bicubic of the box's
    pixels after the crop filter's clamp (truncate; x0, y0 >= 0; x1 in
    [x0 + 1, W]; y1 in [y0 + 1, H]); a box outside the frame becomes a
    one-pixel edge crop. Two products against the separable weights."""
    c, H, W = images.shape[:3]
    b = torch.trunc(boxes.float()).to(torch.int32)
    x0 = b[..., 0].clamp(min=0)
    y0 = b[..., 1].clamp(min=0)
    x1 = torch.minimum(torch.maximum(b[..., 2], x0 + 1),
                       torch.tensor(W, device=b.device))
    y1 = torch.minimum(torch.maximum(b[..., 3], y0 + 1),
                       torch.tensor(H, device=b.device))
    x0 = torch.minimum(x0, x1 - 1)
    y0 = torch.minimum(y0, y1 - 1)
    wy = crop_resize_weights(y0, y1, H, out_size)  # (c, K, H, s)
    wx = crop_resize_weights(x0, x1, W, out_size)  # (c, K, W, s)
    t = torch.einsum("chwd,ckhs->ckswd", images.float(), wy)
    return torch.einsum("ckswd,ckwt->ckstd", t, wx)


def center_crop(frames: torch.Tensor, size: int) -> torch.Tensor:
    """Center crop of (..., h, w, c) to (size, size), as HF
    CLIPImageProcessor crops."""
    h, w = frames.shape[-3], frames.shape[-2]
    top, left = (h - size) // 2, (w - size) // 2
    return frames[..., top:top + size, left:left + size, :]


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
                      resize_mode: str = "nearest",
                      dtype=torch.float32) -> torch.Tensor:
    """(t, h, w, 3) uint8 -> normalized (t, image_size, image_size, 3).
    'nearest' resizes straight to the square and casts to uint8, as the
    reference's load_video does; 'bicubic' is the HF processor's path for
    frames of any size: the shortest edge to image_size (antialiased
    bicubic), the center crop, then round and clip to [0, 255]."""
    if resize_mode == "nearest":
        x = resize_nearest(frames, image_size, image_size)
        if x.dtype != torch.uint8:
            x = x.to(torch.uint8)
    elif resize_mode == "bicubic":
        h, w = frames.shape[-3], frames.shape[-2]
        scale = image_size / min(h, w)
        x = resize_bicubic(frames, round(h * scale), round(w * scale))
        x = torch.clamp(torch.round(center_crop(x, image_size)), 0, 255)
    else:
        raise ValueError(f"unknown resize_mode: {resize_mode}")
    return normalize_clip(x, dtype)
