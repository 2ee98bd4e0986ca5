"""Spatio-temporal feature pooling.

Counterpart of video_llava_tpu/ops/pooling.py:

    features: (t, s, c) per-frame CLIP patch features
    temporal  = mean over s, rows >= num_valid_frames zeroed,
                zero-padded to (max_temporal_tokens, c)
    spatial   = mean over the valid frames -> (s, c)
    output    = concat([temporal, spatial])  # (max_temporal_tokens + s, c)

:func:`spatio_temporal_pool` is the plain version;
:func:`spatio_temporal_pool_fused` runs csrc/pool.cu on CUDA tensors.
:func:`pool_partials_plain` and :func:`pool_combine_plain` are the plain
versions of the kernel's two stages (a block's temporal partial over a
run of patches, then their run-order sum).
"""

from __future__ import annotations

from typing import Optional

import torch

from video_llava_tpu_torch.constants import MAX_TEMPORAL_TOKENS
from video_llava_tpu_torch.ops import cuda_lib


def spatio_temporal_pool(
    features: torch.Tensor,
    num_valid_frames: Optional[int] = None,
    max_temporal_tokens: int = MAX_TEMPORAL_TOKENS,
    out_dtype: torch.dtype = torch.bfloat16,
) -> torch.Tensor:
    """Pool (t, s, c) features -> (max_temporal_tokens + s, c), sums in
    f32."""
    t, s, c = features.shape
    if t > max_temporal_tokens:
        raise ValueError(
            f"t={t} exceeds max_temporal_tokens={max_temporal_tokens}")
    x = features.float()
    if num_valid_frames is None:
        temporal = x.mean(dim=1)
        spatial = x.mean(dim=0)
    else:
        n = int(num_valid_frames)
        mask = (torch.arange(t, device=x.device) < n).float()[:, None]
        temporal = x.mean(dim=1) * mask
        spatial = (x * mask[:, :, None]).sum(dim=0) / max(float(n), 1.0)
    pad = temporal.new_zeros((max_temporal_tokens - t, c))
    return torch.cat([temporal, pad, spatial], dim=0).to(out_dtype)


def pool_partials_plain(features: torch.Tensor, num_valid_frames: int,
                        run: int):
    """The kernel's first stage: (partial (ceil(s / run), t, c), spatial
    sums (s, c)), f32. partial[r, f] is frame f summed over patches
    [r * run, (r + 1) * run) for f < min(n, t), 0 for the frames never
    read; the spatial sums run over those same frames."""
    t, s, c = features.shape
    nv = max(min(int(num_valid_frames), t), 0)
    x = features.float()
    runs = -(-s // run)
    padded = torch.nn.functional.pad(x, (0, 0, 0, runs * run - s))
    partial = padded.reshape(t, runs, run, c).sum(dim=2).transpose(0, 1)
    partial = partial * (torch.arange(t, device=x.device) < nv).float()[
        None, :, None]
    return partial.contiguous(), x[:nv].sum(dim=0)


def pool_combine_plain(partial: torch.Tensor, spatial_sum: torch.Tensor,
                       num_valid_frames: int, max_temporal_tokens: int,
                       out_dtype: torch.dtype = torch.bfloat16):
    """The kernel's second stage: the runs' partials added in run order
    over s, the spatial sums over max(n, 1) -> (max_temporal_tokens + s,
    c)."""
    runs, t, c = partial.shape
    s = spatial_sum.shape[0]
    temporal = partial[0].clone()
    for r in range(1, runs):
        temporal += partial[r]
    pad = temporal.new_zeros((max_temporal_tokens - t, c))
    spatial = spatial_sum / max(float(num_valid_frames), 1.0)
    return torch.cat([temporal / s, pad, spatial], dim=0).to(out_dtype)


def spatio_temporal_pool_fused(
    features: torch.Tensor,
    num_valid_frames: Optional[int] = None,
    max_temporal_tokens: int = MAX_TEMPORAL_TOKENS,
    out_dtype: torch.dtype = torch.bfloat16,
) -> torch.Tensor:
    """Same contract as :func:`spatio_temporal_pool`. On CUDA one read of
    the valid frames produces both means (csrc/pool.cu); bf16 in, bf16 or
    f32 out, any s and c."""
    t, s, c = features.shape
    if features.device.type == "cpu":
        return spatio_temporal_pool(features, num_valid_frames,
                                    max_temporal_tokens, out_dtype)
    if not 1 <= t <= max_temporal_tokens:
        raise ValueError(
            f"t={t} outside [1, max_temporal_tokens={max_temporal_tokens}]")
    if out_dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"out_dtype: bf16 or f32, got {out_dtype}")
    cuda_lib.require(features, "features", torch.bfloat16)
    n = t if num_valid_frames is None else int(num_valid_frames)
    lib = cuda_lib.library()
    runs = -(-s // lib.vlt_pool_rows_per_block())
    out = torch.empty((max_temporal_tokens + s, c), dtype=out_dtype,
                      device=features.device)
    partial = torch.empty((runs, t, c), dtype=torch.float32,
                          device=features.device)
    cuda_lib.launch(
        "spatio_temporal_pool", "vlt_spatio_temporal_pool", features.device,
        cuda_lib.ptr(features), cuda_lib.ptr(out), cuda_lib.ptr(partial),
        t, s, c, max_temporal_tokens, n, int(out_dtype == torch.bfloat16),
    )
    return out
