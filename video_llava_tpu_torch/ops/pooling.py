"""Spatio-temporal feature pooling.

Counterpart of video_llava_tpu/ops/pooling.py:

    features: (t, s, c) per-frame CLIP patch features
    temporal  = mean over s, rows >= num_valid_frames zeroed,
                zero-padded to (max_temporal_tokens, c)
    spatial   = mean over the valid frames -> (s, c)
    output    = concat([temporal, spatial])  # (max_temporal_tokens + s, c)

or, batched as the JAX package pools under vmap, (b, t, s, c) features
with a valid count a video -> (b, max_temporal_tokens + s, c).

:func:`spatio_temporal_pool` is the plain version;
:func:`spatio_temporal_pool_fused` runs csrc/pool.cu on CUDA tensors
(every video of a batch in one launch);
:func:`spatio_temporal_pool_sharded` pools frame-sharded over a mesh's
'data' axis through the same kernel, each rank's spatial sums divided by
the global count (:func:`pool_shard_plain` is its plain version).
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
    f32. Batched (b, t, s, c) features take None or b valid counts (a
    sequence or a (b,) tensor) -> (b, max_temporal_tokens + s, c)."""
    if features.ndim == 4:
        counts = (None,) * len(features) if num_valid_frames is None else [
            int(n) for n in num_valid_frames]
        return torch.stack([
            spatio_temporal_pool(f, n, max_temporal_tokens, out_dtype)
            for f, n in zip(features, counts)])
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


# The mesh an entry point registered (runtime/model_init.py, as the JAX
# package's does): encode_video pools frame-sharded under it.
_GLOBAL_MESH = None


def set_pooling_mesh(mesh) -> None:
    global _GLOBAL_MESH
    _GLOBAL_MESH = mesh


def get_pooling_mesh():
    return _GLOBAL_MESH


def spatio_temporal_pool_fused(
    features: torch.Tensor,
    num_valid_frames=None,
    max_temporal_tokens: int = MAX_TEMPORAL_TOKENS,
    out_dtype: torch.dtype = torch.bfloat16,
    n_denom: Optional[int] = None,
) -> torch.Tensor:
    """Same contract as :func:`spatio_temporal_pool`. On CUDA one read of
    the valid frames produces both means (csrc/pool.cu); bf16 in, bf16 or
    f32 out, any s and c. (t, s, c) features take an int count or None;
    batched (b, t, s, c) features take None or a (b,) int32 tensor of
    counts on their device, and every video pools in the same launch
    (the (t, s, c) call is its b = 1 case). `n_denom`, when given,
    divides the spatial sums in place of the valid count (the JAX
    kernel's n_denom: one shard's partial of the frame-sharded form,
    :func:`pool_shard_plain` on the CPU)."""
    if features.device.type == "cpu":
        if n_denom is not None:
            return pool_shard_plain(features, num_valid_frames, n_denom,
                                    max_temporal_tokens, out_dtype)
        return spatio_temporal_pool(features, num_valid_frames,
                                    max_temporal_tokens, out_dtype)
    batched = features.ndim == 4
    b, t, s, c = features.shape if batched else (1, *features.shape)
    if not 1 <= t <= max_temporal_tokens:
        raise ValueError(
            f"t={t} outside [1, max_temporal_tokens={max_temporal_tokens}]")
    if not 1 <= b <= 65535:
        raise ValueError(f"{b} videos: the grid takes 1 to 65,535")
    if out_dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"out_dtype: bf16 or f32, got {out_dtype}")
    cuda_lib.require(features, "features", torch.bfloat16)
    counts, n = None, t
    if batched and num_valid_frames is not None:
        counts = num_valid_frames
        cuda_lib.require(counts, "num_valid_frames", torch.int32, (b,),
                         features.device)
    elif not batched and num_valid_frames is not None:
        n = int(num_valid_frames)
    # the divisor: the count itself (each video's own for device counts)
    denom = (int(n_denom) if n_denom is not None
             else -1 if counts is not None else n)
    lib = cuda_lib.library()
    runs = -(-s // lib.vlt_pool_rows_per_block())
    out = torch.empty((b, max_temporal_tokens + s, c), dtype=out_dtype,
                      device=features.device)
    partial = torch.empty((b, runs, t, c), dtype=torch.float32,
                          device=features.device)
    cuda_lib.launch(
        "spatio_temporal_pool", "vlt_spatio_temporal_pool", features.device,
        cuda_lib.ptr(features), cuda_lib.ptr(out), cuda_lib.ptr(partial),
        None if counts is None else cuda_lib.ptr(counts), b, t, s, c,
        max_temporal_tokens, n, denom, int(out_dtype == torch.bfloat16),
    )
    return out if batched else out[0]


def pool_shard_plain(features: torch.Tensor, n_mask, n_denom: int,
                     max_temporal_tokens: Optional[int] = None,
                     out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """One shard's pooling, plainly (the JAX _pool_kernel with n_mask
    and n_denom apart): (t, s, c) -> (max_temporal_tokens (t by
    default) + s, c): each frame's mean over s, 0 from frame n_mask on
    and in the padding rows; then the sum of the first n_mask frames
    over max(n_denom, 1), all in f32."""
    t, s, c = features.shape
    T = t if max_temporal_tokens is None else max_temporal_tokens
    x = features.float()
    n = t if n_mask is None else int(n_mask)
    mask = (torch.arange(t, device=x.device) < n).float()[:, None]
    temporal = x.mean(dim=1) * mask
    spatial = (x * mask[:, :, None]).sum(dim=0) / max(float(n_denom), 1.0)
    pad = temporal.new_zeros((T - t, c))
    return torch.cat([temporal, pad, spatial], dim=0).to(out_dtype)


# (s, c) multiples the JAX package's sharded form takes (its TPU blocks)
SHARD_BLOCK_S, SHARD_BLOCK_C = 64, 128


def spatio_temporal_pool_sharded(
    features: torch.Tensor,
    num_valid_frames,
    mesh,
    max_temporal_tokens: int = MAX_TEMPORAL_TOKENS,
    out_dtype: torch.dtype = torch.bfloat16,
) -> torch.Tensor:
    """Pooling with the frame axis sharded over the mesh's 'data' axis
    (JAX ops/pooling.py:216-274); same contract as
    :func:`spatio_temporal_pool` for (t, s, c) features, which every
    rank of the axis holds whole. Rank k of the axis pools its t / D
    frames [k t/D, (k+1) t/D), n_local = clip(n - k t/D, 0, t/D) of them
    valid, through kernel 2 (its plain version on the CPU) with the
    spatial sums divided by the global n; the spatial partials are added
    over the axis and the temporal rows gathered in frame order. The
    partials stay f32 across the sum and the result is rounded to
    out_dtype once (the JAX wrapper rounds each partial to out_dtype
    before its psum: a bf16 result differs from it by a few bf16 ulps).
    As in the JAX package, shapes the sharded form does not take (t !=
    max_temporal_tokens, t not divisible by the axis, s or c off the TPU
    blocks) pool unsharded (:func:`spatio_temporal_pool_fused`)."""
    axis = "data"
    t, s, c = features.shape
    n_sh = int(mesh.shape[axis])
    if (t != max_temporal_tokens or t % n_sh or s % SHARD_BLOCK_S
            or c % SHARD_BLOCK_C):
        return spatio_temporal_pool_fused(features, num_valid_frames,
                                          max_temporal_tokens, out_dtype)
    tl = t // n_sh
    k = mesh.coords[axis]
    n = t if num_valid_frames is None else int(num_valid_frames)
    n_local = min(max(n - k * tl, 0), tl)
    part = spatio_temporal_pool_fused(
        features[k * tl:(k + 1) * tl].contiguous(), n_local, tl,
        torch.float32, n_denom=n)
    temporal = mesh.gather(part[:tl].contiguous(), 0, axis)
    spatial = mesh.all_sum(part[tl:].contiguous(), axis)
    return torch.cat([temporal, spatial], dim=0).to(out_dtype)
