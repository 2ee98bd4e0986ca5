"""Multi-scale deformable attention (Deformable DETR / GroundingDINO).

Counterpart of video_llava_tpu/ops/deformable.py and its two Pallas
kernels (ops/deformable_pallas.py). Per (query, head, level, point): a
zero-padded bilinear sample of that level's value map (torch grid_sample
with align_corners=False), times the attention weight, summed over
levels and points in f32.

:func:`multi_scale_deformable_attention` launches csrc/deformable_
attention.cu on CUDA tensors and runs :func:`msda_plain` on CPU tensors.
The plain version is the JAX package's XLA twin (four gathers per level)
with the Pallas kernels' rule for non-finite sampling coordinates: such
a sample contributes exactly zero.
"""

from __future__ import annotations

import ctypes
from typing import Sequence, Tuple

import torch

from video_llava_tpu_torch.ops import cuda_lib

# 'auto' and 'pallas' (the JAX package's kernel) both launch the CUDA
# kernel on CUDA tensors; 'xla' names the JAX package's gather twin, whose
# counterpart here is the plain version: it runs on the tensor's device,
# CUDA included, and launches nothing.
_DEFAULT_IMPL = "auto"
# set_tile2d(True) sends encoder shapes (q == sum_hw) to the JAX package's
# 2D-tiled kernel; it computes the same function, and here both settings
# launch the one CUDA kernel.
_TILE2D = False


def set_default_impl(impl: str) -> None:
    global _DEFAULT_IMPL
    if impl not in ("auto", "xla", "pallas"):
        raise ValueError(f"unknown deformable attention impl {impl!r}")
    _DEFAULT_IMPL = impl


def set_tile2d(enabled: bool) -> None:
    global _TILE2D
    _TILE2D = bool(enabled)


def _bilinear_sample_level(value: torch.Tensor, loc: torch.Tensor):
    """value (b, h, w, heads, d), loc (b, q, heads, points, 2) in [0, 1]
    (x, y) -> (b, q, heads, points, d) f32, zero padded."""
    b, h, w, nh, d = value.shape
    x = loc[..., 0] * w - 0.5
    y = loc[..., 1] * h - 0.5
    # a non-finite coordinate moves its sample off the map (zero), as the
    # Pallas kernel's -10 sentinel does; far-off finite ones are clamped
    # off the map so the integer corners cannot overflow
    finite = torch.isfinite(x) & torch.isfinite(y)
    x = torch.where(finite, x, -10.0).clamp(-2.0, w + 1.0)
    y = torch.where(finite, y, -10.0).clamp(-2.0, h + 1.0)
    x0, y0 = torch.floor(x), torch.floor(y)
    dx, dy = (x - x0)[..., None], (y - y0)[..., None]
    x0i, y0i = x0.long(), y0.long()
    flat = value.reshape(b, h * w, nh, d).permute(0, 2, 1, 3)  # (b,nh,hw,d)
    q, p = loc.shape[1], loc.shape[3]

    def gather(yi, xi):
        inside = (yi >= 0) & (yi < h) & (xi >= 0) & (xi < w)
        idx = yi.clamp(0, h - 1) * w + xi.clamp(0, w - 1)  # (b, q, nh, p)
        idx = idx.permute(0, 2, 1, 3).reshape(b, nh, q * p, 1)
        out = torch.gather(flat, 2, idx.expand(b, nh, q * p, d))
        out = out.reshape(b, nh, q, p, d).permute(0, 2, 1, 3, 4).float()
        return out * inside[..., None]

    v00 = gather(y0i, x0i)
    v01 = gather(y0i, x0i + 1)
    v10 = gather(y0i + 1, x0i)
    v11 = gather(y0i + 1, x0i + 1)
    top = v00 * (1 - dx) + v01 * dx
    bot = v10 * (1 - dx) + v11 * dx
    return top * (1 - dy) + bot * dy


def msda_plain(value: torch.Tensor, spatial_shapes: Sequence[Tuple[int, int]],
               sampling_locations: torch.Tensor,
               attention_weights: torch.Tensor) -> torch.Tensor:
    """The plain version: value (b, sum_hw, heads, d), locations (b, q,
    heads, levels, points, 2), weights (b, q, heads, levels, points) ->
    (b, q, heads * d) in value's dtype."""
    b, _, nh, d = value.shape
    q = sampling_locations.shape[1]
    locs = sampling_locations.float()
    weights = attention_weights.float()
    out = torch.zeros((b, q, nh, d), dtype=torch.float32, device=value.device)
    offset = 0
    for lvl, (h, w) in enumerate(spatial_shapes):
        v = value[:, offset:offset + h * w].reshape(b, h, w, nh, d)
        sampled = _bilinear_sample_level(v, locs[:, :, :, lvl])
        out = out + (sampled * weights[:, :, :, lvl, :, None]).sum(dim=3)
        offset += h * w
    return out.reshape(b, q, nh * d).to(value.dtype)


def msda_kernel(value: torch.Tensor, spatial_shapes: Sequence[Tuple[int, int]],
                sampling_locations: torch.Tensor,
                attention_weights: torch.Tensor) -> torch.Tensor:
    """csrc/deformable_attention.cu on CUDA tensors (see msda_plain for
    shapes). Locations and weights are read in f32."""
    b, sum_hw, nh, hd = value.shape
    q, n_levels, n_points = (sampling_locations.shape[1],
                             sampling_locations.shape[3],
                             sampling_locations.shape[4])
    shapes = [(int(h), int(w)) for h, w in spatial_shapes]
    if value.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"value: expected float32 or bfloat16, got "
                        f"{value.dtype}")
    if (len(shapes) != n_levels or not 1 <= n_levels <= 5
            or n_levels * n_points > 32 or hd > 128
            or sum(h * w for h, w in shapes) != sum_hw):
        raise ValueError(
            f"deformable attention kernel: unsupported shapes value "
            f"{tuple(value.shape)}, levels {shapes}, points {n_points}")
    value = value.contiguous()
    locs = sampling_locations.float().contiguous()
    weights = attention_weights.float().contiguous()
    cuda_lib.require(value, "value", value.dtype)
    dev = value.device
    cuda_lib.require(locs, "sampling_locations", torch.float32,
                     (b, q, nh, n_levels, n_points, 2), dev)
    cuda_lib.require(weights, "attention_weights", torch.float32,
                     (b, q, nh, n_levels, n_points), dev)
    out = torch.empty((b, q, nh * hd), dtype=value.dtype, device=dev)
    host_shapes = (ctypes.c_int * (2 * n_levels))(
        *[v for hw in shapes for v in hw])
    cuda_lib.launch(
        "multi_scale_deformable_attention", "vlt_msda", dev,
        cuda_lib.ptr(value), cuda_lib.ptr(locs), cuda_lib.ptr(weights),
        cuda_lib.ptr(out), b, sum_hw, q, nh, hd, n_levels, n_points,
        ctypes.cast(host_shapes, ctypes.c_void_p),
        int(value.dtype == torch.bfloat16))
    return out


def multi_scale_deformable_attention(
    value: torch.Tensor,  # (b, sum_hw, heads, d)
    spatial_shapes: Sequence[Tuple[int, int]],  # [(h, w), ...]
    sampling_locations: torch.Tensor,  # (b, q, heads, levels, points, 2)
    attention_weights: torch.Tensor,  # (b, q, heads, levels, points)
) -> torch.Tensor:
    """-> (b, q, heads * d): the kernel on CUDA tensors (also with
    set_tile2d(True): one kernel serves both TPU kernels), the plain
    version on CPU tensors and, under set_default_impl('xla'), on CUDA
    tensors too (the JAX package's 'xla' runs its twin on the
    accelerator)."""
    if value.device.type == "cpu" or _DEFAULT_IMPL == "xla":
        return msda_plain(value, spatial_shapes, sampling_locations,
                          attention_weights)
    return msda_kernel(value, spatial_shapes, sampling_locations,
                       attention_weights)
