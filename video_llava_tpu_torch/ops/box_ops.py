"""Box math and NMS.

Counterpart of video_llava_tpu/ops/box_ops.py (reference
grounding_evaluation/util/box_ops.py and the torchvision NMS the tracker
uses). NMS is the sorted-suppression loop over an (n, n) IoU matrix and
returns a keep mask, as in the JAX package.
"""

from __future__ import annotations

from typing import Optional

import torch


def box_cxcywh_to_xyxy(b: torch.Tensor) -> torch.Tensor:
    cx, cy, w, h = b.unbind(-1)
    return torch.stack([cx - 0.5 * w, cy - 0.5 * h, cx + 0.5 * w,
                        cy + 0.5 * h], dim=-1)


def box_xyxy_to_cxcywh(b: torch.Tensor) -> torch.Tensor:
    x0, y0, x1, y1 = b.unbind(-1)
    return torch.stack([(x0 + x1) / 2, (y0 + y1) / 2, x1 - x0, y1 - y0],
                       dim=-1)


def box_area(b: torch.Tensor) -> torch.Tensor:
    return ((b[..., 2] - b[..., 0]).clamp(min=0)
            * (b[..., 3] - b[..., 1]).clamp(min=0))


def box_iou(a: torch.Tensor, b: torch.Tensor):
    """a (n, 4), b (m, 4) xyxy -> (iou (n, m), union (n, m))."""
    area_a, area_b = box_area(a), box_area(b)
    lt = torch.maximum(a[:, None, :2], b[None, :, :2])
    rb = torch.minimum(a[:, None, 2:], b[None, :, 2:])
    wh = (rb - lt).clamp(min=0)
    inter = wh[..., 0] * wh[..., 1]
    union = area_a[:, None] + area_b[None, :] - inter
    return inter / union.clamp(min=1e-9), union


def generalized_box_iou(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    iou, union = box_iou(a, b)
    lt = torch.minimum(a[:, None, :2], b[None, :, :2])
    rb = torch.maximum(a[:, None, 2:], b[None, :, 2:])
    wh = (rb - lt).clamp(min=0)
    hull = wh[..., 0] * wh[..., 1]
    return iou - (hull - union) / hull.clamp(min=1e-9)


def masks_to_boxes(masks: torch.Tensor) -> torch.Tensor:
    """(..., n, h, w) masks -> (..., n, 4) xyxy f32 of the pixels > 0;
    an empty mask gives zeros (torchvision semantics)."""
    m = masks > 0
    rows, cols = m.any(dim=-1), m.any(dim=-2)  # (..., h), (..., w)
    h, w = m.shape[-2], m.shape[-1]
    ys = torch.arange(h, device=m.device)
    xs = torch.arange(w, device=m.device)
    big = 10 ** 9
    x0 = torch.where(cols, xs, big).amin(-1)
    x1 = torch.where(cols, xs, -1).amax(-1)
    y0 = torch.where(rows, ys, big).amin(-1)
    y1 = torch.where(rows, ys, -1).amax(-1)
    boxes = torch.stack([x0, y0, x1, y1], dim=-1).float()
    return torch.where(rows.any(-1)[..., None], boxes, 0.0)


def nms(boxes: torch.Tensor, scores: torch.Tensor, iou_threshold: float = 0.5,
        max_outputs: Optional[int] = None) -> torch.Tensor:
    """Greedy NMS over the last two axes: boxes (..., n, 4) xyxy, scores
    (..., n) -> keep mask (..., n). Padded boxes take score -inf. Leading
    axes batch independent problems (the tracker's frames)."""
    n = boxes.shape[-2]
    order = torch.argsort(-scores, dim=-1, stable=True)
    b_sorted = torch.gather(boxes, -2, order[..., None].expand(boxes.shape))
    flat = b_sorted.reshape(-1, n, 4)
    iou = torch.stack([box_iou(x, x)[0] for x in flat]).reshape(
        boxes.shape[:-2] + (n, n))
    keep = torch.gather(scores, -1, order) > float("-inf")
    later = torch.arange(n, device=boxes.device)
    for i in range(n):
        suppress = (iou[..., i, :] > iou_threshold) & keep[..., i:i + 1] & (
            later > i)
        keep = keep & ~suppress
    out = torch.zeros_like(keep).scatter(-1, order, keep)
    if max_outputs is not None and max_outputs < n:
        masked = torch.where(out, scores, float("-inf"))
        rank = torch.argsort(torch.argsort(-masked, dim=-1, stable=True),
                             dim=-1, stable=True)
        out = out & (rank < max_outputs)
    return out


def batched_nms(boxes: torch.Tensor, scores: torch.Tensor,
                class_ids: torch.Tensor, iou_threshold: float = 0.5):
    """Class-aware NMS: boxes offset per class never overlap."""
    offset = class_ids.float()[:, None] * (boxes.max() + 1.0)
    return nms(boxes + offset, scores, iou_threshold)
