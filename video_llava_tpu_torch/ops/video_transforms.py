"""Clip-level video transform zoo (full reference parity).

Counterpart of video_llava_tpu/ops/video_transforms.py, a copy of its
numpy code (the port imports nothing of the JAX package). Parity:
reference grounding_evaluation/util/image_transforms.py
(torch_videovision/MDETR lineage), the complete op set:
  * aspect-preserving resize with max_size cap (image_transforms.py:
    291-312 get_size_with_aspect_ratio), box/area/mask target scaling
    (:340-378);
  * crop with degenerate-box dropping and field filtering (:391-438);
  * RandomSizeCrop with respect_boxes patience loop (:441-487);
  * RandomHorizontalFlip (:225-272), RandomResize (:380-389),
    RandomSelect (:274-289), Compose (:177-193), normalize (:195-223);
  * `make_video_transforms` with the full 128..800 resolution table
    (:489-604) and `prepare` annotation conversion (:605-625).

Differences by design: clips stay channels-last (t, h, w, c) numpy
arrays (the models' frames are NHWC); randomness flows through an
explicit np.random.Generator instead of the global `random` module; bilinear resampling uses half-pixel centers with edge clamp
(cv2.INTER_LINEAR semantics, the reference's resize_clip default).

Targets are per-frame dicts: {"boxes": (n,4) xyxy float, optional
"masks": (n,h,w) bool, "area": (n,), "labels": (n,), ...}, mirroring
the reference's per-frame target list.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from video_llava_tpu_torch.ops.image import CLIP_IMAGE_MEAN, CLIP_IMAGE_STD

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)

Targets = Optional[List[Dict[str, np.ndarray]]]


# -- primitives ---------------------------------------------------------------


def _bilinear_resize(clip: np.ndarray, H: int, W: int) -> np.ndarray:
    """(t, h, w, c) -> (t, H, W, c), half-pixel centers, edge clamp."""
    t, h, w, c = clip.shape
    ys = (np.arange(H) + 0.5) * h / H - 0.5
    xs = (np.arange(W) + 0.5) * w / W - 0.5
    y0 = np.clip(np.floor(ys).astype(int), 0, h - 1)
    x0 = np.clip(np.floor(xs).astype(int), 0, w - 1)
    y1 = np.clip(y0 + 1, 0, h - 1)
    x1 = np.clip(x0 + 1, 0, w - 1)
    wy = np.clip(ys - y0, 0.0, 1.0).astype(np.float32)[None, :, None, None]
    wx = np.clip(xs - x0, 0.0, 1.0).astype(np.float32)[None, None, :, None]
    f = clip.astype(np.float32)
    top = f[:, y0][:, :, x0] * (1 - wx) + f[:, y0][:, :, x1] * wx
    bot = f[:, y1][:, :, x0] * (1 - wx) + f[:, y1][:, :, x1] * wx
    out = top * (1 - wy) + bot * wy
    if np.issubdtype(clip.dtype, np.integer):
        return np.clip(np.round(out), 0, 255).astype(clip.dtype)
    return out.astype(clip.dtype)


def resize_clip(clip: np.ndarray, size: Tuple[int, int],
                interpolation: str = "bilinear") -> np.ndarray:
    """Resize (t, h, w, c) to size=(H, W)."""
    t, h, w, c = clip.shape
    H, W = size
    if (h, w) == (H, W):
        return clip
    if interpolation == "nearest":
        rows = (np.arange(H) * h // H).clip(0, h - 1)
        cols = (np.arange(W) * w // W).clip(0, w - 1)
        return clip[:, rows][:, :, cols]
    return _bilinear_resize(clip, H, W)


def resize_boxes(boxes: np.ndarray, from_hw, to_hw) -> np.ndarray:
    fy, fx = to_hw[0] / from_hw[0], to_hw[1] / from_hw[1]
    return boxes * np.array([fx, fy, fx, fy], boxes.dtype)


def center_crop_clip(clip: np.ndarray, size: Tuple[int, int]):
    t, h, w, c = clip.shape
    H, W = size
    top, left = (h - H) // 2, (w - W) // 2
    return clip[:, top : top + H, left : left + W], (top, left)


def random_crop_clip(clip: np.ndarray, size: Tuple[int, int],
                     rng: np.random.Generator):
    t, h, w, c = clip.shape
    H, W = size
    top = int(rng.integers(0, h - H + 1))
    left = int(rng.integers(0, w - W + 1))
    return clip[:, top : top + H, left : left + W], (top, left)


def crop_boxes(boxes: np.ndarray, top: int, left: int,
               size: Tuple[int, int]) -> np.ndarray:
    H, W = size
    out = boxes - np.array([left, top, left, top], boxes.dtype)
    out[..., 0::2] = out[..., 0::2].clip(0, W)
    out[..., 1::2] = out[..., 1::2].clip(0, H)
    return out


def hflip_clip(clip: np.ndarray) -> np.ndarray:
    return clip[:, :, ::-1]


def hflip_boxes(boxes: np.ndarray, width: int) -> np.ndarray:
    """xyxy boxes under horizontal flip (image_transforms.py flip path)."""
    out = boxes.copy()
    out[..., 0] = width - boxes[..., 2]
    out[..., 2] = width - boxes[..., 0]
    return out


def normalize_clip_np(clip: np.ndarray,
                      mean=CLIP_IMAGE_MEAN, std=CLIP_IMAGE_STD) -> np.ndarray:
    x = clip.astype(np.float32) / 255.0
    return (x - np.asarray(mean, np.float32)) / np.asarray(std, np.float32)


# -- target-aware functional ops (reference resize/crop/hflip) ----------------


def get_size_with_aspect_ratio(
    hw: Tuple[int, int], size: int, max_size: Optional[int] = None
) -> Tuple[int, int]:
    """Shortest-side-to-`size` output (H, W), capped so the longest side
    stays <= max_size (image_transforms.py:294-312)."""
    h, w = hw
    if max_size is not None:
        mn, mx = float(min(w, h)), float(max(w, h))
        if mx / mn * size > max_size:
            size = int(round(max_size * mn / mx))
    if (w <= h and w == size) or (h <= w and h == size):
        return (h, w)
    if w < h:
        return (int(size * h / w), size)
    return (size, int(size * w / h))


def resize(clip: np.ndarray, targets: Targets, size,
           max_size: Optional[int] = None):
    """Reference resize() (:291-378): `size` is a shortest-side scalar
    or an explicit (H, W); boxes/area scale, masks nearest-resize."""
    h, w = clip.shape[1:3]
    if isinstance(size, (list, tuple)):
        new_hw = tuple(size)
    else:
        new_hw = get_size_with_aspect_ratio((h, w), size, max_size)
    out = resize_clip(clip, new_hw)
    if targets is None:
        return out, None
    ry, rx = new_hw[0] / h, new_hw[1] / w
    new_targets = []
    for tgt in targets:
        tgt = dict(tgt)
        if "boxes" in tgt:
            tgt["boxes"] = tgt["boxes"] * np.array([rx, ry, rx, ry],
                                                   np.float32)
        if "area" in tgt:
            tgt["area"] = tgt["area"] * (rx * ry)
        if "masks" in tgt:
            m = tgt["masks"]
            rows = (np.arange(new_hw[0]) * m.shape[1] // new_hw[0]).clip(
                0, m.shape[1] - 1
            )
            cols = (np.arange(new_hw[1]) * m.shape[2] // new_hw[1]).clip(
                0, m.shape[2] - 1
            )
            tgt["masks"] = m[:, rows][:, :, cols]
        tgt["size"] = np.asarray(new_hw)
        new_targets.append(tgt)
    return out, new_targets


_FILTER_FIELDS = ("labels", "area", "iscrowd", "positive_map", "isfinal",
                  "boxes", "masks")


def crop(clip: np.ndarray, targets: Targets, region):
    """Reference crop() (:391-438): region=(top, left, h, w); boxes
    translate+clamp, degenerate boxes (and their fields) drop per
    frame."""
    top, left, h, w = region
    out = clip[:, top : top + h, left : left + w]
    if targets is None:
        return out, None
    new_targets = []
    for tgt in targets:
        tgt = dict(tgt)
        tgt["size"] = np.asarray([h, w])
        keep = None
        if "boxes" in tgt:
            boxes = tgt["boxes"] - np.array([left, top, left, top],
                                            np.float32)
            boxes = boxes.reshape(-1, 2, 2)
            boxes = np.minimum(boxes, np.array([w, h], np.float32))
            boxes = boxes.clip(min=0)
            tgt["area"] = (boxes[:, 1] - boxes[:, 0]).prod(axis=1)
            tgt["boxes"] = boxes.reshape(-1, 4)
            keep = np.all(boxes[:, 1] > boxes[:, 0], axis=1)
        if "masks" in tgt:
            tgt["masks"] = tgt["masks"][:, top : top + h, left : left + w]
            if keep is None:
                keep = tgt["masks"].reshape(tgt["masks"].shape[0], -1).any(1)
        if keep is not None:
            for f in _FILTER_FIELDS:
                if f in tgt:
                    tgt[f] = tgt[f][keep]
        new_targets.append(tgt)
    return out, new_targets


def hflip(clip: np.ndarray, targets: Targets):
    """Reference hflip (:235-272)."""
    out = hflip_clip(clip)
    if targets is None:
        return np.ascontiguousarray(out), None
    w = clip.shape[2]
    new_targets = []
    for tgt in targets:
        tgt = dict(tgt)
        if "boxes" in tgt:
            tgt["boxes"] = hflip_boxes(tgt["boxes"], w)
        if "masks" in tgt:
            tgt["masks"] = tgt["masks"][:, :, ::-1]
        new_targets.append(tgt)
    return np.ascontiguousarray(out), new_targets


# -- composable transform objects ---------------------------------------------


class Compose:
    def __init__(self, transforms: Sequence[Callable]):
        self.transforms = list(transforms)

    def __call__(self, clip, targets=None):
        for t in self.transforms:
            clip, targets = t(clip, targets)
        return clip, targets


class ToTensorNormalize:
    """uint8 clip -> float32 normalized (imagenet stats, the reference's
    ToTensor+Normalize pair, :496-498). Stays (t, h, w, c) NHWC."""

    def __init__(self, mean=IMAGENET_MEAN, std=IMAGENET_STD):
        self.mean, self.std = mean, std

    def __call__(self, clip, targets=None):
        return normalize_clip_np(np.ascontiguousarray(clip), self.mean,
                                 self.std), targets


class RandomHorizontalFlip:
    def __init__(self, p: float = 0.5, rng: Optional[np.random.Generator] = None):
        self.p = p
        self.rng = rng or np.random.default_rng()

    def __call__(self, clip, targets=None):
        if self.rng.random() < self.p:
            return hflip(clip, targets)
        return clip, targets


class RandomResize:
    def __init__(self, sizes: Sequence[int], max_size: Optional[int] = None,
                 rng: Optional[np.random.Generator] = None):
        self.sizes = list(sizes)
        self.max_size = max_size
        self.rng = rng or np.random.default_rng()

    def __call__(self, clip, targets=None):
        size = self.sizes[int(self.rng.integers(0, len(self.sizes)))]
        return resize(clip, targets, size, self.max_size)


class RandomSelect:
    """transforms1 with probability p, else transforms2 (:274-289)."""

    def __init__(self, transforms1, transforms2, p: float = 0.5,
                 rng: Optional[np.random.Generator] = None):
        self.transforms1, self.transforms2, self.p = transforms1, transforms2, p
        self.rng = rng or np.random.default_rng()

    def __call__(self, clip, targets=None):
        if self.rng.random() < self.p:
            return self.transforms1(clip, targets)
        return self.transforms2(clip, targets)


class RandomSizeCrop:
    """Random crop size in [min_size, max_size]; with respect_boxes,
    retry up to 100 times until no box disappears, else return the
    uncropped input (:441-487)."""

    def __init__(self, min_size: int, max_size: int,
                 respect_boxes: bool = False,
                 rng: Optional[np.random.Generator] = None):
        self.min_size, self.max_size = min_size, max_size
        self.respect_boxes = respect_boxes
        self.rng = rng or np.random.default_rng()

    def __call__(self, clip, targets=None):
        h, w = clip.shape[1:3]
        init_boxes = (
            sum(len(t.get("boxes", ())) for t in targets)
            if targets is not None else 0
        )
        result = (clip, targets)
        for _ in range(100):
            tw = int(self.rng.integers(self.min_size,
                                       min(w, self.max_size) + 1))
            th = int(self.rng.integers(self.min_size,
                                       min(h, self.max_size) + 1))
            th, tw = min(th, h), min(tw, w)
            top = int(self.rng.integers(0, h - th + 1))
            left = int(self.rng.integers(0, w - tw + 1))
            result = crop(clip, targets, (top, left, th, tw))
            if not self.respect_boxes or result[1] is None:
                return result
            if sum(len(t.get("boxes", ())) for t in result[1]) == init_boxes:
                return result
        if self.respect_boxes:
            return clip, targets  # avoid disappearing boxes (:485-486)
        return result


# -- factory (reference resolution table, :489-604) ---------------------------

_RESOLUTION_TABLE = {
    128: ([96, 128], 213, [80, 100, 120], 64, [128]),
    224: ([128, 160, 192, 224], 373, [100, 150, 200], 96, [224]),
    256: ([160, 192, 224, 256], 427, [140, 180, 220], 128, [256]),
    288: ([160, 192, 224, 256, 288], 480, [150, 200, 250], 128, [288]),
    320: ([192, 224, 256, 288, 320], 533, [200, 240, 280], 160, [320]),
    336: ([224, 256, 288, 320, 352, 336], 640, [200, 250, 300], 192, [384]),
    352: ([224, 256, 288, 320, 352], 587, [200, 250, 300], 192, [352]),
    384: ([224, 256, 288, 320, 352, 384], 640, [200, 250, 300], 192, [384]),
    416: ([256, 288, 320, 352, 384, 416], 693, [240, 300, 360], 224, [416]),
    448: ([256, 288, 320, 352, 384, 416, 448], 746, [240, 300, 360], 224,
          [448]),
    480: ([288, 320, 352, 384, 416, 448, 480], 800, [240, 300, 360], 240,
          [480]),
    800: ([480, 512, 544, 576, 608, 640, 672, 704, 736, 768, 800], 1333,
          [400, 500, 600], 384, [800]),
}


def make_video_transforms(image_set: str, cautious: bool = True,
                          resolution: int = 224,
                          seed: Optional[int] = None) -> Compose:
    """Reference factory (:489-604): train = optional hflip + RandomSelect
    of (multi-scale resize) vs (resize -> RandomSizeCrop -> resize);
    val/test = deterministic shortest-side resize. `cautious` disables
    the flip and makes the crop box-preserving, exactly as upstream."""
    if resolution not in _RESOLUTION_TABLE:
        raise NotImplementedError(f"resolution {resolution}")
    scales, max_size, resizes, crop_sz, test_size = _RESOLUTION_TABLE[
        resolution
    ]
    rng = np.random.default_rng(seed)
    normalizeop = ToTensorNormalize()
    if image_set == "train":
        horizontal = [] if cautious else [RandomHorizontalFlip(rng=rng)]
        return Compose(
            horizontal
            + [
                RandomSelect(
                    RandomResize(scales, max_size=max_size, rng=rng),
                    Compose(
                        [
                            RandomResize(resizes, rng=rng),
                            RandomSizeCrop(crop_sz, max_size,
                                           respect_boxes=cautious, rng=rng),
                            RandomResize(scales, max_size=max_size, rng=rng),
                        ]
                    ),
                    rng=rng,
                ),
                normalizeop,
            ]
        )
    if image_set in ("val", "test"):
        return Compose(
            [
                RandomResize(test_size, max_size=max_size, rng=rng),
                normalizeop,
            ]
        )
    raise ValueError(f"unknown image_set {image_set!r}")


def prepare(w: int, h: int, anno: Sequence[dict]) -> Dict[str, np.ndarray]:
    """Annotation dicts (COCO-style xywh 'bbox') -> target dict with
    xyxy clamped boxes, degenerate boxes dropped (:605-625)."""
    boxes = np.asarray([obj["bbox"] for obj in anno], np.float32).reshape(
        -1, 4
    )
    boxes[:, 2:] += boxes[:, :2]
    boxes[:, 0::2] = boxes[:, 0::2].clip(0, w)
    boxes[:, 1::2] = boxes[:, 1::2].clip(0, h)
    keep = (boxes[:, 3] > boxes[:, 1]) & (boxes[:, 2] > boxes[:, 0])
    return {
        "boxes": boxes[keep],
        "orig_size": np.asarray([int(h), int(w)]),
        "size": np.asarray([int(h), int(w)]),
    }


# -- simple square-output pipeline (kept for feature-extraction-style
#    augmentation; NOT the reference factory) ---------------------------------


@dataclasses.dataclass
class VideoTransform:
    """Shortest-side resize -> (random|center) square crop -> CLIP
    normalize, with box tracking. A compact training-augmentation
    pipeline for fixed-size model inputs; the reference-parity zoo above
    is what the grounding benchmarks define."""

    train: bool = False
    resolution: int = 224
    hflip_prob: float = 0.5
    seed: int = 0

    def __post_init__(self):
        self._rng = np.random.default_rng(self.seed)

    def __call__(self, clip: np.ndarray,
                 boxes: Optional[np.ndarray] = None):
        t, h, w, c = clip.shape
        scale = self.resolution / min(h, w)
        new_hw = (max(int(round(h * scale)), self.resolution),
                  max(int(round(w * scale)), self.resolution))
        out = resize_clip(clip, new_hw, interpolation="nearest")
        if boxes is not None:
            boxes = resize_boxes(boxes, (h, w), new_hw)
        size = (self.resolution, self.resolution)
        if self.train:
            if self._rng.random() < self.hflip_prob:
                out = hflip_clip(out)
                if boxes is not None:
                    boxes = hflip_boxes(boxes, out.shape[2])
            out, (top, left) = random_crop_clip(out, size, self._rng)
        else:
            out, (top, left) = center_crop_clip(out, size)
        if boxes is not None:
            boxes = crop_boxes(boxes, top, left, size)
        return normalize_clip_np(np.ascontiguousarray(out)), boxes
