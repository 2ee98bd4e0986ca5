"""CLIP zero-shot crop filtering of detections.

Counterpart of video_llava_tpu/grounding/clip_filter.py (reference
__apply_clip_thresholding + mask_and_crop, grounding_evaluation/
grounding_new_api.py:111-230, :295): each detected box is cropped,
encoded by the CLIP ViT-B/32 vision tower, scored against prompt-ensembled
class text embeddings, and kept when the class probability is > 0.1 and
the raw similarity >= 0.2.

The crops of a batch of frames are cut and resized as two matmuls
(ops/image.crop_resize_bicubic_batch) and encoded in one tower forward
(kernel 1 on CUDA); the text tower runs once per class list (cached).
Everything runs on the vision tower's device; the decisions come back to
the host.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Sequence, Tuple

import numpy as np
import torch

from video_llava_tpu_torch.config import CLIPTextConfig
from video_llava_tpu_torch.models import clip as clip_mod
from video_llava_tpu_torch.models.layers import dense
from video_llava_tpu_torch.ops.image import (
    crop_resize_bicubic_batch,
    normalize_clip,
    resize_bicubic,
)

# A compact subset of the 80 ImageNet templates the reference ensembles.
DEFAULT_TEMPLATES = (
    "a photo of a {}.",
    "a photo of the {}.",
    "a bad photo of a {}.",
    "a cropped photo of a {}.",
    "a bright photo of a {}.",
    "a dark photo of a {}.",
    "a close-up photo of a {}.",
    "a photo of one {}.",
    "a blurry photo of a {}.",
    "a photo of a small {}.",
)


def _unit(x: torch.Tensor) -> torch.Tensor:
    return x / torch.linalg.norm(x, dim=-1, keepdim=True)


class ClipCropFilter:
    # GroundedTracker reads this for the whole-clip path's eligibility.
    supports_batch_device = True

    def __init__(
        self,
        vision_tower: clip_mod.CLIPVisionTower,
        text_params,
        text_cfg: CLIPTextConfig,
        tokenize: Callable[[str], List[int]],
        visual_projection,  # {'kernel': (hidden, proj)}
        prob_threshold: float = 0.1,
        score_threshold: float = 0.2,
        templates: Sequence[str] = DEFAULT_TEMPLATES,
    ):
        self.vision_tower = vision_tower
        self.vision_cfg = vision_tower.cfg
        self.text_params = text_params
        self.text_cfg = text_cfg
        self.tokenize = tokenize
        self.visual_projection = visual_projection
        self.prob_threshold = prob_threshold
        self.score_threshold = score_threshold
        self.templates = templates
        self.device = vision_tower.class_embedding.device
        self._text_cache: Dict[Tuple[str, ...], torch.Tensor] = {}

    def _embed(self, pixels: torch.Tensor) -> torch.Tensor:
        """Normalized pixels (n, s, s, 3) -> projected, L2-normalized
        image embeddings (n, proj)."""
        emb = dense(self.visual_projection,
                    clip_mod.vision_pooled_embedding(self.vision_tower,
                                                     pixels))
        return _unit(emb)

    @torch.inference_mode()
    def zeroshot_weights(self, classes: Sequence[str]) -> torch.Tensor:
        """(proj, n_classes) L2-normalized ensemble embeddings (reference
        zeroshot_classifier, grounding_new_api.py:120-140), cached per
        class list."""
        key = tuple(classes)
        if key in self._text_cache:
            return self._text_cache[key]
        maxlen = self.text_cfg.max_position_embeddings
        cols = []
        for cls in classes:
            toks = [self.tokenize(t.format(cls)) for t in self.templates]
            ids = np.zeros((len(toks), maxlen), np.int64)
            for i, t in enumerate(toks):
                t = t[:maxlen]
                ids[i, :len(t)] = t
            emb = clip_mod.text_forward(self.text_params,
                                        torch.from_numpy(ids), self.text_cfg)
            cols.append(_unit(_unit(emb).mean(dim=0)))
        w = torch.stack(cols, dim=1)
        self._text_cache[key] = w
        return w

    @torch.inference_mode()
    def embed_crops(self, image: np.ndarray,
                    boxes: np.ndarray) -> torch.Tensor:
        """The per-crop reference formulation: each box's pixels sliced on
        the host (the same clamp as the batched crop), resized, then all
        crops (padded to a power-of-two count) encoded -> (n, proj)."""
        size = self.vision_cfg.image_size
        h, w = image.shape[:2]
        crops = []
        for (x0, y0, x1, y1) in boxes.astype(int):
            x0, y0 = max(x0, 0), max(y0, 0)
            x1, y1 = min(max(x1, x0 + 1), w), min(max(y1, y0 + 1), h)
            crop = torch.from_numpy(
                np.ascontiguousarray(image[y0:y1, x0:x1], np.float32))
            crops.append(resize_bicubic(crop.to(self.device), size, size))
        n = len(crops)
        crops.extend([crops[-1]] * ((1 << (n - 1).bit_length()) - n))
        return self._embed(normalize_clip(torch.stack(crops)))[:n]

    @torch.inference_mode()
    def _scores(self, frames: torch.Tensor, boxes: torch.Tensor,
                text_w: torch.Tensor) -> torch.Tensor:
        """(c, H, W, 3) frames, (c, K, 4) boxes -> (c, K, n_classes)
        cosine scores: every crop cut and resized as matmuls, encoded in
        one tower forward."""
        size = self.vision_cfg.image_size
        crops = crop_resize_bicubic_batch(frames, boxes, size)
        c, k = crops.shape[:2]
        emb = self._embed(normalize_clip(crops).reshape(c * k, size, size,
                                                        crops.shape[-1]))
        return (emb @ text_w).reshape(c, k, -1)

    def __call__(self, image, boxes: np.ndarray, class_ids: np.ndarray,
                 classes: Sequence[str]) -> np.ndarray:
        """-> keep mask (n,) bool: the batched scorer on one frame, the
        box count padded to a power of two."""
        n = len(boxes)
        if n == 0:
            return np.zeros((0,), bool)
        bucket = 1 << (n - 1).bit_length()
        bx = np.zeros((bucket, 4), np.float32)
        bx[:n] = boxes
        valid = np.zeros((bucket,), bool)
        valid[:n] = True
        cid = np.zeros((bucket,), np.int64)
        cid[:n] = class_ids
        frame = (image[None] if isinstance(image, torch.Tensor)
                 else np.asarray(image)[None])
        keep = self.filter_frames_device(frame, bx[None], valid[None],
                                         cid[None], classes, chunk=1)
        return np.asarray(keep[0, :n], bool)

    def _decide(self, scores: np.ndarray, class_ids: np.ndarray,
                n_classes: int) -> np.ndarray:
        """scores (..., n_classes) cosine -> keep (...,) bool: the class's
        probability (softmax of 100 x scores) > prob_threshold and its
        raw score >= score_threshold (grounding_new_api.py:430-443)."""
        probs = torch.softmax(100.0 * torch.from_numpy(
            np.asarray(scores, np.float32)), dim=-1).numpy()
        cls = np.clip(np.asarray(class_ids), 0, n_classes - 1)
        sel = np.take_along_axis(scores, cls[..., None], axis=-1)[..., 0]
        psel = np.take_along_axis(probs, cls[..., None], axis=-1)[..., 0]
        return (psel > self.prob_threshold) & (sel >= self.score_threshold)

    def score_frames_device(self, frames, boxes, classes: Sequence[str],
                            chunk: int = 4) -> np.ndarray:
        """(F, H, W, 3) uint8 frames (numpy or a tensor, moved to the
        tower's device once), (F, K, 4) boxes -> (F, K, n_classes) cosine
        scores, in chunks of `chunk` frames (the last padded by
        repeating its last frame)."""
        w = self.zeroshot_weights(classes)
        frames = (frames if isinstance(frames, torch.Tensor)
                  else torch.from_numpy(np.ascontiguousarray(frames)))
        frames = frames.to(self.device)
        boxes = torch.as_tensor(np.asarray(boxes, np.float32),
                                device=self.device)
        outs = []
        for s in range(0, len(frames), chunk):
            fc, bc = frames[s:s + chunk], boxes[s:s + chunk]
            n = len(fc)
            if n < chunk:
                fc = torch.cat([fc, fc[-1:].expand((chunk - n,)
                                                   + fc.shape[1:])])
                bc = torch.cat([bc, bc[-1:].expand((chunk - n,)
                                                   + bc.shape[1:])])
            outs.append(self._scores(fc, bc, w)[:n])
        return torch.cat(outs).cpu().numpy()

    def filter_frames_device(self, frames, boxes, valid, class_ids,
                             classes: Sequence[str],
                             chunk: int = 4) -> np.ndarray:
        """The batched twin of __call__ over a clip's detection frames ->
        keep (F, K) bool, False wherever `valid` is."""
        valid = np.asarray(valid, bool)
        if not valid.any():
            return np.zeros_like(valid)
        scores = self.score_frames_device(frames, boxes, classes,
                                          chunk=chunk)
        return self._decide(scores, class_ids, len(classes)) & valid
