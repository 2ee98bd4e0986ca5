"""Assembly of the grounding stack: detector, MobileSAM, tagger, STM
tracker and entity matching.

Counterpart of video_llava_tpu/grounding/builders.py with random weights
(checkpoint loading is not ported yet): every model draws its parameters
on `device` from a seeded torch.Generator, in the JAX package's layout.
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from video_llava_tpu_torch.grounding.entity_matching import (
    EntityMatchingModule,
)
from video_llava_tpu_torch.grounding.memory_tracker import TrackerConfig
from video_llava_tpu_torch.grounding.tagging import (
    TaggingModule,
    init_tag_head,
)
from video_llava_tpu_torch.grounding.tracker import GroundedTracker
from video_llava_tpu_torch.models import sam as sam_mod
from video_llava_tpu_torch.models import swin as swin_mod
from video_llava_tpu_torch.models import tiny_vit as tv
from video_llava_tpu_torch.models.layers import TreeInit
from video_llava_tpu_torch.models.sam import SamConfig
from video_llava_tpu_torch.models.swin import SwinConfig
from video_llava_tpu_torch.ops.image import normalize_clip, resize_bicubic

DEFAULT_TAG_LIST = [
    "person", "man", "woman", "child", "dog", "cat", "car", "bicycle",
    "tree", "building", "table", "chair", "food", "water", "road",
    "grass", "sky", "ball", "phone", "guitar",
]


class SamSegmenter:
    """segmenter(image, boxes) -> (n, H, W) masks, best of the three
    multimask outputs by predicted IoU. The image encoder and the prompt
    + mask decoder run apart, so detection frames encode in batches
    (precompute_embeddings) and per-frame calls only decode."""

    supports_frame_cache = True

    def __init__(self, params, cfg: SamConfig, encode_fn,
                 encode_batch_size: int = 4):
        """encode_fn(params, pixels) -> (b, g, g, d) image embeddings
        (MobileSAM's TinyViT encoder)."""
        self.params = params
        self.cfg = cfg
        self.encode_batch_size = encode_batch_size
        self._encode = encode_fn
        self.device = params["shared_pe"].device
        self._emb_cache: dict = {}

    def _encode_raw(self, raw: torch.Tensor) -> torch.Tensor:
        """(k, H, W, 3) uint8 -> embeddings: cast, bicubic resize, round,
        normalize and encode on the device."""
        size = self.cfg.vision.image_size
        x = resize_bicubic(raw.to(self.device).float(), size, size)
        x = normalize_clip(torch.clamp(torch.round(x), 0, 255)).to(
            self.params["shared_pe"].dtype)
        return self._encode(self.params, x)

    @torch.inference_mode()
    def precompute_embeddings(self, frames, frame_indices,
                              batch_size: Optional[int] = None) -> None:
        """Encode frames[i] for i in frame_indices in fixed-size batches
        (the last pads by repetition) into the per-frame cache."""
        k = batch_size or self.encode_batch_size
        idx = [i for i in frame_indices if i not in self._emb_cache]
        for start in range(0, len(idx), k):
            chunk = idx[start:start + k]
            padded = chunk + [chunk[-1]] * (k - len(chunk))
            raw = torch.as_tensor(np.stack([np.asarray(frames[i])
                                            for i in padded]))
            emb = self._encode_raw(raw)
            for j, i in enumerate(chunk):
                self._emb_cache[i] = emb[j:j + 1]

    @torch.inference_mode()
    def decode_masks_batch_device(self, frames, boxes: np.ndarray,
                                  out_hw: Optional[Tuple[int, int]] = None):
        """Batched box -> mask decode that stays on the device (the
        whole-clip tracker's producer). frames (F, H, W, 3) uint8 (numpy
        or a tensor), boxes (F, K, 4) xyxy pixels -> (F, K, Hp, Wp) uint8
        {0, 1}, (Hp, Wp) = out_hw or (H, W), zero-padded bottom/right:
        best-IoU head, > 0, nearest upsample from the mask grid."""
        frames = (frames if isinstance(frames, torch.Tensor)
                  else torch.as_tensor(np.asarray(frames))).to(self.device)
        f_count, H, W = frames.shape[:3]
        hp, wp = out_hw or (H, W)
        size = self.cfg.vision.image_size
        k = self.encode_batch_size
        embs = []
        for s in range(0, f_count, k):
            chunk = frames[s:s + k]
            n = len(chunk)
            if n < k:
                chunk = torch.cat([chunk, chunk[-1:].expand(
                    (k - n,) + chunk.shape[1:])])
            embs.append(self._encode_raw(chunk)[:n])
        emb = torch.cat(embs)
        scale = torch.tensor([size / W, size / H, size / W, size / H])
        scaled = (torch.as_tensor(np.asarray(boxes, np.float32))
                  * scale).to(self.device)
        outs = []
        for s in range(0, f_count, 4):  # bounds the box-repeated embedding
            masks, iou = sam_mod.predict_from_embeddings(
                self.params, emb[s:s + 4], scaled[s:s + 4], self.cfg)
            best = iou.argmax(dim=-1)  # (F, K)
            m = torch.gather(masks, 2, best[:, :, None, None, None].expand(
                masks.shape[:2] + (1,) + masks.shape[3:]))[:, :, 0]
            g = m.shape[-1]
            ys = (torch.arange(H, device=self.device) * g // H).clamp(0, g - 1)
            xs = (torch.arange(W, device=self.device) * g // W).clamp(0, g - 1)
            up = (m[:, :, ys][:, :, :, xs] > 0).to(torch.uint8)
            outs.append(torch.nn.functional.pad(up, (0, wp - W, 0, hp - H)))
        return torch.cat(outs)

    def num_cached_embeddings(self) -> int:
        return len(self._emb_cache)

    def discard_embedding(self, frame_index) -> None:
        self._emb_cache.pop(frame_index, None)

    def clear_cache(self) -> None:
        self._emb_cache = {}

    @torch.inference_mode()
    def __call__(self, image: np.ndarray, boxes: np.ndarray,
                 frame_index: Optional[int] = None) -> np.ndarray:
        H, W = image.shape[:2]
        size = self.cfg.vision.image_size
        emb = (self._emb_cache.pop(frame_index, None)
               if frame_index is not None else None)
        if emb is None:
            emb = self._encode_raw(torch.as_tensor(np.asarray(image))[None])
        scaled = boxes.astype(np.float32) * np.array(
            [size / W, size / H, size / W, size / H], np.float32)
        n = len(scaled)
        masks, iou = sam_mod.predict_from_embeddings(
            self.params, emb, torch.as_tensor(scaled, device=self.device)[None],
            self.cfg)
        masks, iou = masks[0].cpu().numpy(), iou[0].cpu().numpy()
        best = iou.argmax(axis=1)
        out = np.zeros((n, H, W), np.float32)
        for i, b in enumerate(best):
            m = masks[i, b] > 0
            g = m.shape[0]
            ys = (np.arange(H) * g // H).clip(0, g - 1)
            xs = (np.arange(W) * g // W).clip(0, g - 1)
            out[i] = m[np.ix_(ys, xs)].astype(np.float32)
        return out


def build_sam(checkpoint_dir: Optional[str] = None,
              cfg: Optional[SamConfig] = None, variant: str = "mobile",
              tiny_cfg: Optional[tv.TinyViTConfig] = None, device=None,
              seed: int = 0) -> SamSegmenter:
    """MobileSAM (TinyViT-5M encoder + the SAM prompt encoder and mask
    decoder) with random weights on `device`."""
    if variant != "mobile":
        raise NotImplementedError(f"SAM variant {variant!r}: only 'mobile' "
                                  "is ported")
    if checkpoint_dir:
        raise NotImplementedError("SAM checkpoint loading is not ported yet")
    warnings.warn("MobileSAM weights not provided; using random init")
    tiny_cfg = tiny_cfg or tv.TinyViTConfig()
    cfg = cfg or SamConfig(vision=dataclasses.replace(
        SamConfig().vision, image_size=tiny_cfg.image_size))
    init = TreeInit(seed, device)
    params = {"vision": tv.init_params(init, tiny_cfg),
              **sam_mod.init_decoder_params(init, cfg)}
    return SamSegmenter(
        params, cfg, lambda p, px: tv.encoder(p["vision"], px, tiny_cfg))


def build_tagger(swin_checkpoint: Optional[str] = None,
                 tag_list: Sequence[str] = DEFAULT_TAG_LIST,
                 cfg: Optional[SwinConfig] = None,
                 ram_checkpoint: Optional[str] = None, device=None,
                 seed: int = 0) -> TaggingModule:
    """Swin-L backbone with a linear tag head, random weights."""
    if swin_checkpoint or ram_checkpoint:
        raise NotImplementedError("tagger checkpoint loading (Swin, RAM) is "
                                  "not ported yet")
    cfg = cfg or SwinConfig.swin_l()
    init = TreeInit(seed, device)
    backbone = swin_mod.init_params(init, cfg)
    head = init_tag_head(init, cfg.num_features, len(tag_list))
    return TaggingModule(backbone, head, cfg, tag_list)


def build_grounding_stack(
    dino_checkpoint: Optional[str] = None,
    sam_checkpoint: Optional[str] = None,
    swin_checkpoint: Optional[str] = None,
    clip_checkpoint: Optional[str] = None,
    xmem_checkpoint: Optional[str] = None,
    detection_every: int = 5,
    temporal_setting: str = "online",
    max_objects: int = 5,
    sam_variant: str = "mobile",
    device=None,
    seed: int = 0,
):
    """The PGVideoLLaVA grounding stack (reference chat.py:243-252):
    GroundingDINO Swin-T at 800 px, MobileSAM, no CLIP crop filter, the
    handcrafted STM propagator, a Swin-L tagger, entity matching; all on
    `device`, random weights from `seed`."""
    from video_llava_tpu_torch.models import grounding_dino as gdino_mod

    if sam_variant != "mobile":
        raise NotImplementedError(f"SAM variant {sam_variant!r}: only "
                                  "'mobile' is ported")
    if clip_checkpoint:
        raise NotImplementedError("the CLIP crop filter is not ported yet")
    if xmem_checkpoint:
        raise NotImplementedError("the XMem propagator is not ported yet")
    detector = gdino_mod.build_detector(dino_checkpoint, device=device,
                                        seed=seed)
    segmenter = build_sam(sam_checkpoint, variant=sam_variant, device=device,
                          seed=seed + 1)
    tracker = GroundedTracker(
        detector=detector, segmenter=segmenter,
        detection_every=detection_every, temporal_setting=temporal_setting,
        tracker_cfg=TrackerConfig(max_objects=max_objects), device=device)
    tagger = build_tagger(swin_checkpoint, device=device, seed=seed + 2)
    return tracker, tagger, EntityMatchingModule()
