"""Grounded tracking: detect, segment, propagate.

Counterpart of video_llava_tpu/grounding/tracker.py (reference
Tracker_with_GroundingDINO, grounding_new_api.py:242-598): text-prompted
detection every N frames, NMS, SAM box masks, an id mask in descending
area order, association of detections to tracked objects by mask IoU,
and propagation in between, through the host loop (per frame, or with a
learned propagator a chunk a detection gap) or the whole-clip program
(grounding/fused_clip.py) that build_grounding_stack's propagators (the
STM, or XMem with a checkpoint) take, with the CLIP crop filter before
SAM there and after it in the host loop.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from video_llava_tpu_torch.grounding.memory_tracker import (
    LearnedMemoryTracker,
    MemoryTracker,
    TrackerConfig,
    edge_pad16,
)
from video_llava_tpu_torch.ops.box_ops import box_iou, masks_to_boxes, nms

Detector = Callable[[np.ndarray, Sequence[str]],
                    Tuple[np.ndarray, np.ndarray, np.ndarray]]
Segmenter = Callable[[np.ndarray, np.ndarray], np.ndarray]


def _mask_match_iou(det_masks: np.ndarray, prev_masks: np.ndarray):
    """Box IoU of detection masks (> 0) against tracked masks (> 0.5)."""
    det = masks_to_boxes(torch.as_tensor(det_masks) > 0)
    prev = masks_to_boxes(torch.as_tensor(prev_masks) > 0.5)
    return box_iou(det, prev)[0].numpy()


class ObjectInfo(NamedTuple):
    id: int
    category_id: int
    score: float


class FrameResult(NamedTuple):
    frame_index: int
    masks: np.ndarray  # (max_objects, H, W)
    objects: List[ObjectInfo]


@dataclasses.dataclass
class GroundedTracker:
    detector: Detector
    segmenter: Segmenter
    crop_filter: Optional[object] = None
    classes: Sequence[str] = ()
    detection_every: int = 5
    temporal_setting: str = "online"  # or 'semionline'
    num_voting_frames: int = 3
    box_threshold: float = 0.35
    nms_threshold: float = 0.5
    iou_match_threshold: float = 0.5
    tracker_cfg: TrackerConfig = dataclasses.field(
        default_factory=TrackerConfig)
    propagator: Optional[object] = None
    detect_batch_size: int = 4  # frames per batched detector forward
    emb_prefetch_frames: int = 8  # SAM embeddings kept encoded ahead
    binary_masks: bool = False  # propagators threshold at 0.5 on device
    prefer_fused: bool = True
    device: Optional[torch.device] = None  # where the propagator runs

    def __post_init__(self):
        self.tracker = self.propagator or MemoryTracker(self.tracker_cfg,
                                                        device=self.device)
        self._objects: List[ObjectInfo] = []
        self._buffer: List[Tuple[int, np.ndarray, np.ndarray,
                                 List[ObjectInfo]]] = []
        self._det_cache: Dict[int, Tuple[np.ndarray, np.ndarray,
                                         np.ndarray]] = {}
        self._emb_plan: List[int] = []

    def clear(self):
        self.tracker.clear()
        self._objects, self._buffer = [], []
        self._det_cache, self._emb_plan = {}, []
        clear_cache = getattr(self.segmenter, "clear_cache", None)
        if clear_cache is not None:
            clear_cache()

    # -- detection ----------------------------------------------------------

    def precompute_detections(self, frames, frame_indices: Sequence[int],
                              prompts: Sequence[str]) -> None:
        """Batched raw detection of `frame_indices` into the per-frame
        cache detect_and_segment reads (the last batch repeats its last
        frame), then the first window of SAM embeddings."""
        detect_batch = getattr(self.detector, "detect_batch", None)
        if detect_batch is not None and self.detect_batch_size > 1:
            idx = [i for i in frame_indices if i not in self._det_cache]
            k = self.detect_batch_size
            for start in range(0, len(idx), k):
                chunk = idx[start:start + k]
                padded = chunk + [chunk[-1]] * (k - len(chunk))
                results = detect_batch(np.stack([frames[i] for i in padded]),
                                       prompts)
                for i, res in zip(chunk, results[:len(chunk)]):
                    self._det_cache[i] = res
        precompute_emb = getattr(self.segmenter, "precompute_embeddings",
                                 None)
        if (precompute_emb is not None
                and getattr(self.segmenter, "encode_batch_size", 1) > 1):
            self._emb_plan = [i for i in frame_indices if i not in getattr(
                self.segmenter, "_emb_cache", {})]
            self._prefetch_embeddings(frames)

    def _prefetch_embeddings(self, frames) -> None:
        """Keep up to emb_prefetch_frames detection frames encoded ahead
        of the cursor."""
        precompute_emb = getattr(self.segmenter, "precompute_embeddings",
                                 None)
        if not self._emb_plan or precompute_emb is None:
            return
        count = getattr(self.segmenter, "num_cached_embeddings", None)
        room = self.emb_prefetch_frames - (count() if callable(count) else 0)
        if room <= 0:
            return
        batch, self._emb_plan = self._emb_plan[:room], self._emb_plan[room:]
        precompute_emb(frames, batch)

    def detect_and_segment(self, image: np.ndarray, prompts: Sequence[str],
                           frame_index: Optional[int] = None):
        """-> (masks (n, H, W) f32 {0, 1} by descending area, infos)."""
        cached = (self._det_cache.pop(frame_index, None)
                  if frame_index is not None else None)
        if cached is not None:
            boxes, conf, class_ids = cached
        else:
            boxes, conf, class_ids = self.detector(image, prompts)
        if len(boxes):
            keep = conf >= self.box_threshold
            boxes, conf, class_ids = boxes[keep], conf[keep], class_ids[keep]
        if len(boxes) == 0:
            discard = getattr(self.segmenter, "discard_embedding", None)
            if discard is not None and frame_index is not None:
                discard(frame_index)
            return np.zeros((0,) + image.shape[:2], np.float32), []
        keep = nms(torch.as_tensor(boxes), torch.as_tensor(conf),
                   self.nms_threshold).numpy()
        boxes, conf, class_ids = boxes[keep], conf[keep], class_ids[keep]
        if getattr(self.segmenter, "supports_frame_cache", False):
            masks = self.segmenter(image, boxes, frame_index=frame_index)
        else:
            masks = self.segmenter(image, boxes)
        if self.crop_filter is not None and len(boxes):
            keep = self.crop_filter(image, boxes, class_ids, prompts)
            boxes, conf, class_ids, masks = (boxes[keep], conf[keep],
                                             class_ids[keep], masks[keep])
        # descending area, ties in detection order (a stable sort, as the
        # whole-clip path's _area_order: numpy's default sort may order
        # equal areas either way); the filter may have dropped every box
        order = np.argsort(-masks.sum(axis=(1, 2)), kind="stable")
        infos = [ObjectInfo(id=i + 1, category_id=int(class_ids[j]),
                            score=float(conf[j]))
                 for i, j in enumerate(order)]
        return masks[order].astype(np.float32), infos

    # -- propagation -----------------------------------------------------------

    def _mask_dtype(self):
        return np.uint8 if self.binary_masks else np.float32

    def _step(self, frame, **kw) -> np.ndarray:
        if self.binary_masks:
            kw["binary"] = True
        return self.tracker.step(frame, **kw)

    def _incorporate(self, frame01, det_masks: np.ndarray,
                     det_infos: List[ObjectInfo]) -> np.ndarray:
        """Matched detections refresh their object's mask, unmatched ones
        become new objects (DEVA incorporate_detection)."""
        max_o = self.tracker_cfg.max_objects
        H, W = frame01.shape[:2]
        if self.tracker.state is None or not self._objects:
            n = min(len(det_masks), max_o)
            self._objects = [ObjectInfo(i + 1, det_infos[i].category_id,
                                        det_infos[i].score)
                             for i in range(n)]
            slots = np.zeros((max_o, H, W), self._mask_dtype())
            slots[:n] = det_masks[:n]
            self.tracker.clear()
            if n:
                self.tracker.add_reference(frame01, slots,
                                           num_objects=len(self._objects))
            return slots
        prev = self._step(frame01, update_memory=False)
        slots = prev.copy()
        used = set()
        if len(det_masks):
            up = (det_masks.astype(np.uint8) if self.binary_masks
                  else det_masks)
            iou = _mask_match_iou(up, prev)
            for d in range(len(det_masks)):
                j = int(np.argmax(iou[d])) if iou.shape[1] else -1
                if j >= 0 and iou[d, j] >= self.iou_match_threshold and (
                        j < len(self._objects) and j not in used):
                    slots[j] = det_masks[d]
                    used.add(j)
                elif len(self._objects) < max_o:
                    new_id = len(self._objects)
                    self._objects.append(ObjectInfo(
                        new_id + 1, det_infos[d].category_id,
                        det_infos[d].score))
                    slots[new_id] = det_masks[d]
        self.tracker.add_reference(frame01, slots,
                                   num_objects=len(self._objects))
        return slots

    def process_frame(self, ti: int, image: np.ndarray):
        """One frame of the host loop; frames stay uint8 (the propagator
        casts on the device)."""
        prompts = list(self.classes)
        if self.temporal_setting == "online":
            if ti % self.detection_every == 0:
                det_masks, infos = self.detect_and_segment(image, prompts,
                                                           frame_index=ti)
                slots = self._incorporate(image, det_masks, infos)
            elif self.tracker.state is not None:
                slots = self._step(image)
            else:
                slots = np.zeros((self.tracker_cfg.max_objects,)
                                 + image.shape[:2], self._mask_dtype())
            return [FrameResult(ti, slots, list(self._objects))]
        det_masks, infos = self.detect_and_segment(image, prompts,
                                                   frame_index=ti)
        self._buffer.append((ti, image, det_masks, infos))
        if len(self._buffer) < self.num_voting_frames:
            return None
        t0, f0, _, _ = self._buffer[0]
        voted_masks, voted_infos = self._vote()
        results = [FrameResult(t0, self._incorporate(f0, voted_masks,
                                                     voted_infos),
                               list(self._objects))]
        for tj, fj, _, _ in self._buffer[1:]:
            results.append(FrameResult(tj, self._step(fj),
                                       list(self._objects)))
        self._buffer = []
        return results

    def _vote(self):
        """Keep keyframe detections confirmed (IoU >= 0.5) in a majority
        of the buffered frames."""
        _, _, m0, i0 = self._buffer[0]
        if len(m0) == 0:
            return m0, i0
        votes = np.zeros(len(m0), np.int32)
        b0 = masks_to_boxes(torch.as_tensor(m0))
        for _, _, mj, _ in self._buffer[1:]:
            if len(mj) == 0:
                continue
            iou = box_iou(b0, masks_to_boxes(torch.as_tensor(mj)))[0].numpy()
            votes += (iou.max(axis=1) >= 0.5).astype(np.int32)
        keep = votes >= len(self._buffer) // 2
        return m0[keep], [info for k, info in zip(keep, i0) if k]

    # -- public APIs -------------------------------------------------------------

    def _fusable_propagator(self) -> bool:
        """The learned XMem propagator, or the default-feature STM."""
        return isinstance(self.tracker, LearnedMemoryTracker) or (
            isinstance(self.tracker, MemoryTracker) and self.tracker._fused)

    def fused_eligible(self) -> bool:
        """True when run_on_list_of_images takes the whole-clip program:
        online or semionline, a fusable propagator (both configurations
        build_grounding_stack makes), and a crop filter that is absent or
        scores box batches on the device (supports_batch_device)."""
        return (self.prefer_fused
                and self.temporal_setting in ("online", "semionline")
                and self._fusable_propagator()
                and (self.crop_filter is None or getattr(
                    self.crop_filter, "supports_batch_device", False)))

    def run_on_list_of_images(self, frames, classes: Sequence[str]):
        if self.fused_eligible():
            return self.run_on_list_of_images_fused(
                frames, classes, binary=self.binary_masks)
        return self.run_host_loop(frames, classes)

    def run_host_loop(self, frames, classes: Sequence[str]):
        self.classes = list(classes)
        self.clear()
        det_frames = (range(0, len(frames), self.detection_every)
                      if self.temporal_setting == "online"
                      else range(len(frames)))
        self.precompute_detections(frames, list(det_frames), list(classes))
        results: List[FrameResult] = []
        chunk_step = (getattr(self.tracker, "step_chunk", None)
                      if self.temporal_setting == "online" else None)
        if chunk_step is not None:
            # a chunk-capable propagator takes each detection gap in one
            # call (its key encoder batched over the gap)
            n, E = len(frames), self.detection_every
            ti = 0
            while ti < n:
                if ti % E == 0:
                    self._prefetch_embeddings(frames)
                    results.extend(self.process_frame(ti, frames[ti]))
                    ti += 1
                    continue
                gap = list(range(ti, min(n, (ti // E + 1) * E)))
                if self.tracker.state is None:
                    zeros = np.zeros((self.tracker_cfg.max_objects,)
                                     + frames[gap[0]].shape[:2],
                                     self._mask_dtype())
                    results.extend(FrameResult(tj, zeros,
                                               list(self._objects))
                                   for tj in gap)
                else:
                    kw = {"binary": True} if self.binary_masks else {}
                    masks = chunk_step([frames[tj] for tj in gap],
                                       pad_to=E - 1, **kw)
                    results.extend(FrameResult(tj, masks[j],
                                               list(self._objects))
                                   for j, tj in enumerate(gap))
                ti = gap[-1] + 1
        else:
            for ti, frame in enumerate(frames):
                self._prefetch_embeddings(frames)
                out = self.process_frame(ti, frame)
                if out:
                    results.extend(out)
        for tj, fj, _, _ in self._buffer:  # semionline remainder
            if self.tracker.state is not None:
                results.append(FrameResult(tj, self._step(fj),
                                           list(self._objects)))
        self._buffer = []
        results.sort(key=lambda r: r.frame_index)
        return results

    def run_on_list_of_images_fused(self, frames, classes: Sequence[str],
                                    max_dets: int = 8, binary: bool = True):
        """The whole clip through fused_clip.run_clip_fused (XMem) or
        run_clip_fused_stm: frames go to the device once (or arrive
        there, as a (T, H, W, 3) uint8 tensor that tagging shares; XMem
        pads them to multiples of 16 there); detection, the crop filter,
        SAM and propagation read slices of that one upload, and the
        bit-packed masks come back in one copy. The crop filter scores
        every detection frame's boxes before SAM (its decisions depend
        on the boxes only; the host loop filters after SAM). max_dets
        bounds the detections a frame keeps after the box threshold
        (top-scoring first)."""
        from video_llava_tpu_torch.grounding import fused_clip
        from video_llava_tpu_torch.grounding import memory_tracker as mt
        from video_llava_tpu_torch.models import xmem as xmem_mod

        if self.crop_filter is not None and not getattr(
                self.crop_filter, "supports_batch_device", False):
            raise NotImplementedError("the crop filter lacks "
                                      "filter_frames_device: use "
                                      "run_host_loop")
        prop = self.tracker
        if not self._fusable_propagator():
            raise NotImplementedError(
                "the fused path needs a LearnedMemoryTracker or the "
                "default-feature MemoryTracker")
        is_stm = isinstance(prop, MemoryTracker)
        semi = self.temporal_setting == "semionline"
        self.classes = list(classes)
        self.clear()

        E = self.num_voting_frames if semi else self.detection_every
        t0 = len(frames)
        n_seg = -(-t0 // E)
        t_pad = n_seg * E
        dev = prop.device
        if isinstance(frames, torch.Tensor):
            clip = frames.to(dev)
        else:
            clip = torch.as_tensor(np.stack([np.asarray(f) for f in frames]),
                                   device=dev)
        if t_pad > t0:
            clip = torch.cat([clip, clip[-1:].expand(
                (t_pad - t0,) + clip.shape[1:])])
        h, w = clip.shape[1:3]
        if not is_stm:  # XMem's stride 16
            clip = edge_pad16(clip)
        ph, pw = clip.shape[1] - h, clip.shape[2] - w
        frame_valid = torch.arange(t_pad) < t0

        det_idx = (list(range(t0)) if semi
                   else [s * E for s in range(n_seg) if s * E < t0])
        n_det = len(det_idx)
        dev_det = clip[torch.as_tensor(det_idx, device=dev), :h, :w]
        detect_batch = getattr(self.detector, "detect_batch", None)
        raw = []
        if detect_batch is not None and self.detect_batch_size > 1:
            kb = self.detect_batch_size
            for start in range(0, n_det, kb):
                n_chunk = min(kb, n_det - start)
                chunk = dev_det[start:start + n_chunk]
                if n_chunk < kb:
                    chunk = torch.cat([chunk, chunk[-1:].expand(
                        (kb - n_chunk,) + chunk.shape[1:])])
                raw.extend(detect_batch(chunk, list(classes))[:n_chunk])
        else:
            det_host = dev_det.cpu().numpy()
            raw = [self.detector(det_host[i], classes) for i in range(n_det)]
        k_det = max_dets
        boxes = np.zeros((n_det, k_det, 4), np.float32)
        score = np.zeros((n_det, k_det), np.float32)
        cat = np.zeros((n_det, k_det), np.int64)
        nms_in = np.zeros((len(raw), k_det, 4), np.float32)
        nms_sc = np.full((len(raw), k_det), -np.inf, np.float32)
        pre = []
        for s, (b, c, ids) in enumerate(raw):
            keep = c >= self.box_threshold
            b, c, ids = b[keep], c[keep], ids[keep]
            order = np.argsort(-c)[:k_det]
            b, c, ids = b[order], c[order], ids[order]
            pre.append((b, c, ids))
            nms_in[s, :len(b)] = b
            nms_sc[s, :len(b)] = c
        if raw:
            keep_all = nms(torch.as_tensor(nms_in), torch.as_tensor(nms_sc),
                           self.nms_threshold).numpy()
        det_valid = np.zeros((n_det, k_det), bool)
        for s, (b, c, ids) in enumerate(pre):
            kept = np.nonzero(keep_all[s, :len(b)])[0]
            n = len(kept)
            boxes[s, :n], score[s, :n], cat[s, :n] = b[kept], c[kept], ids[kept]
            det_valid[s, :n] = True
        n_nms = det_valid.sum(axis=1)  # a prefix of the slots
        if self.crop_filter is not None and det_valid.any():
            det_valid &= np.asarray(self.crop_filter.filter_frames_device(
                dev_det, boxes, det_valid, cat, list(classes)), bool)

        seg = self.segmenter
        if hasattr(seg, "decode_masks_batch_device"):
            det_masks = seg.decode_masks_batch_device(
                dev_det, boxes, out_hw=(h + ph, w + pw))
        else:  # stub segmenters (tests): host masks, one upload
            det_host = dev_det.cpu().numpy()
            m = np.zeros((n_det, k_det, h + ph, w + pw), np.uint8)
            for s in range(n_det):
                nv = int(n_nms[s])
                if nv:
                    m[s, :nv, :h, :w] = seg(det_host[s],
                                            boxes[s, :nv]) > 0.5
            det_masks = torch.as_tensor(m, device=dev)
        det_masks = det_masks.to(dev)

        seg_is_det = None
        if semi:
            # every frame votes; only keyframe rows feed the program, and
            # the trailing partial window never votes (the host loop
            # flushes it by propagation)
            if n_det < t_pad:
                det_masks = torch.cat([det_masks, det_masks.new_zeros(
                    (t_pad - n_det,) + det_masks.shape[1:])])
            dv_pad = np.zeros((t_pad, k_det), bool)
            dv_pad[:n_det] = det_valid
            keep_key = fused_clip.vote_detections(
                det_masks, torch.as_tensor(dv_pad, device=dev),
                E).cpu().numpy()
            keep_key[t0 // E:] = False
            det_masks = det_masks.reshape((n_seg, E) + det_masks.shape[1:])[
                :, 0]
            key_rows = [s * E for s in range(n_seg)]
            det_valid, cat, score = keep_key, cat[key_rows], score[key_rows]
            seg_is_det = [(s + 1) * E <= t0 for s in range(n_seg)]
        elif n_det < n_seg:
            det_masks = torch.cat([det_masks, det_masks.new_zeros(
                (n_seg - n_det,) + det_masks.shape[1:])])
            pad = n_seg - n_det
            det_valid = np.concatenate([det_valid,
                                        np.zeros((pad, k_det), bool)])
            cat = np.concatenate([cat, np.zeros((pad, k_det), np.int64)])
            score = np.concatenate([score, np.zeros((pad, k_det),
                                                    np.float32)])

        cfg = prop.cfg
        args = (clip, det_masks, torch.as_tensor(det_valid, device=dev),
                torch.as_tensor(cat.astype(np.int32), device=dev),
                torch.as_tensor(score, device=dev), frame_valid,
                fused_clip.init_table(cfg), cfg)
        kw = dict(detect_every=E, iou_threshold=self.iou_match_threshold,
                  binary=binary, pack=binary, seg_is_det=seg_is_det)
        if is_stm:
            n_feat = (h // cfg.patch) * (w // cfg.patch)
            state = mt.init_state(cfg, n_feat, 5, dev)
            masks, cats, scores_out, counts, state = (
                fused_clip.run_clip_fused_stm(state, *args, **kw))
            unpack_w = w + (-w % 8)
        else:
            state = xmem_mod.init_state(cfg, (h + ph) // 16, (w + pw) // 16,
                                        dev)
            masks, cats, scores_out, counts, state = (
                fused_clip.run_clip_fused(prop.params, state, *args, **kw))
            prop._frame_idx = t_pad
            unpack_w = w + pw
        prop.state, prop._hw = state, (h, w)
        packed = masks.cpu().numpy()  # the one device-to-host copy
        cats, scores_out = cats.numpy(), scores_out.numpy()
        counts = counts.numpy()

        results: List[FrameResult] = []
        obj_cache: Dict[int, List[ObjectInfo]] = {}
        for t in range(t0):
            s = t // E
            objs = obj_cache.get(s)
            if objs is None:
                objs = [ObjectInfo(i + 1, int(cats[s, i]),
                                   float(scores_out[s, i]))
                        for i in range(int(counts[s]))]
                obj_cache[s] = objs
            full = (fused_clip.unpack_mask_bits(packed[t], unpack_w)
                    if binary else packed[t])
            results.append(FrameResult(t, full[:, :h, :w], list(objs)))
        self._objects = list(obj_cache.get(n_seg - 1, []))
        return results

    def run_on_video(self, video_path: str, classes: Sequence[str],
                     num_frames: int = 100):
        from video_llava_tpu_torch.media.loader import load_video_native_size

        frames = load_video_native_size(video_path, num_frm=num_frames)
        return self.run_on_list_of_images(list(frames), classes)
