"""Result overlays and the async writer.

Counterpart of video_llava_tpu/grounding/results.py (reference
ImgFileWriter + ResultSaver, grounding_evaluation/util/result_utils.py):
colorized per-object masks, per-class merged boxes, annotated frames, and
a bounded queue drained by a daemon thread that encodes the video at the
end.
"""

from __future__ import annotations

import queue
import threading
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from video_llava_tpu_torch.ops.box_ops import masks_to_boxes

PALETTE = np.array([(239, 83, 80), (66, 165, 245), (102, 187, 106),
                    (255, 202, 40), (171, 71, 188), (38, 198, 218),
                    (255, 112, 67), (141, 110, 99)], np.uint8)


def colorize_masks(frame: np.ndarray, masks: np.ndarray, alpha: float = 0.5,
                   threshold: float = 0.5) -> np.ndarray:
    """Alpha-blend per-object masks onto the frame."""
    out = frame.astype(np.float32).copy()
    for i, m in enumerate(masks):
        sel = m > threshold
        color = PALETTE[i % len(PALETTE)].astype(np.float32)
        out[sel] = (1 - alpha) * out[sel] + alpha * color
    return out.astype(np.uint8)


def draw_box(frame: np.ndarray, box, color, thickness: int = 2) -> None:
    x0, y0, x1, y1 = [int(v) for v in box]
    h, w = frame.shape[:2]
    x0, x1 = np.clip([x0, x1], 0, w - 1)
    y0, y1 = np.clip([y0, y1], 0, h - 1)
    frame[y0:y0 + thickness, x0:x1] = color
    frame[max(y1 - thickness, 0):y1, x0:x1] = color
    frame[y0:y1, x0:x0 + thickness] = color
    frame[y0:y1, max(x1 - thickness, 0):x1] = color


def _boxes(masks: np.ndarray) -> np.ndarray:
    return masks_to_boxes(torch.as_tensor(np.asarray(masks))).numpy()


def merge_boxes_per_class(masks: np.ndarray, class_ids: Sequence[int],
                          threshold: float = 0.5
                          ) -> List[Tuple[int, np.ndarray]]:
    """Union box of all objects of each class."""
    boxes = _boxes(masks > threshold)
    merged = {}
    for box, cid, m in zip(boxes, class_ids, masks):
        if (m > threshold).sum() == 0:
            continue
        if cid not in merged:
            merged[cid] = box.copy()
        else:
            merged[cid][:2] = np.minimum(merged[cid][:2], box[:2])
            merged[cid][2:] = np.maximum(merged[cid][2:], box[2:])
    return sorted(merged.items())


def annotate_frame(frame: np.ndarray, masks: np.ndarray,
                   class_ids: Optional[Sequence[int]] = None,
                   merge_per_class: bool = True) -> np.ndarray:
    out = colorize_masks(frame, masks)
    if class_ids is not None and len(masks):
        if merge_per_class:
            for cid, box in merge_boxes_per_class(masks, class_ids):
                draw_box(out, box, PALETTE[cid % len(PALETTE)])
        else:
            for i, box in enumerate(_boxes(masks > 0.5)):
                draw_box(out, box, PALETTE[i % len(PALETTE)])
    return out


class ResultSaver:
    """Async overlay writer: bounded queue + daemon worker thread; the
    video is encoded at finish()."""

    def __init__(self, output_video_path: Optional[str], fps: float = 5.0,
                 maxsize: int = 10):
        self.output_video_path = output_video_path
        self.fps = fps
        self.queue: "queue.Queue" = queue.Queue(maxsize=maxsize)
        self.frames: List[np.ndarray] = []
        self.worker = threading.Thread(target=self._run, daemon=True)
        self.worker.start()

    def submit(self, frame: np.ndarray, masks: np.ndarray,
               class_ids: Optional[Sequence[int]] = None) -> None:
        self.queue.put((frame, masks, class_ids))

    def _run(self):
        while True:
            item = self.queue.get()
            if item is None:
                self.queue.task_done()
                break
            frame, masks, class_ids = item
            self.frames.append(annotate_frame(frame, masks, class_ids))
            self.queue.task_done()

    def finish(self) -> List[np.ndarray]:
        self.queue.put(None)
        self.queue.join()
        self.worker.join()
        if self.output_video_path and self.frames:
            from video_llava_tpu_torch.media.loader import encode_video

            encode_video(self.output_video_path, np.stack(self.frames),
                         fps=self.fps)
        return self.frames
