"""VidSTG and HC-STVG spatial-grounding datasets.

Counterpart of video_llava_tpu/datasets/grounding_datasets.py. Parity:
reference grounding_evaluation/datasets/{vidstg,hcstvg}_dataset
.py — per video: fps-resampled frame ids (capped at video_max_len=100),
the `inter_frames` subset inside the annotated tube, per-frame GT boxes
(img2box), and the `inter_idx` bookkeeping the sIoU metric consumes
(eval_grounding.py:123-190).

Decoding: the reference pipes ffmpeg's fps filter to rawvideo; here
_decode_frames decodes exactly the computed frame ids with the port's
native libav reader (media/loader.VideoReader): the same frames, one
process, no pipe.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

import numpy as np


def resample_frame_ids(
    start_frame: int,
    end_frame: int,
    video_fps: float,
    required_fps: float = 5.0,
    video_max_len: int = 100,
) -> List[int]:
    """The reference's fps-resampling index walk
    (vidstg_dataset.py:52-67, hcstvg_dataset.py:49-61)."""
    sampling_rate = required_fps / video_fps
    assert sampling_rate <= 1, "downsampling only"
    frame_ids = [start_frame]
    for frame_id in range(start_frame, end_frame):
        if int(frame_ids[-1] * sampling_rate) < int(frame_id * sampling_rate):
            frame_ids.append(frame_id)
    if len(frame_ids) > video_max_len:
        frame_ids = [
            frame_ids[(j * len(frame_ids)) // video_max_len]
            for j in range(video_max_len)
        ]
    return frame_ids


@dataclass
class GroundingSample:
    video_id: str
    caption: str
    frames: np.ndarray  # (t, h, w, 3) uint8
    frame_ids: List[int]
    inter_idx: List[int]  # indices (into frames) inside the annotated tube
    img2box: Dict[int, List[List[float]]]  # inter_idx -> [[x0,y0,x1,y1]]
    qtype: Optional[str] = None  # VidSTG: 'interrogative'/'declarative'


def _decode_frames(video_path: str, frame_ids: Sequence[int]) -> np.ndarray:
    from video_llava_tpu_torch.media.loader import VideoReader

    vr = VideoReader(video_path)
    try:
        ids = [min(int(i), len(vr) - 1) for i in frame_ids]
        # get_batch requires ascending unique ids; map back afterwards.
        uniq = sorted(set(ids))
        frames = vr.get_batch(uniq)
        lookup = {f: k for k, f in enumerate(uniq)}
        return frames[[lookup[i] for i in ids]]
    finally:
        vr.close()


class HCSTVGDataset:
    """HC-STVG v1/v2 (hcstvg_dataset.py:13-190). Videos are 20 s."""

    def __init__(
        self,
        ann_path: str,
        vid_folder: str,
        required_fps: float = 5.0,
        video_max_len: int = 100,
        take_only_temp_loc_frames: bool = False,
    ):
        with open(ann_path) as f:
            self.annotations = json.load(f)
        if isinstance(self.annotations, dict):
            self.annotations = list(self.annotations.values())
        self.vid_folder = vid_folder
        self.required_fps = required_fps
        self.video_max_len = video_max_len
        self.tmp_loc = not take_only_temp_loc_frames

    def __len__(self):
        return len(self.annotations)

    def get_caption(self, idx: int) -> str:
        return self.annotations[idx]["caption"]

    def __getitem__(self, idx: int) -> GroundingSample:
        video = self.annotations[idx]
        n = video["frame_count"]
        video_fps = n / 20.0
        start = 0 if self.tmp_loc else video["tube_start_frame"]
        end = (n - 1) if self.tmp_loc else video["tube_end_frame"]
        frame_ids = resample_frame_ids(
            start, end, video_fps, self.required_fps, self.video_max_len
        )
        trajectory = video["trajectory"]
        inter_idx, img2box = [], {}
        for i_img, img_id in enumerate(frame_ids):
            if video["tube_start_frame"] <= img_id < video["tube_end_frame"]:
                x, y, w, h = trajectory[img_id - video["tube_start_frame"]]
                img2box[i_img] = [[x, y, x + w, y + h]]
                inter_idx.append(i_img)
        frames = _decode_frames(
            os.path.join(self.vid_folder, video["video_path"]), frame_ids
        )
        return GroundingSample(
            video_id=str(video["video_id"]),
            caption=video["caption"],
            frames=frames,
            frame_ids=frame_ids,
            inter_idx=inter_idx,
            img2box=img2box,
        )


class VidSTGDataset:
    """VidSTG val/test (vidstg_dataset.py:16-172); trajectories from
    VidOR, interrogative/declarative qtypes."""

    def __init__(
        self,
        ann_path: str,
        vid_folder: str,
        image_set: str = "test",
        required_fps: float = 5.0,
        video_max_len: int = 100,
        take_only_temp_loc_frames: bool = False,
        qtype_filter: Optional[str] = None,
    ):
        with open(os.path.join(ann_path, f"{image_set}.json")) as f:
            self.annotations = json.load(f)
        self.vid_folder = vid_folder
        self.required_fps = required_fps
        self.video_max_len = video_max_len
        self.tmp_loc = not take_only_temp_loc_frames
        self.videos = self.annotations["videos"]
        if qtype_filter:
            self.videos = [
                v for v in self.videos if v.get("qtype") == qtype_filter
            ]

    def __len__(self):
        return len(self.videos)

    def get_caption(self, idx: int) -> str:
        return self.videos[idx]["caption"]

    def __getitem__(self, idx: int) -> GroundingSample:
        video = self.videos[idx]
        start = video["start_frame"] if self.tmp_loc else video["tube_start_frame"]
        end = video["end_frame"] if self.tmp_loc else video["tube_end_frame"]
        frame_ids = resample_frame_ids(
            start, end, video["fps"], self.required_fps, self.video_max_len
        )
        trajectory = self.annotations["trajectories"][
            video["original_video_id"]
        ][str(video["target_id"])]
        inter_idx, img2box = [], {}
        for i_img, img_id in enumerate(frame_ids):
            if video["tube_start_frame"] <= img_id < video["tube_end_frame"]:
                ann = trajectory[str(img_id)]
                bbox = ann["bbox"] if isinstance(ann, dict) else ann
                # VidSTG preproc stores xyxy (reference preproc_vidstg.py
                # stores xmax/ymax — the 'NOTE' override of the old ltwh).
                img2box[i_img] = [list(bbox)]
                inter_idx.append(i_img)
        frames = _decode_frames(
            os.path.join(self.vid_folder, "video", video["video_path"]),
            frame_ids,
        )
        return GroundingSample(
            video_id=str(video["video_id"]),
            caption=video["caption"],
            frames=frames,
            frame_ids=frame_ids,
            inter_idx=inter_idx,
            img2box=img2box,
            qtype=video.get("qtype"),
        )
