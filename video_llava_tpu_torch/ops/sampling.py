"""Uniform frame sampling (numpy only).

Counterpart of video_llava_tpu/ops/sampling.py::get_seq_frames:
split [0, total-1] into `desired` equal segments of (total-1)/desired
and take the middle index of each, with numpy's round-half-to-even of
the segment bounds (reference video_chatgpt/eval/model_utils.py:55-79).
"""

from __future__ import annotations

import numpy as np


def get_seq_frames(total_num_frames: int, desired_num_frames: int) -> list:
    """Sampled frame indices as python ints."""
    seg_size = float(total_num_frames - 1) / desired_num_frames
    i = np.arange(desired_num_frames + 1, dtype=np.float64)
    bounds = np.round(seg_size * i).astype(np.int64)
    return [int(x) for x in (bounds[:-1] + bounds[1:]) // 2]
