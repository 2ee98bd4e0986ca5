"""Shot/scene detection on decoded frames.

Counterpart of video_llava_tpu/media/scene.py, which replaces the
reference's scenedetect subprocess
(video_chatgpt/chat.py:272): PySceneDetect's ContentDetector computes a
per-frame content value from the mean absolute HSV channel deltas and
cuts when it exceeds a threshold (default 27) with a minimum scene
length. Implemented here in numpy over the frames we already decoded —
no second decode pass, no subprocess.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np


def rgb_to_hsv(frames: np.ndarray) -> np.ndarray:
    """(t, h, w, 3) uint8 RGB -> float32 HSV with H in [0, 360),
    S, V in [0, 255] (OpenCV full-range convention scaled to match
    PySceneDetect's content metric)."""
    f = frames.astype(np.float32) / 255.0
    r, g, b = f[..., 0], f[..., 1], f[..., 2]
    maxc = np.max(f, axis=-1)
    minc = np.min(f, axis=-1)
    v = maxc
    delta = maxc - minc
    s = np.where(maxc > 0, delta / np.maximum(maxc, 1e-9), 0.0)
    h = np.zeros_like(maxc)
    mask = delta > 0
    rmax = (maxc == r) & mask
    gmax = (maxc == g) & mask & ~rmax
    bmax = mask & ~rmax & ~gmax
    h[rmax] = ((g - b)[rmax] / delta[rmax]) % 6
    h[gmax] = (b - r)[gmax] / delta[gmax] + 2
    h[bmax] = (r - g)[bmax] / delta[bmax] + 4
    return np.stack([h * 60.0, s * 255.0, v * 255.0], axis=-1)


def content_values(frames: np.ndarray) -> np.ndarray:
    """Per-frame-transition content score (t-1,): mean abs delta of
    H (wrapped, weighted to 255-range), S, V averaged."""
    hsv = rgb_to_hsv(frames)
    dh = np.abs(hsv[1:, ..., 0] - hsv[:-1, ..., 0])
    dh = np.minimum(dh, 360.0 - dh) * (255.0 / 180.0)
    ds = np.abs(hsv[1:, ..., 1] - hsv[:-1, ..., 1])
    dv = np.abs(hsv[1:, ..., 2] - hsv[:-1, ..., 2])
    comp = np.stack([dh, ds, dv], axis=-1)
    return comp.reshape(comp.shape[0], -1).mean(axis=1)


def detect_scenes(
    frames: np.ndarray,
    threshold: float = 27.0,
    min_scene_len: int = 2,
) -> List[Tuple[int, int]]:
    """-> [(start, end)) frame-index ranges covering the whole video."""
    t = frames.shape[0]
    if t == 0:
        return []
    scores = content_values(frames)
    cuts = []
    last_cut = 0
    for i, s in enumerate(scores):
        frame_idx = i + 1
        if s >= threshold and frame_idx - last_cut >= min_scene_len:
            cuts.append(frame_idx)
            last_cut = frame_idx
    bounds = [0] + cuts + [t]
    return [(bounds[i], bounds[i + 1]) for i in range(len(bounds) - 1)]
