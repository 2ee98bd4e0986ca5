"""Video decode and encode through the repository's native libav library.

Counterpart of video_llava_tpu/media/loader.py: the package's own copy
of the native library, ``media/native/libmedia_io.so`` (built from
``media/native/media_io.cpp`` with its Makefile against the libav
development headers), bound here with ctypes. Frames come back as one
contiguous (n, h, w, 3) uint8 RGB array.
"""

from __future__ import annotations

import ctypes
import os
import threading
from typing import Optional, Tuple

import numpy as np

from video_llava_tpu_torch.ops.sampling import get_seq_frames

LIB_PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "native", "libmedia_io.so")

_lib = None
_lock = threading.Lock()


def _load_lib() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(LIB_PATH)
            u8p = ctypes.POINTER(ctypes.c_uint8)
            lib.vlt_open.restype = ctypes.c_void_p
            lib.vlt_open.argtypes = [ctypes.c_char_p]
            lib.vlt_close.restype = None
            lib.vlt_close.argtypes = [ctypes.c_void_p]
            lib.vlt_num_frames.restype = ctypes.c_int64
            lib.vlt_num_frames.argtypes = [ctypes.c_void_p]
            lib.vlt_width.restype = ctypes.c_int
            lib.vlt_width.argtypes = [ctypes.c_void_p]
            lib.vlt_height.restype = ctypes.c_int
            lib.vlt_height.argtypes = [ctypes.c_void_p]
            lib.vlt_fps.restype = ctypes.c_double
            lib.vlt_fps.argtypes = [ctypes.c_void_p]
            lib.vlt_decode_indices.restype = ctypes.c_int
            lib.vlt_decode_indices.argtypes = [
                ctypes.c_void_p, ctypes.POINTER(ctypes.c_int64), ctypes.c_int,
                u8p, ctypes.c_int, ctypes.c_int,
            ]
            lib.vlt_encode_video.restype = ctypes.c_int
            lib.vlt_encode_video.argtypes = [
                ctypes.c_char_p, u8p, ctypes.c_int, ctypes.c_int,
                ctypes.c_int, ctypes.c_double, ctypes.c_char_p,
            ]
            _lib = lib
    return _lib


class VideoReader:
    """Native video reader (decord VideoReader equivalent)."""

    def __init__(self, path: str):
        self._lib = _load_lib()
        self._h = self._lib.vlt_open(path.encode())
        if not self._h:
            raise IOError(f"cannot open video: {path}")
        self.num_frames = int(self._lib.vlt_num_frames(self._h))
        self.width = int(self._lib.vlt_width(self._h))
        self.height = int(self._lib.vlt_height(self._h))
        self.fps = float(self._lib.vlt_fps(self._h))

    def __len__(self):
        return self.num_frames

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def get_batch(self, indices,
                  out_size: Optional[Tuple[int, int]] = None) -> np.ndarray:
        """Decode frames at `indices` (sorted ascending), scaled to
        out_size=(h, w) when given -> (n, h, w, 3) uint8 RGB."""
        if not self._h:
            raise ValueError("reader is closed")
        idx = np.asarray(sorted(int(i) for i in indices), np.int64)
        h, w = out_size if out_size else (self.height, self.width)
        out = np.empty((len(idx), h, w, 3), np.uint8)
        n = self._lib.vlt_decode_indices(
            self._h, idx.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            len(idx), out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            h, w,
        )
        if n != len(idx):
            raise IOError(f"decoded {n}/{len(idx)} frames")
        return out

    def close(self):
        if self._h:
            self._lib.vlt_close(self._h)
            self._h = None


def load_video(vis_path: str, num_frm: int = 100,
               shape: Tuple[int, int] = (224, 224)) -> np.ndarray:
    """min(total, num_frm) uniformly sampled frames resized to `shape`
    -> (t, H, W, 3) uint8 (reference model_utils.py:12-52)."""
    with VideoReader(vis_path) as vr:
        total = len(vr)
        idx = get_seq_frames(total, min(total, num_frm))
        return vr.get_batch(idx, out_size=shape)


def encode_video(path: str, frames: np.ndarray, fps: float = 25.0,
                 codec: str = "libx264") -> None:
    """Encode (n, h, w, 3) uint8 RGB frames to a video file."""
    frames = np.ascontiguousarray(frames, np.uint8)
    if frames.ndim != 4 or frames.shape[-1] != 3:
        raise ValueError(f"frames: expected (n, h, w, 3), got {frames.shape}")
    n, h, w, _ = frames.shape
    rc = _load_lib().vlt_encode_video(
        path.encode(), frames.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        n, h, w, float(fps), codec.encode(),
    )
    if rc != 0:
        raise IOError(f"encode failed ({rc}) for {path}")


def load_video_native_size(vis_path: str, num_frm: int = 100) -> np.ndarray:
    """min(total, num_frm) uniformly sampled frames at the video's own
    size -> (t, H, W, 3) uint8."""
    with VideoReader(vis_path) as vr:
        total = len(vr)
        return vr.get_batch(get_seq_frames(total, min(total, num_frm)))
