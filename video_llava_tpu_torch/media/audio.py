"""Audio extraction from media files through the native libav decoder.

Counterpart of video_llava_tpu/media/audio.py over the same committed
libmedia_io.so, bound by media/loader._load_lib.
"""

from __future__ import annotations

import ctypes

import numpy as np

from video_llava_tpu_torch.media.loader import _load_lib
from video_llava_tpu_torch.ops.audio import SAMPLE_RATE


def load_audio(path: str, sample_rate: int = SAMPLE_RATE) -> np.ndarray:
    """Decode the first audio stream to mono float32 PCM at
    `sample_rate` (whisperX's load_audio). Returns (n,), or an empty
    array when the file has no audio stream."""
    lib = _load_lib()
    lib.vlt_decode_audio.restype = ctypes.c_int64
    lib.vlt_decode_audio.argtypes = [
        ctypes.c_char_p, ctypes.c_int, ctypes.POINTER(ctypes.c_float),
        ctypes.c_int64,
    ]
    n = lib.vlt_decode_audio(path.encode(), sample_rate, None, 0)
    if n <= 0:
        return np.zeros((0,), np.float32)
    out = np.empty((int(n),), np.float32)
    m = lib.vlt_decode_audio(
        path.encode(), sample_rate,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), int(n))
    return out[:int(m)]
