"""Port: pooling refuses more frames than it has temporal tokens."""

import pytest
import torch

from video_llava_tpu_torch.ops.pooling import spatio_temporal_pool


def test_pool_rejects_too_many_frames():
    with pytest.raises(ValueError):
        spatio_temporal_pool(torch.zeros((101, 4, 8)))
