"""Port: decode attention never reads cache positions past a row's length."""

import numpy as np
import torch

from video_llava_tpu_torch.ops.attention import decode_attention_stacked_plain


def test_decode_attention_ignores_positions_past_length():
    """Values at or past a row's length never reach the output."""
    rng = np.random.default_rng(1)
    q = torch.from_numpy(rng.normal(size=(1, 1, 2, 16)).astype(np.float32))
    k = torch.from_numpy(rng.normal(size=(2, 1, 24, 2, 16))
                         .astype(np.float32))
    v = k.clone()
    lens = torch.tensor([9], dtype=torch.int32)
    base = decode_attention_stacked_plain(q, k, v, 1, lens)
    k[:, :, 9:] = 1e4
    v[:, :, 9:] = -1e4
    torch.testing.assert_close(
        decode_attention_stacked_plain(q, k, v, 1, lens), base)
