"""Port: the CLIP attention's plain version ignores the pad tail of k/v."""

import numpy as np
import torch

from video_llava_tpu_torch.ops.attention import flash_attention_bhsd_plain


def test_flash_bhsd_pad_rows_do_not_leak():
    """Garbage in the pad tail of k/v must not change the valid rows."""
    rng = np.random.default_rng(1)
    q, k, v = (torch.from_numpy(rng.normal(size=(1, 2, 32, 16))
                                .astype(np.float32)) for _ in range(3))
    base = flash_attention_bhsd_plain(q, k, v, kv_len=20)
    k2, v2 = k.clone(), v.clone()
    k2[:, :, 20:] = 1e4
    v2[:, :, 20:] = -1e4
    torch.testing.assert_close(
        flash_attention_bhsd_plain(q, k2, v2, kv_len=20), base)
