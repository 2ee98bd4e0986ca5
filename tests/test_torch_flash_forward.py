"""Port parity: kernel 7's plain version (flash_forward_plain) against the
JAX package's _flash_forward run in Pallas interpret mode."""

import numpy as np
import jax.numpy as jnp
import torch

from video_llava_tpu.ops.attention import _flash_forward
from video_llava_tpu_torch.ops.attention import flash_forward_plain

# (b, sq, skv, h, h_kv, d, causal, block): s 64 and 67, both masks, GQA
# 8/2, right-aligned 16 queries over 48 keys
CASES = [
    (2, 64, 64, 4, 4, 32, False, 32), (2, 64, 64, 4, 4, 32, True, 32),
    (2, 67, 67, 4, 4, 32, False, 32), (2, 67, 67, 4, 4, 32, True, 32),
    (1, 32, 32, 8, 2, 16, True, 16), (1, 16, 48, 2, 2, 32, True, 16),
]


def test_flash_forward_plain_matches_pallas():
    """out and the row logsumexp, f32 inputs, within 1e-5 (the same f32
    math in another summation order)."""
    rng = np.random.default_rng(0)
    for b, sq, skv, h, h_kv, d, causal, block in CASES:
        q = rng.normal(size=(b, sq, h, d)).astype(np.float32)
        k = rng.normal(size=(b, skv, h_kv, d)).astype(np.float32)
        v = rng.normal(size=(b, skv, h_kv, d)).astype(np.float32)
        want, want_lse = _flash_forward(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal, None,
            block, block, True)
        got, lse = flash_forward_plain(torch.from_numpy(q),
                                       torch.from_numpy(k),
                                       torch.from_numpy(v), causal)
        case = (b, sq, skv, h, h_kv, d, causal)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                                   rtol=1e-5, err_msg=str(case))
        want_lse = np.asarray(want_lse)[:, :sq, 0].reshape(b, h, sq)
        np.testing.assert_allclose(lse.numpy(), want_lse, atol=1e-5,
                                   rtol=1e-5, err_msg=str(case))
