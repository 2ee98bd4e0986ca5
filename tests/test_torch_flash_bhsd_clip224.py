"""Port parity: CLIP encoder attention at the 224 px tiling.

ViT-L/14 at 224 px pads 257 tokens to s_pad 272 at head dim 64: on the
card the Hopper body (csrc/flash_bhsd.cu) reads that in 64-row tiles,
five query tiles and five key tiles, the last key tile holding one valid
key. The JAX side runs its Pallas kernel in interpret mode; the port's
side is the plain version the CUDA kernel is held against on the card
(tests/test_torch_kernels_gpu.py, chip_smoke.py).
"""

import numpy as np
import jax.numpy as jnp
import torch

from video_llava_tpu.ops.attention import flash_attention_bhsd as jax_flash
from video_llava_tpu_torch.ops.attention import (
    flash_attention_bhsd,
    flash_attention_bhsd_plain,
)


def test_flash_bhsd_clip224_matches_jax_interpret():
    """(1, 2, 272, 64) with kv_len 257 (key tile 4 holds one valid key)
    and kv_len 65 (key tile 1 holds one, tiles 2-4 none). The pad rows of
    k and v are large, so a leaked pad key would show. f32 throughout;
    the two sides differ only in summation order, so 2e-5, as in
    tests/test_torch_flash_bhsd.py."""
    rng = np.random.default_rng(224)
    b, h, s_pad, d = 1, 2, 272, 64
    for kv_len in (257, 65):
        q, k, v = (rng.normal(size=(b, h, s_pad, d)).astype(np.float32)
                   for _ in range(3))
        k[:, :, kv_len:] = 30.0
        v[:, :, kv_len:] = 1e4
        want = np.asarray(jax_flash(jnp.asarray(q), jnp.asarray(k),
                                    jnp.asarray(v), kv_len=kv_len,
                                    interpret=True))
        tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
        got = flash_attention_bhsd_plain(tq, tk, tv, kv_len=kv_len).numpy()
        assert np.abs(got).max() < 10.0  # no pad value reached the output
        np.testing.assert_allclose(got, want, atol=2e-5, rtol=2e-5)
        # the wrapper takes the plain version for CPU tensors
        np.testing.assert_array_equal(
            flash_attention_bhsd(tq, tk, tv, kv_len=kv_len).numpy(), got)
