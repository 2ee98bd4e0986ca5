"""Port parity: CLIP encoder attention (ops.attention.flash_attention_bhsd).

The JAX side runs its Pallas kernel in interpret mode; the port's side
is the plain version its CUDA kernel is checked against on the card
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


def test_flash_bhsd_matches_jax_interpret():
    """Ragged kv_len inside a padded sequence: 23 -> 32 (one block) and
    the 336 px CLIP pad 577 -> 640 (several blocks). f32 throughout; the
    two sides differ only in summation order (online vs one-shot
    softmax), so 2e-5."""
    rng = np.random.default_rng(0)
    for b, h, s, s_pad, d in ((2, 4, 23, 32, 32), (1, 2, 577, 640, 16)):
        q, k, v = (rng.normal(size=(b, h, s_pad, d)).astype(np.float32)
                   for _ in range(3))
        want = np.asarray(jax_flash(jnp.asarray(q), jnp.asarray(k),
                                    jnp.asarray(v), kv_len=s,
                                    interpret=True))
        tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
        got = flash_attention_bhsd_plain(tq, tk, tv, kv_len=s).numpy()
        np.testing.assert_allclose(got, want, atol=2e-5, rtol=2e-5)
        # the wrapper takes the plain version for CPU tensors
        np.testing.assert_array_equal(
            flash_attention_bhsd(tq, tk, tv, kv_len=s).numpy(), got)


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
