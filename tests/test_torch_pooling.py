"""Port parity: spatio-temporal pooling (ops.pooling).

The JAX side runs its fused Pallas kernel in interpret mode; the port's
side is the plain version its CUDA kernel is checked against on the
card.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from video_llava_tpu.ops.pooling import spatio_temporal_pool_pallas
from video_llava_tpu_torch.ops.pooling import (
    spatio_temporal_pool,
    spatio_temporal_pool_fused,
)


def test_pool_matches_jax_interpret():
    """t = 100 (every frame valid) and t = 7 with 5 valid frames (rows
    zeroed and padded to 100). f32 sums in another order: 1e-5."""
    rng = np.random.default_rng(0)
    for t, n in ((100, None), (7, 5)):
        x = rng.normal(size=(t, 64, 128)).astype(np.float32)
        want = np.asarray(spatio_temporal_pool_pallas(
            jnp.asarray(x),
            num_valid_frames=None if n is None else jnp.int32(n),
            out_dtype=jnp.float32, interpret=True,
        ))
        tx = torch.from_numpy(x)
        got = spatio_temporal_pool(tx, n, out_dtype=torch.float32).numpy()
        assert got.shape == (100 + 64, 128)
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
        # the wrapper takes the plain version for CPU tensors
        np.testing.assert_array_equal(
            spatio_temporal_pool_fused(tx, n, out_dtype=torch.float32)
            .numpy(), got)


def test_pool_rejects_too_many_frames():
    with pytest.raises(ValueError):
        spatio_temporal_pool(torch.zeros((101, 4, 8)))
