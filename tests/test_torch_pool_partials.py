"""Kernel 2's two stages, on the CPU.

On the card, a block of the pool kernel sums the valid frames of a run of
patches into the spatial sums and into a temporal partial (run, frame,
channel); a second kernel adds the runs' partials in run order. The plain versions of the two stages (pool_partials_plain,
pool_combine_plain) are held against the JAX spatio_temporal_pool_pallas
in interpret mode and against the port's plain version.
"""

import numpy as np
import jax.numpy as jnp
import torch

from video_llava_tpu.ops.pooling import spatio_temporal_pool_pallas
from video_llava_tpu_torch.ops.pooling import (
    pool_combine_plain,
    pool_partials_plain,
    spatio_temporal_pool,
)


def test_pool_partials_match_jax_interpret():
    """t = 6 frames of 48 patches x 128 channels, in runs of 16 and of 32
    patches (the last run ragged), with every frame valid, 4 valid, none,
    and n = 9 > t (the spatial mean then divides by 9, as in the JAX
    package). Frames at or past n are never summed: their partial rows
    are 0. f32 sums in another order: 1e-5."""
    rng = np.random.default_rng(2)
    t, s, c, T = 6, 48, 128, 10
    x = rng.normal(size=(t, s, c)).astype(np.float32)
    tx = torch.from_numpy(x)
    for n in (6, 4, 0, 9):
        want = np.asarray(spatio_temporal_pool_pallas(
            jnp.asarray(x), num_valid_frames=jnp.int32(n),
            max_temporal_tokens=T, out_dtype=jnp.float32, block_s=16,
            block_c=128, interpret=True))
        for run in (16, 32):
            partial, spatial = pool_partials_plain(tx, n, run)
            assert partial.shape == (-(-s // run), t, c)
            assert not partial[:, min(n, t):].any()
            got = pool_combine_plain(partial, spatial, n, T, torch.float32)
            assert got.shape == (T + s, c)
            np.testing.assert_allclose(got.numpy(), want, atol=1e-5,
                                       rtol=1e-5, err_msg=f"n {n} run {run}")
            np.testing.assert_allclose(
                got.numpy(), spatio_temporal_pool(
                    tx, n, T, torch.float32).numpy(), atol=1e-5, rtol=1e-5)
