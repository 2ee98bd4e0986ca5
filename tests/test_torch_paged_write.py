"""Port parity: writes into the paged block pool against the JAX
package's _write_paged_cache."""

import numpy as np
import jax.numpy as jnp
import torch

from video_llava_tpu.models.llama import _write_paged_cache as jax_write
from video_llava_tpu_torch.models.llama import _write_paged_cache
from video_llava_tpu_torch.ops.attention import paged_layer_dense


def test_paged_write_matches_jax():
    """Both regimes and the past-the-table rule, on a value pool
    (NL, NB, BS, h, d) and a scale pool (NL, NB, BS, h): a whole-block
    window at a block-aligned position, token-at-a-time writes that
    cross a block boundary, and a window that runs past MAXB*BS of a
    fully allocated row, whose excess must land in pad block 0 and leave
    the row's own last block as it was. After every write the pools are
    bit for bit the JAX package's (f32 copies, no arithmetic)."""
    rng = np.random.default_rng(0)
    nl, nb, bs, h, d = 2, 10, 4, 2, 8
    table = np.array([[7, 2, 9, 1], [3, 8, 5, 6]], np.int32)
    writes = [  # (layer, positions, s): block regime, token regime, past
        (1, [0, 0], 8), (1, [8, 8], 3), (0, [5, 2], 1), (1, [12, 8], 8)]
    for trail in ((h, d), (h,)):
        jpool = jnp.zeros((nl, nb, bs) + trail, jnp.float32)
        pool = torch.zeros((nl, nb, bs) + trail)
        for li, pos, s in writes:
            new = rng.normal(size=(2, s) + trail).astype(np.float32)
            jpool = jax_write(jpool, jnp.asarray(new),
                              jnp.asarray(pos, jnp.int32), jnp.int32(li),
                              jnp.asarray(table))
            _write_paged_cache(pool, torch.from_numpy(new),
                               torch.tensor(pos, dtype=torch.int32), li,
                               torch.from_numpy(table))
            np.testing.assert_array_equal(pool.numpy(), np.asarray(jpool))
        # row 0's window [12, 20) writes its block 3 (pool block 1) and
        # sends positions 16-19 (logical block 4 of 4) to the pad block
        np.testing.assert_array_equal(pool[1, 1].numpy(), new[0, :4])
        np.testing.assert_array_equal(pool[1, 0].numpy(), new[0, 4:])
        dense = paged_layer_dense(pool, 1, torch.from_numpy(table))
        assert dense.shape == (2, 16) + trail
        np.testing.assert_array_equal(dense[1, 8:].numpy(), new[1])
