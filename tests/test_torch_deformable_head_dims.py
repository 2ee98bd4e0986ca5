"""ops/deformable.py's multi_scale_deformable_attention on CPU tensors (its
plain version, what the CUDA kernel is held to) against the JAX package's
kernel 12 in Pallas interpret mode and its XLA gather twin, at the shapes
where the CUDA kernel leaves its main vector path or its usual tiling:
head dims whose rows are not a power-of-two count of 16-byte chunks (40
and 96: the scalar body), a row of two chunks (hd 8 in f32: a warp takes
two queries at a time), a sample count that is not a multiple of 4 (3
levels x 5 points: 4-byte copies of the locations), the most samples a
query may have (4 levels x 8 points), and query counts that are not a
multiple of the vector path's 64-query tile (70 = 64 + 6, 41, 7). A few
coordinates are non-finite (exactly zero: the XLA twin, which has no rule
for them, gets those samples dropped) and the rest straddle the maps'
edges. Tolerances as in tests/test_torch_deformable.py: f32 1e-4 of
max |ref|; bf16 2^-6 of the Pallas kernel's (it rounds inside) and 2^-7
of the XLA twin's."""

import numpy as np
import jax.numpy as jnp
import torch

from video_llava_tpu.ops.deformable import (
    multi_scale_deformable_attention as j_xla,
)
from video_llava_tpu.ops.deformable_pallas import (
    multi_scale_deformable_attention_pallas as j_pallas,
)
from video_llava_tpu_torch.ops import deformable


def _rel(got, want):
    want = np.asarray(want, np.float32)
    return np.abs(np.asarray(got, np.float32) - want).max() / np.abs(
        want).max()


def test_plain_matches_pallas_at_the_kernels_other_paths():
    rng = np.random.default_rng(13)
    cases = (  # (level shapes, q, b, nh, hd, points, dtype)
        (((8, 8), (4, 4), (2, 2)), 70, 1, 2, 8, 5, jnp.float32),
        (((7, 5), (3, 2)), 41, 2, 3, 40, 4, jnp.bfloat16),
        (((6, 6), (3, 3), (2, 2), (1, 1)), 7, 1, 2, 96, 8, jnp.bfloat16),
        (((6, 6), (3, 3), (2, 2), (1, 1)), 7, 1, 2, 96, 8, jnp.float32),
    )
    for shapes, q, b, nh, hd, p, dtype in cases:
        sum_hw = sum(h * w for h, w in shapes)
        value = rng.standard_normal((b, sum_hw, nh, hd)).astype(np.float32)
        locs = rng.uniform(-0.2, 1.2, (b, q, nh, len(shapes), p, 2)).astype(
            np.float32)
        locs[0, q - 1, nh - 1, 0, p - 1, 0] = np.nan
        locs[-1, 1, 0, len(shapes) - 1, 0, 1] = np.inf
        weights = rng.uniform(0, 1, (b, q, nh, len(shapes), p)).astype(
            np.float32)
        jv = jnp.asarray(value, dtype)
        tdtype = torch.float32 if dtype == jnp.float32 else torch.bfloat16
        tv = torch.from_numpy(np.array(jv.astype(jnp.float32))).to(tdtype)
        got = deformable.multi_scale_deformable_attention(
            tv, shapes, torch.from_numpy(locs), torch.from_numpy(weights))
        assert got.dtype == tdtype and got.shape == (b, q, nh * hd)
        got = got.float().numpy()
        assert np.isfinite(got).all()
        tol_p, tol_x = ((1e-4, 1e-4) if dtype == jnp.float32
                        else (2 ** -6, 2 ** -7))
        want = j_pallas(jv, shapes, jnp.asarray(locs), jnp.asarray(weights),
                        interpret=True, query_block=16)
        assert _rel(got, want) <= tol_p, (shapes, q, hd, dtype)
        # the XLA twin has no rule for non-finite coordinates: give it the
        # same samples dropped (finite, weight 0)
        bad = ~np.isfinite(locs).all(-1)
        fin = np.where(np.isfinite(locs), locs, 0.5).astype(np.float32)
        dropped = np.where(bad, 0.0, weights).astype(np.float32)
        assert _rel(got, j_xla(jv, shapes, jnp.asarray(fin),
                               jnp.asarray(dropped))) <= tol_x, (
            shapes, q, hd, dtype)
