"""ops/deformable.py's plain version (what CPU tensors run, and what the
CUDA kernel is held to) against the JAX package's three implementations
on the same seeded inputs: kernel 12 (multi_scale_deformable_attention_
pallas) and kernel 13 (the 2D-tiled twin, encoder shapes q == sum_hw)
in Pallas interpret mode, and the XLA gather twin. f32 values: within
1e-4 of max |ref| (another summation order). bf16 values: within 2^-6
of max |ref| of the Pallas kernels (they round the weight-times-tent
operand and the point sums to bf16; the plain version sums in f32) and
within 2^-7 of the XLA twin (both f32 inside, one bf16 output rounding).
Non-finite sampling coordinates give exactly zero, as in the Pallas
kernels. Locations straddle the maps' edges (zero padding)."""

import numpy as np
import jax.numpy as jnp
import torch

from video_llava_tpu.ops.deformable import (
    multi_scale_deformable_attention as j_xla,
)
from video_llava_tpu.ops.deformable_pallas import (
    multi_scale_deformable_attention_pallas as j_pallas,
    multi_scale_deformable_attention_pallas_2d as j_pallas_2d,
)
from video_llava_tpu_torch.ops import deformable


def _case(rng, shapes, q, b, nh=4, hd=32, p=4):
    sum_hw = sum(h * w for h, w in shapes)
    value = rng.standard_normal((b, sum_hw, nh, hd)).astype(np.float32)
    locs = rng.uniform(-0.2, 1.2, (b, q, nh, len(shapes), p, 2)).astype(
        np.float32)
    weights = rng.uniform(0, 1, (b, q, nh, len(shapes), p)).astype(
        np.float32)
    return value, locs, weights


def _rel(got, want):
    want = np.asarray(want, np.float32)
    return np.abs(np.asarray(got, np.float32) - want).max() / np.abs(
        want).max()


def test_plain_matches_pallas_kernels_and_xla_twin():
    rng = np.random.default_rng(0)
    cases = (  # (level shapes, q, b): decoder-like and encoder (q = sum)
        (((12, 12), (6, 6), (3, 3)), 50, 2),
        (((10, 14), (5, 7), (3, 4), (2, 2)), 33, 1),
        (((8, 8), (4, 4)), 80, 2),
    )
    for shapes, q, b in cases:
        value, locs, weights = _case(rng, shapes, q, b)
        for dtype, tdtype, tol_p, tol_x in (
                (jnp.float32, torch.float32, 1e-4, 1e-4),
                (jnp.bfloat16, torch.bfloat16, 2 ** -6, 2 ** -7)):
            jv = jnp.asarray(value, dtype)
            tv = torch.from_numpy(np.array(jv.astype(jnp.float32))).to(
                tdtype)
            got = deformable.multi_scale_deformable_attention(
                tv, shapes, torch.from_numpy(locs), torch.from_numpy(weights))
            assert got.dtype == tdtype and got.shape == (b, q, 4 * 32)
            got = got.float().numpy()
            want = j_pallas(jv, shapes, jnp.asarray(locs),
                            jnp.asarray(weights), interpret=True,
                            query_block=16)
            assert _rel(got, want) <= tol_p, (shapes, dtype)
            assert _rel(got, j_xla(jv, shapes, jnp.asarray(locs),
                                   jnp.asarray(weights))) <= tol_x
            if q == sum(h * w for h, w in shapes):  # kernel 13's shapes
                deformable.set_tile2d(True)
                try:
                    again = deformable.multi_scale_deformable_attention(
                        tv, shapes, torch.from_numpy(locs),
                        torch.from_numpy(weights)).float().numpy()
                finally:
                    deformable.set_tile2d(False)
                np.testing.assert_array_equal(again, got)
                want2d = j_pallas_2d(jv, shapes, jnp.asarray(locs),
                                     jnp.asarray(weights), interpret=True)
                assert _rel(got, want2d) <= tol_p, (shapes, dtype, "2d")

    # non-finite coordinates contribute exactly zero
    shapes = ((9, 9), (4, 4))
    value, locs, weights = _case(rng, shapes, 21, 1)
    bad = locs.copy()
    bad[0, 3, 1, 0, 2, 0] = np.nan
    bad[0, 7, 0, 1, 1, 1] = np.inf
    bad[0, 9, 2, 0, 0, :] = -np.inf
    fin = locs.copy()
    w = weights.copy()
    for i in ((0, 3, 1, 0, 2), (0, 7, 0, 1, 1), (0, 9, 2, 0, 0)):
        w[i] = 0.0  # the same samples, dropped
    got = deformable.msda_plain(torch.from_numpy(value), shapes,
                                torch.from_numpy(bad),
                                torch.from_numpy(weights)).numpy()
    assert np.isfinite(got).all()
    dropped = deformable.msda_plain(torch.from_numpy(value), shapes,
                                    torch.from_numpy(fin),
                                    torch.from_numpy(w)).numpy()
    np.testing.assert_array_equal(got, dropped)
    want = j_pallas(jnp.asarray(value), shapes, jnp.asarray(bad),
                    jnp.asarray(weights), interpret=True, query_block=8)
    assert _rel(got, want) <= 1e-4
    # far-off finite coordinates are off the map too
    far = locs.copy()
    far[0, 5, 0, 0, 0] = (1e30, -1e30)
    w = weights.copy()
    w[0, 5, 0, 0, 0] = 0.0
    np.testing.assert_array_equal(
        deformable.msda_plain(torch.from_numpy(value), shapes,
                              torch.from_numpy(far),
                              torch.from_numpy(weights)).numpy(),
        deformable.msda_plain(torch.from_numpy(value), shapes,
                              torch.from_numpy(locs),
                              torch.from_numpy(w)).numpy())
