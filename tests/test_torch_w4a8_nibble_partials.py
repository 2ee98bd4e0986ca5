"""Port parity: the decomposition kernels A and B use on the card (each
packed byte's two nibbles as 16 q in a signed byte, int32 sums over
32-row steps and runs of at most 128 rows, each run shifted right by 4),
held against the JAX package: bit for bit against the dots of its
unpack_int4, and, assembled with the scales, against its Pallas kernels 4
and 5 in interpret mode."""

import numpy as np
import jax.numpy as jnp
import torch

from video_llava_tpu.ops import quant4 as jax_quant4
from video_llava_tpu_torch.ops import quant4

# As tests/test_torch_quant4_block.py: both sides form exact integer
# partials per group; only the f32 sums over groups run in another order.
TOL = 1e-4


def test_nibble_partials_match_jax():
    """G = 1 (per channel, one activation group a half), groups of 32
    rows, and D = 768 with g = 128 (G/2 = 3, odd). The partials of
    random int8 activations equal the int64 dots of the JAX unpack_int4
    exactly; assembled as kernel A does (sx[r, g] sw[g, f] per group) they
    match _int4_matvec_stacked_pallas(interpret=True) on layer 1 of a
    3-layer stacked weight, and as kernel B does (sw[g, f] per group, sx[r]
    at the end) _int4_block_stacked_pallas(interpret=True)."""
    rng = np.random.default_rng(11)
    for d, f, g in ((256, 128, None), (512, 384, 32), (768, 256, 128)):
        w = rng.normal(size=(3, d, f)).astype(np.float32) * d ** -0.5
        packed, scales = quant4.quantize_tensor_int4(torch.from_numpy(w), g)
        n_groups = scales.shape[-2]
        ga = n_groups if n_groups > 1 else 2
        p1, s1 = packed[1], scales[1]
        jp = jnp.asarray(packed.numpy())
        js = jnp.asarray(scales.float().numpy()).astype(jnp.bfloat16)

        # bit for bit: random int8 activations, the extremes included
        xq = rng.integers(-127, 128, size=(5, d)).astype(np.int8)
        xq[0, :] = 127
        xq[1, :] = -127
        q = np.asarray(jax_quant4.unpack_int4(jnp.asarray(p1.numpy())))
        xg = xq.astype(np.int64).reshape(5, ga, d // ga).transpose(1, 0, 2)
        want = np.einsum("grk,gkf->grf", xg,
                         q.astype(np.int64).reshape(ga, d // ga, f))
        got = quant4.w4a8_nibble_partials(torch.from_numpy(xq), p1, n_groups)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy().astype(np.int64), want)

        sw = s1.float()
        sw = sw if sw.shape[0] == ga else sw.expand(ga, -1)
        for nb in (1, 3, 8):  # kernel A: scales per (row, group)
            x = rng.normal(size=(nb, d)).astype(np.float32)
            xqa, sxa = quant4.quantize_activation_int8(torch.from_numpy(x),
                                                       ga)
            part = quant4.w4a8_nibble_partials(xqa, p1, n_groups).float()
            y = (part * sxa.t()[:, :, None] * sw[:, None]).sum(0)
            ref = np.asarray(jax_quant4._int4_matvec_stacked_pallas(
                jnp.asarray(x), jp, js, jnp.int32(1), interpret=True))
            np.testing.assert_allclose(y.numpy(), ref, rtol=TOL, atol=TOL)
        for nb in (9, 40):  # kernel B: one scale a row
            x = rng.normal(size=(nb, d)).astype(np.float32)
            xqb, sxb = quant4.quantize_activation_int8(torch.from_numpy(x), 1)
            part = quant4.w4a8_nibble_partials(xqb, p1, n_groups).float()
            y = (part * sw[:, None]).sum(0) * sxb
            ref = np.asarray(jax_quant4._int4_block_stacked_pallas(
                jnp.asarray(x), jp, js, jnp.int32(1), interpret=True))
            np.testing.assert_allclose(y.numpy(), ref, rtol=TOL, atol=TOL)
