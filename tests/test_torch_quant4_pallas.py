"""Port parity: the per-layer int4 matmul (JAX kernel 6,
int4_matmul_pallas) in its W4A8 branches, and the W4A16 twin that both
packages take for an F that is not a multiple of 128."""

import numpy as np
import jax.numpy as jnp
import torch

from video_llava_tpu.ops import quant4 as jax_quant4
from video_llava_tpu_torch.ops import quant4

TOL = 1e-4  # exact integer partials on both sides; f32 sums reordered


def test_int4_matmul_matches_jax_pallas_a8_branches():
    """int4_matmul_pallas(interpret=True, a8=True) for 1 and 8 rows and
    (a8_block=True) for 9 and 40 rows against the port's int4_matmul on
    a flat per-layer weight (g = 128, G/2 odd; g = 32). With F = 200
    (not a multiple of 128) both packages' dispatch takes the W4A16
    twin, whose bf16-rounded operands agree to 1e-5."""
    rng = np.random.default_rng(2)
    for d, f, g in ((768, 256, 128), (512, 128, 32)):
        w = rng.normal(size=(d, f)).astype(np.float32) * d ** -0.5
        packed, scales = quant4.quantize_tensor_int4(torch.from_numpy(w), g)
        jp = jnp.asarray(packed.numpy())
        js = jnp.asarray(scales.float().numpy()).astype(jnp.bfloat16)
        for nb in (1, 8, 9, 40):
            x = rng.normal(size=(nb, d)).astype(np.float32)
            want = np.asarray(jax_quant4.int4_matmul_pallas(
                jnp.asarray(x), jp, js, interpret=True, a8=nb <= 8,
                a8_block=nb > 8))
            got = quant4.int4_matmul(torch.from_numpy(x), packed, scales)
            np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)

    w = rng.normal(size=(256, 200)).astype(np.float32) * 256 ** -0.5
    x = rng.normal(size=(3, 5, 256)).astype(np.float32)
    jp, js = jax_quant4.quantize_tensor_int4(jnp.asarray(w), 128)
    packed, scales = quant4.quantize_tensor_int4(torch.from_numpy(w), 128)
    want = np.asarray(jax_quant4.int4_matmul(jnp.asarray(x), jp, js))
    got = quant4.int4_matmul(torch.from_numpy(x), packed, scales)
    assert got.shape == (3, 5, 200)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
