"""Port parity: the W4A8 block matmul (kernel B's plain version) against
the JAX package's stacked Pallas kernel 5, in interpret mode."""

import numpy as np
import jax.numpy as jnp
import torch

from video_llava_tpu.ops import quant4 as jax_quant4
from video_llava_tpu_torch.ops import quant4

# As tests/test_quant4.py holds the Pallas kernels: both sides quantize
# each row by the same rule and form exact integer partials per group;
# only the f32 sums over groups run in another order.
TOL = 1e-4


def test_w4a8_block_matches_jax_interpret():
    """_int4_block_stacked_pallas(interpret=True) on layer 2 of a 3-layer
    stacked weight, nb in {9, 64}, g = 128 with G/2 odd (D = 768),
    g = 32 and per-channel scales; int4_matmul_stacked dispatches more
    than 8 rows to the block matmul."""
    rng = np.random.default_rng(1)
    for d, f, g in ((768, 256, 128), (512, 384, 32), (256, 128, None)):
        w = rng.normal(size=(3, d, f)).astype(np.float32) * d ** -0.5
        packed, scales = quant4.quantize_tensor_int4(torch.from_numpy(w), g)
        jp = jnp.asarray(packed.numpy())
        js = jnp.asarray(scales.float().numpy()).astype(jnp.bfloat16)
        for nb in (9, 64):
            x = rng.normal(size=(nb, d)).astype(np.float32)
            want = np.asarray(jax_quant4._int4_block_stacked_pallas(
                jnp.asarray(x), jp, js, jnp.int32(2), interpret=True))
            tx = torch.from_numpy(x)
            got = quant4.int4_matmul_w4a8_block_xla(tx, packed[2], scales[2])
            np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)
            np.testing.assert_array_equal(
                quant4.int4_matmul_stacked(tx, packed, scales, 2).numpy(),
                got.numpy())
