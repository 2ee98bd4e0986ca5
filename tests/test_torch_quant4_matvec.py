"""Port parity: the W4A8 matvec (kernel A's plain version) against the
JAX package's stacked Pallas kernel 4, in interpret mode."""

import numpy as np
import jax.numpy as jnp
import torch

from video_llava_tpu.ops import quant4 as jax_quant4
from video_llava_tpu_torch.ops import quant4

# As tests/test_quant4.py holds the Pallas kernels: both sides quantize
# the activations by the same rule and form exact integer partials per
# (row, group); only the f32 sums over groups run in another order.
TOL = 1e-4


def _stacked_weight(rng, layers, d, f, g):
    w = rng.normal(size=(layers, d, f)).astype(np.float32) * d ** -0.5
    return quant4.quantize_tensor_int4(torch.from_numpy(w), g)


def test_w4a8_matvec_matches_jax_interpret():
    """_int4_matvec_stacked_pallas(interpret=True) on layer 1 of a
    3-layer stacked weight, nb in {1, 3, 8}, g = 128 with G/2 odd
    (D = 768), g = 32, and per-channel scales (two activation groups);
    the port's int4_matmul_stacked takes the same layer as a view and,
    on the CPU, the plain version."""
    rng = np.random.default_rng(0)
    for d, f, g in ((768, 256, 128), (512, 384, 32), (256, 128, None)):
        packed, scales = _stacked_weight(rng, 3, d, f, g)
        jp = jnp.asarray(packed.numpy())
        js = jnp.asarray(scales.float().numpy()).astype(jnp.bfloat16)
        for nb in (1, 3, 8):
            x = rng.normal(size=(nb, d)).astype(np.float32)
            want = np.asarray(jax_quant4._int4_matvec_stacked_pallas(
                jnp.asarray(x), jp, js, jnp.int32(1), interpret=True))
            tx = torch.from_numpy(x)
            got = quant4.int4_matmul_w4a8_xla(tx, packed[1], scales[1])
            np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)
            stacked = quant4.int4_matmul_stacked(tx, packed, scales, 1)
            np.testing.assert_array_equal(stacked.numpy(), got.numpy())
            np.testing.assert_array_equal(
                quant4.w4a8_matvec(tx, packed[1], scales[1]).numpy(),
                got.numpy())
