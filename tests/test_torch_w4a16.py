"""Port parity: kernel 6's W4A16 branches (int4_matmul_pallas with a8 and
a8_block off: the VPU matvec and the bf16 block matmul) and the int4
dispatch under each setting of the A8 switches.

The JAX side runs int4_matmul_pallas in interpret mode with the flags
its own dispatch would pass (quant4.py:856-866): a8 for b <= A8_MAX_BATCH
under VLT_INT4_A8, a8_block for b > A8_MAX_BATCH under VLT_INT4_A8_BLOCK.
The port's side is its plain versions, which its kernels are held to on
the card.
"""

import numpy as np
import jax.numpy as jnp
import torch

from video_llava_tpu.ops import quant4 as jax_quant4
from video_llava_tpu_torch.ops import quant4

# Both sides form f32 group partials of the same products (integer
# nibbles times f32 or bf16 activations, exact in f32) and scale each
# group's partial; only the order of the f32 sums differs.
TOL = 1e-4


def test_w4a16_matches_jax_pallas_under_each_switch(monkeypatch):
    """Rows 1, 4, 9 and 40 against g = 128 (G/2 odd), g = 32 and one
    scale per column; each plain version against its Pallas branch, then
    int4_matmul under every (A8_DECODE, A8_BLOCK) setting against
    int4_matmul_pallas with the flags the JAX dispatch passes."""
    rng = np.random.default_rng(6)
    max_b = quant4.A8_MAX_BATCH
    assert max_b == jax_quant4.A8_MAX_BATCH == 8
    for d, f, g in ((768, 256, 128), (512, 128, 32), (256, 128, None)):
        w = rng.normal(size=(d, f)).astype(np.float32) * d ** -0.5
        packed, scales = quant4.quantize_tensor_int4(torch.from_numpy(w), g)
        jp = jnp.asarray(packed.numpy())
        js = jnp.asarray(scales.float().numpy()).astype(jnp.bfloat16)
        for nb in (1, 4, 9, 40):
            x = rng.normal(size=(nb, d)).astype(np.float32)
            tx = torch.from_numpy(x)
            pallas = lambda a8, a8_block: np.asarray(  # noqa: E731
                jax_quant4.int4_matmul_pallas(
                    jnp.asarray(x), jp, js, interpret=True, a8=a8,
                    a8_block=a8_block))
            want = pallas(False, False)
            plain = (quant4.int4_matmul_w4a16_matvec_plain if nb == 1
                     else quant4.int4_matmul_w4a16_block_plain)
            np.testing.assert_allclose(plain(tx, packed, scales).numpy(),
                                       want, rtol=TOL, atol=TOL)
            for a8 in (True, False):
                for a8_block in (True, False):
                    monkeypatch.setattr(quant4, "A8_DECODE", a8)
                    monkeypatch.setattr(quant4, "A8_BLOCK", a8_block)
                    want = pallas(a8 and nb <= max_b,
                                  a8_block and nb > max_b)
                    got = quant4.int4_matmul(tx, packed, scales)
                    np.testing.assert_allclose(got.numpy(), want, rtol=TOL,
                                               atol=TOL,
                                               err_msg=f"{d} {g} {nb} "
                                               f"{a8} {a8_block}")
