"""Port parity: the int8 weights-only matmul keeps its product in f32."""

import numpy as np
import jax.numpy as jnp
import torch

from video_llava_tpu.ops import quant as jax_quant
from video_llava_tpu_torch.ops import quant


def test_quantized_matmul_keeps_the_f32_product():
    """bf16 activations (as the int4 layout's int8 lm_head sees them)
    against JAX ops/quant.py:55-60: dot(x, q.astype(bf16),
    preferred_element_type=f32) * scales, cast to bf16 once. Both round
    one f32 value to bf16, so they agree but for f32 summation order:
    at most one bf16 ulp (2^-7 relative) on at most 1% of the outputs.
    Rounding the product to bf16 before the scale, as the port did
    first, is one rounding more: at this seed 24.6% of the outputs
    differed from JAX, by one ulp (max relative error 2^-7); after the
    repair none differ."""
    rng = np.random.default_rng(0)
    x = rng.normal(size=(3, 5, 512)).astype(np.float32)
    q = rng.integers(-127, 128, size=(512, 768)).astype(np.int8)
    s = (rng.random((1, 768)) / 127 + 1e-3).astype(np.float32)
    want = np.asarray(jax_quant.quantized_matmul(
        jnp.asarray(x, jnp.bfloat16), jnp.asarray(q), jnp.asarray(s)
    ).astype(jnp.float32))
    got = quant.quantized_matmul(
        torch.from_numpy(x).to(torch.bfloat16), torch.from_numpy(q),
        torch.from_numpy(s))
    assert got.dtype == torch.bfloat16 and got.shape == (3, 5, 768)
    got = got.float().numpy()
    differ = got != want
    assert differ.mean() <= 0.01, differ.mean()
    np.testing.assert_allclose(got, want, rtol=2 ** -7, atol=0)
