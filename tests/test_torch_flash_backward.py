"""Port parity: flash_attention's gradient on the CPU (the autograd
function's plain backward, kernel 8's plain version) against jax.grad of
the JAX package's flash_attention in Pallas interpret mode."""

import numpy as np
import jax
import jax.numpy as jnp
import torch

from video_llava_tpu.ops.attention import flash_attention as jax_flash
from video_llava_tpu_torch.ops.attention import flash_attention

# the cases of tests/test_flash_backward.py: (b, sq, skv, h, h_kv, d,
# causal, block)
CASES = [
    (2, 64, 64, 4, 4, 32, False, 32), (2, 64, 64, 4, 4, 32, True, 32),
    (2, 67, 67, 4, 4, 32, False, 32), (2, 67, 67, 4, 4, 32, True, 32),
    (1, 32, 32, 8, 2, 16, True, 16), (1, 16, 48, 2, 2, 32, True, 16),
]


def test_flash_attention_grad_matches_jax():
    """Loss (0.1 * sum(out))^2 as in tests/test_flash_backward.py; dq,
    dk, dv within its rtol 1e-3, atol 1e-4."""
    rng = np.random.default_rng(0)
    for b, sq, skv, h, h_kv, d, causal, block in CASES:
        arrays = [rng.normal(size=shape).astype(np.float32) for shape in
                  ((b, sq, h, d), (b, skv, h_kv, d), (b, skv, h_kv, d))]
        want = jax.grad(
            lambda q, k, v: jnp.sum(jax_flash(q, k, v, causal, None, block,
                                              block, True) * 0.1) ** 2,
            argnums=(0, 1, 2))(*map(jnp.asarray, arrays))
        leaves = [torch.from_numpy(a).requires_grad_() for a in arrays]
        out = flash_attention(*leaves, causal=causal)
        # the gradient is the function's own backward, not autograd
        # through the plain forward
        assert type(out.grad_fn).__name__ == "_FlashAttentionBackward"
        ((out * 0.1).sum() ** 2).backward()
        case = (b, sq, skv, h, h_kv, d, causal)
        for leaf, w in zip(leaves, want):
            np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(w),
                                       rtol=1e-3, atol=1e-4,
                                       err_msg=str(case))
