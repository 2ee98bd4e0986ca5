"""Port parity: the gradient of ops/quant.dot_f32 (the f32-accumulating
product under the bf16 lm_head and the int8 quantized_matmul, whose CUDA
op has no derivative of its own) against jax.grad of the JAX package's
dot with preferred_element_type=f32 and its quantized_matmul."""

import numpy as np
import jax
import jax.numpy as jnp
import torch

from video_llava_tpu.ops.quant import quantized_matmul as jax_qmm
from video_llava_tpu_torch.models.layers import linear
from video_llava_tpu_torch.ops.quant import dot_f32, quantized_matmul


def _bf16(a):
    return torch.from_numpy(a).to(torch.bfloat16)


def _np(t):
    return t.detach().float().numpy()


def test_dot_f32_and_quantized_matmul_gradients_match_jax():
    """x (2, 3, 64) against w (64, 96), a cotangent of the f32 output,
    in bf16 (the lm_head's dtypes: the gradient for x, and for w when w
    requires one) and in f32; then the int8 quantized_matmul's gradient
    for bf16 x. Both sides take the f32 cotangent against the other
    operand in f32 and cast once to the operand's dtype, so bf16 results
    agree to one bf16 ulp (2^-8 relative: the two f32 sums may straddle a
    rounding boundary) and f32 ones to 1e-6."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 3, 64)).astype(np.float32)
    w = (rng.standard_normal((64, 96)) / 8).astype(np.float32)
    gy = rng.standard_normal((2, 3, 96)).astype(np.float32)

    for jdt, tdt, rtol in ((jnp.bfloat16, torch.bfloat16, 2 ** -8),
                           (jnp.float32, torch.float32, 1e-6)):
        jx, jw = jnp.asarray(x, jdt), jnp.asarray(w, jdt)
        want = jax.grad(
            lambda a, b: jnp.sum(jnp.dot(a, b, preferred_element_type=jnp.
                                         float32) * gy), argnums=(0, 1))(jx,
                                                                         jw)
        tx = torch.from_numpy(x).to(tdt).requires_grad_()
        tw = torch.from_numpy(w).to(tdt).requires_grad_()
        y = dot_f32(tx, tw)
        assert y.dtype == torch.float32
        y.backward(torch.from_numpy(gy))
        for got, ref in zip((tx.grad, tw.grad), want):
            assert got.dtype == tdt
            ref = np.asarray(ref, np.float32)
            np.testing.assert_allclose(_np(got), ref, rtol=rtol,
                                       atol=rtol * np.abs(ref).max())
        # the lm_head's product (layers.linear with f32 out) is this one
        tx.grad = None
        tw.requires_grad_(False)
        linear(tx, tw, out_dtype=torch.float32).backward(
            torch.from_numpy(gy))
        np.testing.assert_allclose(_np(tx.grad),
                                   np.asarray(want[0], np.float32),
                                   rtol=rtol,
                                   atol=rtol * np.abs(want[0]).max())

    q = rng.integers(-127, 128, size=(64, 96)).astype(np.int8)
    s = (rng.random((1, 96)) / 127).astype(np.float32)
    gq = rng.standard_normal((2, 3, 96)).astype(np.float32)
    jx = jnp.asarray(x, jnp.bfloat16)
    want = jax.grad(lambda a: jnp.sum(
        jax_qmm(a, jnp.asarray(q), jnp.asarray(s)).astype(jnp.float32)
        * jnp.asarray(gq, jnp.bfloat16).astype(jnp.float32)))(jx)
    tx = _bf16(x).requires_grad_()
    out = quantized_matmul(tx, torch.from_numpy(q), torch.from_numpy(s))
    assert out.dtype == torch.bfloat16
    out.backward(_bf16(gq))
    ref = np.asarray(want, np.float32)
    np.testing.assert_allclose(_np(tx.grad), ref, rtol=2 ** -8,
                               atol=2 ** -8 * np.abs(ref).max())
