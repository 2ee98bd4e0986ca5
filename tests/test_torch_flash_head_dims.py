"""Kernel 7 and 8 at head dims that are a multiple of 8 but not of 16.

multi_head_attention sends every plain operand with d % 8 == 0 to kernel
7, as the JAX package sends it to its Pallas forward; the CUDA bodies
take multiples of 16, so the wrappers zero-pad d to the next multiple of
16 around them (flash_forward_padded, flash_backward_padded), with the
scale of the unpadded d. Here the same pad-and-slice runs around the
plain versions on the CPU: the forward against the JAX package's Pallas
forward in interpret mode on the same f32 inputs (out and lse within
1e-5: the same f32 math in another summation order), the backward
against the unpadded plain backward (1e-5), and the dispatch is checked
on meta tensors, which stand in for the card."""

import numpy as np
import jax.numpy as jnp
import torch

from video_llava_tpu.ops.attention import _flash_forward
from video_llava_tpu_torch.ops import attention

# (b, sq, skv, h, h_kv, d, causal)
CASES = [(2, 40, 40, 3, 3, 24, False),
         (1, 30, 50, 4, 2, 40, True)]


def test_padded_head_dims_match_pallas(monkeypatch):
    calls = []

    def recorder(q, k, v, causal=False, scale=None):
        calls.append(q.shape[-1])
        return q

    monkeypatch.setattr(attention, "flash_attention", recorder)
    q = torch.empty(1, 40, 3, 24, device="meta")
    assert attention.multi_head_attention(q, q, q) is q
    assert calls == [24]

    rng = np.random.default_rng(7)
    for b, sq, skv, h, h_kv, d, causal in CASES:
        case = (b, sq, skv, h, h_kv, d, causal)
        q = rng.normal(size=(b, sq, h, d)).astype(np.float32)
        k = rng.normal(size=(b, skv, h_kv, d)).astype(np.float32)
        v = rng.normal(size=(b, skv, h_kv, d)).astype(np.float32)
        g = rng.normal(size=(b, sq, h, d)).astype(np.float32)
        want, want_lse = _flash_forward(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal, None,
            64, 64, True)
        qt, kt, vt, gt = (torch.from_numpy(x) for x in (q, k, v, g))
        got, lse = attention.flash_forward_padded(
            attention.flash_forward_plain, qt, kt, vt, causal)
        assert got.shape == (b, sq, h, d) and got.is_contiguous()
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                                   rtol=1e-5, err_msg=str(case))
        want_lse = np.asarray(want_lse)[:, :sq, 0].reshape(b, h, sq)
        np.testing.assert_allclose(lse.numpy(), want_lse, atol=1e-5,
                                   rtol=1e-5, err_msg=str(case))

        grads = attention.flash_backward_padded(
            attention.flash_backward_plain, qt, kt, vt, got, lse, gt, causal)
        ref = attention.flash_backward_plain(qt, kt, vt, got, lse, gt, causal)
        for a, r in zip(grads, ref):
            assert a.shape == r.shape and a.is_contiguous()
            np.testing.assert_allclose(a.numpy(), r.numpy(), atol=1e-5,
                                       rtol=1e-5, err_msg=str(case))
