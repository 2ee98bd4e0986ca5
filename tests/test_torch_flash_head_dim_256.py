"""Kernels 7 and 8 at head dims past 128, up to 256.

The JAX package's multi_head_attention sends any d % 8 == 0 to its Pallas
forward; the port's CUDA bodies take d 256 (the WMMA and f32 bodies, in
slabs of 128 output columns) and the wrappers zero-pad d in (128, 256) to
256 with the unpadded d's scale (padded_head_dim, flash_forward_padded).
On the CPU: the port's multi_head_attention, and the same pad-and-slice
around the plain versions, against the JAX package's multi_head_attention
on its Pallas path in interpret mode (use_pallas=True, as on one TPU
chip) at d 256 and 200, f32 inputs, out within 1e-5 (the same f32 math in
another summation order) and lse within 1e-5; the padded backward
against the unpadded plain backward (1e-5); the dispatch on meta
tensors, which stand in for the card (the raise past 256 is held on the
card, tests/test_torch_kernels_gpu.py)."""

import numpy as np
import jax.numpy as jnp
import torch

from video_llava_tpu.ops.attention import (
    _flash_forward,
    multi_head_attention as jax_mha,
)
from video_llava_tpu_torch.ops import attention

# (b, sq, skv, h, h_kv, d, causal)
CASES = [(1, 40, 40, 2, 2, 256, True),
         (2, 24, 50, 4, 2, 200, False)]


def test_head_dims_past_128_match_pallas(monkeypatch):
    assert [attention.padded_head_dim(d) for d in (24, 128, 136, 200, 256)
            ] == [32, 128, 256, 256, 256]
    calls = []

    def recorder(q, k, v, causal=False, scale=None):
        calls.append(q.shape[-1])
        return q

    monkeypatch.setattr(attention, "flash_attention", recorder)
    for d in (256, 200):
        q = torch.empty(1, 40, 3, d, device="meta")
        assert attention.multi_head_attention(q, q, q) is q
    assert calls == [256, 200]
    monkeypatch.undo()

    rng = np.random.default_rng(9)
    for b, sq, skv, h, h_kv, d, causal in CASES:
        case = (b, sq, skv, h, h_kv, d, causal)
        q = rng.normal(size=(b, sq, h, d)).astype(np.float32)
        k = rng.normal(size=(b, skv, h_kv, d)).astype(np.float32)
        v = rng.normal(size=(b, skv, h_kv, d)).astype(np.float32)
        g = rng.normal(size=(b, sq, h, d)).astype(np.float32)
        jq, jk, jv = (jnp.asarray(x) for x in (q, k, v))
        want = np.asarray(jax_mha(jq, jk, jv, causal=causal, use_pallas=True,
                                  interpret=True))
        _, want_lse = _flash_forward(jq, jk, jv, causal, None, 64, 64, True)
        qt, kt, vt, gt = (torch.from_numpy(x) for x in (q, k, v, g))
        got = attention.multi_head_attention(qt, kt, vt, causal=causal)
        np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5,
                                   err_msg=str(case))
        padded, lse = attention.flash_forward_padded(
            attention.flash_forward_plain, qt, kt, vt, causal)
        assert padded.shape == (b, sq, h, d) and padded.is_contiguous()
        np.testing.assert_allclose(padded.numpy(), want, atol=1e-5,
                                   rtol=1e-5, err_msg=str(case))
        want_lse = np.asarray(want_lse)[:, :sq, 0].reshape(b, h, sq)
        np.testing.assert_allclose(lse.numpy(), want_lse, atol=1e-5,
                                   rtol=1e-5, err_msg=str(case))
        grads = attention.flash_backward_padded(
            attention.flash_backward_plain, qt, kt, vt, padded, lse, gt,
            causal)
        ref = attention.flash_backward_plain(qt, kt, vt, padded, lse, gt,
                                             causal)
        for a, r in zip(grads, ref):
            assert a.shape == r.shape and a.is_contiguous()
            np.testing.assert_allclose(a.numpy(), r.numpy(), atol=1e-5,
                                       rtol=1e-5, err_msg=str(case))
