"""Kernel 7 on f32 operands (Whisper `base`, as the chat CLI's --use_asr
builds it, runs its encoder in f32). multi_head_attention's dispatch is
decided from the operands alone: off the CPU (meta tensors here stand in
for the card), f32 operands reach kernel 7's wrapper as bf16 ones do, and
a mask, an offset or d % 8 != 0 keep them on the reference. Then the
f32 body's plain version (flash_forward_plain) against the JAX package's
Pallas forward in interpret mode on f32 inputs, at Whisper base's head
layout and a ragged causal GQA pair: out and lse within 1e-5 (the same
f32 math in another summation order)."""

import numpy as np
import jax.numpy as jnp
import torch

from video_llava_tpu.ops.attention import _flash_forward
from video_llava_tpu_torch.ops import attention

# (b, sq, skv, h, h_kv, d, causal, block): Whisper base's 8 heads of 64
# over 600 positions (JAX tiles them in blocks of 256, the last ragged),
# and a ragged causal GQA pair at d 128 (one block)
CASES = [(1, 600, 600, 8, 8, 64, False, 256),
         (2, 100, 130, 8, 2, 128, True, 64)]


def test_f32_dispatch_and_pallas_parity(monkeypatch):
    calls = []

    def recorder(q, k, v, causal=False, scale=None):
        calls.append(q.dtype)
        return q

    monkeypatch.setattr(attention, "flash_attention", recorder)
    for dtype in (torch.float32, torch.bfloat16):
        q = torch.empty(1, 1500, 8, 64, dtype=dtype, device="meta")
        assert attention.multi_head_attention(q, q, q) is q
    assert calls == [torch.float32, torch.bfloat16]
    q = torch.empty(1, 15, 8, 64, device="meta")
    lens = torch.empty(1, dtype=torch.int32, device="meta")
    attention.multi_head_attention(q, q, q, kv_valid_len=lens)
    attention.multi_head_attention(q, q, q, q_offset=lens)
    q12 = q[..., :12]
    attention.multi_head_attention(q12, q12, q12)
    cpu = torch.zeros(1, 15, 8, 64)
    attention.multi_head_attention(cpu, cpu, cpu)
    assert len(calls) == 2  # none of these reached the kernels

    rng = np.random.default_rng(3)
    for b, sq, skv, h, h_kv, d, causal, block in CASES:
        q = rng.normal(size=(b, sq, h, d)).astype(np.float32)
        k = rng.normal(size=(b, skv, h_kv, d)).astype(np.float32)
        v = rng.normal(size=(b, skv, h_kv, d)).astype(np.float32)
        want, want_lse = _flash_forward(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal, None,
            block, block, True)
        assert want.dtype == jnp.float32
        got, lse = attention.flash_forward_plain(
            torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
            causal)
        case = (b, sq, skv, h, h_kv, d, causal)
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                                   rtol=1e-5, err_msg=str(case))
        want_lse = np.asarray(want_lse)[:, :sq, 0].reshape(b, h, sq)
        np.testing.assert_allclose(lse.numpy(), want_lse, atol=1e-5,
                                   rtol=1e-5, err_msg=str(case))
