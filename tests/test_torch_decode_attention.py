"""Port parity: decode attention over the stacked KV cache
(ops.attention.decode_attention_stacked).

The JAX side runs its Pallas kernel in interpret mode; the port's side
is the plain version its CUDA kernel is checked against on the card.
"""

import numpy as np
import jax.numpy as jnp
import torch

from video_llava_tpu.models.llama import _quantize_kv as jax_quantize_kv
from video_llava_tpu.ops.attention import decode_attention_mxu_stacked
from video_llava_tpu_torch.models.llama import _quantize_kv
from video_llava_tpu_torch.ops.attention import (
    decode_attention_stacked,
    decode_attention_stacked_plain,
)

# The JAX kernel rounds q * scale and the softmax weights to bf16 before
# its two products (ops/attention.py:1235, :1196); the plain version
# keeps both in f32. A bf16 rounding (relative 2^-9) of q moves each
# logit by about 2^-9 * |logit| (|logit| < 4 here) and of p each weight
# by 2^-9 relative: outputs (|v| < 4) differ by a few 1e-3 (4e-3 at
# this seed), well inside 1e-2.
ATOL = 1e-2


def _bf16(a):
    return torch.from_numpy(a).to(torch.bfloat16)


def test_decode_attention_matches_jax_interpret():
    """NL=3, b=2, ragged lengths, L=40 (not a multiple of 16); a bf16
    cache and an int8 cache quantized by both packages' _quantize_kv."""
    rng = np.random.default_rng(0)
    nl, b, L, h, d = 3, 2, 40, 4, 32
    lens = np.array([17, 40], np.int32)
    q = rng.normal(size=(b, 1, h, d)).astype(np.float32)
    k = rng.normal(size=(nl, b, L, h, d)).astype(np.float32)
    v = rng.normal(size=(nl, b, L, h, d)).astype(np.float32)
    tq, tlens = torch.from_numpy(q), torch.from_numpy(lens)

    # bf16 cache: both sides read the same bf16 values
    kb, vb = _bf16(k), _bf16(v)
    for li in range(nl):
        want = np.asarray(decode_attention_mxu_stacked(
            jnp.asarray(q), jnp.asarray(k, jnp.bfloat16),
            jnp.asarray(v, jnp.bfloat16), jnp.int32(li),
            jnp.asarray(lens), interpret=True))
        got = decode_attention_stacked_plain(tq, kb, vb, li, tlens).numpy()
        np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
        np.testing.assert_array_equal(
            decode_attention_stacked(tq, kb, vb, li, tlens).numpy(), got)

    # int8 cache: identical quantization, then the same attention
    jkq, jks = jax_quantize_kv(jnp.asarray(k))
    jvq, jvs = jax_quantize_kv(jnp.asarray(v))
    kq, ks = _quantize_kv(torch.from_numpy(k))
    vq, vs = _quantize_kv(torch.from_numpy(v))
    np.testing.assert_array_equal(kq.numpy(), np.asarray(jkq))
    np.testing.assert_array_equal(vq.numpy(), np.asarray(jvq))
    np.testing.assert_allclose(ks.numpy(), np.asarray(jks), rtol=1e-7)
    np.testing.assert_allclose(vs.numpy(), np.asarray(jvs), rtol=1e-7)
    for li in range(nl):
        want = np.asarray(decode_attention_mxu_stacked(
            jnp.asarray(q), jkq, jvq, jnp.int32(li), jnp.asarray(lens),
            k_scale=jks, v_scale=jvs, interpret=True))
        got = decode_attention_stacked_plain(
            tq, kq, vq, li, tlens, k_scale=ks, v_scale=vs).numpy()
        np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
