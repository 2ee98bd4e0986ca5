"""Port parity for the int4 chat slice: a tiny VideoLLaVA whose LLM is
quantized with the JAX package's quantize_params_int4, fused with
fuse_layer_kernels and carried across with engine/convert.py.

Every layer kernel packs to int4 (hidden 256, 4 x 64 heads, intermediate
512, g = 128); vocab 500 is not a multiple of 128, so lm_head falls back
to int8, as Vicuna-7B's 32006 does, and the embedding table is int8.

JAX on the CPU runs the W4A16 twin for int4 kernels (quant4.py:858-859),
not what the TPU runs. So the JAX dispatch is patched for this test to
the TPU's W4A8 dispatch over its XLA twins -- up to A8_MAX_BATCH rows
int4_matmul_w4a8_xla per row, more rows int4_matmul_w4a8_block_xla --
which is what the port runs on the CPU (its plain versions) and on the
card (its kernels). The JAX package itself is not changed.
"""

import jax.numpy as jnp

import video_llava_tpu.ops.quant4 as jax_quant4
from torch_slice_pair import compare_int4_slice


def _jax_w4a8(x, packed, scales):
    """The TPU's int4 dispatch (quant4.py:854-866, 993-1025) with its
    Pallas kernels replaced by their XLA twins."""
    if packed.shape[-1] % 128:
        return jax_quant4.int4_matmul_xla(x, packed, scales)
    xb = x.reshape(-1, x.shape[-1])
    if xb.shape[0] <= jax_quant4.A8_MAX_BATCH:
        y = jnp.concatenate([
            jax_quant4.int4_matmul_w4a8_xla(xb[i:i + 1], packed, scales)
            for i in range(xb.shape[0])])
    else:
        y = jax_quant4.int4_matmul_w4a8_block_xla(xb, packed, scales)
    return y.reshape(x.shape[:-1] + (packed.shape[-1],))


def test_int4_slice_matches_jax(monkeypatch):
    """Prefill logits, then 4 greedy decode steps fed the JAX side's
    tokens, f32 cache; the bytes of the quantized leaves arrive
    unchanged.

    Tolerance: one int4 linear agrees to 1e-6 on the same input (both
    quantize activations by the same rule and form exact integer
    partials). But the int8 embedding returns bf16, so the LLM runs on
    bf16 activations (as in the JAX package), and a bf16 rounding that
    lands one way in one framework and the other in the other, or an f32
    sum in another order, moves an activation across an int8 rounding
    boundary: one step, 1/127 of its group's absmax. These steps add up
    through 4 layers. Scaling one video feature by 1.02 moves either
    package's own prefill logits by 2.4% (max) / 0.54% (mean) of their
    largest value; the port against JAX measured 2.0% / 0.51% at prefill
    and at most 2.4% / 0.61% over the decode steps. So logits are held to
    5% (max) and 1% (mean) of max |logit|, and greedy tokens must agree
    where that bound decides them."""
    compare_int4_slice(monkeypatch, _jax_w4a8)
