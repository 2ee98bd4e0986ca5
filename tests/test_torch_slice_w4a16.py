"""Port parity for the W4A16 int4 chat slice (VLT_INT4_A8=0,
VLT_INT4_A8_BLOCK=0): the tiny int4 VideoLLaVA of test_torch_slice_int4
with both A8 switches off, so every int4 linear runs kernel 6's W4A16
branches -- the matvec for a decode step's one row, the bf16 block
matmul for the prompt's rows.

JAX on the CPU runs the W4A16 twin int4_matmul_xla for int4 kernels
(quant4.py:858-859), which rounds the dequantized weight to bf16; the
TPU with both switches off runs int4_matmul_pallas with a8 and a8_block
off. So the JAX dispatch is patched for this test to that route, its
Pallas kernels in interpret mode; the port's switches are set off, and
it runs its W4A16 plain versions on the CPU (its kernels on the card).
The JAX package itself is not changed.
"""

import jax.numpy as jnp

import video_llava_tpu.ops.quant4 as jax_quant4
from torch_slice_pair import compare_int4_slice
from video_llava_tpu_torch.ops import quant4


def _jax_w4a16(x, packed, scales):
    """The TPU's int4 dispatch (quant4.py:854-866) with VLT_INT4_A8=0 and
    VLT_INT4_A8_BLOCK=0."""
    if packed.shape[-1] % 128:
        return jax_quant4.int4_matmul_xla(x, packed, scales)
    y = jax_quant4.int4_matmul_pallas(
        x.reshape(-1, x.shape[-1]).astype(jnp.float32), packed, scales,
        interpret=True, a8=False, a8_block=False)
    return y.reshape(x.shape[:-1] + (packed.shape[-1],))


def test_w4a16_slice_matches_jax(monkeypatch):
    """Prefill logits, then 4 greedy decode steps, as the W4A8 slice.
    Tolerance: 2% max and 0.45% mean of max |logit|. No activation is
    quantized here, so a bf16 rounding that differs between the
    frameworks moves an activation by a bf16 ulp, not by an int8 step:
    measured at most 1.2% (max) and 0.27% (mean). The limits sit between
    that and the W4A8 slice's own readings (2.4%, 0.61%), so a port that
    quantized activations with the A8 switches off would fail them."""
    monkeypatch.setattr(quant4, "A8_DECODE", False)
    monkeypatch.setattr(quant4, "A8_BLOCK", False)
    compare_int4_slice(monkeypatch, _jax_w4a16, limits=(0.02, 0.0045))
