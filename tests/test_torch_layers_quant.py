"""Port parity: the quantized linears and the int8 embedding gather that
models/layers.py dispatches on (JAX models/layers.py:31-65, 119-125)."""

import numpy as np
import jax.numpy as jnp
import torch

import video_llava_tpu.ops.quant4 as jax_quant4
from video_llava_tpu.models import layers as jax_layers
from video_llava_tpu.ops import quant as jax_quant
from video_llava_tpu_torch.models import layers
from video_llava_tpu_torch.ops import quant4


def _kernel(cls, **leaves):
    k = cls.__new__(cls)
    torch.nn.Module.__init__(k)
    for name, t in leaves.items():
        setattr(k, name, torch.nn.Parameter(t, requires_grad=False))
    return k


def _jax_w4a8(x, packed, scales):
    """The TPU's dispatch for one layer (quant4.py:854-866) over the XLA
    twins; JAX on the CPU would take the W4A16 twin instead."""
    xb = x.reshape(-1, x.shape[-1])
    if xb.shape[0] <= jax_quant4.A8_MAX_BATCH:
        y = jnp.concatenate([
            jax_quant4.int4_matmul_w4a8_xla(xb[i:i + 1], packed, scales)
            for i in range(xb.shape[0])])
    else:
        y = jax_quant4.int4_matmul_w4a8_block_xla(xb, packed, scales)
    return y.reshape(x.shape[:-1] + (packed.shape[-1],))


def test_quantized_linear_and_embedding_match_jax(monkeypatch):
    """int8 linear with bias, bf16 activations: the port's bf16 product
    is rounded to bf16 once more than the JAX package's f32-accumulated
    dot, before the bias: one bf16 step of a product below 4 (2^-6,
    atol 2e-2) plus one of the output (rtol 2^-7). int4 linear with bias, f32
    activations, 2 rows (matvec) and 12 rows (block): 1e-5. int8
    embedding rows: bf16, bit for bit."""
    monkeypatch.setattr(jax_quant4, "int4_matmul", _jax_w4a8)
    rng = np.random.default_rng(3)
    w = rng.normal(size=(256, 128)).astype(np.float32) / 16
    bias = rng.normal(size=(128,)).astype(np.float32)

    jq, js = jax_quant.quantize_tensor(jnp.asarray(w), axis=0)
    k8 = _kernel(layers.Int8Kernel, qvalues=torch.tensor(np.asarray(jq)),
                 scales=torch.tensor(np.asarray(js)))
    x = rng.normal(size=(3, 256)).astype(np.float32)
    want = jax_layers.linear({"kernel": {"qvalues": jq, "scales": js},
                              "bias": jnp.asarray(bias)},
                             jnp.asarray(x, jnp.bfloat16))
    got = layers.linear(torch.from_numpy(x).to(torch.bfloat16), k8,
                        torch.from_numpy(bias))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               atol=2e-2, rtol=2 ** -7)

    packed, scales = quant4.quantize_tensor_int4(torch.from_numpy(w), 128)
    k4 = _kernel(layers.Int4Kernel, qvalues_packed=packed, scales=scales)
    jp = jnp.asarray(packed.numpy())
    js4 = jnp.asarray(scales.float().numpy()).astype(jnp.bfloat16)
    for rows in (2, 12):
        x = rng.normal(size=(1, rows, 256)).astype(np.float32)
        want = jax_layers.linear(
            {"kernel": {"qvalues_packed": jp, "scales": js4},
             "bias": jnp.asarray(bias)}, jnp.asarray(x))
        got = layers.linear(torch.from_numpy(x), k4, torch.from_numpy(bias))
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=1e-5, rtol=1e-5)

    table = rng.normal(size=(40, 64)).astype(np.float32) * 0.02
    eq, es = jax_quant.quantize_tensor(jnp.asarray(table), axis=1)
    ids = rng.integers(0, 40, size=(2, 7)).astype(np.int32)
    want = jax_layers.embed({"weight": {"qvalues": eq, "scales": es}},
                            jnp.asarray(ids))
    emb = _kernel(layers.Int8Kernel, qvalues=torch.tensor(np.asarray(eq)),
                  scales=torch.tensor(np.asarray(es)))
    got = layers.embed(emb, torch.from_numpy(ids))
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.view(torch.int16).numpy(),
                                  np.asarray(want).view(np.int16))
