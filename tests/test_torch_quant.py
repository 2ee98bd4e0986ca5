"""Port parity: weights-only int8 quantization (ops.quant)."""

import numpy as np
import jax.numpy as jnp
import torch

from video_llava_tpu.ops import quant as jax_quant
from video_llava_tpu_torch.ops import quant


def test_int8_quantization_matches_jax():
    """quantize_tensor (per-channel over axis 0, -2 of a stacked kernel,
    1 of an embedding table) and quantize_params give the JAX package's
    bytes and scales exactly; dequantize and quantized_matmul agree to
    f32 rounding (1e-6)."""
    rng = np.random.default_rng(0)
    for shape, axis in (((64, 48), 0), ((3, 64, 48), -2), ((50, 32), 1)):
        w = rng.normal(size=shape).astype(np.float32)
        jq, js = jax_quant.quantize_tensor(jnp.asarray(w), axis=axis)
        q, s = quant.quantize_tensor(torch.from_numpy(w), axis=axis)
        np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
        np.testing.assert_array_equal(s.numpy(), np.asarray(js))
        np.testing.assert_allclose(
            quant.dequantize(q, s, torch.float32).numpy(),
            np.asarray(jax_quant.dequantize(jq, js, jnp.float32)),
            rtol=1e-6, atol=1e-7)

    w = rng.normal(size=(64, 48)).astype(np.float32)
    x = rng.normal(size=(5, 64)).astype(np.float32)
    jq, js = jax_quant.quantize_tensor(jnp.asarray(w), axis=0)
    want = np.asarray(jax_quant.quantized_matmul(jnp.asarray(x), jq, js))
    got = quant.quantized_matmul(torch.from_numpy(x),
                                 torch.from_numpy(np.asarray(jq)),
                                 torch.from_numpy(np.asarray(js)))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)

    tree = {
        "embed_tokens": {"weight": rng.normal(size=(300, 256))},
        "layers": {"wq": {"kernel": rng.normal(size=(2, 256, 256))},
                   "norm": {"scale": np.ones((2, 256))}},
        "small": {"kernel": rng.normal(size=(16, 16))},
        "position_embedding": rng.normal(size=(300, 256)),
    }
    want = jax_quant.quantize_params(
        _map(lambda a: jnp.asarray(a, jnp.float32), tree))
    got = quant.quantize_params(
        _map(lambda a: torch.from_numpy(a.astype(np.float32)), tree))
    flat_w, flat_g = _flat(want), _flat(got)
    assert sorted(flat_w) == sorted(flat_g)
    assert "embed_tokens/weight/qvalues" in flat_g
    assert "layers/wq/kernel/qvalues" in flat_g
    assert "small/kernel" in flat_g and "position_embedding" in flat_g
    for k in flat_w:
        np.testing.assert_array_equal(flat_g[k].numpy(), np.asarray(flat_w[k]))


def _flat(tree, prefix=""):
    if not isinstance(tree, dict):
        return {prefix: tree}
    out = {}
    for k, v in tree.items():
        out.update(_flat(v, f"{prefix}/{k}" if prefix else k))
    return out


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    return fn(tree)
