"""Port parity: the int4 nibble-packed format (ops.quant4) is the JAX
package's byte for byte."""

import numpy as np
import jax.numpy as jnp
import torch

from video_llava_tpu.ops import quant4 as jax_quant4
from video_llava_tpu_torch.ops import quant4


def _bf16_bits(t: torch.Tensor) -> np.ndarray:
    return t.view(torch.int16).numpy()


def _tree(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree(fn, v) for k, v in tree.items()}
    return fn(tree)


def _flat(tree, prefix=""):
    if not isinstance(tree, dict):
        return {prefix: tree}
    out = {}
    for k, v in tree.items():
        out.update(_flat(v, f"{prefix}/{k}" if prefix else k))
    return out


def test_int4_format_matches_jax():
    """pack_int4 / unpack_int4 on every nibble value; quantize_tensor_int4
    at g = 32, 128 and per-channel (None), per-layer and stacked (L, D,
    F), with G/2 odd (D = 768, g = 128: G = 6); quantize_activation_int8
    for weight groups and for the per-channel case's two halves; and
    quantize_params_int4 over a tree with int4 kernels, the int8
    fallbacks (F not a multiple of 128, groups that straddle the halves),
    an embedding table, small and skipped leaves. Packed bytes, int8
    values and bf16/f32 scales are equal, bit for bit."""
    rng = np.random.default_rng(0)
    q = rng.integers(-8, 8, size=(2, 64, 40)).astype(np.int32)
    want = np.asarray(jax_quant4.pack_int4(jnp.asarray(q)))
    got = quant4.pack_int4(torch.from_numpy(q))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(quant4.unpack_int4(got).numpy(), q)

    for shape, g in (((256, 128), 128), ((768, 256), 128),
                     ((3, 512, 384), 32), ((2, 256, 128), None)):
        w = rng.normal(size=shape).astype(np.float32)
        jp, js = jax_quant4.quantize_tensor_int4(jnp.asarray(w), g)
        tp, ts = quant4.quantize_tensor_int4(torch.from_numpy(w), g)
        np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
        assert ts.dtype == torch.bfloat16 and ts.shape == js.shape
        np.testing.assert_array_equal(_bf16_bits(ts),
                                      np.asarray(js).view(np.int16))
        np.testing.assert_array_equal(
            quant4.dequantize_int4(tp, ts, torch.float32).numpy(),
            np.asarray(jax_quant4.dequantize_int4(jp, js, jnp.float32)))

    for d, groups in ((768, 6), (256, 1)):
        x = rng.normal(size=(1, d)).astype(np.float32)
        ga = groups if groups > 1 else 2  # as int4_matmul_w4a8_xla asks
        jxq, jsx = jax_quant4.quantize_activation_int8(jnp.asarray(x), ga)
        xq, sx = quant4.quantize_activation_int8(torch.from_numpy(x), ga)
        np.testing.assert_array_equal(xq.numpy(), np.asarray(jxq))
        np.testing.assert_array_equal(sx.numpy().reshape(-1, 1),
                                      np.asarray(jsx))

    tree = {
        "embed_tokens": {"weight": rng.normal(size=(300, 256))},
        "layers": {
            "wq": {"kernel": rng.normal(size=(2, 256, 256))},
            "down": {"kernel": rng.normal(size=(2, 768, 256))},
            "odd_f": {"kernel": rng.normal(size=(2, 256, 200))},
            "straddle": {"kernel": rng.normal(size=(2, 384, 256))},
            "input_norm": {"scale": np.ones((2, 256))},
        },
        "lm_head": {"kernel": rng.normal(size=(256, 300))},
        "small": {"kernel": rng.normal(size=(32, 128))},
        "class_embedding": rng.normal(size=(300, 256)),
    }
    want = _flat(jax_quant4.quantize_params_int4(
        _tree(lambda a: jnp.asarray(a, jnp.float32), tree)))
    got = _flat(quant4.quantize_params_int4(
        _tree(lambda a: torch.from_numpy(a.astype(np.float32)), tree)))
    assert sorted(got) == sorted(want)
    for key in ("layers/wq/kernel/qvalues_packed",
                "layers/down/kernel/qvalues_packed",
                "layers/odd_f/kernel/qvalues",
                "layers/straddle/kernel/qvalues",
                "lm_head/kernel/qvalues", "embed_tokens/weight/qvalues",
                "small/kernel", "class_embedding"):
        assert key in got, key
    for key, w in want.items():
        g = got[key]
        if g.dtype == torch.bfloat16:
            np.testing.assert_array_equal(_bf16_bits(g),
                                          np.asarray(w).view(np.int16))
        else:
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
