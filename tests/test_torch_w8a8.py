"""Port parity: the W8A8 pieces of ops/quant.py. The row quantizer, the
int8 x int8 product and quantize_params(a8=True) give the JAX package's
int8 values, scales and int32 sums bit for bit on the same numpy
inputs; the rescaled f32 product agrees to the last rounding."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from video_llava_tpu.ops import quant as jq
from video_llava_tpu_torch.ops import quant as tq


def test_w8a8_matches_jax_bit_for_bit():
    torch.set_num_threads(1)
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 37, 48)).astype(np.float32)
    # exact ties of the row quantizer: values at odd halves of a step
    x[0, 0, :5] = np.array([127.0, 0.5, 1.5, -2.5, 63.5], np.float32)
    w = rng.standard_normal((48, 40)).astype(np.float32)

    xq_j, sx_j = jq.quantize_rows_int8(jnp.asarray(x))
    xq_t, sx_t = tq.quantize_rows_int8(torch.from_numpy(x))
    np.testing.assert_array_equal(xq_t.numpy(), np.asarray(xq_j))
    np.testing.assert_array_equal(sx_t.numpy(), np.asarray(sx_j))
    # half to even, as TO_NEAREST_EVEN: 0.5 -> 0, 1.5 -> 2, -2.5 -> -2
    assert xq_t[0, 0, :5].tolist() == [127, 0, 2, -2, 64]

    q_j, s_j = jq.quantize_tensor(jnp.asarray(w), axis=0)
    q_t, s_t = tq.quantize_tensor(torch.from_numpy(w), axis=0)
    np.testing.assert_array_equal(q_t.numpy(), np.asarray(q_j))
    np.testing.assert_array_equal(s_t.numpy(), np.asarray(s_j))

    # the int32 sums, and the rescale: int32 sums are exact on both
    # sides; (y * sx) * scales is the same two f32 roundings
    y_j = jnp.dot(xq_j, q_j, preferred_element_type=jnp.int32)
    y_t = tq.int8_mm(xq_t.reshape(-1, 48), q_t).reshape(3, 37, 40)
    np.testing.assert_array_equal(y_t.numpy(), np.asarray(y_j))
    for dtype_j, dtype_t in ((jnp.float32, torch.float32),
                             (jnp.bfloat16, torch.bfloat16)):
        got = tq.quantized_matmul_a8(torch.from_numpy(x).to(dtype_t), q_t,
                                     s_t)
        want = jq.quantized_matmul_a8(jnp.asarray(x, dtype_j), q_j, s_j)
        np.testing.assert_array_equal(
            got.float().numpy(), np.asarray(want.astype(jnp.float32)))

    # quantize_params(a8=True): stacked (L, in, out) kernels take scales
    # over axis -2 and become {qvalues_a8, scales}; an embedding table
    # keeps the weights-only gather form; small leaves stay
    tree = {
        "layers": {"q": {"kernel": rng.standard_normal((2, 48, 40)).astype(
            np.float32), "bias": np.zeros((2, 40), np.float32)}},
        "emb": {"weight": rng.standard_normal((64, 48)).astype(np.float32)},
        "small": {"kernel": rng.standard_normal((4, 8)).astype(np.float32)},
        "position_embedding": rng.standard_normal((50, 48)).astype(
            np.float32),
    }
    want = jq.quantize_params(jax.tree.map(jnp.asarray, tree),
                              min_size=1 << 10, a8=True)
    got = tq.quantize_params(
        tq.map_tree(lambda _, a: torch.from_numpy(a), tree),
        min_size=1 << 10, a8=True)
    flat_w = jax.tree_util.tree_flatten_with_path(want)[0]
    assert {jax.tree_util.keystr(p) for p, _ in flat_w} == {
        "['layers']['q']['kernel']['qvalues_a8']",
        "['layers']['q']['kernel']['scales']", "['layers']['q']['bias']",
        "['emb']['weight']['qvalues']", "['emb']['weight']['scales']",
        "['small']['kernel']", "['position_embedding']"}
    for path, leaf in flat_w:
        node = got
        for k in path:
            node = node[k.key]
        assert node.dtype == {np.dtype(np.int8): torch.int8,
                              np.dtype(np.float32): torch.float32}[
                                  np.asarray(leaf).dtype], path
        np.testing.assert_array_equal(node.numpy(), np.asarray(leaf))
    assert tuple(got["layers"]["q"]["kernel"]["scales"].shape) == (2, 1, 40)
