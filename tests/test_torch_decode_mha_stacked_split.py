"""Kernel 3 (a layer of the stacked cache) through the split body, on
the CPU.

On the card a layer of the stacked (NL, b, L, h, d) cache is address
arithmetic: the split body reads the layer's view as a flat MHA cache.
Here the plain versions of the split kernel and its merge, over the
wrapper's plan (``mha_split_plan``), run on layer 1's view of a
3-layer cache and are held against the JAX
decode_attention_mxu_stacked in interpret mode, bf16 and int8.
"""

import numpy as np
import jax.numpy as jnp
import torch

from video_llava_tpu.ops.attention import (
    decode_attention_mxu_stacked as jax_stacked,
)
from video_llava_tpu_torch.ops.attention import (
    decode_gqa_combine_plain,
    decode_gqa_partials_plain,
    mha_split_plan,
)

SMS = 132  # an H100's streaming multiprocessors


def test_stacked_layer_through_the_split_body_matches_jax():
    # rows end at 1, on a chunk's edge and at L. The JAX kernel rounds
    # q * scale and the weights to bf16, the split keeps f32: a few bf16
    # ulps of outputs below 2 (2e-2), and 2^-6 of each row's max |ref|.
    rng = np.random.default_rng(11)
    nl, b, L, h, d, layer = 3, 3, 256, 4, 64, 1
    chunk, splits = mha_split_plan(L, b, h, SMS)
    assert splits > 2
    lens = np.array([1, 2 * chunk, L], np.int32)
    q = rng.normal(size=(b, 1, h, d)).astype(np.float32)
    k = rng.normal(size=(nl, b, L, h, d)).astype(np.float32)
    v = rng.normal(size=(nl, b, L, h, d)).astype(np.float32)
    ks = np.abs(k).max(-1) / 127.0 + 1e-8  # (nl, b, L, h)
    vs = np.abs(v).max(-1) / 127.0 + 1e-8
    kq = np.clip(np.round(k / ks[..., None]), -127, 127).astype(np.int8)
    vq = np.clip(np.round(v / vs[..., None]), -127, 127).astype(np.int8)
    bf = lambda a: torch.from_numpy(a).to(torch.bfloat16)  # noqa: E731
    jbf = lambda a: jnp.asarray(a, jnp.bfloat16)  # noqa: E731
    tq, tl = bf(q), torch.from_numpy(lens)
    for name, jk, jv, jks, jvs, tk, tv, tks, tvs in (
            ("bf16", jbf(k), jbf(v), None, None, bf(k), bf(v), None, None),
            ("int8", jnp.asarray(kq), jnp.asarray(vq), jnp.asarray(ks),
             jnp.asarray(vs), torch.from_numpy(kq), torch.from_numpy(vq),
             torch.from_numpy(ks), torch.from_numpy(vs))):
        want = np.asarray(jax_stacked(jbf(q), jk, jv, jnp.int32(layer),
                                      jnp.asarray(lens), jks, jvs,
                                      interpret=True), np.float32)
        unit = lambda a: None if a is None else a[layer][..., None]  # noqa
        m, l, acc = decode_gqa_partials_plain(tq, tk[layer], tv[layer], tl,
                                              chunk, splits, unit(tks),
                                              unit(tvs))
        got = decode_gqa_combine_plain(m, l, acc).float().numpy()
        np.testing.assert_allclose(got, want, atol=2e-2, err_msg=name)
        err = np.abs(got - want).reshape(b, -1).max(1)
        rel = err / np.abs(want).reshape(b, -1).max(1)
        assert rel.max() <= 2 ** -6, (name, rel)
