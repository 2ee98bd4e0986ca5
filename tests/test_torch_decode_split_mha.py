"""Kernels 3 and 9 past their shared memory, on the CPU.

The per-(head, row) body of kernels 3 and 9 keeps a score for every
position in shared memory. A longer cache goes, by its length, to the
split body of kernel 11 at one head a block (G = 1): the layer's view is
a flat MHA cache. Here the length rule is checked, and the plain
versions of the split kernel and its combine at G = 1, over the wrapper's
plan, are held against the JAX decode_attention_mxu in interpret mode.
"""

import numpy as np
import jax.numpy as jnp
import torch

from video_llava_tpu.ops.attention import decode_attention_mxu as jax_mxu
from video_llava_tpu_torch.ops.attention import (
    _mha_body_fits,
    decode_attention_mxu,
    decode_gqa_combine_plain,
    decode_gqa_partials_plain,
    gqa_split_plan,
)

SMS = 132  # an H100's streaming multiprocessors


def test_long_mha_cache_takes_the_split_body():
    # the chat and serving caches fit the per-(head, row) body; 65,536
    # positions do not, at any head dim the kernels take
    for d in (32, 64, 128):
        assert _mha_body_fits(2048, d) and _mha_body_fits(56000, d)
        assert not _mha_body_fits(65536, d)
    assert _mha_body_fits(58112 - 9 * 128, 128)
    assert not _mha_body_fits(58112 - 9 * 128 + 1, 128)

    # the split math at G = 1 against the JAX MHA kernel, bf16 and int8
    # caches, rows that end in the first chunk, on a chunk's edge and at
    # the cache's end. The JAX kernel rounds q * scale and the weights to
    # bf16, the split keeps f32: a few bf16 ulps of outputs below 2, 2e-2.
    rng = np.random.default_rng(5)
    b, h, d, L = 3, 4, 64, 256
    chunk, splits = gqa_split_plan(L, b, h, SMS)
    assert splits > 1
    lens = np.array([1, chunk, L], np.int32)
    q = rng.normal(size=(b, 1, h, d)).astype(np.float32)
    k = rng.normal(size=(b, L, h, d)).astype(np.float32)
    v = rng.normal(size=(b, L, h, d)).astype(np.float32)
    ks = np.abs(k).max(-1, keepdims=True) / 127.0 + 1e-8
    vs = np.abs(v).max(-1, keepdims=True) / 127.0 + 1e-8
    kq = np.clip(np.round(k / ks), -127, 127).astype(np.int8)
    vq = np.clip(np.round(v / vs), -127, 127).astype(np.int8)
    bf = lambda a: torch.from_numpy(a).to(torch.bfloat16)  # noqa: E731
    jbf = lambda a: jnp.asarray(a, jnp.bfloat16)  # noqa: E731
    for name, jk, jv, jks, jvs, tk, tv, tks, tvs in (
            ("bf16", jbf(k), jbf(v), None, None, bf(k), bf(v), None, None),
            ("int8", jnp.asarray(kq), jnp.asarray(vq), jnp.asarray(ks),
             jnp.asarray(vs), torch.from_numpy(kq), torch.from_numpy(vq),
             torch.from_numpy(ks), torch.from_numpy(vs))):
        want = np.asarray(jax_mxu(jbf(q), jk, jv, jnp.asarray(lens), jks,
                                  jvs, interpret=True), np.float32)
        tq, tl = bf(q), torch.from_numpy(lens)
        m, l, acc = decode_gqa_partials_plain(tq, tk, tv, tl, chunk, splits,
                                              tks, tvs)
        got = decode_gqa_combine_plain(m, l, acc)
        np.testing.assert_allclose(got.float().numpy(), want, atol=2e-2,
                                   err_msg=name)
        # the wrapper takes the kernel's plain version on the CPU
        np.testing.assert_allclose(
            decode_attention_mxu(tq, tk, tv, tl, tks, tvs).float().numpy(),
            want, atol=2e-2)
