"""Kernels 3 and 9's split body, on the CPU.

Every MHA decode, flat (kernel 9) or a layer of the stacked cache
(kernel 3), runs one body on the card: the row's positions split into
chunks by ``mha_split_plan``, a block per (row, head, chunk) writing an
f32 partial, the last block of a (row, head) merging them in split order
in the same launch. Here the plan is held at the chat and serving
shapes, and the plain versions of the split kernel and its merge at one
head a group (G = 1), over the wrapper's plan, are held against the JAX
decode_attention_mxu in interpret mode.
"""

import numpy as np
import jax.numpy as jnp
import torch

from video_llava_tpu.ops.attention import decode_attention_mxu as jax_mxu
from video_llava_tpu_torch.ops.attention import (
    MHA_SPLITS_MAX,
    decode_attention_mxu,
    decode_gqa_combine_plain,
    decode_gqa_partials_plain,
    mha_split_plan,
)

SMS = 132  # an H100's streaming multiprocessors


def test_long_mha_cache_takes_the_split_body():
    # the plan at the 7B chat's first-turn cache (one row of 832, 32
    # heads), at the serving rows (4 rows of 2,048) and at 65,536
    # positions; a single head of a long cache stops at MHA_SPLITS_MAX
    assert mha_split_plan(832, 1, 32, SMS) == (64, 13)
    assert mha_split_plan(2048, 4, 32, SMS) == (416, 5)
    assert mha_split_plan(65536, 2, 32, SMS) == (7296, 9)
    assert mha_split_plan(65536, 1, 1, SMS) == (512, MHA_SPLITS_MAX)
    for L, b, h in ((832, 1, 32), (2048, 4, 32), (37, 2, 4), (1, 1, 8),
                    (65536, 1, 1), (100000, 1, 2)):
        chunk, splits = mha_split_plan(L, b, h, SMS)
        assert chunk % 16 == 0 and splits <= MHA_SPLITS_MAX
        assert (splits - 1) * chunk < L <= splits * chunk

    # the split math at G = 1 against the JAX MHA kernel, bf16 and int8
    # caches, rows that end in the first chunk, on a chunk's edge and at
    # the cache's end. The JAX kernel rounds q * scale and the weights to
    # bf16, the split keeps f32: a few bf16 ulps of outputs below 2, 2e-2.
    rng = np.random.default_rng(5)
    b, h, d, L = 3, 4, 64, 256
    chunk, splits = mha_split_plan(L, b, h, SMS)
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
