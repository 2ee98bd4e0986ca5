"""Kernel 11's split of the cache along L (flash-decoding), on the CPU.

On the card, decode_attention_pallas cuts [0, L) by gqa_split_plan, runs
a block per (row, KV head, chunk) that writes the chunk's partial (max,
sum, accumulator), and merges the partials in split order. Here the plan
is checked for cover and parallelism, and the plain versions of the two
kernels (decode_gqa_partials_plain, decode_gqa_combine_plain), run over
that plan, are held against the JAX decode_attention_pallas in interpret
mode.
"""

import numpy as np
import jax.numpy as jnp
import torch

from video_llava_tpu.ops.attention import (
    decode_attention_pallas as jax_decode,
)
from video_llava_tpu_torch.ops.attention import (
    decode_attention_pallas,
    decode_gqa_combine_plain,
    decode_gqa_partials_plain,
    gqa_split_plan,
)

SMS = 132  # an H100's streaming multiprocessors


def _cache(rng, b, L, h_kv, d, int8):
    """(k, v, k_scale, v_scale) as numpy: bf16-representable f32 values,
    or int8 values with (b, L, h_kv, 1) f32 scales."""
    if not int8:
        kv = [torch.from_numpy(rng.normal(size=(b, L, h_kv, d)).astype(
            np.float32)).to(torch.bfloat16).float().numpy()
            for _ in range(2)]
        return kv[0], kv[1], None, None
    k, v = (rng.integers(-127, 128, size=(b, L, h_kv, d)).astype(np.int8)
            for _ in range(2))
    ks, vs = (rng.uniform(0.2, 1.0, size=(b, L, h_kv, 1)).astype(
        np.float32) / 127 for _ in range(2))
    return k, v, ks, vs


def test_gqa_split_plan_covers_and_matches_jax():
    # The plan: [0, L) exactly once, chunks a multiple of 16, and at least
    # 132 blocks wherever chunks of 16 would give that many.
    for L in (1, 15, 16, 833, 2048, 6240, 16384):
        for b in (1, 4):
            for h_kv in (1, 8):
                chunk, splits = gqa_split_plan(L, b, h_kv, SMS)
                assert chunk % 16 == 0 and chunk >= 16, (L, b, h_kv, chunk)
                cover = np.zeros(L, np.int32)
                for c in range(splits):
                    cover[c * chunk:(c + 1) * chunk] += 1
                assert (cover == 1).all(), (L, b, h_kv, chunk, splits)
                assert (splits - 1) * chunk < L <= splits * chunk
                blocks = b * h_kv * splits
                most = b * h_kv * -(-L // 16)
                assert blocks >= min(SMS, most), (L, b, h_kv, blocks)

    # The split math over the plan against the JAX kernel. f32 queries
    # and f32 softmax on both sides, caches exact in both (bf16 values,
    # or int8 with f32 scales); only the order of the f32 sums differs
    # (per chunk, then merged), so 2e-5 on outputs of magnitude < 4.
    rng = np.random.default_rng(11)
    b, h, h_kv, d, L = 4, 8, 2, 32, 512
    for sms in (SMS, 16):  # chunks of 16, and chunks of 128
        chunk, splits = gqa_split_plan(L, b, h_kv, sms)
        assert splits > 1
        lens = np.array([1, chunk, chunk + 1, L], np.int32)
        for int8 in (False, True):
            q = rng.normal(size=(b, 1, h, d)).astype(np.float32)
            k, v, ks, vs = _cache(rng, b, L, h_kv, d, int8)
            want = np.asarray(jax_decode(
                jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                jnp.asarray(lens),
                None if ks is None else jnp.asarray(ks),
                None if vs is None else jnp.asarray(vs), interpret=True))
            tk = torch.from_numpy(k)
            tv = torch.from_numpy(v)
            tks = None if ks is None else torch.from_numpy(ks)
            tvs = None if vs is None else torch.from_numpy(vs)
            tq, tl = torch.from_numpy(q), torch.from_numpy(lens)
            m, l, acc = decode_gqa_partials_plain(tq, tk, tv, tl, chunk,
                                                  splits, tks, tvs)
            # chunks at or past a row's length are empty
            for i, n in enumerate(lens):
                live = -(-int(n) // chunk)
                assert (l[i, :, live:] == 0).all()
                assert (l[i, :, :live] > 0).all()
            got = decode_gqa_combine_plain(m, l, acc, torch.float32)
            np.testing.assert_allclose(got.numpy(), want, atol=2e-5,
                                       rtol=2e-5, err_msg=f"int8 {int8}")
            # the wrapper takes the kernel's plain version on the CPU
            np.testing.assert_allclose(
                decode_attention_pallas(tq, tk, tv, tl, tks,
                                        tvs).numpy(), want,
                atol=2e-5, rtol=2e-5)
