"""Kernel 10's split along the block table (flash-decoding), on the CPU.

On the card, decode_attention_paged cuts each row's [0, maxb * bs) by
paged_split_plan into chunks of whole pool blocks, runs a block per (row,
head, chunk) that looks its chunk's blocks up in the table once and
writes the chunk's partial (max, sum, accumulator), and merges the
partials in split order. Here the plan is checked for cover, and the
plain versions of the two kernels (decode_paged_partials_plain,
decode_gqa_combine_plain), run over that plan, are held against the JAX
decode_attention_mxu_paged in interpret mode.
"""

import numpy as np
import jax.numpy as jnp
import torch

from video_llava_tpu.ops.attention import decode_attention_mxu_paged
from video_llava_tpu_torch.ops.attention import (
    PAGED_TABLE_MAX,
    decode_attention_paged,
    decode_gqa_combine_plain,
    decode_paged_partials_plain,
    paged_split_plan,
)

SMS = 132  # an H100's streaming multiprocessors


def _table(rng, lens, bs, maxb, nb):
    """Each row's blocks drawn without replacement from a shuffled pool
    of blocks 1..nb-1, the pad block 0 past its allocation."""
    perm = list(rng.permutation(nb - 1) + 1)
    table = np.zeros((len(lens), maxb), np.int32)
    for i, n in enumerate(lens):
        used = -(-int(n) // bs)
        table[i, :used] = perm[:used]
        perm = perm[used:]
    return table


def test_paged_split_plan_covers_and_matches_jax():
    # The plan: [0, maxb * bs) exactly once, in chunks of whole pool
    # blocks, no chunk past the table entries a block stages.
    for maxb, bs in ((1, 16), (32, 64), (4, 128), (1024, 64), (7, 48),
                     (4096, 16)):
        for b, h in ((1, 32), (4, 32), (4, 8)):
            for sms in (SMS, 1, 16, 8 * SMS):
                L = maxb * bs
                chunk, splits = paged_split_plan(maxb, bs, b, h, sms)
                assert chunk % bs == 0 and chunk >= bs, (maxb, bs, chunk)
                assert chunk // bs <= PAGED_TABLE_MAX
                cover = np.zeros(L, np.int32)
                for c in range(splits):
                    cover[c * chunk:(c + 1) * chunk] += 1
                assert (cover == 1).all(), (maxb, bs, b, h, sms, chunk)
                assert (splits - 1) * chunk < L <= splits * chunk

    # The split math over the plan against the JAX kernel, bf16 and int8
    # pools, a shuffled table with the pad block 0 past each allocation,
    # rows of length 0, 1, a partial block, a chunk's edge and the full
    # table. Both take bf16 inputs; the JAX kernel rounds q * scale and
    # the weights to bf16 for its products, the plain split keeps f32: a
    # few bf16 ulps of outputs below 2, hence 2e-2, the card's tolerance
    # for kernel 10 against its plain version.
    rng = np.random.default_rng(9)
    nl, bs, maxb, h, d = 2, 16, 8, 4, 32
    for sms in (SMS, 6):  # chunks of one block, and of two
        chunk, splits = paged_split_plan(maxb, bs, 3, h, sms)
        assert splits > 1 and chunk in (bs, 2 * bs)
        lens = np.array([0, 1, 37, chunk, maxb * bs], np.int32)
        b = len(lens)
        nb = 1 + sum(-(-int(n) // bs) for n in lens)
        table = _table(rng, lens, bs, maxb, nb)
        q = rng.normal(size=(b, 1, h, d)).astype(np.float32)
        pk = rng.normal(size=(nl, nb, bs, h, d)).astype(np.float32)
        pv = rng.normal(size=(nl, nb, bs, h, d)).astype(np.float32)
        ks = np.abs(pk).max(-1) / 127.0 + 1e-8
        vs = np.abs(pv).max(-1) / 127.0 + 1e-8
        kq = np.clip(np.round(pk / ks[..., None]), -127, 127).astype(np.int8)
        vq = np.clip(np.round(pv / vs[..., None]), -127, 127).astype(np.int8)
        bf = lambda a: torch.from_numpy(a).to(torch.bfloat16)  # noqa: E731
        jbf = lambda a: jnp.asarray(a, jnp.bfloat16)  # noqa: E731
        for name, jk, jv, jks, jvs, tk, tv, tks, tvs in (
                ("bf16", jbf(pk), jbf(pv), None, None, bf(pk), bf(pv), None,
                 None),
                ("int8", jnp.asarray(kq), jnp.asarray(vq), jnp.asarray(ks),
                 jnp.asarray(vs), torch.from_numpy(kq), torch.from_numpy(vq),
                 torch.from_numpy(ks), torch.from_numpy(vs))):
            want = np.asarray(decode_attention_mxu_paged(
                jbf(q), jk, jv, jnp.int32(1), jnp.asarray(table),
                jnp.asarray(lens), k_scale=jks, v_scale=jvs,
                interpret=True), np.float32)
            tq, tt, tl = bf(q), torch.from_numpy(table), torch.from_numpy(lens)
            m, l, acc = decode_paged_partials_plain(
                tq, tk, tv, 1, tt, tl, chunk, splits, tks, tvs)
            # chunks at or past a row's length are empty, the others not
            for i, n in enumerate(lens):
                live = -(-int(n) // chunk)
                assert (l[i, :, live:] == 0).all(), (name, i)
                assert (l[i, :, :live] > 0).all(), (name, i)
            got = decode_gqa_combine_plain(m, l, acc)
            assert got.dtype == torch.bfloat16 and got.shape == (b, 1, h, d)
            np.testing.assert_allclose(got.float().numpy(), want, atol=2e-2,
                                       err_msg=f"{name} chunk {chunk}")
            assert not got[0].any()  # the empty row is 0
            # the wrapper takes its plain version on the CPU (the JAX
            # package's XLA path, which at length 0 averages every value
            # where the kernels write 0; a decode row is never empty)
            np.testing.assert_allclose(
                decode_attention_paged(tq, tk, tv, 1, tt, tl, tks, tvs)[1:]
                .float().numpy(), want[1:], atol=2e-2)
