"""Port parity: decode attention over the paged block pool (kernel 10's
plain version) against the JAX package's paged Pallas kernel."""

import numpy as np
import jax.numpy as jnp
import torch

from video_llava_tpu.ops.attention import decode_attention_mxu_paged
from video_llava_tpu_torch.ops import attention


def test_paged_plain_matches_jax_paged_kernel():
    """JAX decode_attention_mxu_paged in interpret mode against the
    port's decode_attention_paged on CPU tensors (its plain version),
    bf16 and int8 pools, a shuffled table with the pad block 0 past each
    row's allocation, rows of length 1, 37 (a partial block) and 64 (a
    full table), every layer. Both take bf16 inputs and write bf16; the
    kernel rounds q*scale to bf16 and keeps f32 sums, the plain version
    rounds the probabilities to bf16 (and the int8 values dequantized to
    bf16): a few bf16 ulps of outputs below 2, hence 2e-2, the card's
    tolerance for the kernel against the plain version."""
    rng = np.random.default_rng(8)
    nl, nb, bs, h, d, maxb = 2, 12, 16, 4, 32, 4
    table = np.array([[5, 0, 0, 0], [7, 3, 11, 0], [9, 2, 10, 4]], np.int32)
    lens = np.array([1, 37, 64], np.int32)
    b = table.shape[0]
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
        for li in range(nl):
            want = decode_attention_mxu_paged(
                jbf(q), jk, jv, jnp.int32(li), jnp.asarray(table),
                jnp.asarray(lens), k_scale=jks, v_scale=jvs, interpret=True)
            got = attention.decode_attention_paged(
                bf(q), tk, tv, li, torch.from_numpy(table),
                torch.from_numpy(lens), tks, tvs)
            assert got.dtype == torch.bfloat16 and got.shape == (b, 1, h, d)
            np.testing.assert_allclose(
                got.float().numpy(), np.asarray(want, np.float32),
                atol=2e-2, err_msg=f"{name} layer {li}")
