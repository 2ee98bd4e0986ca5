"""Port parity: decode attention over a flat per-layer (b, L, h_kv, d)
cache -- kernel 9 (decode_attention_mxu, MHA), kernel 11
(decode_attention_pallas, grouped query heads) and the flat dispatch
decode_attention under each set_default_impl.

The JAX side runs its Pallas kernels in interpret mode; the port's side
is the plain versions its CUDA kernels are held to on the card.
"""

import numpy as np
import jax.numpy as jnp
import torch

from video_llava_tpu.models.llama import _quantize_kv as jax_quantize_kv
from video_llava_tpu.ops import attention as jax_attention
from video_llava_tpu_torch.ops import attention

# f32 inputs, as JAX's own tests/test_decode_attention_pallas.py. Kernel
# 11 and the reference are f32 throughout on both sides; kernel 9 rounds
# q * scale, the cache and the softmax weights to bf16 at the same places
# on both sides (L is one JAX block here, so its online softmax is the
# two-pass one). Only the order of f32 sums differs.
ATOL = 3e-5


def _case(rng, b, L, h, h_kv, d, int8):
    """numpy q, cache, scales ((b, L, h_kv, 1) or None), lengths."""
    q = rng.normal(size=(b, 1, h, d)).astype(np.float32)
    k = rng.normal(size=(b, L, h_kv, d)).astype(np.float32)
    v = rng.normal(size=(b, L, h_kv, d)).astype(np.float32)
    lens = np.array([L // 2 + 3, L], np.int32)[:b]
    if not int8:
        bf = lambda a: np.array(  # noqa: E731
            jnp.asarray(a, jnp.bfloat16).astype(jnp.float32))
        return q, bf(k), bf(v), None, None, lens
    kq, ks = (np.array(a) for a in jax_quantize_kv(jnp.asarray(k)))
    vq, vs = (np.array(a) for a in jax_quantize_kv(jnp.asarray(v)))
    return q, kq, vq, ks[..., None], vs[..., None], lens


def test_flat_decode_matches_jax_kernels():
    """MHA 4/4 and GQA 8/2 at d 32 and 64, bf16-valued and int8 caches,
    L 64 with two row lengths (35 and 64)."""
    rng = np.random.default_rng(0)
    L = 64
    for h, h_kv in ((4, 4), (8, 2)):
        for d in (32, 64):
            for int8 in (False, True):
                case = _case(rng, 2, L, h, h_kv, d, int8)
                j = [None if a is None else jnp.asarray(a) for a in case]
                t = [None if a is None else torch.from_numpy(a)
                     for a in case]
                tag = f"h {h}/{h_kv} d {d} int8 {int8} L {L}"
                jargs = dict(k_scale=j[3], v_scale=j[4], interpret=True)
                targs = dict(k_scale=t[3], v_scale=t[4])
                want11 = np.asarray(jax_attention.decode_attention_pallas(
                    j[0], j[1], j[2], j[5], **jargs))
                got11 = attention.decode_attention_pallas_plain(
                    t[0], t[1], t[2], t[5], **targs).numpy()
                np.testing.assert_allclose(got11, want11, atol=ATOL,
                                           rtol=0, err_msg=tag)
                np.testing.assert_array_equal(
                    attention.decode_attention_pallas(
                        t[0], t[1], t[2], t[5], **targs).numpy(), got11)
                if h == h_kv:
                    want9 = np.asarray(jax_attention.decode_attention_mxu(
                        j[0], j[1], j[2], j[5], **jargs))
                    got9 = attention.decode_attention_mxu_plain(
                        t[0], t[1], t[2], t[5], **targs).numpy()
                    np.testing.assert_allclose(got9, want9, atol=ATOL,
                                               rtol=0, err_msg=tag)
                    np.testing.assert_array_equal(
                        attention.decode_attention_mxu(
                            t[0], t[1], t[2], t[5], **targs).numpy(),
                        got9)
                # the dispatch: 'pallas' takes kernel 9 for MHA (h*d a
                # multiple of 128, L of 16) and kernel 11 otherwise;
                # 'auto' and 'xla' on the CPU the reference, as JAX's
                # 'auto' on the CPU
                want = np.asarray(jax_attention.decode_attention(
                    j[0], j[1], j[2], j[5], k_scale=j[3], v_scale=j[4]))
                try:
                    for impl in ("pallas", "auto", "xla"):
                        attention.set_default_impl(impl)
                        got = attention.decode_attention(
                            t[0], t[1], t[2], t[5], **targs).numpy()
                        if impl == "pallas":
                            np.testing.assert_array_equal(
                                got, got9 if h == h_kv else got11)
                        else:
                            np.testing.assert_allclose(
                                got, want, atol=ATOL, rtol=0,
                                err_msg=f"{tag} {impl}")
                finally:
                    attention.set_default_impl("auto")
