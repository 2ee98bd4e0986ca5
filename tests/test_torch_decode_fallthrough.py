"""Port parity: the stacked and paged decode wrappers with a grouped-query
cache (8 query heads over 2 KV heads), whose kernels 3 and 10 are MHA
only, fall through to the flat decode dispatch as the JAX package's do
(ops/attention.py:1335-1340, :1478-1492): the stacked cache as the
layer's view, the paged pool gathered into each row's dense view. Under
each set_default_impl and with enable_paged_kernel off and on, against
the JAX wrappers in 'auto', their XLA path on the CPU; under 'pallas'
(kernel 11's plain version here) against JAX's kernel 11 in interpret
mode on the same flat view, since the XLA path rounds the softmax
weights to a bf16 cache's dtype and kernel 11 does not.
"""

import numpy as np
import jax.numpy as jnp
import torch

from video_llava_tpu.models.llama import _quantize_kv as jax_quantize_kv
from video_llava_tpu.ops import attention as jax_attention
from video_llava_tpu_torch.ops import attention

# f32 queries and an f32 softmax on both sides, the same bf16 or int8
# cache values: f32 sums in another order, as JAX's own
# tests/test_decode_attention_pallas.py holds its kernel.
ATOL = 3e-5


def _flat(a, li, table):
    """JAX side: layer li of a stacked cache, or of a pool gathered into
    each row's dense view (table given)."""
    a = a[li]
    if table is not None:
        a = a[table].reshape((table.shape[0], -1) + a.shape[2:])
    return a


def _port_outputs(call):
    """call() under every (impl, paged kernel) setting, switches restored."""
    outs = {}
    try:
        for impl in ("auto", "pallas", "xla"):
            for paged in (False, True):
                attention.set_default_impl(impl)
                attention.enable_paged_kernel(paged)
                outs[impl, paged] = call().numpy()
    finally:
        attention.set_default_impl("auto")
        attention.enable_paged_kernel(True)
    return outs


def test_gqa_decode_falls_through_as_jax():
    rng = np.random.default_rng(3)
    nl, b, h, h_kv, d = 2, 2, 8, 2, 32
    L, nb, bs, maxb = 48, 7, 16, 3
    lens = np.array([29, 48], np.int32)
    q = rng.normal(size=(b, 1, h, d)).astype(np.float32)
    table = np.array([[4, 1, 6], [2, 5, 3]], np.int32)
    jq, jlens, jtable = jnp.asarray(q), jnp.asarray(lens), jnp.asarray(table)
    tq, tlens = torch.from_numpy(q), torch.from_numpy(lens)
    ttable = torch.from_numpy(table)
    for shape, paged in (((nl, b, L, h_kv, d), False),
                         ((nl, nb, bs, h_kv, d), True)):
        k = rng.normal(size=shape).astype(np.float32)
        v = rng.normal(size=shape).astype(np.float32)
        for int8 in (False, True):
            if int8:
                jk, jks = jax_quantize_kv(jnp.asarray(k))
                jv, jvs = jax_quantize_kv(jnp.asarray(v))
                tk, tv, tks, tvs = (torch.from_numpy(np.array(a))
                                    for a in (jk, jv, jks, jvs))
            else:
                jk, jv = (jnp.asarray(a, jnp.bfloat16) for a in (k, v))
                tk, tv = (torch.from_numpy(a).to(torch.bfloat16)
                          for a in (k, v))
                jks = jvs = tks = tvs = None
            for li in range(nl):
                if paged:
                    want = jax_attention.decode_attention_paged(
                        jq, jk, jv, jnp.int32(li), jtable, jlens,
                        k_scale=jks, v_scale=jvs)
                    call = lambda: attention.decode_attention_paged(  # noqa
                        tq, tk, tv, li, ttable, tlens, tks, tvs)
                else:
                    want = jax_attention.decode_attention_stacked(
                        jq, jk, jv, jnp.int32(li), jlens, k_scale=jks,
                        v_scale=jvs)
                    call = lambda: attention.decode_attention_stacked(  # noqa
                        tq, tk, tv, li, tlens, tks, tvs)
                flat = lambda a: None if a is None else _flat(  # noqa
                    a, li, jtable if paged else None)
                unit = lambda a: None if a is None else flat(a)[..., None]  # noqa
                want11 = jax_attention.decode_attention_pallas(
                    jq, flat(jk), flat(jv), jlens, k_scale=unit(jks),
                    v_scale=unit(jvs), interpret=True)
                for setting, got in _port_outputs(call).items():
                    np.testing.assert_allclose(
                        got, np.asarray(want11 if setting[0] == "pallas"
                                        else want), atol=ATOL, rtol=0,
                        err_msg=f"paged {paged} int8 {int8} layer {li} "
                        f"{setting}")
