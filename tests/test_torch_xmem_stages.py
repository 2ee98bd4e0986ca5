"""models/xmem.py's stages against the JAX package's on carried-across
parameters (tests/torch_xmem_pair.py: seeded weights, BN statistics away
from the identity) and seeded 64 x 96 frames, f32: the key encoder, the
value encoder with its deep GRU update, the memory read (anisotropic
similarity, top-k softmax, 3 objects over 3 valid slots of 4 and a
masked one) and the decoder with its hidden update. Each output agrees
within 1e-5 of its scale (convolutions and products summed in another
order), the read's top-k indices exactly."""

import numpy as np
import jax
import jax.numpy as jnp
import torch

from torch_xmem_pair import (
    H,
    W,
    frames,
    jx,
    nchw,
    one_torch_thread,
    tx,
    xmem_pair,
)


def _close(got, want, tol=1e-5):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = np.abs(got - want).max() / max(np.abs(want).max(), 1e-12)
    assert err < tol, err


@one_torch_thread()
def test_xmem_stages_match_jax():
    (jp, jcfg), (tp, tcfg), _ = xmem_pair(max_objects=3)
    fr = frames(2)
    rng = np.random.default_rng(5)

    encode_key = jax.jit(jx.encode_key)
    jk = encode_key(jp, jnp.asarray(fr[0]))
    tk = tx.encode_key(tp, torch.from_numpy(fr[0]))
    for g, w in zip(tk, jk):
        _close(g, nchw(w) if np.ndim(w) == 3 else w)

    masks = (rng.random((3, H, W)) > 0.6).astype(np.float32)
    hidden = rng.normal(size=(3, 4, 6, jcfg.hidden_dim)).astype(np.float32)
    jv, jh = jx.encode_value(jp, jnp.asarray(fr[0]), jk[0],
                             jnp.asarray(hidden), jnp.asarray(masks))
    tv, th = tx.encode_value(tp, torch.from_numpy(fr[0]), tk[0],
                             torch.from_numpy(nchw(hidden).copy()),
                             torch.from_numpy(masks))
    _close(tv, nchw(jv))
    _close(th, nchw(jh))

    # the read: 4 slots of 24 elements, the last slot invalid
    n, ck, cv = 24, jcfg.key_dim, 16
    mk = rng.normal(size=(4 * n, ck)).astype(np.float32)
    ms = rng.uniform(1, 3, 4 * n).astype(np.float32)
    mv = rng.normal(size=(4 * n, 3, cv)).astype(np.float32)
    valid = np.repeat([True, True, True, False], n)
    qk = rng.normal(size=(n, ck)).astype(np.float32)
    qe = rng.uniform(0, 1, (n, ck)).astype(np.float32)
    jr, (jidx, jatt) = jx.read_memory(
        *map(jnp.asarray, (mk, ms, mv, valid, qk, qe)), 8,
        return_attention=True)
    tr, (tidx, tatt) = tx.read_memory(
        *map(torch.from_numpy, (mk, ms, mv, valid, qk, qe)), 8,
        return_attention=True)
    np.testing.assert_array_equal(tidx.numpy(), np.asarray(jidx))
    assert (tidx.numpy() < 3 * n).all()  # never the invalid slot
    _close(tatt, jatt)
    _close(tr, jr)

    # the decoder on the second frame with the first's memory readout
    jk2 = encode_key(jp, jnp.asarray(fr[1]))
    tk2 = tx.encode_key(tp, torch.from_numpy(fr[1]))
    readout = rng.normal(size=(3, 4, 6, jcfg.value_dim)).astype(np.float32)
    jl, jh2 = jx.decode(jp, jk2[0], jk2[1], jk2[2], jnp.asarray(hidden),
                        jnp.asarray(readout))
    tl, th2 = tx.decode(tp, tk2[0], tk2[1], tk2[2],
                        torch.from_numpy(nchw(hidden).copy()),
                        torch.from_numpy(nchw(readout).copy()))
    assert tl.shape == (3, H, W)
    _close(tl, jl)
    _close(th2, nchw(jh2))
    _close(tx.aggregate(torch.sigmoid(tl)), jx.aggregate(jax_sigmoid(jl)))


def jax_sigmoid(x):
    return 1.0 / (1.0 + jnp.exp(-x))
