"""An XMem session with the long-term store on, port against the JAX
package: a 12-frame session of seeded 64 x 96 frames (the reference
write of frame 0 with 2 live objects of 3 slots, then frames 1-11 in
chunks of 4, the last padded by repetition, every frame writing memory
and every other one with the deep update) over a ring of 3 slots, so the
ring evicts and consolidates its most-used elements into a long-term
store of 16 (8 a slot). add_reference_step + propagate_chunk agree with
the JAX package's: the probabilities within 1e-4, the slot and long-term
cursors exactly, memory and usage within 1e-4 of their scale. The port's
own propagate_chunk (unpadded) agrees with frame-by-frame propagate_step
within 1e-4 too."""

import numpy as np
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

CHUNKS = ((1, 5), (5, 9), (9, 12))


def _close(got, want, tol=1e-4):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = np.abs(got - want).max() / max(np.abs(want).max(), 1e-12)
    assert err < tol, err


def _flags(a, b, pad):
    upd = [True] * (b - a) + [False] * pad
    deep = [t % 2 == 0 for t in range(a, b)] + [False] * pad
    return upd, deep, [True] * (b - a) + [False] * pad


@one_torch_thread()
def test_xmem_session_with_long_term_store():
    kw = dict(max_objects=3, mem_slots=3, lt_slots=16, lt_prototypes=8)
    (jp, jcfg), (tp, tcfg), _ = xmem_pair(**kw)
    fr = frames(12, seed=7)
    masks = np.zeros((3, H, W), np.uint8)
    masks[0, 10:40, 8:50] = 1
    masks[1, 30:60, 50:90] = 1

    js = jx.init_state(jcfg, H // 16, W // 16)
    js = jx.add_reference_step(jp, js, jnp.asarray(fr[0]),
                               jnp.asarray(masks), jnp.int32(2), jcfg)
    ts = tx.init_state(tcfg, H // 16, W // 16)
    ts = tx.add_reference_step(tp, ts, torch.from_numpy(fr[0]),
                               torch.from_numpy(masks), 2, tcfg)
    for a, b in CHUNKS:
        pad = 4 - (b - a)
        upd, deep, valid = _flags(a, b, pad)
        chunk = np.concatenate([fr[a:b]] + [fr[b - 1:b]] * pad)
        jprob, js = jx.propagate_chunk(
            jp, js, jnp.asarray(chunk), jnp.asarray(upd), jnp.asarray(deep),
            jcfg, valid=jnp.asarray(valid))
        tprob, ts = tx.propagate_chunk(tp, ts, torch.from_numpy(chunk), upd,
                                       deep, tcfg, valid=valid)
        _close(tprob[:b - a], np.asarray(jprob)[:b - a])
    assert int(js.lt_next) > 0  # the ring evicted and consolidated
    assert ts.next_slot == int(js.next_slot) == 12
    assert ts.lt_next == int(js.lt_next)
    assert ts.num_objects == int(js.num_objects) == 2
    np.testing.assert_array_equal(ts.lt_valid.numpy(), np.asarray(js.lt_valid))
    np.testing.assert_array_equal(ts.slot_valid.numpy(),
                                  np.asarray(js.slot_valid))
    for name in ("keys", "shrinkage", "values", "usage", "lt_keys",
                 "lt_shrinkage", "lt_values"):
        _close(getattr(ts, name), getattr(js, name))
    _close(ts.hidden, nchw(js.hidden))

    # the port's chunk against its own frame-by-frame steps
    runs = []
    for chunked in (True, False):
        s = tx.init_state(tcfg, H // 16, W // 16)
        s = tx.add_reference_step(tp, s, torch.from_numpy(fr[0]),
                                  torch.from_numpy(masks), 2, tcfg)
        probs = []
        for a, b in CHUNKS:
            upd, deep, _ = _flags(a, b, 0)
            if chunked:
                p, s = tx.propagate_chunk(tp, s, torch.from_numpy(fr[a:b]),
                                          upd, deep, tcfg)
                probs.extend(p)
            else:
                for t in range(a, b):
                    p, s = tx.propagate_step(tp, s, torch.from_numpy(fr[t]),
                                             tcfg, update_memory=True,
                                             deep_update=deep[t - a])
                    probs.append(p)
        runs.append((torch.stack(probs), s))
    (pc, sc), (ps, ss) = runs
    _close(pc, ps)
    assert (sc.next_slot, sc.lt_next) == (ss.next_slot, ss.lt_next)
    for name in ("values", "usage", "lt_values", "hidden"):
        _close(getattr(sc, name), getattr(ss, name))
