"""The learned half of scripts/tracking_quality.py against the JAX
package's, at one XMem network's parameters (tests/torch_xmem_pair.py:
the JAX tree drawn from a seed, carried into the port by
engine/convert.xmem_from_jax) with the script's configuration
(max_objects 2, mem_slots 3, top_k 8): evaluate_tracker through
LearnedMemoryTracker and evaluate_tracker_fused through the fused
dispatch (and the handcrafted STM's fused run), each kind's J and F
within 1e-3 of the JAX package's, on one clip a kind of 4 frames; the
brief training's loss on two training pairs within 1e-4 relative of
the JAX script's own loss_fn (captured from brief_train_xmem, whose
first traced step hands it to jax.value_and_grad), and its gradients
finite and not all zero, their global norm within 1e-3 relative of
jax.grad's."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_xmem_pair import one_torch_thread, xmem_pair
from video_llava_tpu.grounding.memory_tracker import (
    LearnedMemoryTracker as JLearned,
)
from video_llava_tpu.models import xmem as jx
from video_llava_tpu.scripts import tracking_quality as jtq
from video_llava_tpu_torch.grounding.memory_tracker import (
    LearnedMemoryTracker,
)
from video_llava_tpu_torch.scripts import tracking_quality as ttq

CFG = dict(max_objects=2, mem_slots=3, top_k=8)


class _Captured(Exception):
    pass


def jax_loss_fn(jp, jcfg, monkeypatch):
    """The JAX script's loss_fn(params, f0, m0, f1, m1): brief_train_xmem
    is run with xmem.init_params answering `jp` and jax.jit calling its
    function as it is, and stopped at its first step, where
    jax.value_and_grad receives the loss."""
    got = {}

    def capture(fn, *a, **kw):
        got["loss_fn"] = fn
        raise _Captured

    monkeypatch.setattr(jx, "init_params", lambda *a, **kw: jp)
    monkeypatch.setattr(jax, "value_and_grad", capture)
    monkeypatch.setattr(jax, "jit", lambda fn, **kw: fn)
    with pytest.raises(_Captured):
        jtq.brief_train_xmem(jcfg, jtq.make_clips(0, 1, 2), steps=1)
    monkeypatch.undo()
    return got["loss_fn"]


def _close(got, want, tol):
    assert list(got) == list(want)
    for kind in want:
        for k in ("J", "F"):
            assert abs(got[kind][k] - want[kind][k]) <= tol, (kind, k)


@one_torch_thread()
def test_tracking_learned_and_loss_match_jax(monkeypatch):
    (jp, jcfg), (tp, tcfg), _ = xmem_pair(**CFG)
    clips = ttq.make_clips(1000, 1, 4)

    want = jtq.evaluate_tracker(lambda: JLearned(jp, jcfg), clips)
    got = ttq.evaluate_tracker(lambda: LearnedMemoryTracker(tp, tcfg), clips)
    _close(got, want, 1e-3)
    want_f = jtq.evaluate_tracker_fused(lambda: JLearned(jp, jcfg), clips)
    got_f = ttq.evaluate_tracker_fused(
        lambda: LearnedMemoryTracker(tp, tcfg), clips)
    _close(got_f, want_f, 1e-3)
    _close(got_f, got, 1e-3)
    _close(ttq.evaluate_tracker_fused(lambda: None, clips, device="cpu"),
           jtq.evaluate_tracker_fused(lambda: None, clips), 1e-3)

    loss_and_grad = jax.jit(jax.value_and_grad(jax_loss_fn(jp, jcfg,
                                                           monkeypatch)))
    train = ttq.make_clips(0, 1, 3)
    leaves = ttq.trainable_leaves(tp)
    for kind in ("translation", "appearance_change"):
        frames, gts = train[kind][0]
        pair = (frames[0], gts[0], frames[2], gts[2])
        want_loss, want_grads = loss_and_grad(jp, *map(jnp.asarray, pair))
        loss = ttq.loss_fn(tp, tcfg, *(torch.from_numpy(a) for a in pair))
        assert abs(loss.item() - float(want_loss)) <= 1e-4 * abs(
            float(want_loss)), kind
        loss.backward()
        # leaves the loss does not reach (the decoder's hidden update)
        # have no gradient, where jax.grad gives zeros
        grads = [p.grad for p in leaves if p.grad is not None]
        assert all(torch.isfinite(g).all() for g in grads)
        norm = torch.sqrt(sum((g.double() ** 2).sum() for g in grads)).item()
        want_norm = float(np.sqrt(sum(
            (np.asarray(g, np.float64) ** 2).sum()
            for g in jax.tree.leaves(want_grads))))
        assert norm > 0 and abs(norm - want_norm) <= 1e-3 * want_norm, kind
        for p in leaves:
            p.grad = None
    for p in leaves:
        p.requires_grad_(False)
