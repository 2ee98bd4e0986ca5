"""The brief XMem training's optimizer in scripts/tracking_quality.py
against the JAX script's optax chain (clip_by_global_norm(1.0), then
adam under warmup_cosine_decay_schedule(0, lr, min(20, max(steps // 5,
1)), max(steps, 2))): the schedule's rate at every count within 1e-6
relative of optax's for 1, 5, 40 and 150 steps, then 5 steps of
trainable_leaves / make_optimizer / optimizer_step on a small seeded
tree under a quadratic loss (gradient norms above 1, where the clip
acts, and below it) within 1e-6 of optax.apply_updates on the same
tree."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import torch

from video_llava_tpu_torch.scripts import tracking_quality as ttq


def test_tracking_optimizer_matches_optax():
    for steps in (1, 5, 40, 150):
        want = optax.warmup_cosine_decay_schedule(
            0.0, 1e-4, warmup_steps=min(20, max(steps // 5, 1)),
            decay_steps=max(steps, 2))
        got = ttq.warmup_cosine(1e-4, steps)
        for count in range(steps + 3):
            w = float(want(count))
            # optax's schedule is f32: 1e-6 of the peak rate
            assert abs(got(count) - w) <= 1e-6 * 1e-4, (steps, count)
    assert ttq.warmup_cosine(1e-4, 5)(0) == 0.0

    rng = np.random.default_rng(0)
    tree = {"a": {"weight": rng.normal(size=(3, 4)).astype(np.float32),
                  "bias": rng.normal(size=(4,)).astype(np.float32)},
            "b": [rng.normal(size=(5,)).astype(np.float32)],
            "count": np.arange(3)}  # not a float: not trained
    scale = {"a": {"weight": rng.uniform(0.1, 2, (3, 4)).astype(np.float32),
                   "bias": rng.uniform(0.1, 2, (4,)).astype(np.float32)},
             "b": [rng.uniform(0.1, 2, (5,)).astype(np.float32)]}
    lr, steps = 0.05, 5

    def jloss(p, k):
        # the gradient shrinks by 8 each step: above 1 and then below
        return sum(jnp.sum(s * (x - 0.3) ** 2) * 8.0 ** -k for x, s in zip(
            jax.tree.leaves(p), jax.tree.leaves(scale)))

    sched = optax.warmup_cosine_decay_schedule(
        0.0, lr, warmup_steps=min(20, max(steps // 5, 1)),
        decay_steps=max(steps, 2))
    tx = optax.chain(optax.clip_by_global_norm(1.0), optax.adam(sched))
    jp = jax.tree.map(jnp.asarray, {k: v for k, v in tree.items()
                                    if k != "count"})
    opt_state = tx.init(jp)
    norms = []
    for k in range(steps):
        grads = jax.grad(jloss)(jp, k)
        norms.append(float(optax.global_norm(grads)))
        updates, opt_state = tx.update(grads, opt_state)
        jp = optax.apply_updates(jp, updates)
    assert norms[0] > 1.0 > norms[-1]

    tp = {"a": {"weight": torch.tensor(tree["a"]["weight"]),
                "bias": torch.tensor(tree["a"]["bias"])},
          "b": [torch.tensor(tree["b"][0])],
          "count": torch.from_numpy(tree["count"])}
    leaves = ttq.trainable_leaves(tp)
    assert all(x is y for x, y in zip(leaves, (tp["a"]["weight"],
                                               tp["a"]["bias"], tp["b"][0])))
    assert len(leaves) == 3 and not tp["count"].requires_grad
    tscale = [torch.from_numpy(x) for x in (
        scale["a"]["weight"], scale["a"]["bias"], scale["b"][0])]
    opt, schedule = ttq.make_optimizer(leaves, lr, steps)
    for k in range(steps):
        loss = sum((s * (x - 0.3) ** 2).sum() * 8.0 ** -k
                   for x, s in zip(leaves, tscale))
        loss.backward()
        ttq.optimizer_step(opt, schedule, leaves, k)
        assert all(p.grad is None for p in leaves)
    for got, want, start in (
            (tp["a"]["weight"], jp["a"]["weight"], tree["a"]["weight"]),
            (tp["a"]["bias"], jp["a"]["bias"], tree["a"]["bias"]),
            (tp["b"][0], jp["b"][0], tree["b"][0])):
        assert got.shape == want.shape
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                   rtol=0, atol=1e-6)
        assert np.abs(np.asarray(want) - start).max() > 1e-2
