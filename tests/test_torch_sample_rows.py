"""Port parity: the continuous engine's per-row sampling."""

import numpy as np
import jax
import jax.numpy as jnp
import torch

from video_llava_tpu.config import GenerationConfig
from video_llava_tpu.engine.continuous import _sample_rows as jax_sample
from video_llava_tpu.engine.generate import process_logits
from video_llava_tpu_torch.engine.continuous import (
    _sample_rows,
    _top_p_masked,
)


def test_sample_rows_greedy_rows_keep_mask_and_replay():
    """(6, 300) f32 logits, rows at temperatures 0 (greedy), 0.2, 0.7,
    1.0, 1.3 and 0, top-p 1.0, 0.5, 0.9, 0.95, 0.8 and 1.0. Greedy rows
    take the JAX _sample_rows token exactly. Each sampled row's keep set
    (finite entries of the port's top-p mask) equals the JAX package's
    (process_logits, the formula _sample_rows applies per row), and 64
    JAX draws with different keys all fall inside it. A row's draws come
    from its own generator only: a seeded row gives the same 16 tokens
    alone and beside other sampling rows."""
    rng = np.random.default_rng(0)
    logits = rng.normal(size=(6, 300)).astype(np.float32) * 3
    temps = [0.0, 0.2, 0.7, 1.0, 1.3, 0.0]
    top_ps = [1.0, 0.5, 0.9, 0.95, 0.8, 1.0]
    gens = [torch.Generator().manual_seed(i) for i in range(6)]
    got = _sample_rows(torch.from_numpy(logits), gens, temps, top_ps)
    keep = torch.isfinite(_top_p_masked(torch.from_numpy(logits), temps,
                                        top_ps)).numpy()
    sample = jax.jit(jax_sample)
    draws = np.stack([np.asarray(sample(
        jnp.asarray(logits), jax.random.split(jax.random.PRNGKey(s), 6),
        jnp.asarray(temps), jnp.asarray(top_ps))) for s in range(64)])
    for i, t in enumerate(temps):
        if t <= 0:
            assert int(got[i]) == int(draws[0, i]) == logits[i].argmax()
            continue
        want = np.isfinite(np.asarray(process_logits(
            jnp.asarray(logits[i]),
            GenerationConfig(temperature=t, top_p=top_ps[i]))))
        np.testing.assert_array_equal(keep[i], want)
        assert keep[i, draws[:, i]].all() and keep[i, int(got[i])]
        assert 1 < want.sum() < 300  # the mask cut something

    def draws_of(row_logits, companions):
        x = torch.from_numpy(np.concatenate([row_logits[None],
                                             companions]))
        g = [torch.Generator().manual_seed(7)] + [
            torch.Generator().manual_seed(100 + j)
            for j in range(len(companions))]
        n = len(companions) + 1
        return [int(_sample_rows(x, g, [0.9] * n, [0.9] * n)[0])
                for _ in range(16)]

    alone = draws_of(logits[2], logits[:0])
    assert alone == draws_of(logits[2], logits[3:])
    assert len(set(alone)) > 1
