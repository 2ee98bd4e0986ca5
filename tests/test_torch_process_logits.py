"""Port parity: temperature and top-p logits processing."""

import numpy as np
import jax.numpy as jnp
import torch

from video_llava_tpu.config import GenerationConfig


def test_process_logits_matches_jax():
    """Temperature + top-p masking: the same kept set and values."""
    from video_llava_tpu.engine.generate import process_logits as jax_pl
    from video_llava_tpu_torch.engine.generate import process_logits

    logits = np.random.default_rng(4).normal(size=(3, 50)).astype(np.float32)
    gen = GenerationConfig(temperature=0.5, top_p=0.7)
    want = np.asarray(jax_pl(jnp.asarray(logits), gen))
    got = process_logits(torch.from_numpy(logits), gen).numpy()
    np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
    np.testing.assert_allclose(got[~np.isinf(got)], want[~np.isinf(want)],
                               rtol=1e-6)
