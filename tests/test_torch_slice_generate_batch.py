"""Port parity of the chat slice: batched greedy generation with stop ids."""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import torch

from torch_slice_pair import slice_pair  # noqa: F401 (fixture)
from video_llava_tpu.engine.generate import generate as jax_generate
from video_llava_tpu_torch.engine.generate import generate


def test_generate_batch_with_stops_matches_jax(slice_pair):
    """Batch 2, ragged prompts, greedy, with a stop id that ends one row
    early: identical tokens (pad after the stop), lengths, and the
    finished row's cache length frozen at its stop."""
    jax_engine, engine = slice_pair
    cfg = engine.cfg
    rng = np.random.default_rng(2)
    ids = rng.integers(0, 256, size=(2, 160)).astype(np.int64)
    ids[:, 4:4 + cfg.video_token_len] = cfg.vid_patch_token_id
    lens = np.array([160, 131], np.int32)
    frames = rng.integers(0, 256, size=(2, 6, 64, 64, 3), dtype=np.uint8)
    jfeats = jnp.stack([jax_engine.encode_video_frames(f) for f in frames])
    feats = torch.stack([engine.encode_video_frames(f) for f in frames])

    def run(gen):
        want = jax_generate(jax_engine.params, cfg, gen,
                            jnp.asarray(ids.astype(np.int32)),
                            jnp.asarray(lens), jfeats,
                            jax.random.PRNGKey(0), cache_dtype=jnp.float32)
        got = generate(engine.model, gen, torch.from_numpy(ids),
                       torch.from_numpy(lens), feats,
                       cache_dtype=torch.float32)
        np.testing.assert_array_equal(got.tokens.numpy(),
                                      np.asarray(want.tokens))
        np.testing.assert_array_equal(got.lengths.numpy(),
                                      np.asarray(want.lengths))
        np.testing.assert_array_equal(got.cache.length.numpy(),
                                      np.asarray(want.cache.length))
        return got

    gen = dataclasses.replace(jax_engine.gen, max_new_tokens=6)
    free = run(gen)
    stop = int(free.tokens[0, 2])
    stopped = run(dataclasses.replace(gen, stop_token_ids=(stop,)))
    assert int(stopped.lengths[0]) <= 3 < 6
