"""The batched video encode (InferenceEngine.batched_encode), the
counterpart of the JAX package's eval/run_inference._batched_encode_jit."""

import numpy as np
import jax.numpy as jnp
import torch

from torch_eval_pair import make_pair
from video_llava_tpu.eval.run_inference import _batched_encode_jit


def test_batched_encode_matches_jax():
    """3 videos of 8 frames with valid counts {8, 5, 1} (zero frames past
    each count, as the runners pad them): CLIP once over the 24 frames and
    the batched pool against the JAX package's vmapped preprocess +
    encode_video (its pool's XLA formulation on the CPU, as its encode
    runs there), within 1e-5 of max |ref| (f32 on both sides, sums in
    another order); and each row equal to that video encoded alone (its
    count's frames), within 1e-6 (the same math, batch-independent)."""
    jax_engine, engine = make_pair()
    cfg = engine.cfg
    rng = np.random.default_rng(5)
    counts = [8, 5, 1]
    frames = rng.integers(0, 256, size=(3, 8, 40, 56, 3), dtype=np.uint8)
    for i, n in enumerate(counts):
        frames[i, n:] = 0
    want = np.asarray(_batched_encode_jit(
        jax_engine.params, jnp.asarray(frames), cfg, cfg.vision.image_size,
        jnp.asarray(counts, jnp.int32)))
    got = engine.batched_encode(frames, counts)
    assert got.shape == want.shape == (3, cfg.video_token_len,
                                       cfg.vision.hidden_size)
    assert got.dtype == torch.float32
    scale = np.abs(want).max()
    assert np.abs(got.numpy() - want).max() <= 1e-5 * scale
    for i, n in enumerate(counts):
        one = engine.encode_video_frames(frames[i, :n], n)
        assert torch.allclose(got[i], one, rtol=0, atol=1e-6 * scale), i
