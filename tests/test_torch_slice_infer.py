"""Port parity of the chat slice: the single-shot InferenceEngine.infer."""

import numpy as np

from torch_slice_pair import slice_pair  # noqa: F401 (fixture)


def test_infer_matches_jax(slice_pair):
    """The single-shot InferenceEngine.infer flow, greedy."""
    jax_engine, engine = slice_pair
    frames = np.random.default_rng(3).integers(
        0, 256, size=(4, 64, 64, 3), dtype=np.uint8)
    want = jax_engine.infer(frames, "What is shown?")
    assert engine.infer(frames, "What is shown?") == want
