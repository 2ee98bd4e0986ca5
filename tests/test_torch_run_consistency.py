"""Port parity of the two-question consistency runner."""

from torch_eval_pair import eval_pair  # noqa: F401 (fixture)
from video_llava_tpu.eval.run_inference import (
    run_consistency as jax_run_consistency,
)
from video_llava_tpu_torch.eval import run_inference


def test_run_consistency_matches_jax(eval_pair):
    """pred1 and pred2 of one clip (8 frames, greedy) equal the JAX
    package's, text for text (exact: f32 on both sides); a missing video
    is skipped."""
    jax_engine, engine, vdir, _ = eval_pair
    samples = [
        {"video_name": "clip_a", "Q1": "What?", "Q2": "What exactly?",
         "A": "x"},
        {"video_name": "missing", "Q1": "?", "Q2": "??", "A": "y"},
    ]
    want = jax_run_consistency(jax_engine, samples, vdir, "pg-video-llava",
                               num_frames=8)
    got = run_inference.run_consistency(engine, samples, vdir,
                                        "pg-video-llava", num_frames=8)
    assert len(got) == 1 and got == want
    assert {"pred1", "pred2"} <= set(got[0])
