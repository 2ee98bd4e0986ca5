"""Port parity of the sequential QA runner (eval/run_inference.run_qa)."""

from torch_eval_pair import eval_pair  # noqa: F401 (fixture)
from video_llava_tpu.eval.run_inference import run_qa as jax_run_qa
from video_llava_tpu_torch.eval import run_inference


def test_run_qa_matches_jax(eval_pair):
    """Two clips and a missing video, 8 frames each, greedy: the same
    samples survive (the missing one skipped), with the pass-through
    fields and the same predictions, text for text (exact: f32 on both
    sides, greedy argmax); on_result sees each result."""
    jax_engine, engine, vdir, _ = eval_pair
    samples = [
        {"id": 1, "video_name": "clip_a", "question": "What?", "answer": "x"},
        {"id": 2, "video_name": "missing", "question": "?", "answer": "y"},
        {"id": 3, "video_name": "clip_b", "question": "Who?", "answer": "z"},
    ]
    want = jax_run_qa(jax_engine, samples, vdir, "pg-video-llava",
                      num_frames=8)
    seen = []
    got = run_inference.run_qa(engine, samples, vdir, "pg-video-llava",
                               num_frames=8, on_result=seen.append)
    assert [r["id"] for r in got] == [1, 3]
    assert got == want and seen == got
    assert all(isinstance(r["pred"], str) for r in got)
