"""Port parity of the batched QA runner (eval/run_inference
.run_qa_batched)."""

from torch_eval_pair import eval_pair  # noqa: F401 (fixture)
from video_llava_tpu.eval.run_inference import (
    run_qa_batched as jax_run_qa_batched,
)
from video_llava_tpu_torch.eval import run_inference


def test_batched_runner_matches_jax(eval_pair):
    """Batches of 2 over ["a", "b", "missing", "c"] (6-frame clips padded
    to 8, so each batch pools with valid counts below its frames;
    prompts of different lengths right-padded to one bucket; greedy, 12
    new tokens, with the engine's prompt-lookup speculation as in the
    JAX package): ids [0, 1, 3] and the JAX package's predictions, text
    for text (exact: f32 on both sides)."""
    jax_engine, engine, _, bdir = eval_pair
    samples = [
        {"id": i, "video_name": n, "question": f"Q{i}?" + " why" * i,
         "answer": "x"}
        for i, n in enumerate(["a", "b", "missing", "c"])
    ]
    want = jax_run_qa_batched(jax_engine, samples, bdir, "pg-video-llava",
                              batch_size=2, num_frames=8, max_new_tokens=12)
    got = run_inference.run_qa_batched(engine, samples, bdir,
                                       "pg-video-llava", batch_size=2,
                                       num_frames=8, max_new_tokens=12)
    assert [r["id"] for r in got] == [0, 1, 3]
    assert got == want
