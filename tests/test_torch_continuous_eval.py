"""The port's continuous QA runner over the slot engine."""

import dataclasses

import pytest

from torch_eval_pair import eval_pair  # noqa: F401 (fixture)
from video_llava_tpu_torch.engine import continuous
from video_llava_tpu_torch.eval import run_inference


def test_continuous_runner_matches_batched(eval_pair, monkeypatch):
    """run_qa_continuous (2 slots, batches of 2) gives run_qa_batched's
    greedy predictions (12 new tokens) (exact: the same f32 model, greedy), with and
    without speculation, skips the missing video, and stops its engine
    thread also when a submit raises."""
    _, engine, _, bdir = eval_pair
    samples = [
        {"id": i, "video_name": n, "question": f"Q{i}?", "answer": "x"}
        for i, n in enumerate(["a", "b", "missing", "c"])
    ]
    for speculative in (True, False):
        eng = dataclasses.replace(engine, speculative=speculative)
        batched = run_inference.run_qa_batched(
            eng, samples, bdir, "pg-video-llava", batch_size=2,
            num_frames=8, max_new_tokens=12)
        cont = run_inference.run_qa_continuous(
            eng, samples, bdir, "pg-video-llava", batch_size=2,
            num_slots=2, max_cache_len=1024, num_frames=8,
            max_new_tokens=12)
        assert [r["id"] for r in cont] == [0, 1, 3]
        assert cont == batched, speculative

    started = []

    class Failing(continuous.ContinuousEngine):
        def start(self):
            super().start()
            started.append(self)

        def submit(self, req):
            raise RuntimeError("submit failed")

    monkeypatch.setattr(run_inference, "ContinuousEngine", Failing)
    with pytest.raises(RuntimeError, match="submit failed"):
        run_inference.run_qa_continuous(engine, samples, bdir,
                                        "pg-video-llava", batch_size=2,
                                        num_slots=2, num_frames=8)
    assert len(started) == 1 and started[0]._thread is None
