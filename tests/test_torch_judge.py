"""The port's LLM judge (eval/judge.py) against the JAX package's."""

import hashlib
import json
import os
import threading

from video_llava_tpu.eval import judge as jax_judge
from video_llava_tpu_torch.eval import judge


class StubClient:
    """A deterministic judge: the reply to a conversation is a function of
    its text; the first reply to every third conversation is not a
    Python dict, so that pair is retried in the next round."""

    def __init__(self, api_base=None, requests_per_second=None):
        self.seen = set()
        self.lock = threading.Lock()

    def chat_text(self, model, messages):
        text = json.dumps([model, messages])
        h = int(hashlib.sha256(text.encode()).hexdigest(), 16)
        with self.lock:
            first = text not in self.seen
            self.seen.add(text)
        if first and h % 3 == 0:
            return "I think it matches."
        verdict = ("yes", "no", "No.")[h % 3]
        return f"{{'pred': '{verdict}', 'score': {h % 6}}}"


def _predictions(task):
    if task == "consistency":
        return {f"v{i}_{i}": {"question1": f"q{i}", "question2": f"q{i}'",
                              "answer": "a", "pred1": f"p{i}",
                              "pred2": f"r{i}"} for i in range(7)}
    return {f"v{i}_{i}": {"question": f"q{i}?", "answer": f"a{i % 3}",
                          "pred": f"p{i % 4}"} for i in range(7)}


def test_judge_matches_jax(tmp_path, monkeypatch):
    """The prompt tables and judge_messages equal the JAX package's for
    every task; run_judge (3 workers, retry rounds) and aggregate against
    the same stub client write the same per-pair files and give the same
    scores (exact: the same host arithmetic); main writes the same
    summary."""
    assert judge.JUDGE_TASKS == jax_judge.JUDGE_TASKS
    for task in judge.JUDGE_TASKS:
        for qa in _predictions(task).values():
            assert (judge.judge_messages(task, qa)
                    == jax_judge.judge_messages(task, qa))
    monkeypatch.setattr(judge, "ChatCompletionClient", StubClient)
    monkeypatch.setattr(jax_judge, "ChatCompletionClient", StubClient)
    for task in ("activitynet_qa", "correctness", "consistency"):
        preds = _predictions(task)
        outs = []
        for mod, side in ((jax_judge, "jax"), (judge, "port")):
            out = str(tmp_path / side / task)
            mod.run_judge(preds, task, out, num_workers=3)
            outs.append(out)
        files = sorted(os.listdir(outs[0]))
        assert files == sorted(os.listdir(outs[1])) and len(files) == 7
        for name in files:
            with open(os.path.join(outs[0], name)) as f, \
                    open(os.path.join(outs[1], name)) as g:
                assert json.load(f) == json.load(g), name
        want = jax_judge.aggregate(outs[0])
        assert judge.aggregate(outs[1]) == want
        assert "accuracy" in want and "average_score" in want

    rows = [{"video_name": f"v{i}", "question": f"q{i}", "answer": "a",
             "pred": f"p{i}"} for i in range(5)]
    (tmp_path / "preds.json").write_text(json.dumps(rows))
    for mod, side in ((jax_judge, "jax"), (judge, "port")):
        mod.main(["--task", "activitynet_qa", "--pred_path",
                  str(tmp_path / "preds.json"), "--output_dir",
                  str(tmp_path / side / "main"), "--output_json",
                  str(tmp_path / f"{side}.json"), "--num_tasks", "2"])
    assert (json.loads((tmp_path / "port.json").read_text())
            == json.loads((tmp_path / "jax.json").read_text()))
