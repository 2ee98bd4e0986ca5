"""scripts/generate_benchmark_qa.py against the JAX package's: the four
TASKS equal; with a stub client answering each task's dictionary (one
caption answered with text literal_eval cannot parse, one raising), both
packages' annotate write the same files with the same contents and skip
the same keys; main (its ChatCompletionClient swapped for a stub that
fails a key's first request) retries until every caption has its file
and ends."""

import json
import os

import pytest

from video_llava_tpu.scripts import generate_benchmark_qa as jqa
from video_llava_tpu_torch.scripts import generate_benchmark_qa as tqa

REPLIES = {
    "consistency": "{'Q1': 'What is {c}?', 'Q2': 'Which is {c}?', "
                   "'A': '{c}'}",
    "temporal": "{'Q': 'What happens after {c}?', 'A': 'then {c}'}",
    "correctness_detail_context": "{'Q1': '1 {c}', 'A1': 'a', 'Q2': '2', "
                                  "'A2': 'b', 'Q3': '3', 'A3': 'c'}",
    "interrogative": "{'Q': 'Who is {c}?'}",
}


class StubClient:
    """Answers from REPLIES by the task in the system prompt; a caption
    'bad' gets text that is not a dict, 'boom' raises, and with
    `flaky` each caption's first request raises."""

    def __init__(self, flaky=False):
        self.seen, self.flaky, self.calls = set(), flaky, []

    def chat_text(self, model, messages):
        system, user = messages[0]["content"], messages[1]["content"]
        self.calls.append((model, system, user))
        task = next(t for t, spec in tqa.TASKS.items()
                    if spec["system"] == system)
        caption = user.split(": ", 1)[1].split(". ", 1)[0]
        if self.flaky and caption not in self.seen:
            self.seen.add(caption)
            raise ConnectionError("first try")
        if caption == "bad":
            return "Sure! Q: what?"
        if caption == "boom":
            raise RuntimeError("server error")
        return REPLIES[task].replace("{c}", caption)


def _files(d):
    return {f: open(os.path.join(d, f)).read() for f in sorted(os.listdir(d))}


def test_generate_benchmark_qa_matches_jax(tmp_path, monkeypatch, capsys):
    assert tqa.TASKS == jqa.TASKS and len(tqa.TASKS) == 4
    gt = {"v1": "a dog runs", "v2": "bad", "v3": "a man cooks",
          "v4": "boom"}
    for task in tqa.TASKS:
        dirs = []
        for mod in (jqa, tqa):
            d = tmp_path / f"{mod.__name__.split('.')[0]}_{task}"
            d.mkdir()
            client = StubClient()
            mod.annotate(client, "m", task, gt, list(gt), str(d))
            dirs.append(_files(d))
            assert [c[2] for c in client.calls] == [
                tqa.TASKS[task]["user"].format(caption=gt[k]) for k in gt]
        assert dirs[0] == dirs[1]
        assert sorted(dirs[1]) == ["v1.json", "v3.json"]
        assert json.loads(dirs[1]["v1.json"]) == eval(  # noqa: S307
            REPLIES[task].replace("{c}", "a dog runs"))
    assert "Error processing file 'v2'" in capsys.readouterr().out

    gt = {f"k{i}": f"caption {i}" for i in range(7)}
    (tmp_path / "gt.json").write_text(json.dumps(gt))
    stub = StubClient(flaky=True)
    made = []

    def client(api_base=None):
        made.append(api_base)
        return stub

    monkeypatch.setattr(tqa, "ChatCompletionClient", client)
    out = tmp_path / "out"
    tqa.main(["--task", "temporal", "--gt_json", str(tmp_path / "gt.json"),
              "--output_dir", str(out), "--num_tasks", "3",
              "--api_base", "http://localhost:1/v1"])
    assert made == ["http://localhost:1/v1"]
    assert sorted(os.listdir(out)) == sorted(f"{k}.json" for k in gt)
    assert len(stub.calls) == 2 * len(gt)
    assert "all QA pairs generated" in capsys.readouterr().out
    with pytest.raises(SystemExit):
        tqa.main(["--task", "nope", "--gt_json", "x", "--output_dir", "y"])
