"""The VidSTG / HC-STVG sIoU evaluation (grounding/eval_grounding.py),
port against the JAX package: iou_per_video on seeded masks and boxes
(empty masks, frames without a result) gives the same value; then
evaluate_dataset over a synthetic dataset of four samples, each
package's GroundedTracker on the same stub detector and segmenter, the
annotator through a stub client that answers a well-formed {'OBJECT':
...}, text that is no dictionary (the referring expression falls back to
the question) and an error (annotate returns None), with a sample whose
loading raises (the reference's try-and-continue): the same m_sIoU,
samples, answers, referring expressions and per-sample sIoU, the same
annotator prompts, and the same files written."""

import json

import numpy as np

from torch_grounding_pair import StubDetector, StubSegmenter
from video_llava_tpu.grounding import eval_grounding as jeval
from video_llava_tpu.grounding.memory_tracker import (
    TrackerConfig as JTrackerConfig,
)
from video_llava_tpu.grounding.tracker import FrameResult as JFrameResult
from video_llava_tpu.grounding.tracker import GroundedTracker as JTracker
from video_llava_tpu_torch.datasets.grounding_datasets import GroundingSample
from video_llava_tpu_torch.grounding import eval_grounding as teval
from video_llava_tpu_torch.grounding.memory_tracker import TrackerConfig
from video_llava_tpu_torch.grounding.tracker import FrameResult, GroundedTracker


class Dataset:
    """Four samples of squares on a gray background; sample 2 fails to
    load."""

    def __len__(self):
        return 4

    def __getitem__(self, i):
        if i == 2:
            raise OSError("cannot open video")
        rng = np.random.default_rng(i)
        frames = np.full((11, 64, 80, 3), 128, np.uint8)
        frames[:, 6:32, 4:34] = rng.integers(0, 256, 3)
        inter = [1, 4, 5, 9]
        return GroundingSample(
            video_id=f"v{i}", caption=f"where is the thing {i}?",
            frames=frames, frame_ids=list(range(0, 55, 5)), inter_idx=inter,
            img2box={k: [[4.0 + i, 6.0, 34.0, 32.0 + k]] for k in inter})


class Client:
    def __init__(self):
        self.prompts = []

    def chat_text(self, model, messages, **kw):
        self.prompts.append((model, json.dumps(messages)))
        n = len(self.prompts)
        if n == 1:
            return "{'OBJECT': 'gray square'}"
        if n == 2:
            return "the answer is a square"
        raise ConnectionError("no server")


def test_eval_grounding_matches_jax(tmp_path):
    rng = np.random.default_rng(0)
    results, img2box = [], {}
    for t in range(6):
        masks = np.zeros((3, 40, 50), np.float32)
        for k in range(3):
            if rng.random() < 0.7:
                y, x = rng.integers(0, 30), rng.integers(0, 40)
                masks[k, y:y + rng.integers(2, 10),
                      x:x + rng.integers(2, 10)] = 1.0
        results.append(masks)
        img2box[t] = [list(rng.uniform(0, 30, 2)) + list(rng.uniform(30, 50,
                                                                     2))]
    inter = [0, 1, 2, 3, 5, 7]  # frame 7 has no result
    want = jeval.iou_per_video([JFrameResult(t, m, []) for t, m in
                                enumerate(results)], inter, img2box)
    got = teval.iou_per_video([FrameResult(t, m, []) for t, m in
                               enumerate(results)], inter, img2box)
    assert 0.0 < got < 1.0
    assert abs(got - want) < 1e-6

    outs = {}
    for name, mod, tracker_cls, cfg_cls in (
            ("jax", jeval, JTracker, JTrackerConfig),
            ("port", teval, GroundedTracker, TrackerConfig)):
        tracker = tracker_cls(detector=StubDetector(),
                              segmenter=StubSegmenter(), detection_every=5,
                              tracker_cfg=cfg_cls(max_objects=3))
        client = Client()
        out = mod.evaluate_dataset(
            Dataset(), tracker,
            infer_answer=lambda frames, q: f"{q} {len(frames)} frames",
            client=client, judge_model="vicuna", output_dir=str(
                tmp_path / name))
        files = {p.name: json.loads(p.read_text())
                 for p in (tmp_path / name).iterdir()}
        outs[name] = out, client.prompts, files
    (want, want_prompts, want_files), (got, prompts, files) = (
        outs["jax"], outs["port"])
    assert got["num_samples"] == want["num_samples"] == 3
    assert abs(got["m_sIoU"] - want["m_sIoU"]) < 1e-6
    exprs = [s["referring_expression"] for s in got["per_sample"]]
    assert exprs == ["gray square", "where is the thing 1?",
                     "where is the thing 3?"]
    for w, g in zip(want["per_sample"], got["per_sample"]):
        assert {k: v for k, v in w.items() if k != "sIoU"} == {
            k: v for k, v in g.items() if k != "sIoU"}
        assert abs(w["sIoU"] - g["sIoU"]) < 1e-6
    assert got["m_sIoU"] > 0
    assert prompts == want_prompts and len(prompts) == 3
    assert sorted(files) == sorted(want_files) == ["v0.json", "v1.json",
                                                   "v3.json"]
