"""scripts/qualitative_demo.run_demo on the tiny engine (greedy, 6 new
tokens) with the grounding tests' stub detector and segmenter (moving
boxes, box masks) in the port's GroundedTracker, a stub tagger and the
entity matcher over a stub client: the answer equals engine.infer's on
the same frames, the classes are the matched entities, sorted, and the
tracker runs once per scene of a two-scene clip; every native frame
comes back annotated, (H, W, 3) uint8, equal to the JAX package's
annotate_frame on the same frame, masks and class ids."""

import dataclasses

import numpy as np

from torch_grounding_pair import (
    StubClient,
    StubDetector,
    StubSegmenter,
    moving_squares,
)
from torch_xmem_pair import one_torch_thread
from video_llava_tpu.grounding.results import annotate_frame as j_annotate
from video_llava_tpu_torch.grounding.entity_matching import (
    EntityMatchingModule,
)
from video_llava_tpu_torch.grounding.memory_tracker import TrackerConfig
from video_llava_tpu_torch.grounding.tracker import GroundedTracker
from video_llava_tpu_torch.media.scene import detect_scenes
from video_llava_tpu_torch.runtime.model_init import initialize_model
from video_llava_tpu_torch.scripts.qualitative_demo import run_demo


class StubTagger:
    def __init__(self):
        self.seen = []

    def run_on_video(self, frames, top_k=10):
        self.seen.append((frames.dtype, frames.shape, float(frames.max())))
        return ["dog", "person", "car"][:top_k]


@one_torch_thread()
def test_run_demo_matches_reference_steps():
    engine = initialize_model(model_size="tiny", device="cpu", seed=0)
    engine.gen = dataclasses.replace(engine.gen, do_sample=False,
                                     max_new_tokens=6)
    native = np.concatenate([moving_squares(6, 48, 64, seed=0),
                             255 - moving_squares(5, 48, 64, seed=1)])
    scenes = detect_scenes(native)
    assert len(scenes) == 2
    size = engine.cfg.vision.image_size
    rows = np.arange(size) * 48 // size
    cols = np.arange(size) * 64 // size
    frames = np.ascontiguousarray(native[:, rows][:, :, cols])
    tracker = GroundedTracker(detector=StubDetector(),
                              segmenter=StubSegmenter(), box_threshold=0.0,
                              tracker_cfg=TrackerConfig(max_objects=4),
                              device="cpu")
    runs = []
    run_on_list = tracker.run_on_list_of_images

    def record(fr, classes):
        out = run_on_list(fr, classes)
        runs.append((len(fr), list(classes), out))
        return out

    tracker.run_on_list_of_images = record
    tagger = StubTagger()
    client = StubClient(n=2)
    answer, classes, annotated = run_demo(
        engine, tracker, tagger, EntityMatchingModule(client=client),
        frames, native, "What is happening?")

    assert answer == engine.infer(frames, "What is happening?",
                                  num_valid_frames=len(frames))
    assert tagger.seen == [(np.float32, frames.shape, frames.max() / 255.0)]
    assert classes == ["dog", "person"]
    assert answer in client.requests[0]
    assert [(n, c) for n, c, _ in runs] == [(e - s, classes)
                                            for s, e in scenes]
    results = [r for _, _, out in runs for r in out]
    assert len(annotated) == len(results) == len(native)
    assert any(r.objects for r in results)
    for frame, r, out in zip(native, results, annotated):
        assert out.shape == frame.shape and out.dtype == np.uint8
        cids = [o.category_id for o in r.objects]
        np.testing.assert_array_equal(out, j_annotate(frame, r.masks, cids))
    assert any(not np.array_equal(a, f) for a, f in zip(annotated, native))
