"""GroundedTracker.run_on_list_of_images against the JAX package's, with
the tiny GroundingDINO and the tiny MobileSAM on both sides (parameters
carried across by engine/convert) and the default STM propagator: the
fused whole-clip path (what build_grounding_stack's tracker takes) and
the host loop, on 11 seeded patch-colored frames (a padded tail segment)
at 48 x 80. Objects (ids, classes) equal and scores within 1e-4; binary
masks equal except on at most 0.5% of pixels (SAM logits and STM scores
within rounding of their thresholds). Then results.annotate_frame on
those masks against the JAX package's overlay (equal, or off by one grey
level where a blend rounds the other way)."""

import numpy as np

from video_llava_tpu.grounding.memory_tracker import (
    TrackerConfig as JTrackerConfig,
)
from video_llava_tpu.grounding.results import annotate_frame as j_annotate
from video_llava_tpu.grounding.tracker import GroundedTracker as JTracker
from video_llava_tpu.models import grounding_dino as jgd
from video_llava_tpu_torch.grounding.memory_tracker import TrackerConfig
from video_llava_tpu_torch.grounding.results import annotate_frame
from video_llava_tpu_torch.grounding.tracker import GroundedTracker
from video_llava_tpu_torch.models import grounding_dino as tgd
from torch_grounding_pair import dino_pair, patchy_frames, sam_segmenters


def test_grounded_tracker_matches_jax():
    jp, tp = dino_pair()
    jseg, tseg = sam_segmenters()
    tok = tgd.char_tokenize
    frames = patchy_frames(11, 48, 80, seed=6)
    classes = ["cat", "dog"]
    for fused in (True, False):
        j = JTracker(detector=jgd.GroundingDinoDetector(
            jp, jgd.GroundingDinoConfig.tiny_test(), tok, image_size=64),
            segmenter=jseg, tracker_cfg=JTrackerConfig(max_objects=3),
            prefer_fused=fused, binary_masks=True)
        t = GroundedTracker(detector=tgd.GroundingDinoDetector(
            tp, tgd.GroundingDinoConfig.tiny_test(), tok, image_size=64),
            segmenter=tseg, tracker_cfg=TrackerConfig(max_objects=3),
            prefer_fused=fused, binary_masks=True)
        assert t.fused_eligible() == fused == j.fused_eligible()
        want = j.run_on_list_of_images(list(frames), classes)
        got = t.run_on_list_of_images(list(frames), classes)
        assert len(got) == len(want) == 11
        for g, w in zip(got, want):
            assert [(o.id, o.category_id) for o in g.objects] == [
                (o.id, o.category_id) for o in w.objects]
            np.testing.assert_allclose([o.score for o in g.objects],
                                       [o.score for o in w.objects],
                                       atol=1e-4)
            assert g.masks.shape == w.masks.shape
            assert np.mean(g.masks != w.masks) <= 5e-3, (fused,
                                                         g.frame_index)
        assert sum(len(r.objects) for r in got) and any(
            r.masks.any() for r in got)
    for g, w, frame in zip(got, want, frames):
        cids = [o.category_id for o in g.objects]
        a = annotate_frame(frame, g.masks, cids).astype(int)
        b = j_annotate(frame, w.masks, cids).astype(int)
        assert np.mean(np.abs(a - b) > 1) <= 5e-3
