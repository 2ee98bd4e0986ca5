"""The whole-clip path with the learned XMem propagator, port against
the JAX package: GroundedTracker.run_on_list_of_images (binary masks, so
the fused program: fused_eligible with LearnedMemoryTracker and a
batch-capable crop filter) over 12 seeded 64 x 96 frames, a detection
every 5 (a padded tail segment), on the JAX package's fused-clip stubs
(moving boxes of distinct areas, box masks, a filter keeping boxes by
their corner's parity, which drops some), soft masks; then semionline
(3-frame voting) without the filter, binary masks (through
run_on_list_of_images). Objects (id, category, score 1e-6) equal, masks
differing by more than 5e-3 on under 0.5% of each frame's pixels."""

import numpy as np

from torch_xmem_pair import (
    one_torch_thread,
    MAX_O,
    StubDetector,
    StubFilter,
    StubSegmenter,
    frames,
    same_results,
    xmem_pair,
)
from video_llava_tpu.grounding.memory_tracker import (
    LearnedMemoryTracker as JLearned,
)
from video_llava_tpu.grounding.memory_tracker import (
    TrackerConfig as JTrackerConfig,
)
from video_llava_tpu.grounding.tracker import GroundedTracker as JTracker
from video_llava_tpu_torch.grounding.memory_tracker import (
    LearnedMemoryTracker,
    TrackerConfig,
)
from video_llava_tpu_torch.grounding.tracker import GroundedTracker


@one_torch_thread()
def test_learned_fused_clip_matches_jax():
    (jp, jcfg), (tp, tcfg), _ = xmem_pair()
    clip = list(frames(12))
    classes = ["person", "dog"]
    # the filter drops some of the detection frames' boxes
    det = StubDetector()
    boxes = [det.detect_batch(np.zeros((1, 64, 96, 3)), [])[0][0]
             for _ in range(0, 12, 5)]
    assert not all(StubFilter.keep(b).all() for b in boxes)
    for kw, crop_filter, binary in (
            ({}, StubFilter(), False),
            ({"temporal_setting": "semionline"}, None, True)):
        j = JTracker(detector=StubDetector(), segmenter=StubSegmenter(),
                     crop_filter=crop_filter, box_threshold=0.0,
                     tracker_cfg=JTrackerConfig(max_objects=MAX_O),
                     propagator=JLearned(jp, jcfg), binary_masks=binary,
                     **kw)
        t = GroundedTracker(detector=StubDetector(), segmenter=StubSegmenter(),
                            crop_filter=crop_filter, box_threshold=0.0,
                            tracker_cfg=TrackerConfig(max_objects=MAX_O),
                            propagator=LearnedMemoryTracker(tp, tcfg),
                            binary_masks=binary, **kw)
        assert t.fused_eligible() and j.fused_eligible()
        if binary:  # run_on_list_of_images dispatches to the fused path
            want = j.run_on_list_of_images(clip, classes)
            got = t.run_on_list_of_images(clip, classes)
            assert got[0].masks.dtype == np.uint8
        else:  # soft masks: the propagated probabilities themselves
            want = j.run_on_list_of_images_fused(clip, classes, binary=False)
            got = t.run_on_list_of_images_fused(clip, classes, binary=False)
            assert all(r.masks[:3].max() > 0.05 for r in got[1:5])
        same_results(got, want)
        assert len(got[-1].objects) > 0
        assert t.tracker._frame_idx == j.tracker._frame_idx
