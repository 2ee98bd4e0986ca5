"""The chunked host loop with the learned XMem propagator: the port's
GroundedTracker.run_host_loop (online, LearnedMemoryTracker.step_chunk
over each detection gap padded to 4 frames, the crop filter after SAM in
detect_and_segment) against the JAX package's, and against the port's
own whole-clip path (the filter before SAM there), over 12 seeded
64 x 96 frames with the JAX package's fused-clip stubs, soft masks. The
filter drops detections (asserted through a counting wrapper). Objects
(id, category, score 1e-6) equal, masks differing by more than 5e-3 on
under 0.5% of each frame's pixels."""

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


class CountingFilter(StubFilter):
    def __init__(self):
        self.dropped = 0

    def __call__(self, image, boxes, class_ids, classes):
        keep = self.keep(boxes)
        self.dropped += int((~keep).sum())
        return keep


@one_torch_thread()
def test_learned_host_loop_matches_jax_and_fused():
    (jp, jcfg), (tp, tcfg), _ = xmem_pair()
    clip = list(frames(12, seed=11))
    classes = ["person", "dog"]
    j = JTracker(detector=StubDetector(), segmenter=StubSegmenter(),
                 crop_filter=StubFilter(), box_threshold=0.0,
                 tracker_cfg=JTrackerConfig(max_objects=MAX_O),
                 propagator=JLearned(jp, jcfg))
    want = j.run_host_loop(clip, classes)

    def port():
        return GroundedTracker(detector=StubDetector(),
                               segmenter=StubSegmenter(),
                               crop_filter=CountingFilter(), box_threshold=0.0,
                               tracker_cfg=TrackerConfig(max_objects=MAX_O),
                               propagator=LearnedMemoryTracker(tp, tcfg))

    host = port()
    calls = []
    step_chunk = host.tracker.step_chunk
    host.tracker.step_chunk = lambda fr, **kw: calls.append(
        (len(fr), kw)) or step_chunk(fr, **kw)
    got = host.run_host_loop(clip, classes)
    assert calls == [(4, {"pad_to": 4}), (4, {"pad_to": 4}),
                     (1, {"pad_to": 4})]
    assert host.crop_filter.dropped > 0
    assert got[1].masks.dtype == np.float32
    assert all(r.masks[:3].max() > 0.05 for r in got[1:5])
    same_results(got, want)
    assert host.tracker._frame_idx == j.tracker._frame_idx

    fused = port()
    same_results(fused.run_on_list_of_images_fused(clip, classes,
                                                   binary=False), got)
