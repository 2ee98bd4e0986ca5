"""grounding/fused_clip.py's whole-clip STM program, through
GroundedTracker.run_on_list_of_images_fused, against the JAX package's
fused program and against the port's own host loop, on seeded
patch-colored frames with stub detections (moving boxes of distinct
areas: the association is not decided by ties). 12 frames with a
detection every 5 (a padded tail segment), 64 x 100 (the packed width
pads to bytes), online soft and packed-binary and semionline. Soft masks
within 2e-4, binary masks equal except on at most 0.1% of pixels (soft
values within rounding of 0.5), objects (id, class, score 1e-6) equal.
Also the bit packing and its inverse, the area order and the voting."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from video_llava_tpu.grounding import fused_clip as jfc
from video_llava_tpu.grounding.memory_tracker import (
    TrackerConfig as JTrackerConfig,
)
from video_llava_tpu.grounding.tracker import GroundedTracker as JTracker
from video_llava_tpu_torch.grounding import fused_clip as tfc
from video_llava_tpu_torch.grounding.memory_tracker import TrackerConfig
from video_llava_tpu_torch.grounding.tracker import GroundedTracker
from torch_grounding_pair import (
    StubDetector,
    StubSegmenter,
    patchy_frames,
)

MAX_O = 4


def _trackers(**kw):
    j = JTracker(detector=StubDetector(), segmenter=StubSegmenter(),
                 box_threshold=0.0, tracker_cfg=JTrackerConfig(
                     max_objects=MAX_O), **kw)
    t = GroundedTracker(detector=StubDetector(), segmenter=StubSegmenter(),
                        box_threshold=0.0,
                        tracker_cfg=TrackerConfig(max_objects=MAX_O), **kw)
    return j, t


def _same(got, want, binary):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.frame_index == w.frame_index
        assert [(o.id, o.category_id) for o in g.objects] == [
            (o.id, o.category_id) for o in w.objects]
        for a, b in zip(g.objects, w.objects):
            assert a.score == pytest.approx(b.score, abs=1e-6)
        assert g.masks.shape == w.masks.shape and g.masks.dtype == w.masks.dtype
        if binary:
            assert np.mean(g.masks != w.masks) <= 1e-3, g.frame_index
        else:
            np.testing.assert_allclose(g.masks, w.masks, atol=2e-4)


def test_fused_stm_clip_matches_jax_and_host_loop():
    m = np.random.default_rng(0).integers(0, 2, (2, 3, 13)).astype(np.uint8)
    m[..., 13:] = 0
    packed = tfc.pack_mask_bits(torch.nn.functional.pad(
        torch.from_numpy(m), (0, 3)))
    np.testing.assert_array_equal(packed.numpy(), np.asarray(
        jfc.pack_mask_bits(jnp.pad(jnp.asarray(m), ((0, 0), (0, 0),
                                                    (0, 3))))))
    np.testing.assert_array_equal(tfc.unpack_mask_bits(packed.numpy(), 13), m)

    frames = patchy_frames(12, 64, 100, seed=4)
    classes = ["person", "dog"]
    for kw, binary in (({}, False), ({}, True),
                       ({"temporal_setting": "semionline"}, True)):
        j, t = _trackers(**kw)
        assert t.fused_eligible()
        want = j.run_on_list_of_images_fused(list(frames), classes,
                                             binary=binary)
        got = t.run_on_list_of_images_fused(list(frames), classes,
                                            binary=binary)
        _same(got, want, binary)
        assert any(r.masks.any() for r in got[1:5])  # propagated frames
        # the same program from one device copy (what chat passes)
        _, t2 = _trackers(**kw)
        _same(t2.run_on_list_of_images_fused(torch.from_numpy(frames),
                                             classes, binary=binary),
              got, binary)
        # the port's own host loop
        _, host = _trackers(**kw)
        host.prefer_fused, host.binary_masks = False, binary
        _same(got, host.run_on_list_of_images(list(frames), classes), binary)

    rng = np.random.default_rng(1)
    dm = (rng.uniform(size=(6, 3, 20, 24)) > 0.6).astype(np.uint8)
    dm[:, 2] = 0
    dv = rng.uniform(size=(6, 3)) > 0.2
    np.testing.assert_array_equal(
        tfc.vote_detections(torch.from_numpy(dm), torch.from_numpy(dv),
                            3).numpy(),
        np.asarray(jfc.vote_detections(jnp.asarray(dm), jnp.asarray(dv), 3)))
