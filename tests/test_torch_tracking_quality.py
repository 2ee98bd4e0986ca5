"""scripts/tracking_quality.py against the JAX package's: the synthetic
clips bit-equal to make_clips', the J (IoU) and F (boundary F-measure)
metrics equal on the same masks, and the handcrafted STM's per-kind J
and F through evaluate_tracker within 1e-4 of the JAX package's, on one
clip a kind of 4 frames."""

import numpy as np

from video_llava_tpu.grounding.memory_tracker import (
    MemoryTracker as JMemoryTracker,
)
from video_llava_tpu.grounding.memory_tracker import (
    TrackerConfig as JTrackerConfig,
)
from video_llava_tpu.scripts import tracking_quality as jtq
from video_llava_tpu_torch.grounding.memory_tracker import (
    MemoryTracker,
    TrackerConfig,
)
from video_llava_tpu_torch.scripts import tracking_quality as ttq


def test_tracking_quality_clips_metrics_and_stm_match_jax():
    for seed, per_kind, n in ((1000, 2, 8), (7, 1, 5)):
        want, got = jtq.make_clips(seed, per_kind, n), ttq.make_clips(
            seed, per_kind, n)
        assert list(got) == list(want) == list(ttq.CLIP_KINDS)
        for kind in want:
            for (wf, wg), (gf, gg) in zip(want[kind], got[kind]):
                for a, b in zip(wf + wg, gf + gg):
                    assert a.dtype == b.dtype and a.shape == b.shape
                    np.testing.assert_array_equal(a, b)

    rng = np.random.default_rng(0)
    clips = ttq.make_clips(3, 1, 4)
    masks = [g for kind in clips.values() for _, gts in kind for g in gts]
    for g in masks:
        for pred in (g, np.roll(g, 3, axis=1),
                     rng.random(g.shape).astype(np.float32),
                     np.zeros_like(g)):
            assert ttq.iou(pred, g) == jtq.iou(pred, g)
            for tol in (1, 2):
                assert (ttq.boundary_f(pred > 0.5, g, tol)
                        == jtq.boundary_f(pred > 0.5, g, tol))
    assert ttq.iou(np.zeros((4, 4)), np.zeros((4, 4))) == 1.0

    want = jtq.evaluate_tracker(
        lambda: JMemoryTracker(JTrackerConfig(max_objects=2)), clips)
    got = ttq.evaluate_tracker(
        lambda: MemoryTracker(TrackerConfig(max_objects=2), device="cpu"),
        clips)
    assert list(got) == list(want)
    for kind in want:
        for k in ("J", "F", "JF"):
            assert abs(got[kind][k] - want[kind][k]) <= 1e-4, (kind, k)
    assert 0.0 < got["mean"]["JF"] < 1.0
    table = {"handcrafted": got, "handcrafted(fused)": want}
    assert ttq.format_table(table) == jtq.format_table(table)
