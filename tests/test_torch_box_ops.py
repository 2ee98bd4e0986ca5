"""ops/box_ops.py against the JAX package's box math and NMS on seeded
boxes and masks. Boxes, IoU and masks_to_boxes agree to 1e-6 (f32, the
same operations); NMS keep masks, with and without max_outputs, padded
-inf rows and the batched (per-frame) form, agree exactly."""

import numpy as np
import jax
import jax.numpy as jnp
import torch

from video_llava_tpu.ops import box_ops as jb
from video_llava_tpu_torch.ops import box_ops as tb


def _boxes(rng, n):
    xy = rng.uniform(0, 80, (n, 2))
    wh = rng.uniform(2, 40, (n, 2))
    return np.concatenate([xy, xy + wh], 1).astype(np.float32)


def test_box_ops_and_nms_match_jax():
    rng = np.random.default_rng(0)
    a, b = _boxes(rng, 7), _boxes(rng, 5)
    t = torch.from_numpy
    for name in ("box_cxcywh_to_xyxy", "box_xyxy_to_cxcywh", "box_area"):
        np.testing.assert_allclose(getattr(tb, name)(t(a)).numpy(),
                                   np.asarray(getattr(jb, name)(a)),
                                   atol=1e-6)
    for got, want in zip(tb.box_iou(t(a), t(b)), jb.box_iou(a, b)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)
    np.testing.assert_allclose(tb.generalized_box_iou(t(a), t(b)).numpy(),
                               np.asarray(jb.generalized_box_iou(a, b)),
                               atol=1e-6)
    masks = rng.uniform(size=(4, 30, 50)) > 0.97
    masks[2] = False  # empty mask -> zeros
    masks[3] = False
    masks[3, 0, 49] = masks[3, 29, 0] = True  # edge rows and columns
    np.testing.assert_array_equal(tb.masks_to_boxes(t(masks)).numpy(),
                                  np.asarray(jb.masks_to_boxes(masks)))

    for n, thr, max_out in ((12, 0.5, None), (12, 0.3, 4), (30, 0.5, None)):
        boxes = _boxes(rng, n)
        boxes[n // 2:] = boxes[:n - n // 2] + rng.uniform(
            -3, 3, (n - n // 2, 4)).astype(np.float32)  # overlapping pairs
        scores = rng.uniform(size=n).astype(np.float32)
        scores[-2:] = -np.inf  # padded rows
        want = np.asarray(jb.nms(jnp.asarray(boxes), jnp.asarray(scores),
                                 thr, max_outputs=max_out))
        got = tb.nms(t(boxes), t(scores), thr, max_outputs=max_out).numpy()
        np.testing.assert_array_equal(got, want)
        assert 0 < got.sum() < n
    cls = rng.integers(0, 3, 12)
    boxes, scores = _boxes(rng, 12), rng.uniform(size=12).astype(np.float32)
    np.testing.assert_array_equal(
        tb.batched_nms(t(boxes), t(scores), t(cls)).numpy(),
        np.asarray(jb.batched_nms(jnp.asarray(boxes), jnp.asarray(scores),
                                  jnp.asarray(cls))))
    # the tracker's per-frame NMS: one call over (frames, k) rows
    fb = np.stack([_boxes(rng, 8) for _ in range(3)])
    fs = rng.uniform(size=(3, 8)).astype(np.float32)
    fs[1, 5:] = -np.inf
    want = np.asarray(jax.vmap(jb.nms, in_axes=(0, 0, None))(
        jnp.asarray(fb), jnp.asarray(fs), 0.5))
    np.testing.assert_array_equal(tb.nms(t(fb), t(fs), 0.5).numpy(), want)
