"""Port parity: ops/video_transforms (the port's copy) gives the JAX
package's clips and targets bit for bit: every op, and
make_video_transforms('train' | 'test') under the same seeds."""

import numpy as np

import video_llava_tpu.ops.video_transforms as J
import video_llava_tpu_torch.ops.video_transforms as T


def _same(a, b, path="out"):
    """Equal structure, dtypes and values (targets: lists of dicts)."""
    if isinstance(a, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _same(x, y, f"{path}[{i}]")
    elif isinstance(a, dict):
        assert a.keys() == b.keys(), path
        for k in a:
            _same(a[k], b[k], f"{path}.{k}")
    elif a is None or isinstance(a, (int, float, str)):
        assert a == b, path
    else:
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape, path
        np.testing.assert_array_equal(a, b, err_msg=path)


def _targets(rng, t, h, w):
    out = []
    for _ in range(t):
        n = 3
        xy = rng.uniform(0, [w - 20, h - 20], (n, 2)).astype(np.float32)
        wh = rng.uniform(5, 60, (n, 2)).astype(np.float32)
        boxes = np.concatenate([xy, np.minimum(xy + wh, [w, h])], 1).astype(
            np.float32)
        out.append({"boxes": boxes, "labels": np.arange(n),
                    "area": ((boxes[:, 2] - boxes[:, 0])
                             * (boxes[:, 3] - boxes[:, 1])),
                    "masks": rng.random((n, h, w)) > 0.7})
    return out


def test_video_transforms_match_jax_bit_for_bit():
    rng = np.random.default_rng(0)
    t, h, w = 3, 90, 160
    clip = rng.integers(0, 256, (t, h, w, 3), dtype=np.uint8)
    targets = _targets(rng, t, h, w)
    fclip = clip.astype(np.float32) / 7.0

    for x in (clip, fclip):
        for size, mode in (((45, 80), "bilinear"), ((61, 203), "bilinear"),
                           ((45, 80), "nearest"), ((90, 160), "bilinear")):
            _same(T.resize_clip(x, size, mode), J.resize_clip(x, size, mode))
        _same(T.hflip_clip(x), J.hflip_clip(x))
        _same(T.center_crop_clip(x, (40, 50)), J.center_crop_clip(x, (40, 50)))
        _same(T.random_crop_clip(x, (40, 50), np.random.default_rng(4)),
              J.random_crop_clip(x, (40, 50), np.random.default_rng(4)))
        _same(T.normalize_clip_np(x), J.normalize_clip_np(x))
    boxes = targets[0]["boxes"]
    _same(T.resize_boxes(boxes, (h, w), (45, 80)),
          J.resize_boxes(boxes, (h, w), (45, 80)))
    _same(T.crop_boxes(boxes, 10, 20, (40, 50)),
          J.crop_boxes(boxes, 10, 20, (40, 50)))
    _same(T.hflip_boxes(boxes, w), J.hflip_boxes(boxes, w))
    for hw, size, mx in (((90, 160), 64, None), ((90, 160), 224, 300),
                         ((160, 90), 90, None), ((480, 640), 800, 1333)):
        assert (T.get_size_with_aspect_ratio(hw, size, mx)
                == J.get_size_with_aspect_ratio(hw, size, mx))
    for size, mx in ((64, None), ((50, 70), None), (120, 150)):
        _same(T.resize(clip, targets, size, mx),
              J.resize(clip, targets, size, mx))
    _same(T.resize(clip, None, 64), J.resize(clip, None, 64))
    for region in ((10, 20, 40, 50), (0, 0, h, w), (70, 140, 20, 20)):
        _same(T.crop(clip, targets, region), J.crop(clip, targets, region))
    _same(T.hflip(clip, targets), J.hflip(clip, targets))
    _same(T.hflip(clip, None), J.hflip(clip, None))
    anno = [{"bbox": [5, 6, 30, 40]}, {"bbox": [150, 80, 30, 30]},
            {"bbox": [10, 10, 0, 5]}]
    _same(T.prepare(w, h, anno), J.prepare(w, h, anno))

    # the composable objects, each with its own Generator of one seed
    for seed in range(3):
        for make in (lambda m, g: m.RandomHorizontalFlip(0.5, rng=g),
                     lambda m, g: m.RandomResize([64, 80, 96], 200, rng=g),
                     lambda m, g: m.RandomSizeCrop(30, 70, True, rng=g),
                     lambda m, g: m.RandomSizeCrop(30, 70, False, rng=g),
                     lambda m, g: m.ToTensorNormalize()):
            _same(make(T, np.random.default_rng(seed))(clip, targets),
                  make(J, np.random.default_rng(seed))(clip, targets))

    # the factory: train (cautious or not) and test at several
    # resolutions, each call drawing from the pipeline's own Generator
    for image_set, cautious, res in (("train", True, 224),
                                     ("train", False, 128),
                                     ("train", False, 800),
                                     ("test", True, 224), ("val", True, 336)):
        tp = T.make_video_transforms(image_set, cautious, res, seed=7)
        jp = J.make_video_transforms(image_set, cautious, res, seed=7)
        for _ in range(4):
            _same(tp(clip, targets), jp(clip, targets))

    for train in (False, True):
        tv = T.VideoTransform(train=train, resolution=64, seed=3)
        jv = J.VideoTransform(train=train, resolution=64, seed=3)
        for _ in range(3):
            _same(tv(clip, boxes), jv(clip, boxes))
