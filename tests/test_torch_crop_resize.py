"""The crop filter's batched crop resize and the bicubic preprocess,
port against the JAX package, on seeded uint8 frames: in a loop,
crop_resize_bicubic_batch at 24 px (upsampling) and 8 px (antialiased
downsampling) over fractional boxes inside, across and outside the
frame's edges, degenerate and inverted ones, within 1e-3 of 255;
crop_resize_weights exactly as the JAX ones (1e-6); center_crop at even
and odd margins; preprocess_frames(resize_mode='bicubic') of landscape
and portrait frames within 1e-5 (its uint8 rounding equal). The
per-crop host formulation (resize_bicubic of each clamped slice) agrees
with the batch within 3e-3 (1.2e-5 of 255: the crop's weights sum in
another order)."""

import numpy as np
import jax.numpy as jnp
import torch

from torch_xmem_pair import one_torch_thread
from video_llava_tpu.ops import image as jimg
from video_llava_tpu_torch.ops import image as timg

BOXES = np.asarray([
    [[3.7, 5.2, 30.9, 40.1], [-6.5, -3.2, 20.4, 11.8],
     [50.3, 30.6, 90.0, 70.0], [60.2, 10.0, 60.9, 10.4]],
    [[0.0, 0.0, 72.0, 48.0], [70.1, 46.7, 71.9, 47.9],
     [80.0, 50.0, 95.0, 60.0], [20.9, 30.2, 10.1, 5.5]],
], np.float32)


@one_torch_thread()
def test_crop_resize_and_preprocess_match_jax():
    rng = np.random.default_rng(0)
    frames = rng.integers(0, 256, size=(2, 48, 72, 3), dtype=np.uint8)
    for size in (24, 8):
        want = np.asarray(jimg.crop_resize_bicubic_batch(
            jnp.asarray(frames), jnp.asarray(BOXES), size))
        got = timg.crop_resize_bicubic_batch(torch.from_numpy(frames),
                                             torch.from_numpy(BOXES), size)
        assert got.shape == want.shape == (2, 4, size, size, 3)
        np.testing.assert_allclose(got.numpy(), want, atol=1e-3)
        # the per-crop host slices (the filter's embed_crops clamp) of the
        # boxes that start inside the frame (the others slice nothing)
        for f in range(2):
            for b in range(4):
                x0, y0, x1, y1 = BOXES[f, b].astype(int)
                if x0 >= 72 or y0 >= 48:
                    continue
                x0, y0 = max(x0, 0), max(y0, 0)
                x1, y1 = min(max(x1, x0 + 1), 72), min(max(y1, y0 + 1), 48)
                one = timg.resize_bicubic(torch.from_numpy(
                    frames[f, y0:y1, x0:x1].astype(np.float32)), size, size)
                np.testing.assert_allclose(one.numpy(), got[f, b].numpy(),
                                           atol=3e-3)
    lo = np.asarray([[0, 5], [40, 47]], np.int32)
    hi = np.asarray([[10, 48], [47, 48]], np.int32)
    np.testing.assert_allclose(
        timg.crop_resize_weights(torch.from_numpy(lo), torch.from_numpy(hi),
                                 48, 16).numpy(),
        np.asarray(jimg.crop_resize_weights(jnp.asarray(lo),
                                            jnp.asarray(hi), 48, 16)),
        atol=1e-6)

    for shape, size in (((3, 48, 72, 3), 32), ((2, 50, 37, 3), 17)):
        x = rng.integers(0, 256, size=shape, dtype=np.uint8)
        np.testing.assert_array_equal(
            timg.center_crop(torch.from_numpy(x), size).numpy(),
            np.asarray(jimg.center_crop(jnp.asarray(x), size)))
        want = np.asarray(jimg.preprocess_frames(x, size,
                                                 resize_mode="bicubic"))
        got = timg.preprocess_frames(torch.from_numpy(x), size,
                                     resize_mode="bicubic")
        assert got.shape == want.shape == (shape[0], size, size, 3)
        np.testing.assert_allclose(got.numpy(), want, atol=1e-5)
