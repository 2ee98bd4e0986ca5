"""ops/image.py resize_bicubic against jax.image.resize(method='bicubic',
antialias=True) as the JAX package calls it, on pixel values in [0, 255],
up and down, one axis or both, at the grounded path's real sizes too
(480 x 832 to 800, 384 and 1024). The weight matrices match jax's
compute_weight_mat to 1e-6; the result is within 1e-4 absolute of an
f64 evaluation of those weights. jax's own f32 einsum contracts both
axes in another order and strays from that reference by up to ~1e-2
(480 x 832 -> 800), so the port is held to jax within 1e-4 plus jax's
own error there."""

import numpy as np
import jax.numpy as jnp
import torch
from jax._src.image.scale import _fill_keys_cubic_kernel, compute_weight_mat

from video_llava_tpu.ops.image import resize_bicubic as j_resize
from video_llava_tpu_torch.ops.image import resize_bicubic, resize_weights


def _weights(i, o):
    if i == o:
        return np.eye(i)
    w = np.asarray(compute_weight_mat(i, o, o / i, 0.0,
                                      _fill_keys_cubic_kernel, True))
    np.testing.assert_allclose(resize_weights(i, o).numpy(), w, atol=1e-6)
    return w.astype(np.float64)


def test_resize_bicubic_matches_jax():
    rng = np.random.default_rng(0)
    for shape, (oh, ow) in (((2, 48, 80, 3), (64, 64)),  # up and down
                            ((1, 40, 24, 3), (96, 72)),  # up
                            ((2, 96, 120, 3), (32, 30)),  # down
                            ((2, 30, 50, 3), (30, 20)),  # one axis
                            ((3, 61, 37, 3), (61, 37)),  # no-op
                            ((1, 480, 832, 3), (800, 800)),
                            ((1, 480, 832, 3), (384, 384)),
                            ((1, 480, 832, 3), (1024, 1024))):
        x = rng.integers(0, 256, shape).astype(np.float32)
        want = np.asarray(j_resize(jnp.asarray(x), oh, ow))
        got = resize_bicubic(torch.from_numpy(x), oh, ow).numpy()
        assert got.shape == want.shape
        ref = np.einsum("bhwc,ho->bowc", x.astype(np.float64),
                        _weights(shape[1], oh), optimize=True)
        ref = np.einsum("bowc,wp->bopc", ref, _weights(shape[2], ow),
                        optimize=True)
        np.testing.assert_allclose(got, ref, atol=1e-4, rtol=0,
                                   err_msg=str((shape, oh, ow)))
        jax_err = np.abs(want - ref).max()
        np.testing.assert_allclose(got, want, atol=1e-4 + jax_err, rtol=0,
                                   err_msg=str((shape, oh, ow)))
