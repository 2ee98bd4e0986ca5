"""Port parity: the W8A8 CLIP tower (JAX quantize_params(vision,
a8=True)) carried across by engine.convert.clip_vision_from_jax, and
CLIP's frame_batch chunking."""

import numpy as np
import jax
import jax.numpy as jnp
import torch

from video_llava_tpu.config import CLIPVisionConfig
from video_llava_tpu.models import clip as jax_clip
from video_llava_tpu.ops.quant import quantize_params
from video_llava_tpu_torch.engine.convert import clip_vision_from_jax
from video_llava_tpu_torch.models.clip import quantize_a8_
from video_llava_tpu_torch.models.layers import Int8A8Kernel


def test_w8a8_tower_and_frame_batch_match_jax():
    """A 3-layer tower (32 px, 4 patches + CLS), f32, every kernel
    W8A8 at min_size 1 << 10.

    Tolerance: the int8 values and int32 sums are exact on both sides,
    but the f32 activations they quantize differ by summation order
    (~1e-7 relative), so a row value on a rounding tie of x / sx may
    round the other way: that moves one int32 sum by one weight value,
    an output by at most sx * scale * 127 (one step of the row times
    one channel's absmax). Measured here: 5.7e-7 of max |feature|
    (no flip); the dense tower is 1.6e-2 away. The limit, 1e-3 of max
    |feature|, passes a flip's step and fails an unquantized tower, a
    wrong scale or layout. Chunked frames equal unchunked ones exactly
    (every op is per frame)."""
    torch.set_num_threads(1)
    cfg = CLIPVisionConfig(image_size=32, patch_size=16, hidden_size=64,
                           intermediate_size=128, num_layers=3, num_heads=4)
    dense = jax_clip.init_vision_params(jax.random.PRNGKey(1), cfg,
                                        jnp.float32)
    params = quantize_params(dense, min_size=1 << 10, a8=True)
    tower = clip_vision_from_jax(jax.tree.map(np.asarray, params), cfg)
    kinds = {type(layer.q.kernel) for layer in tower.layers} | {
        type(layer.fc2.kernel) for layer in tower.layers}
    assert kinds == {Int8A8Kernel}

    # the port's own quantizer on the dense tower gives the same leaves
    mine = quantize_a8_(clip_vision_from_jax(
        jax.tree.map(np.asarray, dense), cfg), min_size=1 << 10)
    ref = dict(tower.named_parameters())
    for name, p in mine.named_parameters():
        assert p.dtype == ref[name].dtype, name
        assert torch.equal(p, ref[name]), name
    # a kernel of fewer elements than min_size stays as it is
    kept = quantize_a8_(clip_vision_from_jax(
        jax.tree.map(np.asarray, dense), cfg), min_size=1 << 20)
    assert isinstance(kept.layers[0].q.kernel, torch.Tensor)

    rng = np.random.default_rng(0)
    pixels = rng.standard_normal((6, 32, 32, 3)).astype(np.float32)
    want = np.asarray(jax_clip.encode_frames(params, jnp.asarray(pixels),
                                             cfg))
    got = tower.encode_frames(torch.from_numpy(pixels)).numpy()
    assert got.shape == want.shape == (6, 4, 64)
    scale = np.abs(want).max()
    err = np.abs(got - want).max() / scale
    assert err < 1e-3, err

    # frame_batch: chunks of 2 and 3 frames against the whole batch and
    # against the JAX scan; 4 does not divide 6, so no chunking
    for fb in (2, 3, 4):
        chunked = tower.encode_frames(torch.from_numpy(pixels), fb).numpy()
        np.testing.assert_array_equal(chunked, got)
        jax_chunked = np.asarray(jax_clip.encode_frames(
            params, jnp.asarray(pixels), cfg, fb))
        assert np.abs(chunked - jax_chunked).max() / scale < 1e-3
