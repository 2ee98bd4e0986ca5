"""Port parity: the CLIP vision tower and video encode, with the JAX
parameters carried over by engine.convert.params_from_jax."""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import torch

from video_llava_tpu.config import VideoLLaVAConfig
from video_llava_tpu.models import clip as jax_clip
from video_llava_tpu.models import video_llava as jax_vl
from video_llava_tpu.ops.image import preprocess_frames as jax_preprocess
from video_llava_tpu_torch.engine.convert import params_from_jax
from video_llava_tpu_torch.models.clip import padded_length
from video_llava_tpu_torch.ops.image import preprocess_frames


def test_encode_frames_and_video_match_jax():
    """Tiny tower (2 layers, 56 px, 16 patches + CLS = 17 -> 32 padded),
    f32 params: patch features and pooled video features agree to 1e-4
    (f32 products summed in another order through two layers)."""
    cfg = VideoLLaVAConfig.tiny()
    params = jax_vl.init_params(jax.random.PRNGKey(0), cfg, jnp.float32)
    model = params_from_jax(jax.tree.map(np.asarray, params), cfg)
    rng = np.random.default_rng(0)
    frames = rng.integers(0, 256, size=(7, 64, 80, 3), dtype=np.uint8)
    pixels = np.asarray(jax_preprocess(frames, cfg.vision.image_size))
    np.testing.assert_allclose(
        preprocess_frames(torch.from_numpy(frames),
                          cfg.vision.image_size).numpy(),
        pixels, atol=1e-6)
    tp = torch.from_numpy(pixels.copy())

    want = np.asarray(jax_clip.encode_frames(
        params["vision"], jnp.asarray(pixels), cfg.vision))
    got = model.vision.encode_frames(tp).numpy()
    assert got.shape == (7, cfg.vision.num_patches, cfg.vision.hidden_size)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)

    want = np.asarray(jax_vl.encode_video(
        params, jnp.asarray(pixels), cfg, num_valid_frames=jnp.int32(5)))
    got = model.encode_video(tp, num_valid_frames=5).numpy()
    assert got.shape == (cfg.video_token_len, cfg.vision.hidden_size)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)


def test_padded_length_rule():
    """257 -> 272 at 224 px and 577 -> 640 at 336 px."""
    assert padded_length(257) == 272
    assert padded_length(577) == 640
    assert padded_length(17) == 32


def test_bf16_tree_carries_the_same_bytes():
    cfg = dataclasses.replace(VideoLLaVAConfig.tiny())
    params = jax_vl.init_params(jax.random.PRNGKey(1), cfg, jnp.bfloat16)
    tree = jax.tree.map(np.asarray, params)
    model = params_from_jax(tree, cfg)
    want = tree["vision"]["layers"]["q"]["kernel"][1]
    got = model.vision.layers[1].q.kernel
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.view(torch.int16).numpy(),
                                  want.view(np.int16))
