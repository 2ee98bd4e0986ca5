"""grounding/tagging.py against the JAX package's tagger on the tiny
Swin with a linear tag head (parameters carried across by
engine/convert): tag logits within 1e-4 (the head's tanh GELU included),
run_on_frames_raw from uint8 frames in two batches (the last padded),
run_on_video's top tags and get_unique_tags, equal. The threshold sits
at the median probability, far (> 1e-3) from every probability, so the
tag lists are not decided by rounding."""

import numpy as np
import jax.numpy as jnp
import torch

from video_llava_tpu.grounding import tagging as jtag
from video_llava_tpu.models import swin as jswin
from video_llava_tpu_torch.grounding import tagging as ttag
from video_llava_tpu_torch.models import swin as tswin
from torch_grounding_pair import tagger_pair, textured_frames

TAGS = [f"tag{i}" for i in range(20)]


def test_tagging_matches_jax():
    (jb, jh), (tb, th) = tagger_pair(len(TAGS))
    cfg, tcfg = jswin.SwinConfig.tiny_test(), tswin.SwinConfig.tiny_test()
    rng = np.random.default_rng(0)
    px = rng.standard_normal((2, 64, 64, 3)).astype(np.float32)
    want = np.asarray(jtag.tag_logits(jb, jh, jnp.asarray(px), cfg))
    got = ttag.tag_logits(tb, th, torch.from_numpy(px), tcfg).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4)

    frames = textured_frames(7, 48, 80, seed=2)
    frames[3:] //= 2  # darker frames tag differently
    jmod = jtag.TaggingModule(jb, jh, cfg, TAGS)
    probs = np.concatenate([np.asarray(jmod._raw_fwd(64)(
        jb, jh, jnp.asarray(frames)))])
    probs = 1 / (1 + np.exp(-probs))
    thr = float(np.median(probs))
    assert np.abs(probs - thr).min() > 1e-3
    jmod.threshold = thr
    tmod = ttag.TaggingModule(tb, th, tcfg, TAGS, threshold=thr)
    want = jmod.run_on_frames_raw(frames, image_size=64, batch_size=4)
    got = tmod.run_on_frames_raw(frames, image_size=64, batch_size=4)
    assert got == want and any(want)
    got_dev = tmod.run_on_frames_raw(torch.from_numpy(frames),
                                     image_size=64, batch_size=4)
    assert got_dev == want
    assert ttag.get_unique_tags(got) == jtag.get_unique_tags(want)
    assert ttag.get_unique_tags([["a", "b"], ["b"], ["c", "b", "a"]]) == [
        "b", "a", "c"]
    norm = rng.standard_normal((3, 64, 64, 3)).astype(np.float32)
    assert tmod.run_on_frames(norm) == jmod.run_on_frames(norm)
