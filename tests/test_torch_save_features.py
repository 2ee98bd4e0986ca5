"""Port parity: scripts/save_features' extract step against the JAX
functions it composes (normalize_clip, vision_penultimate_patches,
spatio_temporal_pool in f32), and main over a directory: one pickle a
video, resume by existence, a failing video skipped."""

import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import torch

from video_llava_tpu.config import CLIPVisionConfig as JaxVisionConfig
from video_llava_tpu.models import clip as jax_clip
from video_llava_tpu.ops.image import normalize_clip as jax_normalize
from video_llava_tpu.ops.pooling import spatio_temporal_pool as jax_pool
from video_llava_tpu_torch.config import CLIPVisionConfig
from video_llava_tpu_torch.engine.convert import clip_vision_from_jax
from video_llava_tpu_torch.scripts import save_features


def test_extract_and_main_match_jax(tmp_path, monkeypatch, capsys):
    """A 3-layer f32 tower at 32 px (4 patches): 100 and 37 frames (the
    37 zero-padded to 100 and masked) give the JAX composition's pooled
    features to 1e-5 of their max (f32 sums in another order through
    three layers; measured 4.1e-7 and 4.9e-7)."""
    torch.set_num_threads(1)
    kw = dict(image_size=32, patch_size=16, hidden_size=64,
              intermediate_size=128, num_layers=3, num_heads=4)
    params = jax_clip.init_vision_params(jax.random.PRNGKey(2),
                                         JaxVisionConfig(**kw), jnp.float32)
    tower = clip_vision_from_jax(jax.tree.map(np.asarray, params),
                                 CLIPVisionConfig(**kw))
    rng = np.random.default_rng(0)
    clips = {"a.mp4": rng.integers(0, 256, (100, 32, 32, 3), np.uint8),
             "b.mp4": rng.integers(0, 256, (37, 32, 32, 3), np.uint8)}

    @jax.jit
    def jax_extract(frames, n_valid):
        pixels = jax_normalize(frames, dtype=jnp.float32)
        feats = jax_clip.vision_penultimate_patches(
            params, pixels, JaxVisionConfig(**kw))
        return jax_pool(feats, num_valid_frames=n_valid,
                        out_dtype=jnp.float32)

    want = {}
    for name, frames in clips.items():
        t = frames.shape[0]
        padded = np.pad(frames, ((0, 100 - t), (0, 0), (0, 0), (0, 0)))
        want[name] = np.asarray(jax_extract(jnp.asarray(padded),
                                            jnp.int32(t)))
        got = save_features.video_features(tower, save_features.extract,
                                           frames)
        assert got.dtype == np.float32 and got.shape == (104, 64)
        assert np.abs(got - want[name]).max() < 1e-5 * np.abs(
            want[name]).max()

    # main: the tower swapped for the tiny one, load_video for the seeded
    # clips; c.mp4 fails to read and is skipped, then a rerun resumes
    vids, feats = tmp_path / "vids", tmp_path / "feats"
    vids.mkdir()
    for name in ("a.mp4", "b.mp4", "c.mp4"):
        (vids / name).write_bytes(b"")

    def load_video(path, num_frm, shape):
        assert (num_frm, shape) == (100, (224, 224))
        name = os.path.basename(path)
        if name not in clips:
            raise OSError(f"cannot decode {name}")
        return clips[name]

    monkeypatch.setattr(save_features, "load_video", load_video)
    monkeypatch.setattr(save_features, "build_extractor",
                        lambda *a, **k: (None, tower, save_features.extract))
    argv = ["--video_dir_path", str(vids), "--clip_feat_path", str(feats),
            "--device", "cpu"]
    save_features.main(argv)
    out = capsys.readouterr().out
    assert "Can't process c.mp4: cannot decode c.mp4" in out
    assert "finished: 2 new feature files" in out
    assert sorted(os.listdir(feats)) == ["a.pkl", "b.pkl"]
    for name in ("a", "b"):
        with open(feats / f"{name}.pkl", "rb") as f:
            got = pickle.load(f)
        assert np.abs(got - want[f"{name}.mp4"]).max() < 1e-5 * np.abs(
            got).max()
    save_features.main(argv)
    assert "finished: 0 new feature files" in capsys.readouterr().out
