"""The port's whisper-at TL-TR head (models/whisper.
audio_tag_logits_tltr) against the JAX package's on the same tiny f32
head and seeded layer states: windowed logits (25 pooled tokens a
window, as the transcriber reads them), whole-clip logits, and the
legacy linear probe. Tolerance 1e-4 absolute (f32 logits of order 1)."""

import numpy as np
import jax.numpy as jnp
import torch

from torch_audio_pair import tltr_pair, whisper_pair
from video_llava_tpu.models import whisper as jwhisper
from video_llava_tpu_torch.models import whisper as twhisper

TOL = 1e-4
JAT = jwhisper.WhisperATConfig.tiny_test(rep_dim=64)
TAT = twhisper.WhisperATConfig.tiny_test(rep_dim=64)


def _states(seed=0, L=2, b=2, T=1500):
    return np.random.default_rng(seed).normal(
        size=(L, b, T, 64)).astype(np.float32)


def test_tltr_windowed_logits_match_jax():
    jh, th = tltr_pair()
    states = _states()
    want = jwhisper.audio_tag_logits_tltr(jh, jnp.asarray(states), JAT,
                                          window_tokens=25)
    got = twhisper.audio_tag_logits_tltr(th, torch.from_numpy(states), TAT,
                                         window_tokens=25)
    assert got.shape == (2, 3, 16)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=TOL)


def test_tltr_whole_clip_logits_match_jax():
    jh, th = tltr_pair(seed=2)
    states = _states(seed=1, T=1000)
    want = jwhisper.audio_tag_logits_tltr(jh, jnp.asarray(states), JAT)
    got = twhisper.audio_tag_logits_tltr(th, torch.from_numpy(states), TAT)
    assert got.shape == (2, 16)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=TOL)


def test_tr_block_and_linear_probe_match_jax():
    jh, th = tltr_pair()
    x = np.random.default_rng(4).normal(size=(3, 25, 32)).astype(np.float32)
    want = jwhisper._tr_block(jh["time_tr"][0], jnp.asarray(x), 2)
    got = twhisper._tr_block(th["time_tr"][0], torch.from_numpy(x), 2)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=TOL)
    jp, tp = whisper_pair()
    enc = np.random.default_rng(5).normal(size=(2, 50, 64)).astype(
        np.float32)
    want = jwhisper.audio_tag_logits(jp, jnp.asarray(enc))
    got = twhisper.audio_tag_logits(tp, torch.from_numpy(enc))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=TOL)
