"""The port's log-mel spectrogram (ops/audio.py) against the JAX
package's on the same seeded waveforms: f32, within 1e-4 absolute (the
two FFTs sum in different orders; the values are of order 1)."""

import numpy as np
import jax.numpy as jnp
import torch

from video_llava_tpu.ops import audio as jaudio
from video_llava_tpu_torch.ops import audio as taudio

TOL = 1e-4


def _wave(n, seed=0):
    rng = np.random.default_rng(seed)
    t = np.arange(n) / 16000
    x = 0.3 * np.sin(2 * np.pi * 440 * t) + 0.05 * rng.normal(size=n)
    return x.astype(np.float32)


def test_log_mel_matches_jax():
    for n in (16000 * 7 + 123, taudio.N_SAMPLES + 4000):
        x = _wave(n)
        want = np.asarray(jaudio.log_mel_spectrogram(jnp.asarray(x)))
        got = taudio.log_mel_spectrogram(x, device="cpu")
        assert got.dtype == torch.float32
        assert got.shape == want.shape == (80, taudio.N_FRAMES)
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=TOL)


def test_filterbank_and_constants_match_jax():
    for name in ("SAMPLE_RATE", "N_FFT", "HOP_LENGTH", "N_MELS",
                 "CHUNK_LENGTH", "N_SAMPLES", "N_FRAMES"):
        assert getattr(taudio, name) == getattr(jaudio, name), name
    np.testing.assert_array_equal(taudio.mel_filterbank(),
                                  jaudio.mel_filterbank())
    np.testing.assert_array_equal(taudio.mel_filterbank(128),
                                  jaudio.mel_filterbank(128))


def test_log_mel_without_chunk_padding():
    x = _wave(16000 * 2, seed=1)
    want = np.asarray(jaudio.log_mel_spectrogram(jnp.asarray(x),
                                                 pad_to_chunk=False))
    got = taudio.log_mel_spectrogram(torch.from_numpy(x), pad_to_chunk=False)
    assert got.shape == want.shape == (80, 200)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=TOL)
