"""Whisper's log-mel spectrogram, on the input's device.

Counterpart of video_llava_tpu/ops/audio.py: frame -> periodic Hann ->
rFFT -> slaney mel filterbank -> log compression, with the JAX package's
framing (reflect padding, every frame gathered as its own row, the last
STFT frame dropped), so the frames are the same ones. The filterbank is
built once in numpy. The FFT is a library call (cuFFT on the card), as
it is an XLA op, outside any kernel, in the JAX package.

Constants follow OpenAI Whisper: 16 kHz, n_fft 400, hop 160, 80 mels,
30 s windows -> 3000 frames.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

SAMPLE_RATE = 16_000
N_FFT = 400
HOP_LENGTH = 160
N_MELS = 80
CHUNK_LENGTH = 30  # seconds
N_SAMPLES = CHUNK_LENGTH * SAMPLE_RATE  # 480000
N_FRAMES = N_SAMPLES // HOP_LENGTH  # 3000


def hz_to_mel(f):
    """Slaney mel scale (librosa's default, used by Whisper's filters)."""
    f = np.asarray(f, np.float64)
    f_min, f_sp = 0.0, 200.0 / 3
    mel = (f - f_min) / f_sp
    min_log_hz = 1000.0
    min_log_mel = (min_log_hz - f_min) / f_sp
    logstep = np.log(6.4) / 27.0
    with np.errstate(divide="ignore"):  # log(0) lies in the unused branch
        return np.where(f >= min_log_hz,
                        min_log_mel + np.log(f / min_log_hz) / logstep, mel)


def mel_to_hz(m):
    m = np.asarray(m, np.float64)
    f_min, f_sp = 0.0, 200.0 / 3
    freqs = f_min + f_sp * m
    min_log_hz = 1000.0
    min_log_mel = (min_log_hz - f_min) / f_sp
    logstep = np.log(6.4) / 27.0
    return np.where(
        m >= min_log_mel, min_log_hz * np.exp(logstep * (m - min_log_mel)),
        freqs
    )


@functools.lru_cache()
def mel_filterbank(n_mels: int = N_MELS, n_fft: int = N_FFT,
                   sr: int = SAMPLE_RATE) -> np.ndarray:
    """(n_mels, n_fft//2 + 1) slaney-normalized triangular filters
    (librosa.filters.mel's)."""
    fft_freqs = np.linspace(0, sr / 2, n_fft // 2 + 1)
    mel_pts = np.linspace(hz_to_mel(0.0), hz_to_mel(sr / 2.0), n_mels + 2)
    hz_pts = mel_to_hz(mel_pts)
    fdiff = np.diff(hz_pts)
    ramps = hz_pts[:, None] - fft_freqs[None, :]
    lower = -ramps[:-2] / fdiff[:-1, None]
    upper = ramps[2:] / fdiff[1:, None]
    weights = np.maximum(0, np.minimum(lower, upper))
    enorm = 2.0 / (hz_pts[2:n_mels + 2] - hz_pts[:n_mels])
    return (weights * enorm[:, None]).astype(np.float32)


def log_mel_spectrogram(audio, n_mels: int = N_MELS,
                        pad_to_chunk: bool = True,
                        device=None) -> torch.Tensor:
    """PCM float32 (n_samples,) at 16 kHz -> (n_mels, n_frames) f32
    log-mel with Whisper's normalization, on audio's device (or
    `device` for a numpy input)."""
    x = torch.as_tensor(audio, device=device).float()
    if pad_to_chunk:
        n = x.shape[0]
        x = F.pad(x, (0, N_SAMPLES - n)) if n < N_SAMPLES else x[:N_SAMPLES]
    # Whisper's STFT is centered: reflect-pad half a window each side
    x = F.pad(x[None, None], (N_FFT // 2, N_FFT // 2), mode="reflect")[0, 0]
    frames = x.unfold(0, N_FFT, HOP_LENGTH)  # (frames, n_fft)
    window = torch.as_tensor(np.hanning(N_FFT + 1)[:-1].astype(np.float32),
                             device=x.device)
    stft = torch.fft.rfft(frames * window, dim=-1)
    # Whisper drops the last STFT frame
    mag2 = stft[:-1].abs() ** 2  # (frames - 1, n_fft // 2 + 1)
    mel = torch.as_tensor(mel_filterbank(n_mels), device=x.device) @ mag2.T
    log_spec = torch.log10(torch.clamp(mel, min=1e-10))
    log_spec = torch.maximum(log_spec, log_spec.max() - 8.0)
    return (log_spec + 4.0) / 4.0
