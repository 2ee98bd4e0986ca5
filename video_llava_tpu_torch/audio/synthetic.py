"""Synthetic audio and text for running the audio path with random
weights: the benchmark's speech-band waveform, its id-to-letters text
decoding and the aligner's letter vocabulary (bench.py's
_build_transcriber and its waveform), shared by chip_smoke.py and the
parity tests."""

from __future__ import annotations

import numpy as np


def speech_wave(seconds: float, seed: int = 0, rate: int = 16000,
                noise: float = 0.01, pcm16: bool = False) -> np.ndarray:
    """A speech-band waveform at `rate` Hz, float32: chirps of 200-380 Hz
    restarting every 3 s, a 440 Hz tone gated on and off, plus `noise`
    times seeded normal noise; pcm16 rounds it as a 16-bit WAV holds it
    and reads it back."""
    t = np.arange(int(seconds * rate)) / rate
    x = 0.4 * np.sin(2 * np.pi * (200 + 60 * (t % 3)) * t)
    x += 0.2 * np.sin(2 * np.pi * 440 * t) * (np.sin(0.7 * t) > 0)
    if noise:
        x += noise * np.random.default_rng(seed).normal(size=t.shape)
    if pcm16:
        x = (x * 32767).astype(np.int16) / 32768.0
    return x.astype(np.float32)


def char_vocab(n_letters: int) -> dict:
    """The aligner's vocabulary: blank 0, word delimiter 4, letters from
    5 on."""
    return {"<pad>": 0, "|": 4, **{chr(ord("A") + i): 5 + i
                                   for i in range(n_letters)}}


def letter_words(n_letters: int):
    """A decode_text for random weights: each id -> a word of three
    letters of char_vocab(n_letters), so the aligner and the transcript
    splice get text of a real length."""
    def decode_text(ids):
        return " ".join(
            "".join(chr(ord("A") + (int(i) >> (4 * s)) % n_letters)
                    for s in range(3))
            for i in ids)
    return decode_text
