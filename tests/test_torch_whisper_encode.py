"""The port's Whisper encoder (models/whisper.encode) against the JAX
package's on the same f32 parameters (carried by engine/convert.
whisper_from_jax) and the same seeded log-mel: the tiny configuration
with its per-layer states, and Whisper `base` at full width in f32 (the
chat CLI's --use_asr model) through ops/attention.multi_head_attention,
which on the CPU takes the reference.
Tolerance: 1e-4 absolute on states of order 1 (f32, other summation
orders); the base-width check 2e-4 over 6 layers of width 512."""

import numpy as np
import jax.numpy as jnp
import torch

from torch_audio_pair import whisper_pair
from video_llava_tpu.models import whisper as jwhisper
from video_llava_tpu_torch.models import whisper as twhisper

TOL = 1e-4


def _mel(b, frames, seed=0):
    return np.random.default_rng(seed).normal(
        size=(b, 80, frames)).astype(np.float32)


def test_tiny_encoder_matches_jax():
    jp, tp = whisper_pair()
    mel = _mel(2, 1200)
    cfg = jwhisper.WhisperConfig.tiny_test()
    want, want_states = jwhisper.encode(jp, jnp.asarray(mel), cfg,
                                        return_layer_states=True)
    got, states = twhisper.encode(tp, torch.from_numpy(mel),
                                  twhisper.WhisperConfig.tiny_test(),
                                  return_layer_states=True)
    assert got.shape == (2, 600, 64) and states.shape == (2, 2, 600, 64)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=TOL)
    np.testing.assert_allclose(states.numpy(), np.asarray(want_states),
                               rtol=0, atol=TOL)
    plain = twhisper.encode(tp, torch.from_numpy(mel),
                            twhisper.WhisperConfig.tiny_test())
    torch.testing.assert_close(plain, got, rtol=0, atol=0)


def test_base_f32_encoder_matches_jax():
    """Whisper base, f32, on a short mel, against the JAX package: the
    parity of the f32 encoder at full width. Where f32 operands go on the
    card (kernel 7's f32 body) is held by test_torch_flash_forward_f32's
    dispatch test, tests/test_torch_kernels_gpu.py and chip_smoke.py."""
    jp, tp = whisper_pair("base")
    mel = _mel(1, 200, seed=1)
    want = jwhisper.encode(jp, jnp.asarray(mel),
                           jwhisper.WhisperConfig.base())
    got = twhisper.encode(tp, torch.from_numpy(mel),
                          twhisper.WhisperConfig.base())
    assert got.dtype == torch.float32 and got.shape == (1, 100, 512)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=2e-4)


def test_converted_tree_matches_the_port_layout():
    jp, tp = whisper_pair()
    enc = tp["encoder"]
    assert len(enc["layers"]) == 2 and len(tp["decoder"]["layers"]) == 2
    np.testing.assert_array_equal(
        enc["conv1"]["weight"].numpy(),
        np.asarray(jp["encoder"]["conv1"]["kernel"]).transpose(2, 1, 0))
    np.testing.assert_array_equal(
        enc["layers"][1]["attn"]["q"]["kernel"].numpy(),
        np.asarray(jp["encoder"]["layers"]["attn"]["q"]["kernel"][1]))
    assert "bias" not in enc["layers"][0]["attn"]["k"]
