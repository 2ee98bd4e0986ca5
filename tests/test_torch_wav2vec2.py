"""The port's wav2vec2 CTC model (models/wav2vec2.forward) against the
JAX package's on the same tiny f32 parameters (engine/convert.
wav2vec2_from_jax): the aligner's emissions of a 1.3 s clip, which the
JAX package zero-pads to 2 s before the forward (its group norm sees the
pad), and a bare forward. Tolerance 1e-4 absolute on f32 log-probs."""

import numpy as np
import jax.numpy as jnp
import torch

from torch_audio_pair import char_vocab, speech_wave, wav2vec2_pair
from video_llava_tpu.audio.align import ForcedAligner as JAligner
from video_llava_tpu.models import wav2vec2 as jw2v
from video_llava_tpu_torch.audio.align import ForcedAligner
from video_llava_tpu_torch.models import wav2vec2 as tw2v

TOL = 1e-4
JCFG = jw2v.Wav2Vec2Config.tiny_test()
TCFG = tw2v.Wav2Vec2Config.tiny_test()


def test_aligner_emissions_match_jax():
    jp, tp = wav2vec2_pair()
    audio = speech_wave(1.3)
    padded = np.concatenate([audio, np.zeros(32000 - len(audio),
                                             np.float32)])
    want = np.asarray(jw2v.forward(jp, jnp.asarray(padded), JCFG))
    want = want[:JCFG.num_frames(len(audio))]
    got = ForcedAligner(tp, TCFG, char_vocab(7)).emissions(audio)
    assert got.dtype == np.float32 and got.shape == want.shape == (65, 12)
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)
    # the pad is seen: emissions of the bare clip differ
    bare = tw2v.forward(tp, torch.from_numpy(audio), TCFG).numpy()
    assert bare.shape == got.shape and np.abs(bare - got).max() > 1e-3


def test_forward_matches_jax():
    jp, tp = wav2vec2_pair(seed=3)
    audio = speech_wave(0.75, seed=2)
    want = jw2v.forward(jp, jnp.asarray(audio), JCFG)
    got = tw2v.forward(tp, torch.from_numpy(audio), TCFG)
    assert got.shape == (TCFG.num_frames(len(audio)), 12)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=TOL)


def test_config_matches_jax():
    for make in ("base", "tiny_test"):
        j, t = getattr(jw2v.Wav2Vec2Config, make)(), getattr(
            tw2v.Wav2Vec2Config, make)()
        assert t.frame_stride == j.frame_stride
        assert [t.num_frames(n) for n in (16000, 48000, 480123)] == [
            j.num_frames(n) for n in (16000, 48000, 480123)]
    assert JAligner  # the JAX aligner module imports beside the port's
