"""The port's CTC forced aligner (audio/align.py) against the JAX
package's: align_tokens gives the same spans on the same seeded
emissions (equal: the trellis is the same f32 max and add, and the JAX
package's bucket padding changes no span), the trellis equals
ctc_trellis, and ForcedAligner.align on the tiny wav2vec2 (same
parameters) gives the same words and frame-exact timings, scores within
1e-4."""

import numpy as np
import jax.numpy as jnp
import pytest

from torch_audio_pair import char_vocab, speech_wave, wav2vec2_pair
from video_llava_tpu.audio import align as jalign
from video_llava_tpu.models import wav2vec2 as jw2v
from video_llava_tpu_torch.audio import align as talign
from video_llava_tpu_torch.models import wav2vec2 as tw2v


def _emissions(rng, T, V):
    e = rng.normal(size=(T, V)) * 2.0
    e = e - np.log(np.exp(e).sum(-1, keepdims=True))
    return e.astype(np.float32)


def test_align_tokens_spans_match_jax():
    rng = np.random.default_rng(0)
    cases = [(50, 12, [5, 6, 7]), (128, 12, [5, 5, 6, 4, 7, 7, 8]),
             (300, 32, list(rng.integers(1, 32, 60))),
             (257, 32, list(rng.integers(5, 9, 90))), (3, 12, [5, 6, 7])]
    for T, V, targets in cases:
        em = _emissions(rng, T, V)
        want = jalign.align_tokens(em, targets)
        got = talign.align_tokens(em, targets)
        assert [s[:3] for s in got] == [s[:3] for s in want], (T, targets)
        np.testing.assert_allclose([s[3] for s in got],
                                   [s[3] for s in want], rtol=0, atol=1e-6)
        assert len(got) == len(targets)


def test_trellis_matches_jax():
    rng = np.random.default_rng(1)
    em = _emissions(rng, 90, 12)
    ext = np.zeros(2 * 20 + 1, np.int32)
    ext[1::2] = rng.integers(1, 12, 20)
    want_a, want_b = jalign.ctc_trellis(jnp.asarray(em), jnp.asarray(ext))
    got_a, got_b = talign.ctc_trellis(em, ext)
    np.testing.assert_array_equal(got_b, np.asarray(want_b))
    np.testing.assert_array_equal(got_a, np.asarray(want_a))


def test_word_timings_match_jax():
    jp, tp = wav2vec2_pair()
    vocab = char_vocab(7)
    audio = speech_wave(2.6, seed=4)
    text = "bad face gab fed cab"
    want = jalign.ForcedAligner(jp, jw2v.Wav2Vec2Config.tiny_test(),
                                vocab).align(audio, text, time_offset=1.5)
    got = talign.ForcedAligner(tp, tw2v.Wav2Vec2Config.tiny_test(),
                               vocab).align(audio, text, time_offset=1.5)
    assert [w.word for w in got] == [w.word for w in want] == [
        "BAD", "FACE", "GAB", "FED", "CAB"]
    for g, w in zip(got, want):
        assert (g.start, g.end) == (w.start, w.end)
        assert g.score == pytest.approx(w.score, abs=1e-4)


def test_text_to_ids_and_segments_match_jax():
    jp, tp = wav2vec2_pair()
    vocab = char_vocab(7)
    ja = jalign.ForcedAligner(jp, jw2v.Wav2Vec2Config.tiny_test(), vocab,
                              unk_id=3)
    ta = talign.ForcedAligner(tp, tw2v.Wav2Vec2Config.tiny_test(), vocab,
                              unk_id=3)
    assert ta._text_to_ids("ab, cz  de") == ja._text_to_ids("ab, cz  de")

    class Seg:
        def __init__(self, start, end, text):
            self.start, self.end, self.text = start, end, text

    audio = speech_wave(4.0, seed=5)
    segs = [Seg(0.2, 1.7, "ab ba"), Seg(1.9, 3.9, "gee dace"),
            Seg(3.0, 3.1, "")]
    want = ja.align_segments(audio, segs)
    got = ta.align_segments(audio, segs)
    assert [(w.word, w.start, w.end) for w in got] == [
        (w.word, w.start, w.end) for w in want]
