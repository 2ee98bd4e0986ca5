"""The port's Transcriber (audio/transcribe.py) against the JAX
package's on the same tiny f32 Whisper + TL-TR head: a 35 s waveform in
two 30 s chunks gives the same segments (bounds and text equal, tag
logits within 1e-4, the same keep decisions), with and without the
timestamp split; the linear-probe and no-head modes; the keep rule."""

import numpy as np
import pytest
import torch

from torch_audio_pair import letters, speech_wave, whisper_at_pair, \
    whisper_pair
from video_llava_tpu.audio import transcribe as jtr
from video_llava_tpu.models import whisper as jwhisper
from video_llava_tpu_torch.audio import transcribe as ttr
from video_llava_tpu_torch.models import whisper as twhisper

TOL = 1e-4


def _pair(jp, tp, **kw):
    kw = {"start_tokens": (1,), "eot_token": 2, "max_new_tokens": 6,
          "decode_text": letters(7), **kw}
    j = jtr.Transcriber(jp, jwhisper.WhisperConfig.tiny_test(), **kw)
    t = ttr.Transcriber(tp, twhisper.WhisperConfig.tiny_test(), **kw)
    return j, t


def _same(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert (g.start, g.end, g.text, g.keep) == (w.start, w.end, w.text,
                                                    w.keep)
        assert g.speech_logit == pytest.approx(w.speech_logit, abs=TOL)
        assert g.music_logit == pytest.approx(w.music_logit, abs=TOL)


def test_two_chunk_segments_match_jax():
    jp, tp = whisper_at_pair()
    j, t = _pair(jp, tp, at_cfg=jwhisper.WhisperATConfig.tiny_test(),
                 speech_tag=(0, 3), music_tags=(1, 2))
    t.at_cfg = twhisper.WhisperATConfig.tiny_test()
    audio = speech_wave(35.0)
    want = j.transcribe_audio(audio)
    got = t.transcribe_audio(audio)
    assert [(s.start, s.end) for s in got] == [(0.0, 30.0), (30.0, 35.0)]
    assert all(s.text for s in got)
    _same(got, want)
    # the timestamp path: a timestamp band above the vocabulary is never
    # emitted, so each chunk is one span ending at the audio's end
    kw = dict(timestamp_begin=256, timestamp_start_tokens=(1,))
    j2, t2 = _pair(jp, tp, at_cfg=jwhisper.WhisperATConfig.tiny_test(), **kw)
    t2.at_cfg = twhisper.WhisperATConfig.tiny_test()
    _same(t2.transcribe_audio(audio, with_timestamps=True),
          j2.transcribe_audio(audio, with_timestamps=True))


def test_linear_probe_and_no_head_match_jax():
    jp, tp = whisper_pair()
    audio = speech_wave(3.0, seed=1)
    j, t = _pair(jp, tp)
    _same(t.transcribe_audio(audio), j.transcribe_audio(audio))
    j, t = _pair({k: v for k, v in jp.items() if k != "at_head"},
                 {k: v for k, v in tp.items() if k != "at_head"})
    got = t.transcribe_audio(audio)
    _same(got, j.transcribe_audio(audio))
    assert got[0].keep and t.transcribe_audio(np.zeros(0, np.float32)) == []


def test_keep_rule_and_chunks():
    keep = ttr.Segment(0, 1, "hi", speech_logit=2.0, music_logit=0.5)
    drop = ttr.Segment(0, 1, "la", speech_logit=1.0, music_logit=0.5)
    none = ttr.Segment(0, 1, "x", speech_logit=-3.0)
    for s in (keep, drop, none):
        j = jtr.Segment(s.start, s.end, s.text, s.speech_logit,
                        s.music_logit)
        assert s.keep == j.keep
    assert [s.text for s in ttr.filter_segments([keep, drop, none])] == [
        "hi", "x"]
    _, tp = whisper_pair()
    t = ttr.Transcriber(tp, twhisper.WhisperConfig.tiny_test(), str)
    assert t._chunk(np.zeros(ttr.N_SAMPLES + 1600, np.float32)).shape == (
        2, ttr.N_SAMPLES)


def test_builders_random_branch():
    """build_default_transcriber / build_default_aligner through the
    random-init branch on the CPU: the JAX builders' configurations,
    start and eot tokens, filter mode and vocabulary; checkpoint
    arguments that name no directory (no file for the head) take the
    random-init branch as in the JAX package, an aligner attached where
    one is asked for."""
    from video_llava_tpu.audio import builders as jb
    from video_llava_tpu_torch.audio import builders as tb

    t = tb.build_default_transcriber(size="tiny-test", device="cpu")
    j = jb.build_default_transcriber(size="tiny-test")
    assert (t.start_tokens, t.eot_token, t._at_mode, t.max_new_tokens) == (
        j.start_tokens, j.eot_token, j._at_mode, j.max_new_tokens)
    assert t.cfg.__dict__ == j.cfg.__dict__ and t.dtype == torch.float32
    ta, ja = tb.build_default_aligner(device="cpu"), jb.build_default_aligner()
    assert ta.vocab == ja.vocab and ta.cfg.__dict__ == ja.cfg.__dict__
    for kw in ({"checkpoint_dir": "ckpt"}, {"at_checkpoint": "at.pth"},
               {"align_checkpoint_dir": "w2v"}):
        t = tb.build_default_transcriber(size="tiny-test", device="cpu",
                                         **kw)
        j = jb.build_default_transcriber(size="tiny-test", **kw)
        assert (t.start_tokens, t.eot_token, t._at_mode) == (
            j.start_tokens, j.eot_token, j._at_mode), kw
        assert (t.aligner is None) == (j.aligner is None), kw
        assert t.decode_text([5, 6]) == j.decode_text([5, 6]) == ""
    ta, ja = (tb.build_default_aligner("w2v", device="cpu"),
              jb.build_default_aligner("w2v"))
    assert ta.vocab == ja.vocab and ta.cfg.__dict__ == ja.cfg.__dict__
