"""The port's chat with --use_asr against the JAX package's: the tiny
VideoLLaVA pair (tests/torch_slice_pair.py) and the tiny Whisper pair on
the same f32 parameters. upload_video of a WAV the test writes (its
frames from a seed: a WAV has no video stream, so load_video is stubbed
in both packages; the audio goes through each package's load_audio),
then add_text and answer: the transcript, the spliced prompt's token ids
and the answer are equal. load_audio equals the JAX package's."""

import wave

import numpy as np
import pytest

import video_llava_tpu.runtime.chat as jchat
import video_llava_tpu_torch.runtime.chat as tchat
from torch_audio_pair import letters, speech_wave, whisper_pair
from torch_slice_pair import slice_pair  # noqa: F401 (fixture)
from video_llava_tpu.audio.transcribe import Transcriber as JTranscriber
from video_llava_tpu.media.audio import load_audio as j_load_audio
from video_llava_tpu.models.whisper import WhisperConfig as JCfg
from video_llava_tpu_torch.audio.transcribe import Transcriber
from video_llava_tpu_torch.constants import (
    DEFAULT_AUDIO_TOKEN,
    DEFAULT_TRANSCRIPT_START,
)
from video_llava_tpu_torch.media.audio import load_audio
from video_llava_tpu_torch.models.whisper import WhisperConfig


def _write_wav(path, x, rate=16000):
    with wave.open(str(path), "wb") as f:
        f.setnchannels(1)
        f.setsampwidth(2)
        f.setframerate(rate)
        f.writeframes((np.clip(x, -1, 1) * 32767).astype(np.int16).tobytes())


def _recording(module, monkeypatch, ids_arg, seen):
    real = module.generate_with_keywords

    def run(*a, **kw):
        seen.append(np.asarray(a[ids_arg]).astype(np.int64))
        return real(*a, **kw)

    monkeypatch.setattr(module, "generate_with_keywords", run)


def test_asr_prompt_and_answer_match_jax(slice_pair, tmp_path, monkeypatch):
    jax_engine, engine = slice_pair
    path = tmp_path / "speech.wav"
    _write_wav(path, speech_wave(3.0, seed=2))
    frames = np.random.default_rng(0).integers(0, 256, (9, 64, 64, 3),
                                               dtype=np.uint8)
    for module in (jchat, tchat):
        monkeypatch.setattr(module, "load_video", lambda p, shape: frames)
    seen = {"jax": [], "port": []}
    _recording(jchat, monkeypatch, 3, seen["jax"])
    _recording(tchat, monkeypatch, 2, seen["port"])
    jp, tp = whisper_pair()
    # music_tags=(): the random tag probe would drop the segment
    kw = dict(start_tokens=(1,), eot_token=2, max_new_tokens=5,
              decode_text=letters(7), music_tags=())
    chats = (jchat.VideoChatGPTInterface(
                 jax_engine, use_asr=True, temperature=0.0,
                 max_output_tokens=4,
                 transcriber=JTranscriber(jp, JCfg.tiny_test(), **kw)),
             tchat.VideoChatGPTInterface(
                 engine, use_asr=True, temperature=0.0, max_output_tokens=4,
                 transcriber=Transcriber(tp, WhisperConfig.tiny_test(),
                                         **kw)))
    answers = []
    for chat in chats:
        chat.upload_video(str(path))
        chat.add_text("What is said?", str(path))
        assert chat.state.messages[-2][1].endswith("\n" + DEFAULT_AUDIO_TOKEN)
        answers.append(chat.answer())
    (jc, tc), (ja, ta) = chats, answers
    assert tc.transcript_text == jc.transcript_text
    assert len(tc.transcript_text.split()) == 5
    (jids,), (tids,) = seen["jax"], seen["port"]
    np.testing.assert_array_equal(tids, jids)
    text = engine.tokenizer.decode(list(tids[0]))
    assert f'{DEFAULT_TRANSCRIPT_START}\n"{tc.transcript_text}"' in text
    assert DEFAULT_AUDIO_TOKEN not in text
    assert ta == ja
    # a second turn adds no transcript
    tc.add_text("And?", str(path))
    assert DEFAULT_AUDIO_TOKEN not in tc.state.messages[-2][1]


def test_upload_frames_with_audio_matches_upload_video(slice_pair, tmp_path,
                                                       monkeypatch):
    """upload_frames(frames, audio=...) transcribes the waveform as
    upload_video transcribes the file's audio track."""
    _, engine = slice_pair
    x = speech_wave(2.0, seed=3)
    path = tmp_path / "a.wav"
    _write_wav(path, x)
    frames = np.random.default_rng(1).integers(0, 256, (4, 64, 64, 3),
                                               dtype=np.uint8)
    monkeypatch.setattr(tchat, "load_video", lambda p, shape: frames)
    _, tp = whisper_pair()
    tr = Transcriber(tp, WhisperConfig.tiny_test(), letters(7),
                     max_new_tokens=4, music_tags=())
    chat = tchat.VideoChatGPTInterface(engine, use_asr=True, transcriber=tr)
    chat.upload_video(str(path))
    from_file = chat.transcript_text
    chat.upload_frames(frames, audio=load_audio(str(path)))
    assert chat.transcript_text == from_file and from_file
    chat.upload_frames(frames)
    assert chat.transcript_text is None
    off = tchat.VideoChatGPTInterface(engine, transcriber=tr)
    off.upload_frames(frames, audio=x)
    off.add_text("Hi", None)
    assert off.transcript_text is None
    assert DEFAULT_AUDIO_TOKEN not in off.state.messages[-2][1]


def test_load_audio_matches_jax(tmp_path):
    x = speech_wave(1.5, seed=4)
    path = tmp_path / "b.wav"
    _write_wav(path, x)
    got = load_audio(str(path))
    want = j_load_audio(str(path))
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    assert np.abs(got - x).max() == pytest.approx(0, abs=1e-3)
    missing = load_audio(str(tmp_path / "none.wav"))
    assert missing.shape == (0,)
