"""The port's copy of the Whisper tokenizer (audio/tokenizer.py) against
the JAX package's on a tiny byte-level BPE written by the test: the same
special-token layout, ids, decoded text and timestamp segments (exact)."""

import json

import pytest

from video_llava_tpu.audio import tokenizer as jtok
from video_llava_tpu_torch.audio import tokenizer as ttok

MERGES = [("h", "e"), ("l", "l"), ("he", "ll"), ("hell", "o"), ("w", "o"),
          ("r", "l"), ("wo", "rl"), ("worl", "d"), ("Ġ", "w"),
          ("Ġw", "orld")]
SPECIALS = ["<|endoftext|>", "<|startoftranscript|>", "<|en|>", "<|de|>",
            "<|translate|>", "<|transcribe|>", "<|nospeech|>",
            "<|notimestamps|>"]
TEXTS = ["hello world", "hello", " world", "hello hello world", "held! row",
         "  hello  world"]


@pytest.fixture(scope="module")
def asset_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("whisper_tok")
    b2u = ttok._bytes_to_unicode()
    vocab = {}
    for tok in sorted({b2u[b] for b in " helowrd!".encode("utf-8")}):
        vocab[tok] = len(vocab)
    for a, b in MERGES:
        vocab[a + b] = len(vocab)
    for s in SPECIALS:
        vocab[s] = len(vocab)
    for i in range(10):
        vocab[f"<|{i * 0.02:.2f}|>"] = len(vocab)
    (d / "vocab.json").write_text(json.dumps(vocab))
    (d / "merges.txt").write_text(
        "#version: 0.2\n" + "".join(f"{a} {b}\n" for a, b in MERGES))
    return str(d)


def test_tokenizer_matches_jax(asset_dir):
    j, t = jtok.WhisperTokenizer(asset_dir), ttok.WhisperTokenizer(asset_dir)
    for name in ("eot", "sot", "no_timestamps", "timestamp_begin",
                 "language_ids"):
        assert getattr(t, name) == getattr(j, name), name
    for lang in ("en", "de"):
        for ts in (False, True):
            assert (t.sot_sequence(lang, timestamps=ts)
                    == j.sot_sequence(lang, timestamps=ts))
    for text in TEXTS:
        ids = t.encode(text)
        assert ids == j.encode(text), text
        full = (list(t.sot_sequence("en", timestamps=True))
                + [t.timestamp_begin] + ids + [t.timestamp_begin + 5, t.eot])
        assert t.decode(full) == j.decode(full)
        assert t.decode_with_timestamps(full) == j.decode_with_timestamps(
            full)
    assert ttok._bytes_to_unicode() == jtok._bytes_to_unicode()


def test_parse_timestamp_segments_matches_jax():
    TB = 1000
    streams = [[TB, 7, 8, TB + 50, TB + 75, 9, TB + 100, 999], [5, 6],
               [TB + 10, 5], [TB, TB + 3, 4, 999, 7], []]
    for ids in streams:
        for kw in ({}, {"offset": 30.0, "eot": 999},
                   {"default_end": 12.5}):
            want = jtok.parse_timestamp_segments(ids, TB, **kw)
            got = ttok.parse_timestamp_segments(ids, TB, **kw)
            assert [(s.start, s.end, s.token_ids) for s in got] == [
                (s.start, s.end, s.token_ids) for s in want], (ids, kw)
