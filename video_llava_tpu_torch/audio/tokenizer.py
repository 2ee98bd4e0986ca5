"""Standalone Whisper tokenizer: byte-level BPE from local assets.

The port's own copy of video_llava_tpu/audio/tokenizer.py (pure Python,
no tensors), kept here so the port imports nothing of the JAX package.

The reference gets its tokenizer from whisperX/faster-whisper, which
bundle OpenAI's GPT-2-style byte-level BPE (vocab.json + merges.txt).
We load the same asset files directly (HF whisper checkpoint dirs ship
them) with no network or heavyweight deps, and derive the special-token
layout (<|startoftranscript|>, language tags, <|notimestamps|>,
timestamp tokens at 0.02 s resolution) from the vocabulary itself so
both multilingual and English-only layouts work.

Timestamp semantics follow OpenAI Whisper's tokenizer: ids >=
timestamp_begin encode times `(id - timestamp_begin) * 0.02` seconds;
`parse_timestamp_segments` splits a decoded stream into timed segments
on timestamp-token pairs (used for segment-level timestamps without a
phoneme aligner; see audio/align.py for word-level).
"""

from __future__ import annotations

import dataclasses
import functools
import json
import os
import re
from typing import Dict, List, Optional, Sequence, Tuple

TIME_PRECISION = 0.02  # seconds per timestamp token


@functools.lru_cache()
def _bytes_to_unicode() -> Dict[int, str]:
    """GPT-2 reversible byte <-> printable-unicode map."""
    bs = (
        list(range(ord("!"), ord("~") + 1))
        + list(range(ord("\xa1"), ord("\xac") + 1))
        + list(range(ord("\xae"), ord("\xff") + 1))
    )
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, [chr(c) for c in cs]))


_GPT2_SPLIT = re.compile(
    r"""'s|'t|'re|'ve|'m|'ll|'d| ?[^\s\d\W]+| ?\d+| ?[^\s\w]+|\s+(?!\S)|\s+"""
)


def _get_pairs(word: Tuple[str, ...]):
    return {(word[i], word[i + 1]) for i in range(len(word) - 1)}


class WhisperTokenizer:
    """Byte-level BPE with Whisper special/timestamp tokens.

    asset_dir must contain vocab.json and merges.txt, or else a fast
    tokenizer.json (its model.vocab, model.merges and added_tokens: the
    port's stand-in for the JAX package's transformers.AutoTokenizer
    fallback); added_tokens.json and special_tokens_map.json are merged
    in when present (the HF layout stores <|...|> tokens there for some
    checkpoints).
    """

    def __init__(self, asset_dir: str):
        vocab_path = os.path.join(asset_dir, "vocab.json")
        merges: List[Tuple[str, str]] = []
        if os.path.exists(vocab_path):
            with open(vocab_path, encoding="utf-8") as f:
                self.vocab: Dict[str, int] = json.load(f)
            with open(os.path.join(asset_dir, "merges.txt"),
                      encoding="utf-8") as f:
                for line in f:
                    line = line.rstrip("\n")
                    if not line or line.startswith("#version"):
                        continue
                    a, _, b = line.partition(" ")
                    merges.append((a, b))
        else:
            with open(os.path.join(asset_dir, "tokenizer.json"),
                      encoding="utf-8") as f:
                spec = json.load(f)
            self.vocab = dict(spec["model"]["vocab"])
            merges = [tuple(m.split(" ", 1)) if isinstance(m, str)
                      else tuple(m) for m in spec["model"]["merges"]]
            self.vocab.update({t["content"]: t["id"]
                               for t in spec.get("added_tokens", [])})
        added = os.path.join(asset_dir, "added_tokens.json")
        if os.path.exists(added):
            with open(added, encoding="utf-8") as f:
                self.vocab.update(json.load(f))
        self.id_to_token = {v: k for k, v in self.vocab.items()}
        self.bpe_ranks = {pair: i for i, pair in enumerate(merges)}

        self._byte_enc = _bytes_to_unicode()
        self._byte_dec = {v: k for k, v in self._byte_enc.items()}
        self._bpe_cache: Dict[str, Tuple[str, ...]] = {}

        # Special-token layout derived from the vocabulary.
        self.eot = self._find("<|endoftext|>")
        self.sot = self._find("<|startoftranscript|>")
        self.transcribe = self._find("<|transcribe|>")
        self.translate = self._find("<|translate|>")
        self.no_timestamps = self._find("<|notimestamps|>")
        self.no_speech = self._find("<|nospeech|>", "<|nocaptions|>")
        self.timestamp_begin = (
            self.no_timestamps + 1 if self.no_timestamps is not None else None
        )
        self.language_ids = {
            tok[2:-2]: i
            for tok, i in self.vocab.items()
            if re.fullmatch(r"<\|[a-z]{2,3}\|>", tok)
        }
        self._special_ids = {
            i for i in (self.eot, self.sot, self.transcribe, self.translate,
                        self.no_timestamps, self.no_speech)
            if i is not None
        }
        self._special_ids.update(self.language_ids.values())
        for tok, i in self.vocab.items():
            if tok.startswith("<|") and tok.endswith("|>"):
                self._special_ids.add(i)

    def _find(self, *names: str) -> Optional[int]:
        for n in names:
            if n in self.vocab:
                return self.vocab[n]
        return None

    # -- prompt construction -------------------------------------------------

    def sot_sequence(
        self, language: str = "en", task: str = "transcribe",
        timestamps: bool = False,
    ) -> Tuple[int, ...]:
        """<|sot|>[<|lang|>][<|task|>][<|notimestamps|>] — language/task
        tokens exist only in multilingual vocabularies."""
        if self.sot is None:
            raise ValueError("vocabulary has no <|startoftranscript|>")
        seq = [self.sot]
        if language in self.language_ids:
            seq.append(self.language_ids[language])
        task_id = self.transcribe if task == "transcribe" else self.translate
        if task_id is not None and self.language_ids:
            seq.append(task_id)
        if not timestamps and self.no_timestamps is not None:
            seq.append(self.no_timestamps)
        return tuple(seq)

    # -- BPE ------------------------------------------------------------------

    def _bpe(self, token: str) -> Tuple[str, ...]:
        cached = self._bpe_cache.get(token)
        if cached is not None:
            return cached
        word: Tuple[str, ...] = tuple(token)
        pairs = _get_pairs(word)
        while pairs:
            best = min(pairs, key=lambda p: self.bpe_ranks.get(p, 1 << 60))
            if best not in self.bpe_ranks:
                break
            a, b = best
            out: List[str] = []
            i = 0
            while i < len(word):
                try:
                    j = word.index(a, i)
                except ValueError:
                    out.extend(word[i:])
                    break
                out.extend(word[i:j])
                if j < len(word) - 1 and word[j + 1] == b:
                    out.append(a + b)
                    i = j + 2
                else:
                    out.append(word[j])
                    i = j + 1
            word = tuple(out)
            if len(word) == 1:
                break
            pairs = _get_pairs(word)
        self._bpe_cache[token] = word
        return word

    def encode(self, text: str) -> List[int]:
        ids: List[int] = []
        for piece in _GPT2_SPLIT.findall(text):
            mapped = "".join(self._byte_enc[b] for b in piece.encode("utf-8"))
            for sub in self._bpe(mapped):
                ids.append(self.vocab[sub])
        return ids

    def decode(
        self, ids: Sequence[int], skip_special_tokens: bool = True
    ) -> str:
        parts: List[str] = []
        for i in ids:
            i = int(i)
            if self.timestamp_begin is not None and i >= self.timestamp_begin:
                if not skip_special_tokens:
                    parts.append(
                        f"<|{(i - self.timestamp_begin) * TIME_PRECISION:.2f}|>"
                    )
                continue
            if skip_special_tokens and i in self._special_ids:
                continue
            tok = self.id_to_token.get(i)
            if tok is None:
                continue
            parts.append(tok)
        text = "".join(parts)
        data = bytes(self._byte_dec[c] for c in text if c in self._byte_dec)
        return data.decode("utf-8", errors="replace")

    def decode_with_timestamps(self, ids: Sequence[int]) -> str:
        return self.decode(ids, skip_special_tokens=False)


@dataclasses.dataclass
class TimedSpan:
    start: float
    end: float
    token_ids: List[int]


def parse_timestamp_segments(
    ids: Sequence[int],
    timestamp_begin: int,
    offset: float = 0.0,
    precision: float = TIME_PRECISION,
    eot: Optional[int] = None,
    default_end: Optional[float] = None,
) -> List[TimedSpan]:
    """Split a decoded token stream into timed spans.

    Whisper's timestamp grammar alternates `[t_start] tokens [t_end]`;
    consecutive timestamp tokens mark a new segment start. Unpaired or
    out-of-order timestamps are tolerated (robustness over strictness:
    the greedy decoder is unconstrained). `offset` shifts times by the
    chunk position in the full audio.
    """
    spans: List[TimedSpan] = []
    cur_start: Optional[float] = None
    cur_tokens: List[int] = []
    last_time = 0.0
    for raw in ids:
        i = int(raw)
        if eot is not None and i == eot:
            break
        if i >= timestamp_begin:
            t = (i - timestamp_begin) * precision
            if cur_start is None:
                cur_start = t
            elif cur_tokens:
                spans.append(
                    TimedSpan(offset + cur_start, offset + max(t, cur_start),
                              cur_tokens)
                )
                cur_start, cur_tokens = None, []
            else:  # consecutive timestamps: new segment start
                cur_start = t
            last_time = max(last_time, t)
        elif cur_start is not None:
            cur_tokens.append(i)
        else:  # text before any timestamp: implicit 0.0 start
            cur_start = last_time
            cur_tokens.append(i)
    if cur_tokens and cur_start is not None:
        end = max(last_time, cur_start)
        if default_end is not None:
            end = max(end, default_end)  # unclosed span: chunk end
        spans.append(TimedSpan(offset + cur_start, offset + end, cur_tokens))
    return spans
