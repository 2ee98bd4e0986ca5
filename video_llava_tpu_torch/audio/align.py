"""Word-level forced alignment (whisperX's CTC aligner).

Counterpart of video_llava_tpu/audio/align.py: CTC emissions from the
port's wav2vec2 (models/wav2vec2.py) on the parameters' device, then the
Viterbi trellis and its backtrack in numpy on the host. The trellis is
the JAX package's lax.scan step for step in f32 (the same max and add,
ties to the first index as jnp.argmax takes them), so equal emissions
give equal spans. The JAX package pads the trellis to buckets of 128
frames and 64 positions for its compile cache; padded frames emit only
blank and the backtrack starts from the real end positions, so the
padding changes no span, and it is left out here.

CTC forced alignment: the target chars c_1..c_N are interleaved with
blanks into s_0..s_2N; the Viterbi path through the (frames x 2N+1)
trellis under CTC's transitions (stay, advance one, skip a blank between
distinct chars) gives per-char frame spans, which merge into word
timings at the vocabulary's word delimiter.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

NEG_INF = -1e30


@dataclasses.dataclass
class WordTiming:
    word: str
    start: float
    end: float
    score: float  # mean per-frame log-prob along the aligned span


def ctc_trellis(emissions: np.ndarray, ext_targets: np.ndarray):
    """Viterbi trellis for CTC forced alignment, in f32.

    emissions: (T, V) log-probs; ext_targets: (S,) target ids already
    interleaved with blanks (S = 2N+1). Returns (alphas (T, S) f32,
    backpointers (T, S) int8 in {0: stay, 1: from s-1, 2: from s-2})."""
    em = np.asarray(emissions, np.float32)[:, np.asarray(ext_targets)]
    T, S = em.shape
    ext = np.asarray(ext_targets)
    prev2 = np.concatenate([np.full(2, -1, ext.dtype), ext[:-2]])
    can_skip = (np.arange(S) >= 2) & (ext != prev2)
    neg = np.float32(NEG_INF)
    alphas = np.empty((T, S), np.float32)
    bps = np.zeros((T, S), np.int8)
    init = np.full(S, neg, np.float32)
    init[:2] = 0.0  # the first frame takes position 0 or 1 directly
    alphas[0] = em[0] + init
    stacked = np.empty((3, S), np.float32)
    for t in range(1, T):
        a = alphas[t - 1]
        stacked[0] = a
        stacked[1, 0] = neg
        stacked[1, 1:] = a[:-1]
        stacked[2, :2] = neg
        stacked[2, 2:] = a[:-2]
        stacked[2, ~can_skip] = neg
        bps[t] = stacked.argmax(axis=0)
        alphas[t] = stacked.max(axis=0) + em[t]
    return alphas, bps


def _backtrack(alphas: np.ndarray, bps: np.ndarray, num_ext: int):
    """Viterbi backtrack -> the per-frame ext position of the path."""
    T = alphas.shape[0]
    end = num_ext - 1
    if num_ext > 1 and alphas[T - 1, num_ext - 2] > alphas[T - 1, end]:
        end = num_ext - 2  # the path may end on the final char
    path = np.empty(T, np.int64)
    s = end
    for t in range(T - 1, -1, -1):
        path[t] = s
        s -= int(bps[t, s])
    return path


def align_tokens(emissions: np.ndarray, targets: Sequence[int],
                 blank_id: int = 0) -> List[tuple]:
    """Force-align target ids to (T, V) log-prob emissions.

    Returns [(token_id, start_frame, end_frame_exclusive, score), ...]."""
    targets = list(targets)
    if not targets or emissions.shape[0] < len(targets):
        return []
    ext = np.full(2 * len(targets) + 1, blank_id, np.int32)
    ext[1::2] = targets
    em = np.asarray(emissions, np.float32)
    alphas, bps = ctc_trellis(em, ext)
    path = _backtrack(alphas, bps, len(ext))
    spans: List[tuple] = []
    for s in range(1, len(ext), 2):  # the non-blank positions
        frames = np.nonzero(path == s)[0]
        if len(frames) == 0:
            continue
        f0, f1 = int(frames[0]), int(frames[-1]) + 1
        score = float(em[f0:f1, ext[s]].mean())
        spans.append((int(ext[s]), f0, f1, score))
    return spans


class ForcedAligner:
    """Char-CTC forced aligner over a wav2vec2-style acoustic model.

    vocab: char -> id of the CTC head (the alignment checkpoint's
    vocab.json); `word_delimiter` is "|" in HF char vocabularies. The
    model runs on its parameters' device."""

    def __init__(self, params, cfg, vocab: Dict[str, int],
                 word_delimiter: str = "|", unk_id: Optional[int] = None):
        self.params = params
        self.cfg = cfg
        self.vocab = vocab
        self.word_delimiter = word_delimiter
        self.unk_id = unk_id
        self.device = params["lm_head"]["kernel"].device

    def _text_to_ids(self, text: str) -> List[tuple]:
        """Clean text -> [(char_id, word_index)] with delimiter chars
        between words; chars missing from the vocabulary are dropped."""
        words = [w for w in text.upper().split() if w]
        out: List[tuple] = []
        delim = self.vocab.get(self.word_delimiter)
        for wi, w in enumerate(words):
            if wi > 0 and delim is not None:
                out.append((delim, -1))
            for ch in w:
                if ch in self.vocab:
                    out.append((self.vocab[ch], wi))
                elif self.unk_id is not None:
                    out.append((self.unk_id, wi))
        return out

    def emissions(self, audio: np.ndarray) -> np.ndarray:
        """(T, V) f32 log-probs of the audio's frames. The audio is
        zero-padded to whole seconds first, as the JAX package pads it
        (for its compile cache), and the model's group norm sees that
        tail; the padded frames' rows are dropped."""
        from video_llava_tpu_torch.models import wav2vec2 as w2v

        n_real = len(audio)
        pad = -n_real % 16000
        if pad:
            audio = np.concatenate([audio, np.zeros(pad, audio.dtype)])
        em = w2v.forward(self.params, torch.as_tensor(
            np.asarray(audio, np.float32), device=self.device), self.cfg)
        return em[:self.cfg.num_frames(n_real)].cpu().numpy()

    def align(self, audio: np.ndarray, text: str,
              time_offset: float = 0.0) -> List[WordTiming]:
        """PCM float32 at 16 kHz + transcript -> word timings, shifted by
        time_offset (the segment's start in the track). Words whose
        chars all fell out of the vocabulary are skipped, as whisperX
        skips unalignable tokens."""
        pairs = self._text_to_ids(text)
        if not pairs or len(audio) < self.cfg.frame_stride * 2:
            return []
        emissions = self.emissions(audio)
        spans = align_tokens(emissions, [p[0] for p in pairs],
                             blank_id=self.cfg.blank_id)
        if not spans:
            return []
        sec_per_frame = self.cfg.frame_stride / self.cfg.sample_rate
        # spans follow `pairs` in order: forced alignment visits every
        # ext position unless the path degenerates
        words = [w for w in text.upper().split() if w]
        agg: Dict[int, List[tuple]] = {}
        for (_, f0, f1, score), (_, wi) in zip(spans, pairs):
            if wi >= 0:
                agg.setdefault(wi, []).append((f0, f1, score))
        out: List[WordTiming] = []
        for wi, frames in sorted(agg.items()):
            f0 = min(f[0] for f in frames)
            f1 = max(f[1] for f in frames)
            out.append(WordTiming(
                word=words[wi], start=time_offset + f0 * sec_per_frame,
                end=time_offset + f1 * sec_per_frame,
                score=float(np.mean([f[2] for f in frames]))))
        return out

    def align_segments(self, audio: np.ndarray, segments,
                       pad: float = 0.25) -> List[WordTiming]:
        """Refine Whisper segments to word level (whisperX's flow): align
        each segment's text against its slightly padded audio slice."""
        sr = self.cfg.sample_rate
        out: List[WordTiming] = []
        for seg in segments:
            if not seg.text:
                continue
            a = int(max(seg.start - pad, 0) * sr)
            b = int(min(seg.end + pad, len(audio) / sr) * sr)
            out.extend(self.align(audio[a:b], seg.text, time_offset=a / sr))
        return out
