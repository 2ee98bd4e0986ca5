"""Video or waveform -> filtered speech transcript.

Counterpart of video_llava_tpu/audio/transcribe.py (reference
Transcriber, video_chatgpt/audio_transcript/transcribe.py:22-99):
  1. ASR over the audio track (the port's Whisper), timestamped
     segments;
  2. audio tags for each segment (the shared-encoder TL-TR head, read
     from the encoder's cached layer states window by window);
  3. keep a segment when Speech beats Music by more than 1.1 logits;
  4. join the surviving text.

All 30 s chunks encode as one batch, on the parameters' device.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from video_llava_tpu_torch.models import whisper as whisper_mod
from video_llava_tpu_torch.models.whisper import WhisperConfig
from video_llava_tpu_torch.ops.audio import (
    N_SAMPLES,
    SAMPLE_RATE,
    log_mel_spectrogram,
)

# Default tag ids of the filter (real deployments pass the ontology of
# their AT head's weights).
SPEECH_TAG = 0
MUSIC_TAGS = (1,)
# AudioSet ids for whisper-at checkpoints (reference filter classes,
# transcribe.py:79-87: Speech / Male speech / Female speech, and Music).
AUDIOSET_SPEECH_TAGS = (0, 1, 2)
AUDIOSET_MUSIC_TAGS = (137,)


@dataclasses.dataclass
class Segment:
    start: float
    end: float
    text: str
    speech_logit: float = 0.0
    music_logit: float = -1e9

    @property
    def keep(self) -> bool:
        """Reference filter: Speech must beat Music by > 1.1 logits
        (transcribe.py:88-95); no music logit keeps the segment."""
        return self.speech_logit - self.music_logit > 1.1 or (
            self.music_logit <= -1e8)


class Transcriber:
    """Whisper transcriber with audio-tag filtering, on the parameters'
    device.

    decode_text: token ids -> str (the Whisper BPE tokenizer when its
    assets are available; injectable for tests and random weights).
    """

    def __init__(
        self,
        params,
        cfg: WhisperConfig,
        decode_text: Callable[[Sequence[int]], str],
        start_tokens: Sequence[int] = (1,),
        eot_token: int = 2,
        max_new_tokens: int = 224,
        speech_tag: int = SPEECH_TAG,
        music_tags: Sequence[int] = MUSIC_TAGS,
        timestamp_begin: Optional[int] = None,
        timestamp_start_tokens: Optional[Sequence[int]] = None,
        aligner=None,
        at_cfg=None,
        at_window_s: float = 10.0,
    ):
        self.params = params
        self.cfg = cfg
        self.decode_text = decode_text
        self.start_tokens = tuple(start_tokens)
        self.eot_token = eot_token
        self.max_new_tokens = max_new_tokens
        self.speech_tags = ((speech_tag,) if isinstance(speech_tag, int)
                            else tuple(speech_tag))
        self.speech_tag = self.speech_tags[0]
        self.music_tags = tuple(music_tags)
        # 'tltr' (whisper-at's TL-TR head, per-window logits mapped to
        # the ASR segments), 'linear' (the legacy probe, per chunk) or
        # 'none' (no at_head: the filter keeps everything)
        head = params.get("at_head")
        self._at_mode = ("tltr" if head is not None and "time_tr" in head
                         else "linear" if head is not None else "none")
        self.at_cfg = at_cfg
        if self._at_mode == "tltr" and at_cfg is None:
            self.at_cfg = whisper_mod.WhisperATConfig(rep_dim=cfg.d_model)
        self.at_window_s = at_window_s
        # timestamp decoding: the id of <|0.00|> and the sot sequence
        # WITHOUT <|notimestamps|> (audio/tokenizer.py sot_sequence)
        self.timestamp_begin = timestamp_begin
        self.timestamp_start_tokens = (tuple(timestamp_start_tokens)
                                       if timestamp_start_tokens else None)
        self.aligner = aligner  # audio.align.ForcedAligner: word times
        conv = params["encoder"]["conv1"]["weight"]
        self.device, self.dtype = conv.device, conv.dtype

    def _chunk(self, audio: np.ndarray) -> np.ndarray:
        """Split PCM into zero-padded 30 s chunks: (n_chunks, N_SAMPLES)."""
        n = max(len(audio), 1)
        n_chunks = -(-n // N_SAMPLES)
        out = np.zeros((n_chunks, N_SAMPLES), np.float32)
        for i in range(n_chunks):
            piece = audio[i * N_SAMPLES:(i + 1) * N_SAMPLES]
            out[i, :len(piece)] = piece
        return out

    @torch.inference_mode()
    def transcribe_audio(self, audio: np.ndarray,
                         with_timestamps: bool = False) -> List[Segment]:
        """ASR + tagging over PCM float32 at 16 kHz.

        with_timestamps=True decodes with Whisper's timestamp tokens and
        splits each 30 s chunk at the emitted timestamp pairs (needs
        timestamp_begin and the timestamp sot sequence); otherwise a
        segment is a whole chunk."""
        if len(audio) == 0:
            return []
        use_ts = bool(with_timestamps and self.timestamp_begin is not None
                      and self.timestamp_start_tokens)
        chunks = torch.as_tensor(self._chunk(audio), device=self.device)
        # the log-mel is f32; cast to the parameters' dtype for the stem
        mels = torch.stack([log_mel_spectrogram(c) for c in chunks])
        mels = mels.to(self.dtype)
        want_layers = self._at_mode == "tltr"
        out = whisper_mod.encode(self.params, mels, self.cfg,
                                 return_layer_states=want_layers)
        enc, layer_states = out if want_layers else (out, None)
        start_seq = self.timestamp_start_tokens if use_ts else \
            self.start_tokens
        start = torch.tensor([list(start_seq)] * len(chunks),
                             dtype=torch.int32, device=self.device)
        toks, lens = whisper_mod.greedy_decode_cached(
            self.params, enc, self.cfg, start, self.max_new_tokens,
            self.eot_token)
        if self._at_mode == "tltr":
            # (n_chunks, n_windows, n_class): windows of the cached layer
            # states, mapped to each segment below (the reference re-runs
            # whisper-at on each segment's audio, transcribe.py:70-77)
            atc = self.at_cfg
            win = max(1, int(round(self.at_window_s * 50 / atc.pool_stride)))
            tag_logits = whisper_mod.audio_tag_logits_tltr(
                self.params["at_head"], layer_states, atc,
                window_tokens=win).float().cpu().numpy()
        elif self._at_mode == "linear":
            tag_logits = whisper_mod.audio_tag_logits(
                self.params, enc).float().cpu().numpy()
        else:
            tag_logits = None
        total_s = len(audio) / SAMPLE_RATE

        def seg_tags(i: int, t0: float, t1: float):
            """(speech, music) logits of chunk i over chunk time [t0, t1):
            the max over the overlapped tag windows (tltr) or the chunk's
            logits (linear); no head -> the always-keep sentinel."""
            if tag_logits is None:
                return 0.0, -1e9
            if tag_logits.ndim == 2:
                row = tag_logits[i][None]
            else:
                nw = tag_logits.shape[1]
                w0 = min(int(t0 / self.at_window_s), nw - 1)
                w1 = max(w0 + 1, min(-(-t1 // self.at_window_s), nw))
                row = tag_logits[i, w0:int(w1)]
            speech = max(float(row[:, t].max()) for t in self.speech_tags)
            music = max((float(row[:, m].max()) for m in self.music_tags),
                        default=-1e9)
            return speech, music

        segments: List[Segment] = []
        toks_np, lens_np = toks.cpu().numpy(), lens.cpu().numpy()
        for i in range(len(chunks)):
            ids = [int(t) for t in toks_np[i, :int(lens_np[i])]]
            if use_ts:
                from video_llava_tpu_torch.audio.tokenizer import (
                    parse_timestamp_segments,
                )

                spans = parse_timestamp_segments(
                    ids, self.timestamp_begin, offset=i * 30.0,
                    eot=self.eot_token,
                    default_end=min(30.0, total_s - i * 30.0))
                for sp in spans:
                    text = self.decode_text(sp.token_ids).strip()
                    if not text:
                        continue
                    speech, music = seg_tags(i, sp.start - i * 30.0,
                                             sp.end - i * 30.0)
                    segments.append(Segment(
                        start=min(sp.start, total_s),
                        end=min(sp.end, total_s), text=text,
                        speech_logit=speech, music_logit=music))
                continue
            speech, music = seg_tags(i, 0.0, 30.0)
            segments.append(Segment(
                start=i * 30.0, end=min((i + 1) * 30.0, total_s),
                text=self.decode_text(ids).strip(),
                speech_logit=speech, music_logit=music))
        return segments

    def transcribe_waveform(self, audio: np.ndarray,
                            with_timestamps: bool = False
                            ) -> Tuple[str, List[Segment]]:
        """transcribe_audio, then the kept segments' text joined: what
        transcribe_video returns, for a waveform already decoded."""
        segments = self.transcribe_audio(audio, with_timestamps)
        text = " ".join(s.text for s in segments if s.keep and s.text)
        return text, segments

    def transcribe_video(self, video_path: str,
                         with_timestamps: bool = False
                         ) -> Tuple[str, List[Segment]]:
        """Reference transcribe_video (transcribe.py:51-99): decode the
        audio track, transcribe, drop non-speech, join the text."""
        from video_llava_tpu_torch.media.audio import load_audio

        return self.transcribe_waveform(load_audio(video_path),
                                        with_timestamps)

    def transcribe_video_aligned(self, video_path: str):
        """Transcript + word timings (whisperX: reference
        transcribe.py:43-46 aligns segments with a wav2vec2 CTC model).
        Needs an aligner (audio/align.py ForcedAligner)."""
        if self.aligner is None:
            raise ValueError("Transcriber built without an aligner")
        from video_llava_tpu_torch.media.audio import load_audio

        audio = load_audio(video_path)
        segments = self.transcribe_audio(audio, with_timestamps=True)
        kept = [s for s in segments if s.keep and s.text]
        words = self.aligner.align_segments(audio, kept)
        return " ".join(s.text for s in kept), kept, words


def filter_segments(segments: Sequence[Segment]) -> List[Segment]:
    """The keep rule, for tests and external pipelines."""
    return [s for s in segments if s.keep]
