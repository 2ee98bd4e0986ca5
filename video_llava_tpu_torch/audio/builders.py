"""Transcriber and aligner factories.

Counterpart of video_llava_tpu/audio/builders.py: the models from HF
checkpoint directories when they are there (a Whisper WhisperModel or
WhisperForConditionalGeneration, its tokenizer assets, a whisper-at TL-TR
head .pth, a wav2vec2 CTC aligner with its vocab.json), random-init
otherwise, drawn on `device` from a seeded torch.Generator in the JAX
package's layout. A path that is not a directory (a file for the head)
falls back to random init, as there.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Optional

from video_llava_tpu_torch.audio.align import ForcedAligner
from video_llava_tpu_torch.audio.synthetic import char_vocab
from video_llava_tpu_torch.audio.tokenizer import WhisperTokenizer
from video_llava_tpu_torch.audio.transcribe import (
    AUDIOSET_MUSIC_TAGS,
    AUDIOSET_SPEECH_TAGS,
    Transcriber,
)
from video_llava_tpu_torch.engine.weights import (
    load_checkpoint_dir,
    load_torch_checkpoint_file,
)
from video_llava_tpu_torch.models import wav2vec2 as w2v
from video_llava_tpu_torch.models import whisper as whisper_mod
from video_llava_tpu_torch.models.layers import TreeInit

SIZES = {
    "base": whisper_mod.WhisperConfig.base,
    "large-v2": whisper_mod.WhisperConfig.large_v2,
    "tiny-test": whisper_mod.WhisperConfig.tiny_test,
}

# Whisper's start <|sot|><|en|><|transcribe|><|notimestamps|> and eot in
# the multilingual vocabulary, for a directory without vocab.json
HF_START, HF_EOT = (50258, 50259, 50359, 50363), 50257


def build_default_transcriber(
    checkpoint_dir: Optional[str] = None,
    size: str = "base",
    align_checkpoint_dir: Optional[str] = None,
    at_checkpoint: Optional[str] = None,
    at_cfg=None,
    device="cuda",
) -> Transcriber:
    """A Whisper transcriber of `size` on `device`, f32, as the JAX
    package builds one: from an HF checkpoint directory when there is
    one, random-init otherwise (the legacy linear tag probe, no text
    decoding: decode_text returns '', start tokens (1,), eot 2).

    With a checkpoint, vocab.json + merges.txt give the standalone
    byte-level BPE (audio/tokenizer.py) and timestamp decoding; without
    them the directory's tokenizer.json gives the same BPE for decoding
    (the JAX package's transformers.AutoTokenizer fallback) with
    Whisper's fixed start tokens. at_checkpoint: a whisper-at TL-TR head
    .pth, attached with the AudioSet speech and music ids (reference
    transcribe.py:79-95). align_checkpoint_dir: a wav2vec2 CTC aligner
    (:func:`build_default_aligner`)."""
    cfg = SIZES[size]()
    kw = {}
    if checkpoint_dir and os.path.isdir(checkpoint_dir):
        sd = {k.removeprefix("model."): v
              for k, v in load_checkpoint_dir(checkpoint_dir).items()}
        params = whisper_mod.convert_hf_whisper(sd, cfg, device)
        tok = WhisperTokenizer(checkpoint_dir)
        decode_text = tok.decode
        if os.path.exists(os.path.join(checkpoint_dir, "vocab.json")):
            start, eot = tok.sot_sequence(timestamps=False), tok.eot
            kw.update(timestamp_begin=tok.timestamp_begin,
                      timestamp_start_tokens=tok.sot_sequence(
                          timestamps=True))
        else:
            start, eot = HF_START, HF_EOT
    else:
        params = whisper_mod.init_params(TreeInit(0, device), cfg)
        decode_text = lambda ids: ""  # noqa: E731
        start, eot = (1,), 2
    if at_checkpoint and os.path.exists(at_checkpoint):
        atc = at_cfg or whisper_mod.WhisperATConfig(rep_dim=cfg.d_model)
        params = {**params, "at_head": whisper_mod.convert_whisper_at(
            load_torch_checkpoint_file(at_checkpoint), atc, device)}
        kw.update(at_cfg=atc, speech_tag=AUDIOSET_SPEECH_TAGS,
                  music_tags=AUDIOSET_MUSIC_TAGS)
    elif at_cfg is not None:
        kw["at_cfg"] = at_cfg
    if align_checkpoint_dir:
        kw["aligner"] = build_default_aligner(align_checkpoint_dir, device)
    return Transcriber(params, cfg, decode_text, start_tokens=start,
                       eot_token=eot, **kw)


def build_default_aligner(checkpoint_dir: Optional[str] = None,
                          device="cuda") -> ForcedAligner:
    """A wav2vec2 CTC forced aligner (whisperX's align model) on
    `device`: from an HF Wav2Vec2ForCTC directory with its vocab.json
    (the base configuration, vocab_size and blank from the vocabulary)
    when there is one, else random-init at the tiny_test configuration
    with a minimal char vocabulary, as the JAX package builds it."""
    if checkpoint_dir and os.path.isdir(checkpoint_dir):
        with open(os.path.join(checkpoint_dir, "vocab.json"),
                  encoding="utf-8") as f:
            vocab = json.load(f)
        cfg = dataclasses.replace(w2v.Wav2Vec2Config.base(),
                                  vocab_size=len(vocab),
                                  blank_id=vocab.get("<pad>", 0))
        params = w2v.convert_hf_wav2vec2(load_checkpoint_dir(checkpoint_dir),
                                         cfg, device)
    else:
        cfg = w2v.Wav2Vec2Config.tiny_test()
        params = w2v.init_params(TreeInit(0, device), cfg)
        vocab = char_vocab(cfg.vocab_size - 5)
    return ForcedAligner(params, cfg, vocab, unk_id=vocab.get("<unk>"))
