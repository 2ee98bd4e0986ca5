"""Transcriber and aligner factories.

Counterpart of video_llava_tpu/audio/builders.py through its random-init
branch: the parameters are drawn on `device` from a seeded
torch.Generator, in the JAX package's layout. Loading checkpoints (HF
Whisper and wav2vec2 state dicts, a whisper-at head, the tokenizer's
vocab.json) is not ported yet: those arguments raise.
"""

from __future__ import annotations

from typing import Optional

from video_llava_tpu_torch.audio.align import ForcedAligner
from video_llava_tpu_torch.audio.synthetic import char_vocab
from video_llava_tpu_torch.audio.transcribe import Transcriber
from video_llava_tpu_torch.models import wav2vec2 as w2v
from video_llava_tpu_torch.models import whisper as whisper_mod
from video_llava_tpu_torch.models.layers import TreeInit

SIZES = {
    "base": whisper_mod.WhisperConfig.base,
    "large-v2": whisper_mod.WhisperConfig.large_v2,
    "tiny-test": whisper_mod.WhisperConfig.tiny_test,
}


def _not_ported(what: str):
    return NotImplementedError(
        f"{what}: checkpoint loading for the audio models is not ported "
        "yet (ROADMAP Queue 1, item 3)")


def build_default_transcriber(
    checkpoint_dir: Optional[str] = None,
    size: str = "base",
    align_checkpoint_dir: Optional[str] = None,
    at_checkpoint: Optional[str] = None,
    at_cfg=None,
    device="cuda",
) -> Transcriber:
    """A random-init Whisper transcriber of `size` on `device`, as the
    JAX package builds one without a checkpoint: f32 parameters, the
    legacy linear tag probe, no text decoding (decode_text returns ''),
    start tokens (1,), eot 2. The checkpoint arguments raise
    NotImplementedError."""
    if checkpoint_dir:
        raise _not_ported(f"checkpoint_dir={checkpoint_dir!r}")
    if at_checkpoint:
        raise _not_ported(f"at_checkpoint={at_checkpoint!r}")
    if align_checkpoint_dir:
        raise _not_ported(f"align_checkpoint_dir={align_checkpoint_dir!r}")
    cfg = SIZES[size]()
    params = whisper_mod.init_params(TreeInit(0, device), cfg)
    return Transcriber(params, cfg, lambda ids: "", start_tokens=(1,),
                       eot_token=2, at_cfg=at_cfg)


def build_default_aligner(checkpoint_dir: Optional[str] = None,
                          device="cuda") -> ForcedAligner:
    """A random-init wav2vec2 CTC aligner (whisperX's align model) on
    `device`: the tiny_test configuration and a minimal char vocabulary,
    as the JAX package builds it without a checkpoint."""
    if checkpoint_dir:
        raise _not_ported(f"checkpoint_dir={checkpoint_dir!r}")
    cfg = w2v.Wav2Vec2Config.tiny_test()
    params = w2v.init_params(TreeInit(0, device), cfg)
    vocab = char_vocab(cfg.vocab_size - 5)
    return ForcedAligner(params, cfg, vocab, unk_id=vocab.get("<unk>"))
