"""Tiny audio models shared by the audio parity tests: the JAX package's
parameters (drawn as its own tests draw them) and the same values carried
into the port by engine/convert.whisper_from_jax / wav2vec2_from_jax /
tree_from_jax. Not collected (no test_ prefix)."""

import numpy as np
import jax

from video_llava_tpu.models import wav2vec2 as jw2v
from video_llava_tpu.models import whisper as jwhisper
from video_llava_tpu_torch.engine.convert import (
    tree_from_jax,
    wav2vec2_from_jax,
    whisper_from_jax,
)
from video_llava_tpu_torch.audio.synthetic import (  # noqa: F401
    char_vocab,
    letter_words as letters,
    speech_wave,
)
from video_llava_tpu_torch.models import wav2vec2 as tw2v
from video_llava_tpu_torch.models import whisper as twhisper
from video_llava_tpu_torch.models.layers import TreeInit

META = TreeInit(0, "meta")


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def whisper_pair(size="tiny_test", seed=0):
    """(JAX params, port params) of a random Whisper of `size`, f32."""
    jcfg = getattr(jwhisper.WhisperConfig, size)()
    params = jwhisper.init_params(jax.random.PRNGKey(seed), jcfg)
    like = twhisper.init_params(META, getattr(twhisper.WhisperConfig,
                                              size)())
    return params, whisper_from_jax(_np(params), like)


def tltr_pair(rep_dim=64, seed=1):
    """(JAX TL-TR head, port TL-TR head) of WhisperATConfig.tiny_test."""
    head = jwhisper.init_at_head_tltr(
        jax.random.PRNGKey(seed),
        jwhisper.WhisperATConfig.tiny_test(rep_dim=rep_dim))
    like = twhisper.init_at_head_tltr(
        META, twhisper.WhisperATConfig.tiny_test(rep_dim=rep_dim))
    return head, tree_from_jax(_np(head), like)


def whisper_at_pair():
    """(JAX params, port params): the tiny Whisper with the tiny TL-TR
    head as its at_head."""
    jp, tp = whisper_pair()
    jh, th = tltr_pair()
    return {**jp, "at_head": jh}, {**tp, "at_head": th}


def wav2vec2_pair(seed=0):
    """(JAX params, port params) of Wav2Vec2Config.tiny_test, f32."""
    params = jw2v.init_params(jax.random.PRNGKey(seed),
                              jw2v.Wav2Vec2Config.tiny_test())
    like = tw2v.init_params(META, tw2v.Wav2Vec2Config.tiny_test())
    return params, wav2vec2_from_jax(_np(params), like)
