"""Single-shot video-QA inference.

Counterpart of video_llava_tpu/runtime/inference.py (without
speculative decoding): prompt assembly with
<vid_start><vid_patch>*N<vid_end>, conversation templating, frame
preprocessing + CLIP + pooling, and generation with keyword stopping
(reference video_chatgpt/inference.py:47-125).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from video_llava_tpu_torch.config import GenerationConfig, VideoLLaVAConfig
from video_llava_tpu_torch.constants import (
    DEFAULT_TRANSCRIPT_START,
    DEFAULT_VID_END_TOKEN,
    DEFAULT_VID_START_TOKEN,
    DEFAULT_VIDEO_PATCH_TOKEN,
)
from video_llava_tpu_torch.engine.generate import generate_with_keywords
from video_llava_tpu_torch.models.video_llava import VideoLLaVA
from video_llava_tpu_torch.ops.image import preprocess_frames
from video_llava_tpu_torch.runtime.conversation import conv_templates
from video_llava_tpu_torch.runtime.tokenizer import Tokenizer


def build_video_question(question: str, video_token_len: int,
                         use_vid_start_end: bool,
                         transcript: Optional[str] = None) -> str:
    """The reference's prompt-side string (inference.py:67-74)."""
    if use_vid_start_end:
        qs = (question + "\n" + DEFAULT_VID_START_TOKEN
              + DEFAULT_VIDEO_PATCH_TOKEN * video_token_len
              + DEFAULT_VID_END_TOKEN)
    else:
        qs = question + "\n" + DEFAULT_VIDEO_PATCH_TOKEN * video_token_len
    if transcript:
        qs = f'{qs}\n{DEFAULT_TRANSCRIPT_START}\n"{transcript}"'
    return qs


@dataclasses.dataclass
class InferenceEngine:
    """Holds the model + config and serves single-video QA requests."""

    model: VideoLLaVA
    cfg: VideoLLaVAConfig
    tokenizer: Tokenizer
    gen: GenerationConfig = dataclasses.field(
        default_factory=GenerationConfig)
    seq_pad_multiple: int = 128  # prompts pad to fixed buckets
    cache_dtype: torch.dtype = torch.bfloat16

    @property
    def device(self) -> torch.device:
        return self.model.llm.final_norm.scale.device

    def padded_prompt(self, prompt: str):
        """Tokenize and right-pad to seq_pad_multiple -> (input_ids (1,
        s_pad) on the device, seq_lens (1,) int32, real length)."""
        tok = self.tokenizer
        ids = tok.encode(prompt)
        s_real = len(ids)
        s_pad = s_real + (-s_real % self.seq_pad_multiple)
        input_ids = np.full((1, s_pad), tok.pad_token_id, np.int64)
        input_ids[0, :s_real] = ids
        return (torch.from_numpy(input_ids).to(self.device),
                torch.tensor([s_real], dtype=torch.int32,
                             device=self.device), s_real)

    @torch.inference_mode()
    def encode_video_frames(self, frames: np.ndarray,
                            num_valid_frames: Optional[int] = None):
        """(t, h, w, 3) uint8 -> pooled features (video_token_len, c)."""
        x = torch.from_numpy(np.ascontiguousarray(frames)).to(self.device)
        pixels = preprocess_frames(x, self.cfg.vision.image_size)
        return self.model.encode_video(pixels, num_valid_frames)

    @torch.inference_mode()
    def infer(self, video_frames: Optional[np.ndarray], question: str,
              conv_mode: str = "pg-video-llava",
              transcript: Optional[str] = None,
              generator: Optional[torch.Generator] = None,
              num_valid_frames: Optional[int] = None) -> str:
        """The video_chatgpt_infer flow (inference.py:47-125)."""
        cfg, tok = self.cfg, self.tokenizer
        qs = build_video_question(question, cfg.video_token_len,
                                  cfg.use_vid_start_end, transcript)
        conv = conv_templates[conv_mode].copy()
        conv.append_message(conv.roles[0], qs)
        conv.append_message(conv.roles[1], None)
        stop_str = conv.stop_string()
        input_ids, seq_lens, _ = self.padded_prompt(conv.get_prompt())
        feats = None
        if video_frames is not None:
            feats = self.encode_video_frames(video_frames,
                                             num_valid_frames)[None]
        gen = dataclasses.replace(self.gen, eos_token_id=tok.eos_token_id,
                                  pad_token_id=tok.pad_token_id)
        text, _ = generate_with_keywords(
            self.model, gen, input_ids, seq_lens, feats, generator,
            decode_fn=lambda t: tok.decode(t, skip_special_tokens=True),
            keywords=(stop_str,) if stop_str and stop_str != "</s>" else (),
            cache_dtype=self.cache_dtype,
        )
        # reference post-processing: strip, rstrip(stop_str), strip
        out = text.strip()
        if stop_str and out.endswith(stop_str):
            out = out[: -len(stop_str)]
        return out.strip()
