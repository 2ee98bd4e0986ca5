"""Single-shot video-QA inference.

Counterpart of video_llava_tpu/runtime/inference.py: prompt assembly
with <vid_start><vid_patch>*N<vid_end>, conversation templating, frame
preprocessing + CLIP + pooling, and generation with keyword stopping
(reference video_chatgpt/inference.py:47-125), through prompt-lookup
speculation by default. Under a tensor-parallel mesh the engine is built
on every rank and its computing methods are replicated
(parallel/driver.py); speculation is then ignored, as in the JAX
package.
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
from video_llava_tpu_torch.engine.generate import (
    GenerateResult,
    generate,
    generate_with_keywords,
    tp_mesh,
)
from video_llava_tpu_torch.engine.speculative import generate_pld_text
from video_llava_tpu_torch.models.video_llava import VideoLLaVA
from video_llava_tpu_torch.ops.image import preprocess_frames
from video_llava_tpu_torch.parallel.driver import replicated
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
    # Prompt-lookup speculative decoding (engine/speculative.py), on by
    # default as in the JAX package: token-id-stop templates ("</s>")
    # run the speculative loop whole, textual-stop templates run it in
    # the host-checked chunks of generate_with_keywords. Greedy-exact and
    # sampling distribution-exact.
    speculative: bool = True

    @property
    def device(self) -> torch.device:
        return self.model.llm.final_norm.scale.device

    @property
    def mesh(self):
        """The tensor-parallel mesh (None on one rank)."""
        return tp_mesh(self.model)

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

    @replicated
    @torch.inference_mode()
    def encode_video_frames(self, frames: np.ndarray,
                            num_valid_frames: Optional[int] = None):
        """(t, h, w, 3) uint8 -> pooled features (video_token_len, c)."""
        x = torch.from_numpy(np.ascontiguousarray(frames)).to(self.device)
        pixels = preprocess_frames(x, self.cfg.vision.image_size)
        return self.model.encode_video(pixels, num_valid_frames)

    @replicated
    @torch.inference_mode()
    def batched_encode(self, frames: np.ndarray, num_valid_frames):
        """(b, t, h, w, 3) uint8 frames, padded to one t, and b valid
        counts -> pooled features (b, video_token_len, c): each row is
        :meth:`encode_video_frames` of its video's first count frames.
        The JAX package's eval/run_inference._batched_encode_jit (a vmap
        of preprocess_frames + encode_video)."""
        x = torch.from_numpy(np.ascontiguousarray(frames)).to(self.device)
        b, t = x.shape[:2]
        pixels = preprocess_frames(x.reshape(b * t, *x.shape[2:]),
                                   self.cfg.vision.image_size)
        counts = torch.as_tensor(np.asarray(num_valid_frames, np.int32),
                                 device=self.device)
        return self.model.encode_videos(
            pixels.reshape(b, t, *pixels.shape[1:]), counts)

    @replicated
    @torch.inference_mode()
    def generate_tokens(self, input_ids: torch.Tensor,
                        seq_lens: torch.Tensor,
                        video_features: Optional[torch.Tensor],
                        gen: GenerationConfig, seed: int,
                        speculative: Optional[bool] = None
                        ) -> GenerateResult:
        """engine.generate.generate of a right-padded batch, sampling
        from a generator seeded with `seed` (speculative: the engine's
        own setting by default; ignored under a mesh)."""
        generator = torch.Generator(device=self.device).manual_seed(seed)
        return generate(
            self.model, gen, input_ids.to(self.device),
            seq_lens.to(self.device), video_features, generator,
            cache_dtype=self.cache_dtype,
            speculative=(self.speculative if speculative is None
                         else speculative))

    @replicated
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
        input_ids, seq_lens, s_real = self.padded_prompt(conv.get_prompt())
        feats = None
        if video_frames is not None:
            feats = self.encode_video_frames(video_frames,
                                             num_valid_frames)[None]
        gen = dataclasses.replace(self.gen, eos_token_id=tok.eos_token_id,
                                  pad_token_id=tok.pad_token_id)
        keywords = (stop_str,) if stop_str and stop_str != "</s>" else ()
        if self.speculative and not keywords and self.mesh is None:
            return generate_pld_text(
                self.model, gen, input_ids, s_real, feats, generator, tok,
                stop_str, cache_dtype=self.cache_dtype)
        text, _ = generate_with_keywords(
            self.model, gen, input_ids, seq_lens, feats, generator,
            decode_fn=lambda t: tok.decode(t, skip_special_tokens=True),
            keywords=keywords, cache_dtype=self.cache_dtype,
            speculative=self.speculative,
        )
        # reference post-processing: strip, rstrip(stop_str), strip
        out = text.strip()
        if stop_str and out.endswith(stop_str):
            out = out[: -len(stop_str)]
        return out.strip()
