"""Interactive video chat CLI.

Counterpart of VideoChatGPTInterface in video_llava_tpu/runtime/chat.py
(reference video_chatgpt/chat.py:15-225) without ASR or grounding:
upload_video, add_text (1536/1200-character cut-offs, <video>
injection on the first turn), answer (prompt replace, generate,
code-block post-processing) and the interact() REPL.

Run: python -m video_llava_tpu_torch.runtime.chat --model_size 7b
[--quant int4]
"""

from __future__ import annotations

import argparse
import dataclasses
import random
from typing import Optional

import torch

from video_llava_tpu_torch.constants import (
    DEFAULT_VID_END_TOKEN,
    DEFAULT_VID_START_TOKEN,
    DEFAULT_VIDEO_PATCH_TOKEN,
    DEFAULT_VIDEO_TOKEN,
)
from video_llava_tpu_torch.engine.generate import generate_with_keywords
from video_llava_tpu_torch.engine.quant_select import resolve_quant
from video_llava_tpu_torch.media.loader import load_video
from video_llava_tpu_torch.runtime.conversation import (
    conv_templates,
    default_conversation,
)
from video_llava_tpu_torch.runtime.inference import InferenceEngine
from video_llava_tpu_torch.runtime.model_init import initialize_model


class VideoChatGPTInterface:
    """Stateful multi-turn video chat. `generator` drives sampling at
    temperature > 0; by default it is seeded at random."""

    def __init__(self, engine: InferenceEngine,
                 conv_mode: str = "pg-video-llava",
                 temperature: float = 0.2, max_output_tokens: int = 1024,
                 generator: Optional[torch.Generator] = None):
        self.engine = engine
        self.conv_mode = conv_mode
        self.temperature = temperature
        self.max_new_tokens = max_output_tokens
        if generator is None:
            generator = torch.Generator(device=engine.device).manual_seed(
                random.getrandbits(31))
        self.generator = generator
        cfg = engine.cfg
        patches = DEFAULT_VIDEO_PATCH_TOKEN * cfg.video_token_len
        self.replace_token = (
            DEFAULT_VID_START_TOKEN + patches + DEFAULT_VID_END_TOKEN
            if cfg.use_vid_start_end else patches)
        self.clear_history()

    def clear_history(self):
        self.state = default_conversation.copy()
        self.video_features = None
        self.video_path: Optional[str] = None
        self.first_run = True

    def upload_video(self, video_path: str):
        size = self.engine.cfg.vision.image_size
        self.upload_frames(load_video(video_path, shape=(size, size)))
        self.video_path = video_path

    def upload_frames(self, frames):
        """Encode already decoded (t, h, w, 3) uint8 frames as the
        session's video."""
        self.video_features = self.engine.encode_video_frames(
            frames, num_valid_frames=frames.shape[0])

    def add_text(self, text: str, video_path: Optional[str]):
        if len(text) <= 0 and video_path is None:
            self.state.skip_next = True
            return
        text = text[:1536]  # hard cut-off (chat.py:93)
        if self.first_run:
            text = text[:1200]  # hard cut-off for videos (chat.py:95)
            if DEFAULT_VIDEO_TOKEN not in text:
                text = text + "\n" + DEFAULT_VIDEO_TOKEN
            self.state = default_conversation.copy()
        self.state.append_message(self.state.roles[0], text)
        self.state.append_message(self.state.roles[1], None)
        self.state.skip_next = False

    @torch.inference_mode()
    def answer(self) -> Optional[str]:
        if getattr(self.state, "skip_next", False):
            return None
        if self.first_run:
            new_state = conv_templates[self.conv_mode].copy()
            new_state.append_message(new_state.roles[0],
                                     self.state.messages[-2][1])
            new_state.append_message(new_state.roles[1], None)
            self.state = new_state
            self.first_run = False

        prompt = self.state.get_prompt().replace(
            DEFAULT_VIDEO_TOKEN, self.replace_token, 1)
        stop_str = self.state.stop_string()
        engine, tok = self.engine, self.engine.tokenizer
        input_ids, seq_lens, _ = engine.padded_prompt(prompt)
        gen = dataclasses.replace(
            engine.gen,
            temperature=float(self.temperature),
            do_sample=self.temperature > 0,
            max_new_tokens=min(int(self.max_new_tokens), 1536),
            eos_token_id=tok.eos_token_id,
            pad_token_id=tok.pad_token_id,
        )
        feats = (self.video_features[None]
                 if self.video_features is not None else None)
        text, _ = generate_with_keywords(
            engine.model, gen, input_ids, seq_lens, feats, self.generator,
            decode_fn=lambda t: tok.decode(t, skip_special_tokens=True),
            keywords=(stop_str,) if stop_str and stop_str != "</s>" else (),
            cache_dtype=engine.cache_dtype,
        )
        outputs = text.strip()
        if stop_str and outputs.endswith(stop_str):
            outputs = outputs[: -len(stop_str)]
        outputs = self._post_process_code(outputs.strip())
        self.state.messages[-1][-1] = outputs
        return outputs

    @staticmethod
    def _post_process_code(code: str) -> str:
        """Un-escape underscores inside fenced code blocks
        (chat.py:214-223)."""
        sep = "\n```"
        if sep in code:
            blocks = code.split(sep)
            if len(blocks) % 2 == 1:
                for i in range(1, len(blocks), 2):
                    blocks[i] = blocks[i].replace("\\_", "_")
            code = sep.join(blocks)
        return code

    def interact(self):
        print("Welcome to PG-Video-LLaVA (PyTorch)!")
        video_set = False
        while True:
            try:
                if not video_set:
                    self.upload_video(
                        input("Please enter the video file path:   "))
                    video_set = True
                text = input("USER>>")
                if not text:
                    print("----------\n\n")
                    self.clear_history()
                    video_set = False
                    continue
                self.add_text(text, self.video_path)
                print("ASSISTANT>>", self.answer())
            except (KeyboardInterrupt, EOFError):
                print("----------")
                print("QUITTING...")
                return


def main(argv=None):
    p = argparse.ArgumentParser(
        description="Video chat on the PyTorch port (random weights).")
    p.add_argument("--model-name", default=None,
                   help="checkpoint directory (not supported yet)")
    p.add_argument("--projection_path", default=None,
                   help="mm_projector.bin (not supported yet)")
    p.add_argument("--clip_path", default=None,
                   help="CLIP checkpoint directory (not supported yet)")
    p.add_argument("--model_size", default="7b",
                   choices=("tiny", "7b", "13b"))
    p.add_argument("--conv_mode", default="pg-video-llava")
    p.add_argument("--temperature", type=float, default=0.2)
    p.add_argument("--max_output_tokens", type=int, default=1024)
    p.add_argument("--quant", default=None, choices=("int8", "int4", "auto"),
                   help="weights-only LLM quantization (int4: the W4A8 "
                   "kernels); resolved against the checkpoint's "
                   "quant_preflight.json as in the JAX package")
    args = p.parse_args(argv)
    if args.projection_path or args.clip_path:
        raise NotImplementedError("checkpoint loading is not ported yet")
    quant = resolve_quant(args.quant, args.model_name)
    engine = initialize_model(args.model_name, model_size=args.model_size,
                              device="cuda", llm_quant=quant,
                              llm_fuse=bool(quant))
    VideoChatGPTInterface(
        engine, conv_mode=args.conv_mode, temperature=args.temperature,
        max_output_tokens=args.max_output_tokens,
    ).interact()


if __name__ == "__main__":
    main()
