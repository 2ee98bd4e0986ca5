"""Interactive video chat CLI and the grounded chat orchestrator.

Counterpart of video_llava_tpu/runtime/chat.py:
  * VideoChatGPTInterface (reference video_chatgpt/chat.py:15-225):
    upload_video (with use_asr, the audio track's transcript),
    add_text (1536/1200-character cut-offs, <video> and, with use_asr,
    <audio_transcript> injection on the first turn), answer (prompt
    replace, transcript splice, generate, code-block post-processing)
    and the interact() REPL;
  * PGVideoLLaVA (reference chat.py:240-333): after the LLM answer, tag
    the frames -> top-10 unique tags -> entity matching -> class list ->
    scene split -> tracker per scene -> annotated output video.

Run: python -m video_llava_tpu_torch.runtime.chat --model_size 7b
[--quant int4] [--with_grounding [--sam_variant {mobile,vit_b}]] [--use_asr]
[--mesh_model M [--dist_backend {nccl,gloo}] [--dist_init URL]]

--mesh_model runs the chat tensor parallel over M ranks (parallel/; the
JAX chat CLI has no mesh flag, its engine takes one through
initialize_model): rank 0 reads the REPL and prints the answers; the
chat session is built on every rank and its upload, add_text, answer and
clear_history calls are replicated (parallel/driver.py). Grounding and
ASR take no mesh (grounding runs on one device in the JAX package too).
"""

from __future__ import annotations

import argparse
import dataclasses
import datetime
import os
import random
import string
import sys
from typing import Optional

import numpy as np
import torch

from video_llava_tpu_torch.constants import (
    DEFAULT_AUDIO_TOKEN,
    DEFAULT_TRANSCRIPT_START,
    DEFAULT_VID_END_TOKEN,
    DEFAULT_VID_START_TOKEN,
    DEFAULT_VIDEO_PATCH_TOKEN,
    DEFAULT_VIDEO_TOKEN,
)
from video_llava_tpu_torch.engine.generate import generate_with_keywords
from video_llava_tpu_torch.engine.quant_select import resolve_quant
from video_llava_tpu_torch.media.loader import encode_video, load_video
from video_llava_tpu_torch.parallel import driver
from video_llava_tpu_torch.runtime.conversation import (
    conv_templates,
    default_conversation,
)
from video_llava_tpu_torch.runtime.inference import InferenceEngine
from video_llava_tpu_torch.runtime.model_init import (
    dtype_kwargs,
    initialize_model,
)


class VideoChatGPTInterface:
    """Stateful multi-turn video chat. `generator` drives sampling at
    temperature > 0; by default it is seeded at random. With use_asr and
    a transcriber (audio/transcribe.Transcriber), the video's speech
    transcript joins the first prompt."""

    def __init__(self, engine: InferenceEngine, use_asr: bool = False,
                 conv_mode: str = "pg-video-llava",
                 temperature: float = 0.2, max_output_tokens: int = 1024,
                 generator: Optional[torch.Generator] = None,
                 transcriber=None):
        self.engine = engine
        self.use_asr = use_asr
        self.transcriber = transcriber
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

    @driver.replicated
    def clear_history(self):
        self.state = default_conversation.copy()
        self.video_features = None
        self.video_frames = None
        self.video_path: Optional[str] = None
        self.transcript_text: Optional[str] = None
        self.first_run = True

    def _asr(self) -> bool:
        return self.use_asr and self.transcriber is not None

    def upload_video(self, video_path: str):
        size = self.engine.cfg.vision.image_size
        self.upload_frames(load_video(video_path, shape=(size, size)))
        self.video_path = video_path
        if self._asr():
            self.transcript_text, _ = self.transcriber.transcribe_video(
                video_path)

    @driver.replicated
    def upload_frames(self, frames, audio=None):
        """Encode already decoded (t, h, w, 3) uint8 frames as the
        session's video; `audio`, the clip's 16 kHz float32 waveform, is
        transcribed as upload_video transcribes the file's audio track
        (with use_asr and a transcriber)."""
        self.video_frames = frames
        self.video_features = self.engine.encode_video_frames(
            frames, num_valid_frames=frames.shape[0])
        self.transcript_text = None
        if audio is not None and self._asr():
            self.transcript_text, _ = self.transcriber.transcribe_waveform(
                np.asarray(audio, np.float32))

    @driver.replicated
    def add_text(self, text: str, video_path: Optional[str]):
        if len(text) <= 0 and video_path is None:
            self.state.skip_next = True
            return
        text = text[:1536]  # hard cut-off (chat.py:93)
        if self.first_run:
            text = text[:1200]  # hard cut-off for videos (chat.py:95)
            if DEFAULT_VIDEO_TOKEN not in text:
                text = text + "\n" + DEFAULT_VIDEO_TOKEN
            if self.use_asr:
                text = text + "\n" + DEFAULT_AUDIO_TOKEN
            self.state = default_conversation.copy()
        self.state.append_message(self.state.roles[0], text)
        self.state.append_message(self.state.roles[1], None)
        self.state.skip_next = False

    @driver.replicated
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
            DEFAULT_VIDEO_TOKEN, self.replace_token, 1).replace(
            DEFAULT_AUDIO_TOKEN,
            f'{DEFAULT_TRANSCRIPT_START}\n"{self.transcript_text}"', 1)
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


class PGVideoLLaVA(VideoChatGPTInterface):
    """Grounded chat: the answer plus pixel grounding of its entities
    (reference chat.py:240-333)."""

    def __init__(self, engine: InferenceEngine, tracker, tagging_model,
                 entity_match_module, **kw):
        super().__init__(engine, **kw)
        self.tracker = tracker
        self.tagging_model = tagging_model
        self.entity_match_module = entity_match_module

    @torch.inference_mode()
    def answer(self, with_grounding: bool = True,
               output_dir: str = "outputs"):
        llm_output = super().answer()
        if not with_grounding or llm_output is None:
            return llm_output
        from video_llava_tpu_torch.grounding.results import annotate_frame
        from video_llava_tpu_torch.media.scene import detect_scenes

        # the uint8 frames go to the device once; tagging and (on the
        # whole-clip path) tracking read that one copy
        frames = np.asarray(self.video_frames)
        dev_frames = torch.as_tensor(frames, device=self.engine.device)
        entity_list = self.tagging_model.run_on_video(dev_frames, top_k=10)
        highlight_output, match_state = self.entity_match_module(
            llm_output, entity_list)
        class_list = sorted(set(match_state.values()))

        os.makedirs(output_dir, exist_ok=True)
        stamp = datetime.datetime.now().strftime("%Y%m%d%H%M%S")
        rand = "".join(random.choices(string.ascii_letters + string.digits,
                                      k=6))
        output_video_path = os.path.join(output_dir,
                                         f"video_{stamp}_{rand}.mp4")
        annotated = []
        fused = getattr(self.tracker, "fused_eligible", lambda: False)()
        if class_list:
            for start, end in detect_scenes(frames):
                scene = (dev_frames[start:end] if fused
                         else list(frames[start:end]))
                results = self.tracker.run_on_list_of_images(scene,
                                                             class_list)
                for r, frame in zip(results, frames[start:end]):
                    cids = [o.category_id for o in r.objects]
                    annotated.append(annotate_frame(frame, r.masks, cids))
        if annotated:
            encode_video(output_video_path, np.stack(annotated), fps=5.0)
        else:
            output_video_path = None
        return llm_output, output_video_path, highlight_output, match_state

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
                llm_output, video_out, _, match_state = self.answer()
                print("ASSISTANT>>", llm_output)
                print("\nGROUNDING>>", "\t", video_out, "\n\t", match_state,
                      "\n")
            except (KeyboardInterrupt, EOFError):
                print("----------")
                print("QUITTING...")
                return


def main(argv=None):
    p = argparse.ArgumentParser(
        description="Video chat on the PyTorch port (random weights unless "
        "checkpoints are given).")
    p.add_argument("--model-name", default=None,
                   help="HF Vicuna/LLaMA checkpoint directory (tokenizer "
                   "and LLM weights)")
    p.add_argument("--projection_path", default=None,
                   help="reference-style mm_projector.bin")
    p.add_argument("--clip_path", default=None,
                   help="HF CLIP checkpoint directory")
    p.add_argument("--model_size", default="7b",
                   choices=("tiny", "7b", "13b"))
    p.add_argument("--use_asr", action="store_true",
                   help="transcribe the video's audio track (Whisper base, "
                   "random weights) into the first prompt")
    p.add_argument("--with_grounding", action="store_true",
                   help="ground the answer's entities in the video "
                   "(GroundingDINO, MobileSAM, STM tracking, tagging; "
                   "random weights)")
    p.add_argument("--sam_variant", default="mobile",
                   choices=("mobile", "vit_b"),
                   help="segmenter encoder: MobileSAM's TinyViT or SAM's "
                   "ViT-B (random weights)")
    p.add_argument("--conv_mode", default="pg-video-llava")
    p.add_argument("--temperature", type=float, default=0.2)
    p.add_argument("--max_output_tokens", type=int, default=1024)
    p.add_argument("--quant", default=None, choices=("int8", "int4", "auto"),
                   help="weights-only LLM quantization (int4: the W4A8 "
                   "kernels); resolved against the checkpoint's "
                   "quant_preflight.json as in the JAX package")
    p.add_argument("--mesh_model", type=int, default=None,
                   help="tensor-parallel degree (ranks; default 1)")
    p.add_argument("--dist_backend", default="nccl",
                   choices=("nccl", "gloo"),
                   help="collectives under --mesh_model: nccl (a card a "
                   "rank) or gloo (ranks may share a card; the CPU)")
    p.add_argument("--dist_init", default=None,
                   help="rendezvous of the ranks: tcp://localhost:PORT or "
                   "file://PATH (default: a free localhost port)")
    p.add_argument("--device", default="cuda",
                   help="torch device of the model (default cuda)")
    p.add_argument("--dtype", default="bfloat16",
                   choices=["bfloat16", "float32"],
                   help="parameter and KV-cache dtype (float32: CPU "
                   "checks)")
    args = p.parse_args(argv)
    if (args.mesh_model or 1) > 1 and (args.with_grounding or args.use_asr):
        raise ValueError("--with_grounding and --use_asr take no "
                         "--mesh_model (they run on one device)")
    quant = resolve_quant(args.quant, args.model_name)
    session = driver.start(
        args.mesh_model, args.dist_backend, args.dist_init, args.device,
        entry=("video_llava_tpu_torch.runtime.chat", "main"),
        argv=sys.argv[1:] if argv is None else list(argv))
    try:
        engine = initialize_model(
            args.model_name, args.projection_path, args.clip_path,
            model_size=args.model_size, device=session.device,
            llm_quant=quant,
            llm_fuse=bool(quant) and session.world_size == 1,
            mesh_model=args.mesh_model, **dtype_kwargs(args.dtype))
        if args.dtype == "float32":
            engine.cache_dtype = torch.float32
        if session.follower:
            driver.follow()
            return
        _chat(args, engine)
    finally:
        driver.stop()


def _chat(args, engine: InferenceEngine) -> None:
    """main's REPL on rank 0."""
    transcriber = None
    if args.use_asr:
        from video_llava_tpu_torch.audio.builders import (
            build_default_transcriber,
        )

        transcriber = build_default_transcriber(device=args.device)
    kw = dict(use_asr=args.use_asr, conv_mode=args.conv_mode,
              temperature=args.temperature,
              max_output_tokens=args.max_output_tokens,
              transcriber=transcriber)
    if args.with_grounding:
        from video_llava_tpu_torch.grounding.builders import (
            build_grounding_stack,
        )

        tracker, tagging, matching = build_grounding_stack(
            sam_variant=args.sam_variant, device=args.device)
        PGVideoLLaVA(engine, tracker, tagging, matching, **kw).interact()
    else:
        driver.new(VideoChatGPTInterface, engine, **kw).interact()


if __name__ == "__main__":
    main()
