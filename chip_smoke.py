#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which raises on failure (exit code != 0):
  1. print the card (nvidia-smi name, power limit) and torch/CUDA versions;
  2. build the CUDA kernels from video_llava_tpu_torch/csrc;
  3. check each kernel against its plain PyTorch version at the chat
     and serving paths' shapes (plus the 336 px CLIP shape, the 12-frame
     pool and 9 valid frames of 12, the pool over a batch of 8 videos
     with mixed valid counts in one launch, the int8 caches, the paged pool with
     bf16 and int8 values, kernels 3, 9 and 10 at 65,536 positions,
     for the W4A8 and W4A16 kernels Vicuna-7B's decode and prefill
     linears in the bf16-out build the path launches and in f32 out, a
     flat per-layer weight and a 1100-row prompt, the flat-cache decode
     kernels 9 and 11 at the chat and serving shapes, kernels 3 and 10 at
     head dim 32, kernels A and B at serving's 4-row decode, 36-row
     verify and 256-row prefill window, CLIP's pad keys and values set
     large, the W4A16 block matmul at 2, 8, 36, 256, 768 and 1100 rows,
     Vicuna-13B's shapes of the batched eval phase (A at 8 rows, B at
     8 x 768 prefill rows and an 8 x 9 verify window, kernel 3 at 40
     layers x 8 rows x 40 heads), a tensor-parallel rank's shapes
     (tp_kernel_checks: kernel 1 at 8 heads, 3 at 16, A and B at 2,048
     and 5,504 columns), kernel 2 with a divisor other than its valid
     count (pool_divisor_checks: a 'data' rank's 50 frames of the
     sharded pooling, none of them valid in one case), and planted
     faults in the plain
     versions of kernels 1, 2, 9, 10, 11, A, B and both W4A16 kernels
     that must fail; kernel 1's f32 body at the crop filter's ViT-B/32
     shape and CLIP-L's), timing the
     kernel, the plain version
     and, where one PyTorch call computes the same function, that call,
     each beside the kernel's bound; kernels 3, 9, A and the W4A16
     matvec (and their library calls) also from HBM (ms_hbm: each call of
     the timed graph on another layer or copy, together past the 50 MB
     L2);
  4. check a small model end to end (LlamaConfig.tiny's head dim 32, and
     4 query heads over 2 KV heads), in bf16 and with int4 W4A8 LLM
     weights: the CUDA path in bf16 against the plain path on the CPU
     in f32;
  5. build Vicuna-7B + CLIP ViT-L/14-224 with random bf16 weights and
     answer three chat requests through VideoChatGPTInterface (a
     100-frame clip at temperature 0, a second turn, a 12-frame clip at
     temperature 0.2; frames from a seed; no speculation, as in the chat
     CLI), with every kernel's launch count taken over exactly that
     run; then profile the 100-frame request once more (see
     profile_request); then checkpoint loading (checkpoint_phase): that
     seed engine written as HF-layout checkpoints (BF16 safetensors
     shards in Vicuna's names with a synthetic 32,000-piece
     tokenizer.json, CLIP's pytorch_model.bin, mm_projector.bin;
     scripts/weight_tools' make-delta, apply-delta and consolidate on
     mm_projector.bin and on .safetensors files of the embedding's rows,
     every file read back bit-equal: weight_tools_check) and
     read back by initialize_model(model_name, projection_path,
     clip_path), in bf16 (every parameter equal to the seed engine's)
     and at --quant int4 (every leaf equal to quantizing the bf16
     reload on the card, the load's added device peak within a random
     int4 build's plus one bf16 layer), then the int4 chat's first
     request from it, then validate_quant_quality --preflight --record
     --vision over that checkpoint (bf16, int8, int4 on ~2,048 seeded
     tokens), whose record resolve_quant('auto') and
     resolve_clip_dtype('auto') must read back;
  6. free it, build the same model with int4 W4A8 LLM weights (fused
     wqkv/gate_up, int8 lm_head and embedding: --quant int4) and answer
     the 100-frame request and a second turn, launch counts again taken
     over exactly that run, and profile the 100-frame request; then
     scripts/profile_decode.run on that engine (profile_decode_phase: the
     warm step over bursts of 16, then 64 profiled steps whose top ops
     name kernels A and 3); then the
     same with the A8 switches off (w4a16_chat_phase: the W4A16 kernels,
     not profiled);
  7. serve those weights as `python -m video_llava_tpu_torch.serving
     --model_size 7b --quant int4 --continuous --paged --prefix_cache`
     would, on 127.0.0.1: 8 concurrent HTTP requests and a video
     request through continuous batching, one request through the
     serialized mode (see serving_phase), launch counts over that run;
     the continuous traffic again under the profiler; then 4 greedy
     requests with the paged kernel on and off (paged_off_phase: kernel
     10, then the dense gather and kernel 9);
  8. ground those answers (grounding_phase): kernel 12 (multi-scale
     deformable attention) against its plain version at GroundingDINO's
     800 px encoder and decoder shapes in f32 and bf16, through
     set_tile2d(True), with non-finite locations and a planted fault;
     a small GroundingDINO on the card against the CPU; then the
     full-width stack of `--with_grounding` (build_grounding_stack: Swin-T
     GroundingDINO, MobileSAM, the STM tracker, a Swin-L tagger) on the
     7B int4 engine, PGVideoLLaVA.answer over a seeded 100-frame 480 x 832
     clip, with stage times, launch counts, a profile (reusing the
     counted answer's scene cuts) and peak memory; then
     scripts/qualitative_demo.run_demo on that engine and stack over a
     seeded 24-frame 480 x 832 clip (demo_phase: stage times, classes,
     masks a frame, kernels 1, 2, 3, A, B and 12 launched, 24 annotated
     frames) and scripts/profile_gdino.run on its detector at batch 4
     (gdino_profile: stage prefixes; stage None equal to the forward);
     then BASELINE config 5's harness (grounding_eval_phase): seeded
     GroundingDINO Swin-T, SAM ViT-B, MobileSAM and RAM Swin-L (4,585
     tags) checkpoints written in the released layouts (the original
     .pth with a vocab.txt directory, an HF directory, mobile_sam.pt,
     ram_swin_large_14m.pth with its tag list and thresholds) and read
     back by build_grounding_stack(sam_variant='vit_b'), build_sam and
     build_tagger, every converted leaf equal to the seeded one; SAM's
     ViT encoder and RAM's tag_logits on the card against the CPU; the
     converted detector through kernel 12 against its plain version;
     the chat CLI's --sam_variant vit_b up to its prompt; then
     preprocess_grounding_annotations over synthetic VidOR / VidSTG and
     HC-STVG annotations, VidSTGDataset and HCSTVGDataset over its output
     (seeded frames in place of the decode: no libav here), and
     evaluate_dataset over 2 VidSTG and 1 HC-STVG samples of up to 100
     frames, the answer from the int4 engine's chat, the annotator
     through a stub client: per-sample sIoU, m_sIoU, stage seconds,
     kernel 12's launches, peak memory; then the RAM tagger over one
     sample's frames;
  9. transcribe the audio on the same engine (audio_phase, `--use_asr`):
     kernel 7 against its plain version at the Whisper large-v2 encoder's
     and the TL-TR head's shapes, its f32 body at Whisper base's, a small
     bf16 Whisper, TL-TR head and wav2vec2 on the card against the CPU,
     the chat CLI's f32 Whisper base (kernel 7's f32 body, its launches
     counted, its encoder against the CPU), then bench.py's stack at
     full width (Whisper large-v2 bf16, the TL-TR head, the
     wav2vec2-base aligner) transcribing and aligning a seeded 60 s
     waveform passed to upload_frames with the 100-frame clip, and the
     answer with the transcript spliced in: stage times, every kernel's
     launches, peak memory and a profile of the transcribe; then free
     the engine, build Vicuna-7B with 8 KV heads (int4) and answer the
     100-frame request (gqa_chat_phase: kernel 11), and free it;
     before it, tensor parallel first (tp_phase: the 7B int4 engine,
     unfused, its vocab padded to 256, under --mesh_model 2
     --dist_backend gloo with both ranks on this card, rank 1 spawned;
     the 100-frame request at 224 px, 32 greedy tokens, and 2 requests
     of 16 through the paged continuous engine, held against the
     single-process engine of the same seed: teacher-forced logits
     within TP_LIMITS (the request end to end, each paged request
     through the paged pool; a planted wrong-heads fault outside them),
     tokens equal up to a near tie; each rank's
     launches of 1, 2, 3, A, B and 10 and its peak memory; no multi-GPU
     speed is measured), then the windowed batcher (batching_phase): a
     7B int4 engine
     with the W8A8 CLIP tower (clip_dtype="int8", its leaves equal to
     quantize_a8_ of the seed's bf16 tower; the 100-frame encode timed
     beside the bf16 tower's, their features' per-token cosine, and
     torch._int_mm at the tower's product shapes beside cuBLAS bf16)
     served with --batching: 8 concurrent text requests, a video request
     and a stream, then a greedy request at max_batch 1 against
     ChatModel.chat, token for token;
     then BASELINE config 3 (eval_13b_phase): `python -m
     video_llava_tpu_torch.eval.run_inference --dataset activitynet
     --runner batched --batch_size 8 --quant int4 --model_size 13b` over
     9 samples (one video missing, one clip of 37 frames) through
     eval.run_inference.main, then run_qa_continuous on its engine with 8
     slots: stage times, launches, the b = 8 vs b = 1 prefill logits;
     then the batched runner made greedy must answer row for row as
     run_qa_continuous without speculation; then bench_grounding.py's
     learned build (learned_grounding_phase: GroundingDINO, MobileSAM, the
     ViT-B/32 crop filter in f32, XMem) over 100 seeded 480 x 832 frames,
     the fused path and the chunked host loop agreeing over the first 20
     frames, with stage times,
     launches, 12 frames against the plain versions and a profile; then
     scripts/profile_xmem at 4 frames of 480 x 832 with a trace
     (profile_xmem_phase); then scripts/tracking_quality.main
     (tracking_quality_phase: 150 brief XMem training steps, the J&F
     table of the STM and XMem, each fused and not, the two within 1e-3,
     the loss falling); then
     scripts/save_features (save_features_phase): the f32 ViT-L/14
     extractor over seeded 100- and 37-frame "videos" and one that fails,
     one pickle each, the rerun resuming, kernel 1's f32 body launched;
  10. train (training_phase): kernels 7 and 8 against their
     plain versions at the training layer's shape and four others, then
     (flash_limit_checks) at b*h = 65,600 through each body of kernel 7
     (bf16 Hopper and WMMA, f32) and at head dims 24 (padded to 32), 256,
     200 (padded to 256), 264 and 384 (padded to 384) and 512, forward
     and backward in bf16 and f32, then timed at d 256, 384 and 512
     (flash_wide_times), kernel 8's f32 body against its plain version
     and timed (flash_f32_bwd_checks), a small model's train steps on the
     card against the CPU (bf16, an int8 LLM, and f32: kernel 8's f32
     body's launches), then `python -m video_llava_tpu_torch.train.train
     --model_size 7b` for 4 optimizer steps of 4 rows of 1,024 on seeded
     features, with its checkpoint, export and a profile of step 3, and
     its resume; then sharded training (train_mesh_phase): the same run
     under `--mesh_data 2 --mesh_model 2 --dist_backend gloo`, 4 ranks
     on this card (this process rank 0), held against it within
     MESH_LIMITS (per-step loss and grad norm, the exported projector and
     embed_tokens), a planted fault (no gradient sum over 'data') that
     must fall outside them, kernel 2's frame-sharded form on each rank
     against one process at 100, 73, 50 and 30 valid frames, each rank's
     launches of 7, 8 and 2 and its peak, the step and save seconds;
     then FSDP (`--tune_mode full`) on that mesh at 7B width cut to 2
     layers against one process, its checkpoint resumed in one process
     and at 2 x 1;
  11. print stage times, the kernels' JSON line, the card line and, last,
     {"ok": true, "device": {...}}.
It needs a CUDA card and the repository beside it, and imports no JAX.
"""

from __future__ import annotations

import builtins
import concurrent.futures
import contextlib
import copy
import dataclasses
import functools
import gc
import hashlib
import json
import math
import os
import pickle
import shutil
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import types
import urllib.request

import numpy as np
import torch
import torch.nn.functional as F

from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from video_llava_tpu_torch.audio import transcribe as transcribe_mod
from video_llava_tpu_torch.audio.align import ForcedAligner
from video_llava_tpu_torch.audio.builders import build_default_transcriber
from video_llava_tpu_torch.audio.synthetic import (
    char_vocab,
    letter_words,
    speech_wave,
)
from video_llava_tpu_torch.audio.transcribe import Transcriber
from video_llava_tpu_torch.config import (
    GenerationConfig,
    LlamaConfig,
    VideoLLaVAConfig,
)
from video_llava_tpu_torch.constants import (
    DEFAULT_AUDIO_TOKEN,
    DEFAULT_TRANSCRIPT_START,
    DEFAULT_VID_END_TOKEN,
    DEFAULT_VID_START_TOKEN,
    DEFAULT_VIDEO_PATCH_TOKEN,
    DEFAULT_VIDEO_TOKEN,
)
from video_llava_tpu_torch.engine import weights as weights_mod
from video_llava_tpu_torch.engine.continuous import (
    ContinuousEngine,
    SlotRequest,
)
from video_llava_tpu_torch.engine.quant_select import (
    resolve_clip_dtype,
    resolve_quant,
)
from video_llava_tpu_torch.grounding import fused_clip, results as gresults
from video_llava_tpu_torch.grounding.builders import (
    build_grounding_stack,
    build_sam,
    random_clip_filter,
)
from video_llava_tpu_torch.grounding.memory_tracker import (
    LearnedMemoryTracker,
    TrackerConfig,
)
from video_llava_tpu_torch.grounding.tracker import GroundedTracker
from video_llava_tpu_torch.media import scene as scene_mod
from video_llava_tpu_torch.models.video_llava import VideoLLaVA
from video_llava_tpu_torch.models import grounding_dino as gdino
from video_llava_tpu_torch.models import wav2vec2 as w2v
from video_llava_tpu_torch.models import whisper as whisper_mod
from video_llava_tpu_torch.models import xmem as xmem_mod
from video_llava_tpu_torch.models.clip import (
    CLIPVisionTower,
    padded_length,
    quantize_a8_,
)
from video_llava_tpu_torch.models.layers import Int8A8Kernel, TreeInit
from video_llava_tpu_torch.ops import (
    attention,
    cuda_lib,
    deformable,
    pooling,
    quant4,
)
from video_llava_tpu_torch.parallel import driver, multihost
from video_llava_tpu_torch.runtime import chat as chat_mod
from video_llava_tpu_torch.runtime.chat import (
    PGVideoLLaVA,
    VideoChatGPTInterface,
)
from video_llava_tpu_torch.runtime.conversation import conv_templates
from video_llava_tpu_torch.runtime.inference import (
    InferenceEngine,
    build_video_question,
)
from video_llava_tpu_torch.runtime.model_init import (
    initialize_model,
    model_config,
    random_init_,
    random_init_quantized_llm_,
)
from video_llava_tpu_torch.ops.image import preprocess_frames
from video_llava_tpu_torch.runtime.tokenizer import load_tokenizer
from video_llava_tpu_torch.scripts import (
    profile_decode,
    profile_gdino,
    profile_xmem,
    qualitative_demo,
    save_features,
    tracking_quality,
    validate_quant_quality,
    weight_tools,
)
from video_llava_tpu_torch.serving import server as server_mod
from video_llava_tpu_torch.serving.server import (
    ChatModel,
    ContinuousChatModel,
    serve,
)
from video_llava_tpu_torch.train import train
from video_llava_tpu_torch.train import train_step as train_step_mod
from video_llava_tpu_torch.train.data import (
    MultimodalCfg,
    preprocess,
    preprocess_multimodal,
)
from video_llava_tpu_torch.train.train_step import (
    init_train_state,
    make_optimizer,
    make_train_step,
    trainable_mask,
)
from video_llava_tpu_torch.utils.timing import median_ms, rotating_ms
from video_llava_tpu_torch.utils.trace_tools import busy_and_names, trace_busy

MAX_NEW_TOKENS = 64
QUESTION = "What is happening in this video?"
KERNELS = {  # name -> (CUDA source, the TPU kernel it replaces)
    "flash_attention_bhsd": ("video_llava_tpu_torch/csrc/flash_bhsd.cu",
                             "video_llava_tpu/ops/attention.py:360"),
    "spatio_temporal_pool": ("video_llava_tpu_torch/csrc/pool.cu",
                             "video_llava_tpu/ops/pooling.py:139"),
    "decode_attention_stacked": (
        "video_llava_tpu_torch/csrc/decode_attention.cu",
        "video_llava_tpu/ops/attention.py:1207"),
    "w4a8_matvec": ("video_llava_tpu_torch/csrc/w4a8_matvec.cu",
                    "video_llava_tpu/ops/quant4.py:870"),
    "w4a8_block": ("video_llava_tpu_torch/csrc/w4a8_block.cu",
                   "video_llava_tpu/ops/quant4.py:931"),
    "decode_attention_paged": (
        "video_llava_tpu_torch/csrc/decode_attention.cu",
        "video_llava_tpu/ops/attention.py:1360"),
    "flash_forward": ("video_llava_tpu_torch/csrc/flash_attention.cu",
                      "video_llava_tpu/ops/attention.py:324"),
    "flash_forward_f32": ("video_llava_tpu_torch/csrc/flash_attention_f32.cu",
                          "video_llava_tpu/ops/attention.py:324"),
    "flash_attention_bhsd_f32": (
        "video_llava_tpu_torch/csrc/flash_attention_f32.cu",
        "video_llava_tpu/ops/attention.py:360"),
    "flash_backward_dq": ("video_llava_tpu_torch/csrc/flash_attention.cu",
                          "video_llava_tpu/ops/attention.py:625"),
    "flash_backward_dkv": ("video_llava_tpu_torch/csrc/flash_attention.cu",
                           "video_llava_tpu/ops/attention.py:649"),
    "flash_backward_dq_f32": (
        "video_llava_tpu_torch/csrc/flash_attention_f32.cu",
        "video_llava_tpu/ops/attention.py:625"),
    "flash_backward_dkv_f32": (
        "video_llava_tpu_torch/csrc/flash_attention_f32.cu",
        "video_llava_tpu/ops/attention.py:649"),
    "multi_scale_deformable_attention": (
        "video_llava_tpu_torch/csrc/deformable_attention.cu",
        "video_llava_tpu/ops/deformable_pallas.py:196"),
    "w4a16_matvec": ("video_llava_tpu_torch/csrc/w4a16.cu",
                     "video_llava_tpu/ops/quant4.py:740"),
    "w4a16_block": ("video_llava_tpu_torch/csrc/w4a16.cu",
                    "video_llava_tpu/ops/quant4.py:797"),
    "decode_attention_mxu": (
        "video_llava_tpu_torch/csrc/decode_attention.cu",
        "video_llava_tpu/ops/attention.py:1075"),
    "decode_attention_pallas": (
        "video_llava_tpu_torch/csrc/decode_attention.cu",
        "video_llava_tpu/ops/attention.py:1526"),
}
BF16_PATH = ("flash_attention_bhsd", "spatio_temporal_pool",
             "decode_attention_stacked")
INT4_PATH = BF16_PATH + ("w4a8_matvec", "w4a8_block")
SERVING_PATH = ("decode_attention_paged", "w4a8_matvec", "w4a8_block")
TRAIN_PATH = ("flash_forward", "flash_backward_dq", "flash_backward_dkv")
TRAIN_PATH_F32 = ("flash_forward_f32", "flash_backward_dq_f32",
                  "flash_backward_dkv_f32")
GROUNDING_PATH = ("multi_scale_deformable_attention",)
# the learned grounding build: GroundingDINO, the ViT-B/32 crop filter's
# vision tower (f32) and text tower (kernel 7's f32 body), XMem
LEARNED_PATH = ("multi_scale_deformable_attention", "flash_attention_bhsd_f32",
                "flash_forward_f32")
# Kernel vs plain on the card, both bf16 out. flash: the kernel rounds P
# to bf16 for its second product and accumulates in another order;
# decode: the plain version dequantizes int8 to bf16, the kernel keeps
# f32; pool: f32 sums in another order. Each differs from the plain
# version by a few bf16 ulps of outputs of magnitude < 2.
TOL = {"flash_attention_bhsd": 2e-2, "spatio_temporal_pool": 1e-2,
       "decode_attention_stacked": 2e-2, "decode_attention_paged": 2e-2,
       "decode_attention_mxu": 2e-2, "decode_attention_pallas": 2e-2,
       "flash_forward": 2e-2}
# Kernel 10 also row by row (row_rel_err): a row of 2048 positions
# averages them, so its outputs are small (~0.01 in the int8 pool) and
# the absolute limit would pass a wrong block there; a few bf16 ulps of
# each row's own scale do not (paged_checks plants such faults). Kernels
# 3, 9 and 11 read long rows through a stacked or flat cache (3 and 9 up
# to 65,536 positions in long_decode_checks), and are held the same way
# (flat_decode_checks plants a head-mapping fault in 11's plain version).
ROW_TOL = {"decode_attention_paged": 2 ** -6, "decode_attention_mxu": 2 ** -6,
           "decode_attention_pallas": 2 ** -6,
           "decode_attention_stacked": 2 ** -6}
# W4A8 as max|err| / max|ref|: kernel and plain version quantize the
# activations by the same rule and form exact integer partials, so in f32
# out only the order of the f32 sums over groups differs. In bf16 out
# (what the path launches) the two f32 results round to bf16 at most one
# ulp apart, and an ulp is at most 2^-7 of the value.
# Deformable attention likewise: both sum in f32 in another order; bf16
# out adds one bf16 rounding of each.
# The W4A16 kernels form f32 group partials of exact products (integer
# nibbles times bf16 activations), as their plain versions do: the same
# limits.
REL_TOL = {"w4a8_matvec": {torch.float32: 1e-4, torch.bfloat16: 2 ** -7},
           "w4a8_block": {torch.float32: 1e-4, torch.bfloat16: 2 ** -7},
           "w4a16_matvec": {torch.float32: 1e-4, torch.bfloat16: 2 ** -7},
           "w4a16_block": {torch.float32: 1e-4, torch.bfloat16: 2 ** -7},
           "multi_scale_deformable_attention": {torch.float32: 1e-4,
                                                torch.bfloat16: 2 ** -7}}
# Published peaks of one H100 SXM (dense): the bound of a kernel is the
# larger of its bytes over HBM_RATE and its operations over the peak of
# their type.
HBM_RATE = 3.35e12  # bytes/s
BF16_PEAK = 989e12  # FLOP/s
F32_PEAK = 67e12  # FLOP/s, outside the tensor cores
TF32_PEAK = 495e12  # FLOP/s, the tensor cores
INT8_PEAK = 1979e12  # OP/s


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def bound(nbytes: float, ops: float = 0.0, peak: float = BF16_PEAK):
    """(ms, "bytes" or "operations"): the least time the card could take,
    the larger of the bytes the call must move over HBM_RATE and its
    operations over `peak`."""
    t_bytes, t_ops = nbytes / HBM_RATE, ops / peak
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def row_rel_err(got, want) -> float:
    """The largest over rows (the first axis) of max|got - want| /
    max|want| within the row."""
    err = (got.float() - want.float()).abs().flatten(1).amax(1)
    return (err / want.float().abs().flatten(1).amax(1)).max().item()


def record(results, name, err, ms, plain_ms, library_ms, nbytes, ops=0.0,
           peak=BF16_PEAK):
    """Keep a kernel's max |err| over its shapes and the first shape's
    times (the main path's) beside its bound; return the bound."""
    r = results.setdefault(name, {"max_abs_err": 0.0})
    r["max_abs_err"] = max(r["max_abs_err"], err)
    bound_ms, bound_by = bound(nbytes, ops, peak)
    if "ms" not in r:
        r.update(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                 bound_by=bound_by, library_ms=library_ms)
    return bound_ms, bound_by


def check(results, name, shape, fn, plain, nbytes, ops=0.0,
          peak=BF16_PEAK, library=None, hbm=None):
    """Kernel vs plain on the same inputs; raise past the tolerance
    (absolute, or relative to max |ref| for the REL_TOL kernels, by the
    output's dtype; for the ROW_TOL kernels also relative to each row's
    max |ref|). Time the kernel, the plain version and `library`
    (one PyTorch call computing the same function, or None), and put
    them beside the bound from `nbytes`/`ops` (see bound). hbm: (kernel
    calls, library calls or None) on copies of the operands past L2,
    timed by rotating_ms and printed as ms_hbm beside ms."""
    got, want = fn(), plain()
    torch.cuda.synchronize()
    if got.shape != want.shape or got.dtype != want.dtype:
        raise AssertionError(f"{name} {shape}: {tuple(got.shape)} "
                             f"{got.dtype} != {tuple(want.shape)} "
                             f"{want.dtype}")
    err = (got.float() - want.float()).abs().max().item()
    if name in REL_TOL:
        tol = REL_TOL[name][got.dtype]
        rel = err / want.float().abs().max().item()
        note = f"max|err|/max|ref| {rel:.3e} (tol {tol})"
    else:
        tol = TOL[name]
        rel = err
        note = f"max|err| {err:.3e} (tol {tol})"
    bad = not np.isfinite(rel) or rel > tol
    if name in ROW_TOL:
        row = row_rel_err(got, want)
        note += (f", rows' max|err|/max|ref| {row:.3e} "
                 f"(tol {ROW_TOL[name]:.4g})")
        bad = bad or not np.isfinite(row) or row > ROW_TOL[name]
    if bad:
        raise AssertionError(f"{name} {shape}: {note}")
    ms, plain_ms = median_ms(fn), median_ms(plain)
    library_ms = None if library is None else median_ms(library)
    bound_ms, bound_by = record(results, name, err, ms, plain_ms,
                                library_ms, nbytes, ops, peak)
    lib = "" if library_ms is None else f", library {library_ms:.4f} ms"
    if hbm is not None:
        fns, libs = hbm
        lib += f", ms_hbm {rotating_ms(fns):.4f} over {len(fns)} copies"
        if libs is not None:
            lib += f" (library {rotating_ms(libs):.4f})"
    print(f"check {name} {shape}: {note}, max|err| {err:.3e}, "
          f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms{lib}, bound "
          f"{bound_ms:.4f} ms by {bound_by}", flush=True)


def chat_cache_len(cfg: VideoLLaVAConfig, seq_pad_multiple: int = 128):
    """(prompt tokens, cache capacity) of the first chat turn, built as
    VideoChatGPTInterface.answer builds it."""
    conv = conv_templates["pg-video-llava"].copy()
    conv.append_message(conv.roles[0], QUESTION + "\n" + DEFAULT_VIDEO_TOKEN)
    conv.append_message(conv.roles[1], None)
    video = (DEFAULT_VID_START_TOKEN
             + DEFAULT_VIDEO_PATCH_TOKEN * cfg.video_token_len
             + DEFAULT_VID_END_TOKEN)
    n = len(load_tokenizer(None).encode(
        conv.get_prompt().replace(DEFAULT_VIDEO_TOKEN, video, 1)))
    return n, n + (-n % seq_pad_multiple) + MAX_NEW_TOKENS


def kernel_checks(dev) -> dict:
    g = torch.Generator(device=dev).manual_seed(0)
    rnd = lambda *s: torch.randn(*s, generator=g, device=dev).to(  # noqa
        torch.bfloat16)
    results: dict = {}
    # CLIP attention: 100 frames x 16 heads, 224 px then 336 px; the
    # library call is SDPA with the same key mask. The bound reads q and
    # writes o at s_pad rows, and reads k and v at kv_len rows (the
    # function never needs the pad keys). The pad rows of k and v hold
    # large values (keys of 30, values of 100), so a pad key that leaks
    # into the softmax shows; a planted fault in the plain version
    # (kv_len + 1: the first pad key seen) must fail the check.
    for s, s_pad in ((257, 272), (577, 640)):
        q, k, v = (rnd(100, 16, s_pad, 64) for _ in range(3))
        k[:, :, s:], v[:, :, s:] = 30.0, 100.0
        mask = (torch.arange(s_pad, device=dev) < s)[None, None, None]
        check(results, "flash_attention_bhsd", (100, 16, s_pad, 64, s),
              lambda: attention.flash_attention_bhsd(q, k, v, kv_len=s),
              lambda: attention.flash_attention_bhsd_plain(q, k, v,
                                                           kv_len=s),
              nbytes=(2 * s_pad + 2 * s) * 100 * 16 * 64 * 2,
              ops=4 * 100 * 16 * s_pad * s * 64,
              library=lambda: F.scaled_dot_product_attention(
                  q, k, v, attn_mask=mask))
        if s_pad == 272:
            want = attention.flash_attention_bhsd_plain(q, k, v, kv_len=s)
            faulty = attention.flash_attention_bhsd_plain(q, k, v,
                                                          kv_len=s + 1)
            err = (faulty.float() - want.float()).abs().max().item()
            print(f"planted fault in kernel 1's plain version, kv_len + 1: "
                  f"max|err| {err:.3e}", flush=True)
            if not err > TOL["flash_attention_bhsd"]:
                raise AssertionError("the CLIP attention check passes the "
                                     "planted pad-key fault")
            del want, faulty
    del q, k, v
    bhsd_f32_checks(dev, results)
    # pooling: 100 frames, a 12-frame clip, then 9 valid frames of 12
    # (the kernel reads only those); the library call is the two means
    # over the valid frames. A planted fault in the plain version (n + 1
    # valid frames) must fail the check.
    for t, n in ((100, 100), (12, 12), (12, 9)):
        x = rnd(t, 256, 1024)
        check(results, "spatio_temporal_pool",
              (t, 256, 1024) + (() if n == t else (f"n {n}",)),
              lambda: pooling.spatio_temporal_pool_fused(x, n),
              lambda: pooling.spatio_temporal_pool(x, n),
              nbytes=(n * 256 * 1024 + (100 + 256) * 1024) * 2,
              library=lambda: torch.cat([x[:n].mean(1), x[:n].mean(0)]))
        if n < t:
            err = (pooling.spatio_temporal_pool(x, n + 1).float()
                   - pooling.spatio_temporal_pool(x, n).float()).abs().max()
            print(f"planted fault in kernel 2's plain version, n + 1 valid "
                  f"frames: max|err| {err.item():.3e}", flush=True)
            if not err.item() > TOL["spatio_temporal_pool"]:
                raise AssertionError("the pool check passes the planted "
                                     "n + 1 fault")
    del x
    batched_pool_check(dev, rnd, results)
    # decode attention at the first chat turn's cache, mid-answer
    n_prompt, L = chat_cache_len(VideoLLaVAConfig())
    n = n_prompt + MAX_NEW_TOKENS // 2
    lens = torch.tensor([n], dtype=torch.int32, device=dev)
    q = rnd(1, 1, 32, 128)
    kc, vc = rnd(32, 1, L, 32, 128), rnd(32, 1, L, 32, 128)
    mask = (torch.arange(L, device=dev) < n)[None, None, None]
    sdpa_layer = lambda li: F.scaled_dot_product_attention(  # noqa: E731
        q.transpose(1, 2), kc[li].transpose(1, 2), vc[li].transpose(1, 2),
        attn_mask=mask)
    # from HBM: one call a layer, layers 0-31 (the decode step's order)
    check(results, "decode_attention_stacked", (32, 1, L, 32, 128, "bf16"),
          lambda: attention.decode_attention_stacked(q, kc, vc, 17, lens),
          lambda: attention.decode_attention_stacked_plain(q, kc, vc, 17,
                                                           lens),
          nbytes=2 * n * 32 * 128 * 2, ops=4 * n * 32 * 128,
          library=lambda: sdpa_layer(17),
          hbm=([lambda li=li: attention.decode_attention_stacked(
              q, kc, vc, li, lens) for li in range(32)],
               [lambda li=li: sdpa_layer(li) for li in range(32)]))
    kq = torch.randint(-127, 128, kc.shape, generator=g, device=dev,
                       dtype=torch.int8)
    vq = torch.randint(-127, 128, kc.shape, generator=g, device=dev,
                       dtype=torch.int8)
    ks = torch.rand(kc.shape[:-1], generator=g, device=dev) / 127
    vs = torch.rand(kc.shape[:-1], generator=g, device=dev) / 127
    check(results, "decode_attention_stacked", (32, 1, L, 32, 128, "int8"),
          lambda: attention.decode_attention_stacked(q, kq, vq, 17, lens,
                                                     ks, vs),
          lambda: attention.decode_attention_stacked_plain(q, kq, vq, 17,
                                                           lens, ks, vs),
          nbytes=2 * n * 32 * (128 + 4), ops=4 * n * 32 * 128,
          hbm=([lambda li=li: attention.decode_attention_stacked(
              q, kq, vq, li, lens, ks, vs) for li in range(32)], None))
    del q, kc, vc, kq, vq, ks, vs
    paged_checks(dev, g, rnd, results)
    w4a8_checks(dev, g, results)
    flat_decode_checks(dev, g, rnd, results)
    # after every kernel's main-path shape: record() keeps the first
    long_decode_checks(dev, g, rnd, results)
    w4a16_checks(dev, g, results)
    checks_13b(dev, g, rnd, results)
    tp_kernel_checks(dev, g, rnd, results)
    pool_divisor_checks(dev, rnd, results)
    return results


# One 'data' rank's share of the frame-sharded pooling of 100 frames over
# 2 ranks: (valid frames of its 50, the global count dividing its spatial
# sums), at the global counts 100, 73 and 30 (the second rank's 0 of 50).
POOL_SHARDS = ((50, 100), (23, 73), (0, 30))


def pool_divisor_checks(dev, rnd, results) -> None:
    """Kernel 2 with a divisor other than its valid count, as each rank of
    spatio_temporal_pool_sharded launches it (f32 out, 50 local frames of
    ViT-L's 256 x 1024), against its plain version (pool_shard_plain);
    the library call is the two f32 reductions over the valid frames.
    After every main-path shape: record() keeps the first."""
    x = rnd(50, 256, 1024)
    for n, denom in POOL_SHARDS:
        check(results, "spatio_temporal_pool",
              (50, 256, 1024, f"n {n}", f"divisor {denom}", "f32 out"),
              lambda: pooling.spatio_temporal_pool_fused(
                  x, n, 50, torch.float32, n_denom=denom),
              lambda: pooling.pool_shard_plain(x, n, denom, 50,
                                               torch.float32),
              nbytes=n * 256 * 1024 * 2 + (50 + 256) * 1024 * 4,
              library=lambda: torch.cat([
                  x[:n].float().mean(1),
                  x[:n].float().sum(0) / max(denom, 1)]))
    del x


# Kernel 1's f32 body at (b, h, s_pad, d, kv_len): the crop filter's
# ViT-B/32 over a chunk of 4 detection frames x 8 boxes (the learned
# grounding path's shape, first), then CLIP-L's 100 frames at 224 px.
BHSD_F32_SHAPES = ((32, 12, 64, 64, 50), (100, 16, 272, 64, 257))


def bhsd_f32_checks(dev, results) -> None:
    """Kernel 1's f32 body (3xTF32, csrc/flash_attention_f32.cu's
    head-major entry) against its plain version at BHSD_F32_SHAPES,
    within F32_FLASH_TOL, the pad rows of k and v large (keys of 30,
    values of 100); a planted fault in the plain version (kv_len + 1)
    must fail the check. Timed beside the plain version, SDPA in f32 with
    the same boolean key mask, and the bound: the bytes of q and o at
    s_pad rows and of k and v at kv_len rows, or the two products three
    times over (3xTF32) at the TF32 rate (the f32-FMA bound printed)."""
    g = torch.Generator(device=dev).manual_seed(9)
    name = "flash_attention_bhsd_f32"
    for b, h, s_pad, d, s in BHSD_F32_SHAPES:
        q, k, v = (torch.randn(b, h, s_pad, d, generator=g, device=dev)
                   for _ in range(3))
        k[:, :, s:], v[:, :, s:] = 30.0, 100.0
        before = cuda_lib.LAUNCHES[name]
        got = attention.flash_attention_bhsd(q, k, v, kv_len=s)
        want = attention.flash_attention_bhsd_plain(q, k, v, kv_len=s)
        faulty = attention.flash_attention_bhsd_plain(q, k, v, kv_len=s + 1)
        torch.cuda.synchronize()
        if cuda_lib.LAUNCHES[name] != before + 1 or got.dtype != q.dtype:
            raise AssertionError(f"{name}: not launched, or {got.dtype}")
        err = (got - want).abs().max().item()
        caught = (faulty - want).abs().max().item()
        note = (f"max|err| {err:.3e} (tol {F32_FLASH_TOL}; the plain "
                f"version at kv_len + 1 is off by {caught:.3e})")
        if not (err <= F32_FLASH_TOL and caught > F32_FLASH_TOL):
            raise AssertionError(f"{name} {(b, h, s_pad, d, s)}: {note}")
        mask = (torch.arange(s_pad, device=dev) < s)[None, None, None]
        ms = median_ms(lambda: attention.flash_attention_bhsd(q, k, v,
                                                              kv_len=s))
        plain_ms = median_ms(lambda: attention.flash_attention_bhsd_plain(
            q, k, v, kv_len=s))
        lib_ms = median_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, attn_mask=mask))
        ops = 4 * b * h * s_pad * s * d
        nbytes = (2 * s_pad + 2 * s) * b * h * d * 4
        bound_ms, bound_by = record(results, name, err, ms, plain_ms, lib_ms,
                                    nbytes, 3 * ops, TF32_PEAK)
        if s_pad != BHSD_F32_SHAPES[0][2]:  # CLIP-L's, beside the path's
            results[name]["clip_l"] = dict(
                shape=[b, h, s_pad, d, s], max_abs_err=err, ms=ms,
                plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bound_ms,
                bound_by=bound_by)
        print(f"check {name} {(b, h, s_pad, d, s)}: {note}; kernel "
              f"{ms:.4f} ms ({bound_ms / ms:.3f} of the bound), plain "
              f"{plain_ms:.4f} ms, library (SDPA f32) {lib_ms:.4f} ms, bound "
              f"{bound_ms:.4f} ms by {bound_by} (as f32 FMAs "
              f"{bound(nbytes, ops, F32_PEAK)[0]:.4f} ms)", flush=True)
        del q, k, v, got, want, faulty, mask
    torch.cuda.empty_cache()


# Valid counts of the batched pool check: a batch of 8 videos padded to 100
# frames, two short clips and one of a single frame among them.
BATCH_POOL_COUNTS = (100, 100, 73, 100, 12, 100, 100, 1)


def batched_pool_check(dev, rnd, results) -> None:
    """Kernel 2 over a batch of 8 videos of (100, 256, 1024) in one launch,
    a valid count a video from a device tensor (BATCH_POOL_COUNTS), as
    the batched eval runners pool (eval/run_inference.run_qa_batched):
    against the batched plain version, then bit for bit against one
    launch a video (whose time is printed beside it); the library call is
    the two means over each video's valid frames. A planted fault in the
    plain version (each video pooled with its neighbour's count) must fail
    the check."""
    b, t = len(BATCH_POOL_COUNTS), 100
    x = rnd(b, t, 256, 1024)
    n = torch.tensor(BATCH_POOL_COUNTS, dtype=torch.int32, device=dev)
    fused = lambda: pooling.spatio_temporal_pool_fused(x, n)  # noqa: E731
    check(results, "spatio_temporal_pool",
          (b, t, 256, 1024, f"counts {BATCH_POOL_COUNTS}"), fused,
          # the plain version reads the counts on the host (a graph
          # capture takes no device-to-host copy)
          lambda: pooling.spatio_temporal_pool(x, BATCH_POOL_COUNTS),
          nbytes=(sum(BATCH_POOL_COUNTS) * 256 + b * (100 + 256)) * 1024 * 2,
          library=lambda: [torch.cat([x[i, :k].mean(1), x[i, :k].mean(0)])
                           for i, k in enumerate(BATCH_POOL_COUNTS)])
    got = fused()
    singles = lambda: [  # noqa: E731
        pooling.spatio_temporal_pool_fused(x[i], k)
        for i, k in enumerate(BATCH_POOL_COUNTS)]
    same = all(torch.equal(got[i], one) for i, one in enumerate(singles()))
    print(f"batched kernel 2 against {b} single launches: "
          f"{'bit-identical' if same else 'DIFFERENT'}; {b} single launches "
          f"{median_ms(singles):.4f} ms", flush=True)
    if not same:
        raise AssertionError("the batched pool differs from its single "
                             "launches")
    want = pooling.spatio_temporal_pool(x, BATCH_POOL_COUNTS)
    faulty = pooling.spatio_temporal_pool(
        x, BATCH_POOL_COUNTS[-1:] + BATCH_POOL_COUNTS[:-1])
    err = (faulty.float() - want.float()).abs().max().item()
    print(f"planted fault in kernel 2's batched plain version, each video "
          f"pooled with its neighbour's count: max|err| {err:.3e}",
          flush=True)
    if not err > TOL["spatio_temporal_pool"]:
        raise AssertionError("the batched pool check passes the planted "
                             "count fault")
    del x, got, want, faulty


def chunked(plain, rows: int = 512):
    """`plain` over x in chunks of `rows` rows (the W4A8 plain versions
    hold a (groups, rows, F) f32 partial: 27 GB at 6,144 rows of 13B's
    gate_up at once); rows are independent, so the result is plain's."""
    return lambda x, p, s: torch.cat([plain(x[i:i + rows], p, s)
                                      for i in range(0, len(x), rows)])


def checks_13b(dev, g, rnd, results) -> None:
    """Kernels A, B and 3 at the shapes of the 13B batched eval phase
    (BASELINE config 3: Vicuna-13B, 40 layers of width 5120, 40 heads of
    128, MLP 13824; a batch of 8): A at 8 rows (the A8_MAX_BATCH edge)
    of wqkv (5120 -> 15360), gate_up (5120 -> 27648) and down (13824 ->
    5120); B at the 8 x 768 prefill rows of gate_up and down and at one 8
    x 9 verify window of gate_up; both in the bf16-out build the path
    launches, against the plain versions rounded to bf16; kernel 3 at
    (40 layers, b 8, 40 heads, d 128) over the batch's cache mid-answer
    (8 rows of mixed lengths), also from HBM over the 40 layers. Times
    print on the check lines; the kernels line keeps each kernel's 7B
    main-path shape."""
    cfg = LlamaConfig.vicuna_13b()
    d, f = cfg.hidden_size, cfg.intermediate_size

    def weight(k, n):
        w = torch.randn(1, k, n, generator=g, device=dev)
        packed, scales = quant4.quantize_tensor_int4(w * k ** -0.5, 128)
        return packed[0], scales[0]

    weights = {"wqkv": weight(d, 3 * d), "gate_up": weight(d, 2 * f),
               "down": weight(f, d)}
    bf16 = torch.bfloat16
    prefill = 8 * 768
    for name, nb, key in (("w4a8_matvec", 8, "wqkv"),
                          ("w4a8_matvec", 8, "gate_up"),
                          ("w4a8_matvec", 8, "down"),
                          ("w4a8_block", prefill, "gate_up"),
                          ("w4a8_block", prefill, "down"),
                          ("w4a8_block", 8 * 9, "gate_up")):
        p, s = weights[key]
        x = torch.randn(nb, 2 * p.shape[0], generator=g, device=dev).to(bf16)
        kernel = getattr(quant4, name)
        plain = (quant4.int4_matmul_w4a8_xla if name == "w4a8_matvec"
                 else chunked(quant4.int4_matmul_w4a8_block_xla))
        check(results, name,
              (nb, 2 * p.shape[0], p.shape[1], "13B", "bf16 out", key),
              lambda: kernel(x, p, s, bf16), lambda: plain(x, p, s).to(bf16),
              nbytes=(p.numel() + 2 * s.numel() + 2 * x.numel()
                      + nb * p.shape[1] * 2),
              ops=2 * nb * x.shape[1] * p.shape[1], peak=INT8_PEAK)
        del x
    del weights
    torch.cuda.empty_cache()
    # kernel 3: the batch's cache, 768 prompt positions + 128 new tokens
    L = 768 + 128
    nl, b, h, hd = cfg.num_layers, 8, cfg.num_heads, cfg.head_dim
    lens = torch.tensor([700, 712, 705, 731, 698, 740, 702, 721],
                        dtype=torch.int32, device=dev) + 64
    q = rnd(b, 1, h, hd)
    kc, vc = rnd(nl, b, L, h, hd), rnd(nl, b, L, h, hd)
    mask = (torch.arange(L, device=dev)[None] < lens[:, None])[:, None, None]
    sdpa_layer = lambda li: F.scaled_dot_product_attention(  # noqa: E731
        q.transpose(1, 2), kc[li].transpose(1, 2), vc[li].transpose(1, 2),
        attn_mask=mask)
    n_read = int(lens.sum())
    check(results, "decode_attention_stacked", (nl, b, L, h, hd, "bf16",
                                                "13B batch"),
          lambda: attention.decode_attention_stacked(q, kc, vc, 17, lens),
          lambda: attention.decode_attention_stacked_plain(q, kc, vc, 17,
                                                           lens),
          nbytes=2 * n_read * h * hd * 2, ops=4 * n_read * h * hd,
          library=lambda: sdpa_layer(17),
          hbm=([lambda li=li: attention.decode_attention_stacked(
              q, kc, vc, li, lens) for li in range(nl)],
               [lambda li=li: sdpa_layer(li) for li in range(nl)]))
    del q, kc, vc
    torch.cuda.empty_cache()


def random_table(g, dev, row_lens, bs, maxb, nb):
    """(rows, maxb) int32 block tables: each row's blocks drawn without
    replacement from a shuffled pool of blocks 1..nb-1, the pad block 0
    past its allocation."""
    perm = (torch.randperm(nb - 1, generator=g, device=dev) + 1).tolist()
    table = torch.zeros((len(row_lens), maxb), dtype=torch.int32)
    for i, n in enumerate(row_lens):
        used = -(-n // bs)
        table[i, :used] = torch.tensor(perm[:used])
        perm = perm[used:]
    return table.to(dev), perm


def kv_pair(dev, g, rnd, shape, int8, unit=False):
    """(k, v, k_scale, v_scale) of `shape`: bf16 with no scales, or int8
    with f32 scales of shape[:-1] (plus a unit axis for a flat cache)."""
    if not int8:
        return rnd(*shape), rnd(*shape), None, None
    kq, vq = (torch.randint(-127, 128, shape, generator=g, device=dev,
                            dtype=torch.int8) for _ in range(2))
    sshape = tuple(shape[:-1]) + ((1,) if unit else ())
    ks, vs = (torch.rand(sshape, generator=g, device=dev) / 127
              for _ in range(2))
    return kq, vq, ks, vs


def paged_checks(dev, g, rnd, results) -> None:
    """Kernel 10 at the serving engine's shapes (7B, 4 slots, a pool of
    32 x 129 blocks of 64 positions, 32 blocks a row): two batches of row
    lengths {1000, 2048, 63, 64} and {1, 65, 1000, 2048}, each row's
    blocks drawn without replacement from a shuffled pool, the pad block
    0 past its allocation; bf16, then an int8 pool. The library call is
    SDPA with a length mask over the gathered dense view, timed from the
    gather on. On the first batch of each pool, two planted faults in
    the plain version (one table entry of the 2048-position row pointing
    at a block no row uses; row 1000's partial tail block dropped) must
    fail the row check: printed beside whether the absolute limit alone
    would have caught them. Then the split kernel's and the combine's
    plain versions over the wrapper's plan must pass it, and fail it with
    each row's last live chunk dropped (its partial emptied)."""
    nl, nb, bs, maxb, b, h, d = 32, 129, 64, 32, 4, 32, 128
    k, v = rnd(nl, nb, bs, h, d), rnd(nl, nb, bs, h, d)
    kq = torch.randint(-127, 128, k.shape, generator=g, device=dev,
                       dtype=torch.int8)
    vq = torch.randint(-127, 128, k.shape, generator=g, device=dev,
                       dtype=torch.int8)
    ks = torch.rand(k.shape[:-1], generator=g, device=dev) / 127
    vs = torch.rand(k.shape[:-1], generator=g, device=dev) / 127
    q = rnd(b, 1, h, d)
    pos = torch.arange(maxb * bs, device=dev)
    for int8 in (False, True):
        for row_lens in ((1000, 2048, 63, 64), (1, 65, 1000, 2048)):
            table, perm = random_table(g, dev, row_lens, bs, maxb, nb)
            lens = torch.tensor(row_lens, dtype=torch.int32, device=dev)
            args = ((q, kq, vq, 5, table, lens, ks, vs) if int8 else
                    (q, k, v, 5, table, lens))
            tokens = sum(row_lens) * h
            library = None
            if not int8:
                def library():
                    dense = lambda a: attention.paged_layer_dense(  # noqa
                        a, 5, table).transpose(1, 2)
                    mask = (pos[None] < lens[:, None])[:, None, None]
                    return F.scaled_dot_product_attention(
                        q.transpose(1, 2), dense(k), dense(v),
                        attn_mask=mask).transpose(1, 2)
            label = (nl, nb, bs, h, d, "table", b, maxb, row_lens,
                     "int8" if int8 else "bf16")
            check(results, "decode_attention_paged", label,
                  lambda: attention.decode_attention_paged(*args),
                  lambda: attention.decode_attention_paged_plain(*args),
                  nbytes=2 * tokens * (d + 4 if int8 else 2 * d),
                  ops=4 * tokens * d, library=library)
            if row_lens[:2] == (1000, 2048):
                swapped, short = table.clone(), lens.clone()
                swapped[1, 17] = perm[0]  # a block no row uses
                short[0] = 960  # row 1000 without its 40-position tail
                want = attention.decode_attention_paged_plain(*args)
                for fault, t, n in (("block 17 of row 2048 swapped",
                                     swapped, lens),
                                    ("row 1000's tail block dropped",
                                     table, short)):
                    faulty = attention.decode_attention_paged_plain(
                        *args[:4], t, n, *args[6:])
                    err = (faulty.float() - want.float()).abs().max().item()
                    row = row_rel_err(faulty, want)
                    verdict = ("fails" if err > TOL["decode_attention_paged"]
                               else "passes")
                    print(f"planted fault {label[-1]}, {fault}: max|err| "
                          f"{err:.3e} ({verdict} the absolute limit), rows' "
                          f"max|err|/max|ref| {row:.3e}", flush=True)
                    if not row > ROW_TOL["decode_attention_paged"]:
                        raise AssertionError("the row check passes a "
                                             f"planted fault: {fault}")
                chunk, splits = attention.paged_split_plan(
                    maxb, bs, b, h, torch.cuda.get_device_properties(
                        dev).multi_processor_count)
                m, l, acc = attention.decode_paged_partials_plain(
                    *args[:6], chunk, splits, *args[6:])
                row = row_rel_err(attention.decode_gqa_combine_plain(
                    m, l, acc), want)
                print(f"kernel 10's split plain versions ({splits} chunks "
                      f"of {chunk}) against its plain version: rows' "
                      f"max|err|/max|ref| {row:.3e}", flush=True)
                if not row <= ROW_TOL["decode_attention_paged"]:
                    raise AssertionError("kernel 10's split plain versions "
                                         "disagree with its plain version")
                last = (lens.long() - 1) // chunk
                l[torch.arange(b, device=dev), :, last] = 0.0
                row = row_rel_err(attention.decode_gqa_combine_plain(
                    m, l, acc), want)
                print(f"planted fault in kernel 10's split plain version, "
                      f"each row's last live chunk of {chunk} dropped: "
                      f"rows' max|err|/max|ref| {row:.3e}", flush=True)
                if not row > ROW_TOL["decode_attention_paged"]:
                    raise AssertionError("the row check passes the planted "
                                         "dropped-chunk fault")


def long_decode_checks(dev, g, rnd, results) -> None:
    """Kernels 3, 9 and 10 at 65,536 positions (Vicuna-7B's 32 heads of
    128, bf16), past the shared memory of the per-(head, row) body they
    once had: each is a split body at any length. Rows {65536, 40000};
    the paged pool holds them in blocks of 64."""
    L, h, d = 65536, 32, 128
    rows = (L, 40000)
    b = len(rows)
    lens = torch.tensor(rows, dtype=torch.int32, device=dev)
    q = rnd(b, 1, h, d)
    nbytes, ops = 2 * sum(rows) * h * d * 2, 4 * sum(rows) * h * d
    kc, vc = rnd(1, b, L, h, d), rnd(1, b, L, h, d)
    check(results, "decode_attention_stacked", (1, b, L, h, d, rows, "bf16"),
          lambda: attention.decode_attention_stacked(q, kc, vc, 0, lens),
          lambda: attention.decode_attention_stacked_plain(q, kc, vc, 0,
                                                           lens),
          nbytes=nbytes, ops=ops)
    check(results, "decode_attention_mxu", (b, L, h, d, rows, "bf16"),
          lambda: attention.decode_attention_mxu(q, kc[0], vc[0], lens),
          lambda: attention.decode_attention_mxu_plain(q, kc[0], vc[0],
                                                       lens),
          nbytes=nbytes, ops=ops)
    del kc, vc
    bs, maxb = 64, L // 64
    nb = 1 + sum(-(-r // bs) for r in rows)
    kp, vp = rnd(1, nb, bs, h, d), rnd(1, nb, bs, h, d)
    table, _ = random_table(g, dev, rows, bs, maxb, nb)
    args = (q, kp, vp, 0, table, lens)
    check(results, "decode_attention_paged",
          (1, nb, bs, h, d, "table", b, maxb, rows, "bf16"),
          lambda: attention.decode_attention_paged(*args),
          lambda: attention.decode_attention_paged_plain(*args),
          nbytes=nbytes, ops=ops)


def int4_planted_faults(name, x, p, s, out, want) -> None:
    """Two faults planted in kernel `name`'s plain version (kernel A, B or
    the W4A16 block matmul) must each fail its check against the true
    plain version `want`: the high half's group scales read for the low
    half, and the last K split of the kernel's plan dropped (its packed
    rows zeroed)."""
    half = s.shape[0] // 2
    wrong_scales = torch.cat([s[half:], s[half:]]) if half else s * 2
    plain = {"w4a8_matvec": quant4.int4_matmul_w4a8_xla,
             "w4a8_block": quant4.int4_matmul_w4a8_block_xla,
             "w4a16_block": quant4.int4_matmul_w4a16_block_plain}[name]
    dh, f = p.shape
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    if name == "w4a8_matvec":
        rows = quant4.matvec_rows_per_split(dh, f, s.shape[0], sms)
    elif name == "w4a8_block":
        rows = quant4.w4a8_block_plan(x.shape[0], dh, f, s.shape[0], sms)[1]
    else:
        rows = quant4.w4a16_block_plan(x.shape[0], dh, f, s.shape[0],
                                       sms)[2]
    if rows >= dh:
        raise AssertionError(f"{name} {tuple(x.shape)} x {tuple(p.shape)}: "
                             "the plan does not split K, so the dropped-"
                             "split fault would drop nothing")
    last = (dh - 1) // rows * rows  # the last split's first packed row
    dropped = p.clone()
    dropped[last:] = 0x08  # both nibbles 0: the split adds nothing
    tol = REL_TOL[name][out]
    for label, fault in (("high-half scales for the low half",
                          plain(x, p, wrong_scales)),
                         (f"the last K split (rows {last}-{dh}) dropped",
                          plain(x, dropped, s))):
        fault = fault.to(out)
        rel = ((fault.float() - want.float()).abs().max()
               / want.float().abs().max()).item()
        print(f"planted fault in {name}'s plain version, {label}: "
              f"max|err|/max|ref| {rel:.3e} (tol {tol})", flush=True)
        if not rel > tol:
            raise AssertionError(f"the {name} check passes the planted "
                                 f"fault: {label}")


def w4a8_checks(dev, g, results) -> None:
    """Kernels A and B on Vicuna-7B's linears, bf16 activations as on the
    path. First the build the path launches, bf16 out (its times go in
    the kernels line), against the plain version rounded to bf16: A at
    wqkv (one row: chat decode) and gate_up (4 rows: serving's decode), B
    at 768 rows (the chat prefill), 36 (serving's verify: 4 slots x 9)
    and 256 (a prefill window) of gate_up; then f32 out, where the 1e-4
    relative bound is not hidden by bf16 rounding. Stacked weights are
    (4, Dh, F), read at layer 2 as a view; one weight of each kernel is a
    flat per-layer tensor. A at wqkv and gate_up is also timed from HBM
    (ms_hbm: one call on each of the 4 layers, 100 and 180 MB). Beside B
    at 768 rows, torch._int_mm times the same int32 products on xq and
    the weight unpacked to int8 ahead (no scales, no unpack): cuBLAS's
    int8 rate for reference, not the same function. Two faults planted in
    each plain version (wrong-half scales, the last K split dropped) must
    fail the check."""

    def weight(d, f, layers=None):
        w = torch.randn(layers or 1, d, f, generator=g, device=dev)
        packed, scales = quant4.quantize_tensor_int4(w * d ** -0.5, 128)
        return (packed, scales) if layers else (packed[0], scales[0])

    def act(n, d):
        return torch.randn(n, d, generator=g, device=dev).to(torch.bfloat16)

    cfg = LlamaConfig.vicuna_7b()
    d, f = cfg.hidden_size, cfg.intermediate_size
    weights = {"wqkv": weight(d, 3 * d, layers=4),
               "gate_up": weight(d, 2 * f, layers=4),
               "down": weight(f, d, layers=4), "wo": weight(d, d)}
    bf16, f32 = torch.bfloat16, torch.float32
    for name, nb, key, out in (
            ("w4a8_matvec", 1, "wqkv", bf16),
            ("w4a8_matvec", 4, "gate_up", bf16),
            ("w4a8_matvec", 1, "down", bf16),
            ("w4a8_block", 768, "gate_up", bf16),
            ("w4a8_block", 36, "gate_up", bf16),
            ("w4a8_block", 256, "gate_up", bf16),
            ("w4a8_block", 768, "down", bf16),
            ("w4a8_matvec", 1, "wqkv", f32),
            ("w4a8_matvec", 1, "down", f32),
            ("w4a8_matvec", 4, "gate_up", f32),
            ("w4a8_matvec", 1, "wo", f32),
            ("w4a8_block", 768, "gate_up", f32),
            ("w4a8_block", 768, "down", f32),
            ("w4a8_block", 1100, "wo", f32)):
        pk, sc = weights[key]
        stacked = key != "wo"
        p, s = (pk[2], sc[2]) if stacked else (pk, sc)
        x = act(nb, 2 * p.shape[0])
        kernel = getattr(quant4, name)
        plain = (quant4.int4_matmul_w4a8_xla if name == "w4a8_matvec"
                 else quant4.int4_matmul_w4a8_block_xla)
        hbm = None
        if name == "w4a8_matvec" and out == bf16 and key != "down":
            hbm = ([lambda li=li: kernel(x, pk[li], sc[li], out)
                    for li in range(len(pk))], None)
        check(results, name,
              (nb, 2 * p.shape[0], p.shape[1], "layer 2 of 4" if stacked
               else "flat", f"{str(out)[6:]} out", key),
              lambda: kernel(x, p, s, out), lambda: plain(x, p, s).to(out),
              nbytes=(p.numel() + 2 * s.numel() + 2 * x.numel()
                      + nb * p.shape[1] * out.itemsize),
              ops=2 * nb * x.shape[1] * p.shape[1], peak=INT8_PEAK, hbm=hbm)
        # where the plan splits K (wqkv: 4 splits; down: 2), so the split
        # fault drops a real split
        if (nb, key, out) in ((1, "wqkv", f32), (768, "down", f32)):
            int4_planted_faults(name, x, p, s, out, plain(x, p, s))
        if (name, nb, key, out) == ("w4a8_block", 768, "gate_up", bf16):
            xq, _ = quant4.quantize_activation_int8(x, 1)
            # (D, F) int8 laid out column-major, as cuBLASLt's int8 path
            # takes its second operand
            wq = quant4.unpack_int4(p).to(torch.int8).t().contiguous().t()
            try:
                note = f"{median_ms(lambda: torch._int_mm(xq, wq)):.4f} ms"
            except RuntimeError as e:  # a reference print, not a check
                note = f"not measured ({str(e).splitlines()[0]})"
            print(f"reference torch._int_mm ({nb}, {x.shape[1]}) x "
                  f"({x.shape[1]}, {p.shape[1]}) int8 -> int32 (the same "
                  f"int32 products, no unpack or scales; not the same "
                  f"function): {note}", flush=True)
            del xq, wq


def split_fault_check(label, name, q, kc, vc, lens, plan, want) -> None:
    """The split kernel's and the merge's plain versions over the
    wrapper's plan (chunk, splits) must pass the row check against the
    kernel's plain version `want`; with each row's last live chunk
    dropped (its partial emptied) they must fail it."""
    chunk, splits = plan
    m, l, acc = attention.decode_gqa_partials_plain(q, kc, vc, lens, chunk,
                                                    splits)
    row = row_rel_err(attention.decode_gqa_combine_plain(m, l, acc), want)
    print(f"{label}'s split plain versions ({splits} chunks of {chunk}) "
          f"against its plain version: rows' max|err|/max|ref| {row:.3e}",
          flush=True)
    if not row <= ROW_TOL[name]:
        raise AssertionError(f"{label}'s split plain versions disagree "
                             "with its plain version")
    last = (lens.long() - 1) // chunk
    l[torch.arange(len(lens), device=lens.device), :, last] = 0.0
    row = row_rel_err(attention.decode_gqa_combine_plain(m, l, acc), want)
    print(f"planted fault in {label}'s split plain version, each row's "
          f"last live chunk of {chunk} dropped: rows' max|err|/max|ref| "
          f"{row:.3e}", flush=True)
    if not row > ROW_TOL[name]:
        raise AssertionError("the row check passes the planted "
                             f"dropped-chunk fault of {label}")


def flat_decode_checks(dev, g, rnd, results) -> None:
    """Kernel 9 (MHA, decode_attention_mxu) at the 7B chat's first-turn
    cache mid-answer and at the serving rows {1000, 2048, 63, 64} in a
    dense (4, 2048) cache, the view the paged-off serving phase gathers;
    kernel 11 (GQA, decode_attention_pallas) at 32 query heads over 8 and
    over 4 KV heads at d 128 and 8 over 2 at d 32, at the chat cache; both
    in bf16 and int8. The library call is SDPA with the length mask (and
    enable_gqa for 11) in bf16. Kernel 9 is also timed from HBM over
    enough copies of its cache (at least 5) to read 120 MB a replay. A
    planted fault in kernel 11's plain version must fail the row check
    (query head i reads KV head i % h_kv, not i // group), and so must,
    for kernels 9 (both shapes, bf16) and 11, the split plain versions
    over the wrapper's plan with each row's last live chunk dropped. Then
    kernels 3 and 10 at head dim 32 (the tiny LLaMA's 8 x 32 heads)."""
    n_prompt, L = chat_cache_len(VideoLLaVAConfig())
    n = n_prompt + MAX_NEW_TOKENS // 2
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    sdpa = lambda q, k, v, lens, L: F.scaled_dot_product_attention(  # noqa
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
        attn_mask=(torch.arange(L, device=dev)[None] < lens[:, None])[
            :, None, None], enable_gqa=True).transpose(1, 2)
    cases = [("decode_attention_mxu", 32, 32, 128, L, (n,))] * 2 + [
        ("decode_attention_mxu", 32, 32, 128, 2048, (1000, 2048, 63, 64))] * 2
    for h, h_kv, d in ((32, 8, 128), (32, 4, 128), (8, 2, 32)):
        cases += [("decode_attention_pallas", h, h_kv, d, L, (n,))] * 2
    for i, (name, h, h_kv, d, length, rows) in enumerate(cases):
        int8 = i % 2 == 1
        b = len(rows)
        q = rnd(b, 1, h, d)
        kc, vc, ks, vs = kv_pair(dev, g, rnd, (b, length, h_kv, d), int8,
                                 unit=True)
        lens = torch.tensor(rows, dtype=torch.int32, device=dev)
        kernel, plain = (getattr(attention, name),
                         getattr(attention, name + "_plain"))
        tokens = sum(rows) * h_kv
        nbytes = 2 * tokens * (d + 4 if int8 else 2 * d)
        hbm = None
        if name == "decode_attention_mxu":
            copies = [kv_pair(dev, g, rnd, (b, length, h_kv, d), int8,
                              unit=True)
                      for _ in range(max(5, -(-120_000_000 // nbytes)))]
            hbm = ([lambda c=c: kernel(q, *c[:2], lens, *c[2:])
                    for c in copies],
                   None if int8 else [lambda c=c: sdpa(q, *c[:2], lens,
                                                       length)
                                      for c in copies])
        check(results, name, (b, length, h, h_kv, d, rows,
                              "int8" if int8 else "bf16"),
              lambda: kernel(q, kc, vc, lens, ks, vs),
              lambda: plain(q, kc, vc, lens, ks, vs),
              nbytes=nbytes, ops=4 * sum(rows) * h * d,
              library=None if int8 else (
                  lambda: sdpa(q, kc, vc, lens, length)), hbm=hbm)
        hbm = copies = None
        if name == "decode_attention_mxu" and not int8:
            split_fault_check(
                "kernel 9", name, q, kc, vc, lens,
                attention.mha_split_plan(length, b, h, sms),
                plain(q, kc, vc, lens))
        if name == "decode_attention_pallas" and i == 4:
            heads = [j % h_kv for j in range(h)]
            want = plain(q, kc, vc, lens)
            faulty = plain(q, kc[:, :, heads], vc[:, :, heads], lens)
            row = row_rel_err(faulty, want)
            print(f"planted fault in kernel 11's plain version, KV head "
                  f"i % h_kv: rows' max|err|/max|ref| {row:.3e}", flush=True)
            if not row > ROW_TOL[name]:
                raise AssertionError("the row check passes the planted "
                                     "head-mapping fault")
            split_fault_check("kernel 11", name, q, kc, vc, lens,
                              attention.gqa_split_plan(length, b, h_kv, sms),
                              want)
    # kernels 3 and 10 at head dim 32
    nl, b, h, d = 4, 2, 8, 32
    lens = torch.tensor([n, n // 2], dtype=torch.int32, device=dev)
    for int8 in (False, True):
        kc, vc, ks, vs = kv_pair(dev, g, rnd, (nl, b, L, h, d), int8)
        args = (rnd(b, 1, h, d), kc, vc, 2, lens, ks, vs)
        check(results, "decode_attention_stacked",
              (nl, b, L, h, d, "int8" if int8 else "bf16"),
              lambda: attention.decode_attention_stacked(*args),
              lambda: attention.decode_attention_stacked_plain(*args),
              nbytes=2 * int(lens.sum()) * h * (d + 4 if int8 else 2 * d),
              ops=4 * int(lens.sum()) * h * d)
        row_lens, bs, maxb = (100, 257, 15, 16), 16, 17
        nb = 1 + sum(-(-r // bs) for r in row_lens)
        kp, vp, ksp, vsp = kv_pair(dev, g, rnd, (2, nb, bs, h, d), int8)
        table, _ = random_table(g, dev, row_lens, bs, maxb, nb)
        plens = torch.tensor(row_lens, dtype=torch.int32, device=dev)
        pargs = (rnd(len(row_lens), 1, h, d), kp, vp, 1, table, plens, ksp,
                 vsp)
        check(results, "decode_attention_paged",
              (2, nb, bs, h, d, "table", len(row_lens), maxb, row_lens,
               "int8" if int8 else "bf16"),
              lambda: attention.decode_attention_paged(*pargs),
              lambda: attention.decode_attention_paged_plain(*pargs),
              nbytes=2 * sum(row_lens) * h * (d + 4 if int8 else 2 * d),
              ops=4 * sum(row_lens) * h * d)


def int4pack_library(x, packed, scales):
    """One PyTorch call computing the W4A16 product of x (nb, D) bf16:
    torch._weight_int4pack_mm on the weight repacked to its layout (the
    values q + 8 as unsigned nibbles, zero points 0, so each weight is
    (u - 8) * scale), the repacking done here, outside the timing. None
    when this build of PyTorch has no such call."""
    if not (hasattr(torch, "_weight_int4pack_mm")
            and hasattr(torch, "_convert_weight_to_int4pack")):
        return None
    u = (quant4.unpack_int4(packed) + 8).t().contiguous()  # (F, D) 0..15
    w = torch._convert_weight_to_int4pack(
        ((u[:, ::2] << 4) | u[:, 1::2]).to(torch.uint8), 8)
    group = u.shape[1] // scales.shape[0]
    sz = torch.stack([scales.float(), torch.zeros_like(scales.float())],
                     -1).to(torch.bfloat16).contiguous()  # (G, F, 2)
    return lambda: torch._weight_int4pack_mm(x, w, group, sz)


def w4a16_checks(dev, g, results) -> None:
    """Kernel 6's W4A16 pair on Vicuna-7B's linears, bf16 activations as
    on the path: the matvec (1 row) on the fused wqkv, wo, gate_up and
    down, the block matmul at 2, 8, 36, 256 and 768 rows; first the
    bf16-out build the path launches (its times go in the kernels line),
    then f32 out, with the block matmul also at 1100 rows of wo. The
    library call is torch._weight_int4pack_mm where PyTorch has it (its
    max|err|/max|ref| against the plain version is printed, not held: it
    dequantizes in its own order). The matvec in bf16 out on the stacked
    weights, and its library call, are also timed from HBM over their
    layers (wqkv and gate_up 6, 151 and 270 MB; down 4, 90 MB). A planted
    fault in the matvec's plain version (the low and high halves' group
    scales swapped) must fail the check, and so must two in the block
    matmul's (int4_planted_faults, at 768 rows of down, where its plan
    splits K)."""

    def weight(d, f, layers=None):
        w = torch.randn(layers or 1, d, f, generator=g, device=dev)
        packed, scales = quant4.quantize_tensor_int4(w * d ** -0.5, 128)
        return (packed, scales) if layers else (packed[0], scales[0])

    cfg = LlamaConfig.vicuna_7b()
    d, f = cfg.hidden_size, cfg.intermediate_size
    stacked = {"wqkv": weight(d, 3 * d, 6), "gate_up": weight(d, 2 * f, 6),
               "down": weight(f, d, 4)}
    w = {k: (p[2], sc[2]) for k, (p, sc) in stacked.items()}
    w["wo"] = weight(d, d)
    bf16, f32 = torch.bfloat16, torch.float32
    shapes = ([("w4a16_matvec", 1, "wqkv"), ("w4a16_block", 768, "gate_up")]
              + [("w4a16_matvec", 1, k) for k in ("wo", "gate_up", "down")]
              + [("w4a16_block", nb, k) for nb, k in
                 ((2, "wqkv"), (8, "wo"), (36, "down"), (256, "gate_up"))])
    lib_note = None
    for out in (bf16, f32):
        for name, nb, key in shapes + ([("w4a16_block", 1100, "wo"),
                                        ("w4a16_block", 768, "down")]
                                       if out == f32 else []):
            p, s = w[key]
            x = torch.randn(nb, 2 * p.shape[0], generator=g,
                            device=dev).to(bf16)
            kernel = getattr(quant4, name)
            plain = (quant4.int4_matmul_w4a16_matvec_plain
                     if name == "w4a16_matvec"
                     else quant4.int4_matmul_w4a16_block_plain)
            library = int4pack_library(x, p, s) if out == bf16 else None
            if library is None and out == bf16:
                lib_note = "this PyTorch has no torch._weight_int4pack_mm"
            elif library is not None:
                ref = plain(x, p, s)
                rel = ((library().float() - ref).abs().max()
                       / ref.abs().max()).item()
                print(f"library torch._weight_int4pack_mm {name} ({nb}, "
                      f"{key}): max|err|/max|ref| {rel:.3e} against the "
                      "plain version", flush=True)
            hbm = None
            if (name, out) == ("w4a16_matvec", bf16) and key != "wo":
                sp, ss = stacked[key][0], stacked[key][1]
                hbm = ([lambda li=li: kernel(x, sp[li], ss[li], out)
                        for li in range(len(sp))],
                       None if library is None else
                       [int4pack_library(x, sp[li], ss[li])
                        for li in range(len(sp))])
            check(results, name,
                  (nb, 2 * p.shape[0], p.shape[1], key, f"{str(out)[6:]} out"),
                  lambda: kernel(x, p, s, out), lambda: plain(x, p, s).to(out),
                  nbytes=(p.numel() + 2 * s.numel() + 2 * x.numel()
                          + nb * p.shape[1] * out.itemsize),
                  ops=2 * nb * x.shape[1] * p.shape[1], library=library,
                  hbm=hbm)
            hbm = None
            if (name, key, out) == ("w4a16_matvec", "wqkv", f32):
                half = s.shape[0] // 2
                swapped = torch.cat([s[half:], s[:half]])
                want = plain(x, p, s)
                rel = ((plain(x, p, swapped) - want).abs().max()
                       / want.abs().max()).item()
                print(f"planted fault in the W4A16 matvec's plain version, "
                      f"lo/hi group scales swapped: max|err|/max|ref| "
                      f"{rel:.3e}", flush=True)
                if not rel > REL_TOL[name][f32]:
                    raise AssertionError("the W4A16 check passes the planted "
                                         "scale-swap fault")
            if (name, nb, key, out) == ("w4a16_block", 768, "down", f32):
                int4_planted_faults(name, x, p, s, out, plain(x, p, s))
    if lib_note:
        print(f"library for the W4A16 kernels: null ({lib_note})")


SMALL_LIMIT = {None: 5e-2, "int4": 1e-1}


def small_model_check(dev, quant=None, kv_heads=None) -> None:
    """A small VideoLLaVA (LlamaConfig.tiny's 8 heads of 32, an
    intermediate size of 512 so that every int4 kernel's F is a multiple
    of 128) through the CUDA path in bf16 against the same weights on the
    CPU plain path in f32: pooled video features, prefill and decode
    logits, relative to their scale. Decode runs kernel 3 at head dim 32;
    kv_heads: 4 query heads over `kv_heads` KV heads instead, whose
    decode runs kernel 11. quant="int4": the LLM in the --quant int4
    layout (every layer kernel int4, a 512-word int4 lm_head, an int8
    embedding), so prefill runs kernel B and decode kernel A; its limit
    is wider because an int8 activation rounding step (1/127 of a group's
    absmax) turns a bf16-vs-f32 difference into a visible one."""
    tok = load_tokenizer(None)
    llm = dataclasses.replace(LlamaConfig.tiny(vocab_size=512),
                              intermediate_size=512)
    if kv_heads:
        llm = dataclasses.replace(llm, num_heads=4, num_kv_heads=kv_heads)
    cfg = dataclasses.replace(
        VideoLLaVAConfig.tiny(),
        llm=llm,
        vid_patch_token_id=tok.vid_patch_token_id,
        vid_start_token_id=tok.vid_start_token_id,
        vid_end_token_id=tok.vid_end_token_id,
    )
    layout = dict(llm_quant=quant, llm_fuse=bool(quant))
    ref = VideoLLaVA(cfg, device="cpu", dtype=torch.float32, **layout)
    gen = torch.Generator().manual_seed(0)
    random_init_(ref, gen)
    if quant:
        random_init_quantized_llm_(ref.llm, gen, dtype=torch.float32)
    gpu = VideoLLaVA(cfg, device=dev, dtype=torch.bfloat16, **layout)
    gpu.load_state_dict({
        k: v.to(dev, torch.bfloat16 if v.is_floating_point()
                and not k.endswith(".scales") else v.dtype)
        for k, v in ref.state_dict().items()})
    rng = np.random.default_rng(0)
    pixels = torch.from_numpy(
        rng.normal(size=(12, 56, 56, 3)).astype(np.float32))
    ids = rng.integers(0, 256, size=(1, 256))
    ids[0, 8:8 + cfg.video_token_len] = cfg.vid_patch_token_id
    ids = torch.from_numpy(ids)
    lens = torch.tensor([250], dtype=torch.int32)
    before = dict(cuda_lib.LAUNCHES)
    with torch.inference_mode():
        f_ref = ref.encode_video(pixels, 12)
        f_gpu = gpu.encode_video(pixels.to(dev), 12)
        p_ref = ref.prefill(ids, lens, f_ref[None], 264, torch.float32)
        p_gpu = gpu.prefill(ids.to(dev), lens.to(dev), f_gpu[None], 264)
        tok_ref = p_ref.logits_last.argmax(-1)
        d_ref, _ = ref.llm.decode_step(tok_ref.int(), p_ref.cache)
        d_gpu, _ = gpu.llm.decode_step(tok_ref.int().to(dev), p_gpu.cache)
    need = (("w4a8_matvec", "w4a8_block") if quant else ()) + (
        "decode_attention_pallas" if kv_heads else "decode_attention_stacked",)
    missing = [k for k in need if not cuda_lib.LAUNCHES[k] > before.get(k, 0)]
    label = f"{quant or 'bf16'} {llm.num_heads}/{llm.num_kv_heads} heads"
    if missing:
        raise AssertionError(f"small {label} model did not run {missing}")
    limit = SMALL_LIMIT[quant]
    for name, a, b in (("video features", f_gpu, f_ref),
                       ("prefill logits", p_gpu.logits_last,
                        p_ref.logits_last),
                       ("decode logits", d_gpu, d_ref)):
        a = a.float().cpu()
        rel = ((a - b).abs().max() / b.abs().max()).item()
        print(f"small {label} model {name}: shape {tuple(a.shape)}, "
              f"max|err| / max|ref| = {rel:.3e} (bf16 CUDA vs f32 CPU, "
              f"head dim {llm.head_dim}, limit {limit})")
        if not torch.isfinite(a).all() or rel > limit:
            raise AssertionError(f"small {label} model {name} disagrees: "
                                 f"{rel}")


def chat_requests(engine, clips, requests, dev, label):
    """Answer `requests` through VideoChatGPTInterface, with every
    kernel's launches counted over exactly these requests; print stage
    times. Returns the launch counts."""
    llm = engine.model.llm
    stats = {"nonfinite": 0, "prefill_s": 0.0, "decode_steps": 0,
             "prefills": 0, "steps_total": 0}
    logits_fn, prefill_fn = llm.logits, engine.model.prefill
    decode_fn = llm.decode_step

    def logits(hidden):  # count non-finite logits of every call
        out = logits_fn(hidden)
        stats["nonfinite"] += int((~torch.isfinite(out)).sum())
        return out

    def prefill(*a, **kw):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = prefill_fn(*a, **kw)
        torch.cuda.synchronize()
        stats["prefill_s"] += time.perf_counter() - t
        stats["prefills"] += 1
        return out

    def decode_step(*a, **kw):
        stats["decode_steps"] += 1
        stats["steps_total"] += 1
        return decode_fn(*a, **kw)

    llm.logits, engine.model.prefill = logits, prefill
    llm.decode_step = decode_step
    # warm-up (cuBLAS handles, allocator) so stage times are steady ones
    engine.encode_video_frames(clips["short"])
    torch.cuda.synchronize()
    stats.update(prefills=0, steps_total=0)
    cuda_lib.reset_launch_counts()
    iface = None
    for clip, text, temp in requests:
        if clip is not None:
            iface = VideoChatGPTInterface(
                engine, temperature=temp, max_output_tokens=MAX_NEW_TOKENS,
                generator=torch.Generator(device=dev).manual_seed(0))
            torch.cuda.synchronize()
            t = time.perf_counter()
            iface.upload_frames(clips[clip])
            torch.cuda.synchronize()
            encode_s = time.perf_counter() - t
            feats = iface.video_features
            want = (engine.cfg.video_token_len, engine.cfg.vision.hidden_size)
            if (tuple(feats.shape) != want
                    or not torch.isfinite(feats).all()):
                raise AssertionError(f"bad video features {feats.shape}")
        else:
            encode_s = 0.0
        stats.update(prefill_s=0.0, decode_steps=0)
        iface.add_text(text, None)
        torch.cuda.synchronize()
        t = time.perf_counter()
        answer = iface.answer()
        torch.cuda.synchronize()
        total_s = time.perf_counter() - t
        # One new token per decode step; the first token of the answer
        # comes from the prefill logits and is not counted.
        decode_s = total_s - stats["prefill_s"]
        print(f"{label} request {text!r} T={temp}: encode "
              f"{encode_s * 1e3:.1f} ms, prefill "
              f"{stats['prefill_s'] * 1e3:.1f} ms, decode "
              f"{stats['decode_steps']} steps in "
              f"{decode_s * 1e3:.1f} ms "
              f"({stats['decode_steps'] / decode_s:.2f} tok/s), answer "
              f"{len(answer)} chars", flush=True)
    launches = dict(cuda_lib.LAUNCHES)
    llm.logits, engine.model.prefill = logits_fn, prefill_fn
    llm.decode_step = decode_fn
    print(f"{label} launches over the requests: {launches} "
          f"({stats['prefills']} prefills, {stats['steps_total']} decode "
          "steps)")
    print(f"{label} peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    if stats["nonfinite"]:
        raise AssertionError(f"{label}: {stats['nonfinite']} non-finite "
                             "logits")
    launches["prefills"] = stats["prefills"]
    launches["decode_steps"] = stats["steps_total"]
    return launches


def port_kernel(name: str) -> bool:
    """Whether a profiled device activity is a kernel of csrc/ (the names
    of a few of PyTorch's own kernels also start so)."""
    return name.startswith(("void (anonymous namespace)::",
                            "(anonymous namespace)::", "void flash::",
                            "void flash_f32::"))


def profile_request(engine, clips, dev, label) -> None:
    """Where the device time of one first-turn request goes (100 frames,
    T=0, MAX_NEW_TOKENS new tokens: encode, prefill, decode). The
    request runs once unprofiled for its wall time, then once under
    torch.profiler. Device busy is the union of the intervals of every
    device activity the profiler recorded (kernels, copies, memsets);
    host-side op entries are not added, since each spans the kernels it
    launched and adding both counts that time twice. Idle share = 1 -
    busy / unprofiled wall."""

    def request():
        iface = VideoChatGPTInterface(
            engine, temperature=0.0, max_output_tokens=MAX_NEW_TOKENS,
            generator=torch.Generator(device=dev).manual_seed(0))
        iface.upload_frames(clips["long"])
        iface.add_text(QUESTION, None)
        iface.answer()
        torch.cuda.synchronize()

    torch.cuda.synchronize()
    t = time.perf_counter()
    request()
    wall_ms = (time.perf_counter() - t) * 1e3
    # device activity only, read from kineto's events as recorded (the
    # host ops and their FunctionEvents took ~60-80 s a request to build)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        request()
    device = [(e.name(), e.start_ns(), e.end_ns())
              for e in prof.profiler.kineto_results.events()
              if e.device_type() == DeviceType.CUDA]
    if not device:
        raise AssertionError(f"{label} profile: no device activity")
    busy_ms, by_name = busy_and_names(device)
    print(f"{label} profile, 100-frame request: wall {wall_ms:.1f} ms "
          f"(unprofiled), device busy {busy_ms:.1f} ms over "
          f"{len(device)} device activities, idle share "
          f"{1 - busy_ms / wall_ms:.3f}")
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1][0])
    # the top kernels, those launched once a token (the lm_head), and
    # every kernel of csrc/ (kernel 11's combine among them)
    for i, (name, (total, calls)) in enumerate(ranked):
        if i < 16 or calls == MAX_NEW_TOKENS or port_kernel(name):
            print(f"{label} profile: {total / 1e3:9.2f} ms {calls:6d} "
                  f"calls  {name[:90]}")


SERVING_PROMPT, SERVING_SHARED = 256, 0.6  # tokens; share of the prefix
SERVING_WORDS = ("video", "person", "walks", "market", "camera", "red",
                 "car", "turns", "left", "dog", "runs", "after", "ball",
                 "crowd", "cheers", "light", "rain", "falls", "slowly")


def serving_messages(chat, n: int = 8):
    """n chat requests of SERVING_PROMPT tokens each, whose first
    SERVING_SHARED of tokens are the same (system prompt and a shared
    context), then a distinct question (the byte tokenizer: one token a
    character)."""
    system = {"role": "system",
              "content": "You answer questions about videos."}
    empty = len(chat.build_prompt([system, {"role": "user",
                                            "content": "x"}])[0]) - 1
    n_shared = round(SERVING_SHARED * SERVING_PROMPT) - empty
    rng = np.random.default_rng(1)
    shared = " ".join(rng.choice(SERVING_WORDS, 40))[:n_shared]
    out = []
    for i in range(n):
        tail = f" Q{i}: " + " ".join(rng.choice(SERVING_WORDS, 60))
        text = shared + tail[:SERVING_PROMPT - empty - n_shared]
        msgs = [system, {"role": "user", "content": text}]
        if len(chat.build_prompt(msgs)[0]) != SERVING_PROMPT:
            raise AssertionError("serving prompt length")
        out.append(msgs)
    return out


def http_chat(base, body):
    """POST one chat completion; return (text, seconds). A streamed
    request's text is its deltas concatenated."""
    t = time.perf_counter()
    req = urllib.request.Request(
        base + "/chat/completions", data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=600) as resp:
        if not body.get("stream"):
            text = json.loads(resp.read())["choices"][0]["message"][
                "content"]
        else:
            pieces, done = [], False
            for line in resp:
                line = line.strip()
                if not line.startswith(b"data: "):
                    continue
                if line == b"data: [DONE]":
                    done = True
                    break
                payload = json.loads(line[len(b"data: "):])
                if "error" in payload:
                    raise AssertionError(f"stream error: {payload}")
                pieces.append(payload["choices"][0]["delta"].get(
                    "content", ""))
            if not done:
                raise AssertionError("stream ended without [DONE]")
            text = "".join(pieces)
    if not isinstance(text, str):
        raise AssertionError(f"bad answer {text!r}")
    return text, time.perf_counter() - t


def continuous_traffic(chat, messages, video):
    """Serve `chat` with continuous batching over the paged pool and
    prefix caching (4 slots, 2048 positions a row: serving/__main__.py's
    defaults) on 127.0.0.1, send the 8 requests from 8 threads at once
    (max_tokens 16 and 128 in turn, four at temperature 0 and four at
    0.2, requests 1 and 6 streamed), then submit the video request to
    the engine; check every answer, the stream texts, /metrics and that
    every block came back. Returns what the phase prints."""
    server = serve(chat, host="127.0.0.1", port=0, block=False,
                   model_name="vicuna", continuous=True, paged=True,
                   prefix_cache=True)
    cm, eng = server.chat_model, server.chat_model.engine
    base = f"http://127.0.0.1:{server.server_address[1]}/v1"
    finals, handles = {}, []
    chat_fn, submit_fn = cm.chat, eng.submit

    def chat_recorded(msgs, **kw):  # the final text of every request
        text = chat_fn(msgs, **kw)
        finals[msgs[-1]["content"]] = text
        return text

    def submit_recorded(req):  # every handle, for the token counts
        handles.append(submit_fn(req))
        return handles[-1]

    cm.chat, eng.submit = chat_recorded, submit_recorded
    bodies = [{"model": "vicuna", "messages": m,
               "max_tokens": (16, 128)[i % 2],
               "temperature": 0.0 if i < 4 else 0.2, "seed": i,
               "stream": i in (1, 6)} for i, m in enumerate(messages)]
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with concurrent.futures.ThreadPoolExecutor(len(bodies)) as ex:
            answers = list(ex.map(lambda b: http_chat(base, b), bodies))
        t_video = time.perf_counter()
        vh = eng.submit(video)
        vh.result(timeout=600)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        latency = [s for _, s in answers] + [time.perf_counter() - t_video]
        metrics = json.loads(urllib.request.urlopen(
            base.replace("/v1", "/metrics"), timeout=60).read())
        for body, (text, _) in zip(bodies, answers):
            if body["stream"] and text != finals[
                    body["messages"][-1]["content"]]:
                raise AssertionError("a stream's deltas differ from its "
                                     "final text")
        for key in ("spec_chunks", "plain_chunks", "prefix_hit_tokens"):
            if not metrics.get(key):
                raise AssertionError(f"/metrics {key} = {metrics.get(key)}")
        if any(eng.slots) or any(eng.slot_owned) or any(eng.slot_shared):
            raise AssertionError("a slot still holds blocks")
        warm = set(eng.prefix.refs)
        if (any(eng.prefix.refs.values()) or warm & set(eng.alloc.free)
                or len(warm | set(eng.alloc.free)) != eng.alloc.capacity):
            raise AssertionError("pool blocks leaked")
    finally:
        server.shutdown()
        server.server_close()
    return {"wall_s": wall, "latency_s": latency, "metrics": metrics,
            "tokens": sum(len(h.tokens) for h in handles),
            "chunk": eng.chunk, "blocks": eng.alloc.capacity}


def serving_phase(engine, clips, dev) -> dict:
    """The serving path on the int4 engine's weights (the model
    serving/__main__.py builds for --model_size 7b --quant int4: fused
    wqkv/gate_up, bf16 cache): continuous traffic (continuous_traffic)
    with a video request whose features come from the port's encoder
    over the seeded 100-frame clip (no libav on this machine, so the
    clip is not an mp4), then one request through the default
    serialized mode, with launch counts over exactly that run; then the
    continuous traffic again under torch.profiler (device activity only)
    for device busy time, idle share = 1 - busy / the first run's wall.
    Returns the launch counts."""
    chat = ChatModel(model=engine.model, cfg=engine.cfg,
                     tokenizer=engine.tokenizer)
    messages = serving_messages(chat)
    feats = engine.encode_video_frames(clips["long"])
    ids, _, _ = chat.build_prompt([{"role": "user", "content":
                                    build_video_question(
                                        QUESTION, engine.cfg.video_token_len,
                                        True)}])
    video = lambda: SlotRequest(  # noqa: E731
        ids, max_new_tokens=MAX_NEW_TOKENS, temperature=0.0,
        eos_token_id=engine.tokenizer.eos_token_id, video_features=feats)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    cuda_lib.reset_launch_counts()
    run = continuous_traffic(chat, messages, video())
    server = serve(chat, host="127.0.0.1", port=0, block=False,
                   model_name="vicuna")  # the default serialized mode
    try:
        _, serial_s = http_chat(
            f"http://127.0.0.1:{server.server_address[1]}/v1",
            {"model": "vicuna", "messages": messages[0],
             "max_tokens": MAX_NEW_TOKENS, "temperature": 0.0})
    finally:
        server.shutdown()
        server.server_close()
    torch.cuda.synchronize()
    launches = dict(cuda_lib.LAUNCHES)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    m = run["metrics"]
    plain_steps = m["plain_chunks"] * run["chunk"]
    lat = sorted(run["latency_s"][:-1])
    print(f"serving: 8 HTTP requests + 1 video request in "
          f"{run['wall_s']:.2f} s, {run['tokens']} tokens generated "
          f"({run['tokens'] / run['wall_s']:.1f} tok/s aggregate); HTTP "
          f"latency p50 {statistics.median(lat):.2f} s, p95 "
          f"{lat[min(len(lat) - 1, round(0.95 * (len(lat) - 1)))]:.2f} s "
          f"(each: {', '.join(f'{s:.2f}' for s in run['latency_s'][:-1])}); "
          f"video {run['latency_s'][-1]:.2f} s; serialized request "
          f"{serial_s:.2f} s; peak {peak:.2f} GiB; metrics {m}; pool "
          f"{run['blocks']} blocks", flush=True)
    print(f"serving launches: {launches}")
    need = len(engine.model.llm.layers) * plain_steps
    if launches.get("decode_attention_paged", 0) < need:
        raise AssertionError(f"kernel 10 launched fewer than 32 x "
                             f"{plain_steps} plain decode steps")
    missing = [k for k in SERVING_PATH if not launches.get(k)]
    if missing:
        raise AssertionError(f"serving: kernels never launched: {missing}")

    gc.collect()
    torch.cuda.empty_cache()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        continuous_traffic(chat, messages, video())
    spans = [(e.name(), e.start_ns(), e.end_ns())
             for e in prof.profiler.kineto_results.events()
             if e.device_type() == DeviceType.CUDA]
    if not spans:
        raise AssertionError("serving profile: no device activity")
    busy_ms, by_name = busy_and_names(spans)
    wall_ms = run["wall_s"] * 1e3
    print(f"serving profile: device busy {busy_ms:.1f} ms over "
          f"{len(spans)} device activities, wall {wall_ms:.1f} ms "
          f"(unprofiled run), idle share {1 - busy_ms / wall_ms:.3f}")
    # the top kernels and every kernel of csrc/ (kernel 10's combine
    # among them)
    for i, (name, (total, calls)) in enumerate(
            sorted(by_name.items(), key=lambda kv: -kv[1][0])):
        if i < 8 or port_kernel(name):
            print(f"serving profile: {total / 1e3:9.2f} ms {calls:6d} "
                  f"calls  {name[:90]}")
    return launches


# new tokens a request of the paged-off phase: 31 decode steps hold
# kernels 9 and 10 to a launch a layer a step, in a run kept near 1,000 s
PAGED_OFF_TOKENS = 32


def paged_off_phase(engine, dev) -> dict:
    """Serving with the paged kernel switched off (enable_paged_kernel(
    False), the JAX package's escape hatch): the continuous engine over
    the paged pool, as the serving phase builds it (4 slots, 2048
    positions, blocks of 64), without speculation so that every step is
    a one-token decode, answers 4 of the serving phase's prompts greedily
    once with the kernel on (kernel 10) and once off (each layer's blocks
    gathered dense, kernel 9), launch counts over each run. Prints how
    many greedy tokens agree (weights are random, so a bf16-level
    difference can turn a near tie); the gate is the kernel check, not
    the tokens. Returns the off run's launch counts."""
    chat = ChatModel(model=engine.model, cfg=engine.cfg,
                     tokenizer=engine.tokenizer, speculative=False)
    prompts = [chat.build_prompt(m)[0] for m in serving_messages(chat, 4)]
    cm = ContinuousChatModel(chat, paged=True)
    runs = {}
    try:
        for on in (True, False):
            attention.enable_paged_kernel(on)
            torch.cuda.synchronize()
            cuda_lib.reset_launch_counts()
            t = time.perf_counter()
            handles = [cm.engine.submit(SlotRequest(
                ids, max_new_tokens=PAGED_OFF_TOKENS, temperature=0.0,
                eos_token_id=engine.tokenizer.eos_token_id))
                for ids in prompts]
            for h in handles:
                h.result(timeout=600)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t
            tokens = [list(h.tokens) for h in handles]
            runs[on] = tokens, dict(cuda_lib.LAUNCHES)
            n = sum(map(len, tokens))
            print(f"paged serving, kernel {'10' if on else '9 (paged kernel off)'}"
                  f": 4 greedy requests, {n} tokens in {wall:.2f} s "
                  f"({n / wall:.1f} tok/s aggregate); launches "
                  f"{runs[on][1]}", flush=True)
    finally:
        attention.enable_paged_kernel(True)
        cm.close()
    (on_tokens, on_counts), (off_tokens, off_counts) = runs[True], runs[False]
    # every decode step after a request's first token launches once a layer
    layers = len(engine.model.llm.layers)
    for counts, tokens, runs_k, not_k in (
            (on_counts, on_tokens, "decode_attention_paged",
             "decode_attention_mxu"),
            (off_counts, off_tokens, "decode_attention_mxu",
             "decode_attention_paged")):
        need = layers * (max(map(len, tokens)) - 1)
        if counts.get(not_k) or counts.get(runs_k, 0) < need:
            raise AssertionError(f"{runs_k} must launch at least {need} "
                                 f"times and {not_k} never: {counts}")
    same = [next((i for i, (a, b) in enumerate(zip(x, y)) if a != b),
                 min(len(x), len(y))) for x, y in zip(on_tokens, off_tokens)]
    print(f"paged kernel off vs on: greedy tokens agree for the first "
          f"{same} of {[len(x) for x in on_tokens]} tokens of each request",
          flush=True)
    return off_counts


def w4a16_chat_phase(engine, clips, requests, dev) -> dict:
    """The int4 chat's engine with the A8 switches off for the phase (as
    VLT_INT4_A8=0 VLT_INT4_A8_BLOCK=0 would set them; restored after):
    `requests`, launch counts over exactly them (every layer linear a
    decode step through the W4A16 matvec, a prefill through the W4A16
    block matmul, kernels A and B never). Not profiled: the pass repeated
    the int4 chat's profile with one kernel swapped."""
    label = "W4A16 int4 chat (A8 switches off)"
    saved = quant4.A8_DECODE, quant4.A8_BLOCK
    quant4.A8_DECODE = quant4.A8_BLOCK = False
    try:
        counts = chat_requests(engine, clips, requests, dev, label)
        per_step = len(engine.model.llm.layers) * 4  # wqkv wo gate_up down
        want = {"w4a16_matvec": per_step * counts["decode_steps"],
                "w4a16_block": per_step * counts["prefills"],
                "w4a8_matvec": 0, "w4a8_block": 0}
        got = {k: counts.get(k, 0) for k in want}
        if got != want:
            raise AssertionError(f"{label}: launches {got}, want {want}")
    finally:
        quant4.A8_DECODE, quant4.A8_BLOCK = saved
    return counts


# -- checkpoints ----------------------------------------------------------

CKPT_VOCAB = 32000  # Vicuna's tokenizer pieces; the model has 32,006 rows
CKPT_SHARD_BYTES = 2 * 2 ** 30


def synthetic_llama_tokenizer(n: int = CKPT_VOCAB, seed: int = 0) -> dict:
    """A LLaMA-layout tokenizer.json of n pieces: <unk> <s> </s>, the 256
    byte pieces, ▁ and the printable ASCII characters, then pieces that
    merge two earlier ones (at most 16 characters), drawn from a seed,
    each merge ranked in the order it was drawn; the legacy normalizer
    and decoder of LLaMA's fast tokenizer."""
    rng = np.random.default_rng(seed)
    chars = ["▁"] + [chr(c) for c in range(33, 127)]
    pieces = ["<unk>", "<s>", "</s>"] + [f"<0x{b:02X}>" for b in range(256)]
    pieces += chars
    have, words, merges = set(pieces), list(chars), []
    while len(pieces) < n:
        for x, y in rng.random((4096, 2)):
            a, b = words[int(x * len(words))], words[int(y * len(words))]
            if a + b in have or len(a + b) > 16:
                continue
            have.add(a + b)
            pieces.append(a + b)
            words.append(a + b)
            merges.append(f"{a} {b}")
            if len(pieces) == n:
                break
    return {
        "version": "1.0",
        "added_tokens": [{"id": i, "content": t, "single_word": False,
                          "lstrip": False, "rstrip": False,
                          "normalized": False, "special": True}
                         for i, t in enumerate(pieces[:3])],
        "normalizer": {"type": "Sequence", "normalizers": [
            {"type": "Prepend", "prepend": "▁"},
            {"type": "Replace", "pattern": {"String": " "},
             "content": "▁"}]},
        "pre_tokenizer": None,
        "decoder": {"type": "Sequence", "decoders": [
            {"type": "Replace", "pattern": {"String": "▁"}, "content": " "},
            {"type": "ByteFallback"}, {"type": "Fuse"},
            {"type": "Strip", "content": " ", "start": 1, "stop": 0}]},
        "model": {"type": "BPE", "unk_token": "<unk>", "fuse_unk": True,
                  "byte_fallback": True,
                  "vocab": {p: i for i, p in enumerate(pieces)},
                  "merges": merges},
    }


def hf_llama_tensors(llm, rows: int = CKPT_VOCAB):
    """The port Llama's weights in Vicuna's (HF LlamaForCausalLM) names
    and layouts, as (name, device tensor) pairs: kernels (out, in), the
    embedding's and lm_head's first `rows` rows."""
    yield "model.embed_tokens.weight", llm.embed_tokens.weight[:rows]
    hf = {v: k for k, v in weights_mod.LLAMA_LINEARS.items()}
    norms = {v.split(".")[0]: k for k, v in weights_mod.LLAMA_NORMS.items()}
    for i, layer in enumerate(llm.layers):
        for ours, name in norms.items():
            yield (f"model.layers.{i}.{name}",
                   getattr(layer, ours).scale)
        for ours, name in hf.items():
            yield (f"model.layers.{i}.{name}",
                   getattr(layer, ours).kernel.t())
    yield "model.norm.weight", llm.final_norm.scale
    yield "lm_head.weight", llm.lm_head.kernel[:, :rows].t()


def hf_clip_state(vision) -> dict:
    """The port CLIP tower's weights in CLIPVisionModel's names on the
    host: linears (out, in), the patchify kernel back to the stride-14
    conv (hidden, 3, 14, 14)."""
    p = vision.cfg.patch_size
    sd = {"vision_model.embeddings.patch_embedding.weight":
          vision.patch_embedding.reshape(p, p, 3, -1).permute(3, 2, 0, 1)}
    ours = dict(vision.named_parameters())
    for hf, name in weights_mod.CLIP_VISION_TOP.items():
        if name != "patch_embedding":
            sd["vision_model." + hf] = ours[name]
    for i in range(len(vision.layers)):
        for hf, name in weights_mod.CLIP_LAYER.items():
            t = ours[f"layers.{i}.{name}"]
            sd[f"vision_model.encoder.layers.{i}.{hf}"] = (
                t.t() if name.endswith(".kernel") else t)
    return {k: v.detach().contiguous().cpu() for k, v in sd.items()}


def export_checkpoint(model, root: str) -> dict:
    """The seed engine's VideoLLaVA as the reference's three checkpoints:
    llm/ (BF16 safetensors shards of about CKPT_SHARD_BYTES with
    model.safetensors.index.json, Vicuna's names, the synthetic
    tokenizer.json, a quant_preflight.json approving int4), clip/
    (pytorch_model.bin, CLIPVisionModel's names) and mm_projector.bin
    (the reference's keys). Returns the paths and the bytes written."""
    llm_dir, clip_dir = os.path.join(root, "llm"), os.path.join(root, "clip")
    os.makedirs(llm_dir)
    os.makedirs(clip_dir)
    shards, cur, size = [], [], 0
    for name, t in hf_llama_tensors(model.llm):
        n = t.numel() * t.element_size()
        if cur and size + n > CKPT_SHARD_BYTES:
            shards.append(cur)
            cur, size = [], 0
        cur.append((name, t))
        size += n
    shards.append(cur)
    weight_map, total = {}, 0
    for i, part in enumerate(shards):
        fname = f"model-{i + 1:05d}-of-{len(shards):05d}.safetensors"
        weights_mod.save_safetensors(os.path.join(llm_dir, fname), part)
        for name, t in part:
            weight_map[name] = fname
            total += t.numel() * t.element_size()
    with open(os.path.join(llm_dir, "model.safetensors.index.json"),
              "w") as f:
        json.dump({"metadata": {"total_size": total},
                   "weight_map": weight_map}, f)
    with open(os.path.join(llm_dir, "tokenizer.json"), "w",
              encoding="utf-8") as f:
        json.dump(synthetic_llama_tokenizer(), f, ensure_ascii=False)
    with open(os.path.join(llm_dir, "tokenizer_config.json"), "w") as f:
        json.dump({"add_bos_token": True, "bos_token": "<s>",
                   "eos_token": "</s>", "unk_token": "<unk>"}, f)
    with open(os.path.join(llm_dir, "quant_preflight.json"), "w") as f:
        json.dump({"preflight_llm_format": "int4"}, f)
    clip = hf_clip_state(model.vision)
    torch.save(clip, os.path.join(clip_dir, "pytorch_model.bin"))
    total += sum(t.numel() * t.element_size() for t in clip.values())
    proj = {"model.mm_projector.weight":
            model.projector.layers[0].kernel.t().contiguous().cpu(),
            "model.mm_projector.bias": model.projector.layers[0].bias.cpu()}
    proj_path = os.path.join(root, "mm_projector.bin")
    torch.save(proj, proj_path)
    return {"llm": llm_dir, "clip": clip_dir, "projector": proj_path,
            "bytes": total, "shards": len(shards)}


def host_rss_gib() -> float:
    """This process's resident set in GiB (/proc/self/statm), or nan."""
    try:
        with open("/proc/self/statm") as f:
            pages = int(f.read().split()[1])
    except (OSError, IndexError, ValueError):
        return float("nan")
    return pages * os.sysconf("SC_PAGE_SIZE") / 2 ** 30


def with_host_peak(fn):
    """(fn(), the process's peak resident set in GiB while fn ran),
    sampled every 10 ms by a thread."""
    peak, done = [host_rss_gib()], threading.Event()

    def sample():
        while not done.wait(0.01):
            peak[0] = max(peak[0], host_rss_gib())

    thread = threading.Thread(target=sample, daemon=True)
    thread.start()
    try:
        out = fn()
    finally:
        done.set()
        thread.join()
    return out, max(peak[0], host_rss_gib())


def compare_reload(seed, loaded, rows: int = CKPT_VOCAB) -> str:
    """Every parameter of `loaded` equal to `seed`'s bit for bit, but the
    embedding's rows and lm_head's columns past `rows`, which must equal
    row_mean of the first `rows` (the loader's mean, computed here the
    same way from the same values) in bf16; their distance to the f64
    mean is printed. Raises on any other difference."""
    own = dict(loaded.named_parameters())
    dists = []
    for name, p in seed.named_parameters():
        q = own[name]
        if name not in ("llm.embed_tokens.weight", "llm.lm_head.kernel"):
            if not (q.dtype == p.dtype and torch.equal(q, p)):
                raise AssertionError(f"checkpoint reload: {name} differs")
            continue
        if name == "llm.lm_head.kernel":  # (d, vocab): rows as columns
            p, q = p.t(), q.t()
        if not torch.equal(q[:rows], p[:rows]):
            raise AssertionError(f"checkpoint reload: {name}'s first "
                                 f"{rows} rows differ")
        w = p[:rows].contiguous()
        want = weights_mod.row_mean(w).to(q.dtype)
        if not torch.equal(q[rows:], want.expand_as(q[rows:])):
            raise AssertionError(f"checkpoint reload: {name}'s added rows "
                                 "are not the mean of the others")
        dists.append((q[rows].double() - w.double().mean(0)).abs().max()
                     .item())
    return (f"every parameter equal bit for bit; rows {rows}+ of the "
            f"embedding and lm_head equal their row_mean (max|diff| from "
            f"the f64 mean {max(dists):.3e})")


def compare_int4(bf16, q) -> None:
    """The int4 fused LLM `q` against quantize_params_int4 (min_size 0,
    group 128) and fuse_layer_kernels applied on the card to the bf16
    reload's weights, layer by layer, and the int8 embedding and
    lm_head against quantize_params_int4 of the bf16 ones: every packed
    leaf and scale equal."""
    from video_llava_tpu_torch.engine.convert import flatten_tree
    from video_llava_tpu_torch.models.llama import (
        fuse_layer_kernels,
        layer_layout,
    )
    from video_llava_tpu_torch.ops.quant4 import quantize_params_int4

    quant = functools.partial(quantize_params_int4, min_size=0,
                              group_size=q.group_size)
    own = dict(q.named_parameters())
    formats = {n: fmt for n, (_, _, fmt, _) in
               layer_layout(q.cfg, "int4", q.group_size).items()}

    def same(prefix, tree):
        for name, t in flatten_tree(tree).items():
            if not torch.equal(own[prefix + name], t):
                raise AssertionError(f"int4 reload: {prefix}{name} differs "
                                     "from quantizing the bf16 reload")

    for i, layer in enumerate(bf16.layers):
        tree = {n: {"kernel": getattr(layer, n).kernel} for n in formats}
        tree = {**{n: v for n, v in tree.items() if not formats[n]},
                **quant({n: v for n, v in tree.items() if formats[n]})}
        same(f"layers.{i}.", fuse_layer_kernels({"layers": tree})["layers"])
        same(f"layers.{i}.", {"input_norm": {"scale": layer.input_norm.scale},
                              "post_norm": {"scale": layer.post_norm.scale}})
    same("", quant({"embed_tokens": {"weight": bf16.embed_tokens.weight},
                    "lm_head": {"kernel": bf16.lm_head.kernel}}))
    same("", {"final_norm": {"scale": bf16.final_norm.scale}})


def checkpoint_phase(engine, clips, requests, dev, card) -> dict:
    """Checkpoint loading at full width and depth: the seed engine (7B
    bf16, seed 0) exported as HF-layout checkpoints (export_checkpoint,
    about 14 GB on the temp directory's disk), then through the entry
    point initialize_model(model_name, projection_path, clip_path):
    (1) in bf16, every parameter equal to the seed engine's
    (compare_reload), with the load's wall time and the host's peak
    resident set; (2) at --quant int4 with the fused layout, every
    packed leaf and scale equal to quantizing the bf16 reload on the
    card (compare_int4), and the device memory the load adds at its
    peak at most that of a random int4 initialize_model in this run plus
    one layer of bf16 weights (no whole bf16 LLM is built); then the
    int4 chat's first request on it, through the checkpoint's
    tokenizer (video ids 32000-32002), with kernels 1, 2, 3, A and B
    launched. The directory is removed at the end. Returns the chat's
    launch counts."""
    t_phase = time.perf_counter()
    label = "checkpoint"
    root = tempfile.mkdtemp(prefix="ckpt_")
    free = shutil.disk_usage(root).free / 2 ** 30
    print(f"{label}: {free:.1f} GiB free under {os.path.dirname(root)}",
          flush=True)
    try:
        t = time.perf_counter()
        paths = export_checkpoint(engine.model, root)
        print(f"{label}: wrote {paths['bytes'] / 2 ** 30:.2f} GiB "
              f"({paths['shards']} safetensors shards, CLIP .bin, "
              f"mm_projector.bin) in {time.perf_counter() - t:.2f} s",
              flush=True)
        weight_tools_check(engine.model, root, paths["projector"], card)

        def load(quant):
            gc.collect()
            torch.cuda.empty_cache()
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            t0, rss0 = time.perf_counter(), host_rss_gib()
            eng, host = with_host_peak(lambda: initialize_model(
                paths["llm"], paths["projector"], paths["clip"],
                model_size="7b", device=dev, llm_quant=quant,
                llm_fuse=bool(quant)))
            torch.cuda.synchronize()
            return eng, (time.perf_counter() - t0,
                         (torch.cuda.max_memory_allocated() - base) / 2 ** 30,
                         f"{host:.2f} GiB ({rss0:.2f} before the load)")

        quant = resolve_quant("auto", paths["llm"])
        if quant != "int4":
            raise AssertionError(f"{label}: --quant auto resolved to {quant}")
        bf16, (secs, added, host) = load(None)
        note = compare_reload(engine.model, bf16.model)
        tok = bf16.tokenizer
        ids = (tok.vid_patch_token_id, tok.vid_start_token_id,
               tok.vid_end_token_id)
        if ids != (32000, 32001, 32002) or tok.vocab_size != 32003:
            raise AssertionError(f"{label}: tokenizer video ids {ids}, "
                                 f"vocab {tok.vocab_size}")
        print(f"{label} bf16 load: {secs:.2f} s, device memory added "
              f"{added:.2f} GiB, host peak RSS {host}; {note}; "
              f"tokenizer: {tok.vocab_size} tokens, video ids {ids} "
              f"[{card}]", flush=True)

        # the random int4 build's peak in this run, the bound's base
        gc.collect()
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        rnd = initialize_model(model_size="7b", device=dev, seed=0,
                               llm_quant="int4", llm_fuse=True)
        torch.cuda.synchronize()
        rnd_peak = (torch.cuda.max_memory_allocated() - base) / 2 ** 30
        del rnd
        layer = bf16.model.llm.layers[0]
        layer_gib = sum(getattr(layer, n).kernel.numel() * 2 for n in
                        weights_mod.LLAMA_LINEARS.values()) / 2 ** 30

        q, (secs, added, host) = load(quant)
        compare_int4(bf16.model.llm, q.model.llm)
        for name in ("vision", "projector"):
            for (n, a), b in zip(getattr(q.model, name).named_parameters(),
                                 getattr(bf16.model, name).parameters()):
                if not torch.equal(a, b):
                    raise AssertionError(f"int4 reload: {name}.{n} differs")
        limit = rnd_peak + layer_gib
        print(f"{label} int4 load (fused): {secs:.2f} s, device memory "
              f"added at its peak {added:.2f} GiB (random int4 "
              f"initialize_model in this run {rnd_peak:.2f} GiB + one bf16 "
              f"layer {layer_gib:.3f} GiB = limit {limit:.2f}), host peak "
              f"RSS {host}; every packed leaf and scale equal to "
              f"quantize_params_int4 + fuse_layer_kernels of the bf16 "
              f"reload on the card [{card}]", flush=True)
        if added > limit:
            raise AssertionError(f"{label}: the int4 load added {added:.2f} "
                                 f"GiB at its peak, over {limit:.2f}")
        del bf16
        gc.collect()
        torch.cuda.empty_cache()
        q.speculative = False
        # the first request only: the second turn repeated the int4
        # chat's, and the first launches every kernel of the path
        counts = chat_requests(q, clips, requests[:1], dev,
                               "checkpoint int4 chat (speculative=False)")
        missing = [k for k in INT4_PATH if not counts.get(k)]
        if missing:
            raise AssertionError(f"{label} int4 chat: kernels never "
                                 f"launched: {missing}")
        del q
        gc.collect()
        torch.cuda.empty_cache()
        quant_preflight(root, paths["llm"], dev, card)
    finally:
        shutil.rmtree(root, ignore_errors=True)
        gc.collect()
        torch.cuda.empty_cache()
    print(f"{label} phase: {time.perf_counter() - t_phase:.2f} s [{card}]",
          flush=True)
    return counts


WT_ROWS = 1000  # the delta's base rows; the target adds Vicuna's 6


def weight_tools_check(model, root: str, projector: str, card: str) -> None:
    """scripts/weight_tools' make-delta and apply-delta (its CLI) on the
    exported mm_projector.bin (keys the base lacks pass through) and on
    .safetensors files of the seed engine's embedding rows, the target
    WT_ROWS + 6 rows over a base of WT_ROWS (the resized branch: the
    corner subtracted in bf16), then consolidate to .safetensors: every
    file written and read through the port's own safetensors code
    (engine/weights) bit-equal to the in-memory results, and the applied
    files bit-equal to their targets."""
    t = time.perf_counter()
    d = os.path.join(root, "weight_tools")
    os.makedirs(d)
    emb = model.llm.embed_tokens.weight.detach()[:WT_ROWS + 6].cpu()
    key = "model.embed_tokens.weight"
    files = {n: os.path.join(d, n) for n in (
        "base.safetensors", "target.safetensors", "delta.safetensors",
        "back.safetensors", "proj_delta.bin", "proj_back.bin",
        "proj.safetensors")}
    base, target = {key: emb[:WT_ROWS].clone()}, {key: emb}
    weights_mod.save_safetensors(files["base.safetensors"], base)
    weights_mod.save_safetensors(files["target.safetensors"], target)
    for name, sd in (("base.safetensors", base),
                     ("target.safetensors", target)):
        got = weights_mod.load_safetensors(files[name])
        if not torch.equal(got[key], sd[key]):
            raise AssertionError(f"weight_tools: {name} read back differs")
    cli = weight_tools.main
    cli(["make-delta", "--base", files["base.safetensors"], "--target",
         files["target.safetensors"], "--delta", files["delta.safetensors"]])
    cli(["apply-delta", "--base", files["base.safetensors"], "--delta",
         files["delta.safetensors"], "--target", files["back.safetensors"]])
    cli(["make-delta", "--base", files["base.safetensors"], "--target",
         projector, "--delta", files["proj_delta.bin"]])
    cli(["apply-delta", "--base", files["base.safetensors"], "--delta",
         files["proj_delta.bin"], "--target", files["proj_back.bin"]])
    cli(["consolidate", "--src", files["proj_back.bin"], "--dst",
         files["proj.safetensors"]])
    delta = weight_tools.make_delta(base, target)
    checks = (("delta.safetensors", delta), ("back.safetensors", target),
              ("proj_delta.bin", weights_mod.load_torch_bin(projector)),
              ("proj_back.bin", weights_mod.load_torch_bin(projector)),
              ("proj.safetensors", weights_mod.load_torch_bin(projector)))
    for name, want in checks:
        got = weight_tools._load(files[name])
        if list(got) != list(want) or not all(
                got[k].dtype == want[k].dtype and torch.equal(got[k], want[k])
                for k in want):
            raise AssertionError(f"weight_tools: {name} differs")
    if delta[key][:WT_ROWS].any() or not torch.equal(delta[key][WT_ROWS:],
                                                     emb[WT_ROWS:]):
        raise AssertionError("weight_tools: the resized corner")
    print(f"weight_tools: make-delta / apply-delta on mm_projector.bin and "
          f"the embedding's {WT_ROWS} + 6 rows ({emb.dtype}, .safetensors "
          f"through engine/weights), consolidate to .safetensors: every "
          f"file read back bit-equal, the applied files equal their "
          f"targets; {time.perf_counter() - t:.2f} s [{card}]", flush=True)
    shutil.rmtree(d)


def gqa_chat_phase(clips, requests, dev) -> dict:
    """Vicuna-7B with 8 KV heads for its 32 query heads (int4, fused, as
    --quant int4 builds it): `requests` through the chat interface, the
    decode attention through kernel 11 (32 launches a decode step, kernel
    3 never); the engine is freed after. Not profiled: the pass repeated
    the int4 chat's profile with kernel 11 for kernel 3."""
    label = "GQA 32/8 int4 chat (speculative=False)"
    t0 = time.perf_counter()
    tok = load_tokenizer(None)
    base = model_config("7b")
    cfg = dataclasses.replace(
        base, llm=dataclasses.replace(base.llm, num_kv_heads=8),
        vid_patch_token_id=tok.vid_patch_token_id,
        vid_start_token_id=tok.vid_start_token_id,
        vid_end_token_id=tok.vid_end_token_id,
    )
    model = VideoLLaVA(cfg, device=dev, dtype=torch.bfloat16,
                       llm_quant="int4", llm_fuse=True)
    gen = torch.Generator(device=dev).manual_seed(0)
    random_init_(model, gen)
    random_init_quantized_llm_(model.llm, gen, dtype=torch.bfloat16)
    engine = InferenceEngine(
        model=model, cfg=cfg, tokenizer=tok,
        gen=GenerationConfig(eos_token_id=tok.eos_token_id,
                             pad_token_id=tok.pad_token_id))
    del model
    engine.speculative = False
    torch.cuda.synchronize()
    print(f"7B int4 engine with num_kv_heads=8: "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    torch.cuda.reset_peak_memory_stats()
    counts = chat_requests(engine, clips, requests, dev, label)
    need = len(engine.model.llm.layers) * counts["decode_steps"]
    if (counts.get("decode_attention_pallas") != need
            or counts.get("decode_attention_stacked")):
        raise AssertionError(f"{label}: kernel 11 must run {need} times and "
                             f"kernel 3 never: {counts}")
    del engine
    gc.collect()
    torch.cuda.empty_cache()
    return counts


# The 13B batched eval phase (BASELINE config 3): 9 ActivityNet-layout
# samples, the last without a video file; one clip of 37 frames, the
# others of 100 (240 x 320, from a seed keyed by the video's name).
EVAL_VIDEOS = ("bike", "cook", "dog", "skate", "swim", "dance", "guitar",
               "paint")
EVAL_SHORT = {"dog": 37}
EVAL_QUESTIONS = ("What is happening in this video?", "Who is in the video?",
                  "What color is the main object?", "Where does it happen?",
                  "Describe the scene.", "What happens at the end?",
                  "How many people are there?", "Is it indoors?",
                  "What is the weather like?")
# b = 8 vs b = 1 prefill logits of one row, as fractions of max |logit|
# (max, mean): the W4A8 slice limits of tests/torch_slice_pair.py. Both
# sides run the same bf16 kernels; the activations quantize per row, so
# only the f32 sum order of B's K splits and the padding differ.
EVAL_LOGIT_LIMITS = (0.05, 0.01)


def eval_frames(name: str, num_frm: int = 100) -> np.ndarray:
    """The stand-in for the runner's load_video: (n, 240, 320, 3) uint8
    frames from a seed keyed by `name` (no mp4 decodes on the card's
    machine, which has no libav)."""
    seed = int(hashlib.sha256(name.encode()).hexdigest()[:8], 16)
    n = min(EVAL_SHORT.get(name, 100), num_frm)
    return np.random.default_rng(seed).integers(
        0, 256, size=(n, 240, 320, 3), dtype=np.uint8)


def write_eval_data(root: str) -> dict:
    """ActivityNet-QA's layout under `root`: question and answer JSON
    files, and an empty v_<name>.mp4 a video (find_video's test; the
    frames come from eval_frames). The ninth sample's video is absent."""
    vdir = os.path.join(root, "videos")
    os.makedirs(vdir)
    for name in EVAL_VIDEOS:
        open(os.path.join(vdir, f"v_{name}.mp4"), "w").close()
    names = EVAL_VIDEOS + ("missing",)
    questions = [{"question_id": f"q{i}", "video_name": n, "question": q}
                 for i, (n, q) in enumerate(zip(names, EVAL_QUESTIONS))]
    answers = [{"answer": f"answer {i}"} for i in range(len(names))]
    paths = {"video_dir": vdir,
             "gt_file_question": os.path.join(root, "q.json"),
             "gt_file_answers": os.path.join(root, "a.json")}
    with open(paths["gt_file_question"], "w") as f:
        json.dump(questions, f)
    with open(paths["gt_file_answers"], "w") as f:
        json.dump(answers, f)
    return paths


def eval_13b_phase(dev, results) -> dict:
    """BASELINE config 3, batched Vicuna-13B zero-shot QA over
    ActivityNet-QA, through the entry point: `python -m
    video_llava_tpu_torch.eval.run_inference --dataset activitynet
    --runner batched --batch_size 8 --quant int4` (eval.run_inference.main:
    full width and depth, int4 W4A8 fused, 100 frames, 128 new tokens) on
    9 samples written to a temporary directory, then run_qa_continuous on
    the same engine with 8 slots. Two stand-ins, set up here and not
    paths of the program: the runner module's load_video is eval_frames
    (no libav on the card's machine), and initialize_model is wrapped to
    keep the engine it builds, turn its speculation off for the batched
    run (so that decode runs kernel A at 8 rows and kernel 3 at b = 8, as
    the chat phases decode) and time its stages. The continuous run
    speculates (the engine's default): its verify windows run B at 8 x 9
    rows. Asserts 8 predictions with the missing video skipped; kernels
    1, 2, 3, A and B launched in the batched run, A at least 4 x 40 times
    a decode step and B 4 x 40 times a prefill; and the batched prefill's
    last logits of the 37-frame clip's row within EVAL_LOGIT_LIMITS of
    the same sample encoded and prefilled alone at b = 1. Prints stage
    walls, tok/s, the share of rows where both runners answer alike and
    peak memory. Last, the batched runner with engine.gen made greedy
    must answer row for row as run_qa_continuous without speculation
    (the sampled batched run parts from the greedy continuous one by
    sampling alone). Returns the launches of the first two runs,
    summed."""
    from video_llava_tpu_torch.engine import continuous as cont_mod
    from video_llava_tpu_torch.eval import run_inference as ri

    t_phase = time.perf_counter()
    label = "13B int4 batched eval"
    print(f"{label}: frames for the runner's load_video come from a seed "
          "keyed by the video's name (eval_frames), not through an mp4 (no "
          "libav on this machine)", flush=True)
    stats = {"encode_s": 0.0, "prefill_s": 0.0, "prefills": 0,
             "decode_steps": 0, "init_s": 0.0, "generate_s": 0.0,
             "tokens": 0}
    kept: dict = {}
    delivered: list = []

    def timed_call(fn, key):
        def call(*a, **kw):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = fn(*a, **kw)
            torch.cuda.synchronize()
            stats[key] += time.perf_counter() - t
            return out
        return call

    real_init, real_load = ri.initialize_model, ri.load_video
    real_result = cont_mod.RequestHandle.result

    def result(handle, timeout=None):  # a continuous request's tokens
        toks = real_result(handle, timeout)
        delivered.append(len(toks))
        kept.setdefault("cont_tokens", []).append((handle, list(toks)))
        return toks

    def init(*a, **kw):
        t = time.perf_counter()
        engine = real_init(*a, **kw)
        torch.cuda.synchronize()
        stats["init_s"] = time.perf_counter() - t
        engine.speculative = False
        model, llm = engine.model, engine.model.llm
        timed_encode = timed_call(engine.batched_encode, "encode_s")

        def encode(*a2, **kw2):  # the first: and the peak it adds
            if "encode_peak" in stats:
                return timed_encode(*a2, **kw2)
            base = torch.cuda.memory_allocated()
            stats["peak_before"] = max(stats.get("peak_before", 0),
                                       torch.cuda.max_memory_allocated())
            torch.cuda.reset_peak_memory_stats()
            out = timed_encode(*a2, **kw2)
            stats["encode_peak"] = (torch.cuda.max_memory_allocated()
                                    - base) / 2 ** 30
            return out

        engine.batched_encode = encode
        timed_generate = timed_call(engine.generate_tokens, "generate_s")

        def generate(*a2, **kw2):  # the batched runner's generate call
            out = timed_generate(*a2, **kw2)
            stats["tokens"] += int(out.lengths.sum())
            return out

        engine.generate_tokens = generate
        prefill_fn, decode_fn = model.prefill, llm.decode_step
        timed_prefill = timed_call(prefill_fn, "prefill_s")

        def prefill(input_ids, seq_lens, feats, *rest, **kw2):
            out = timed_prefill(input_ids, seq_lens, feats, *rest, **kw2)
            stats["prefills"] += 1
            if input_ids.shape[0] == len(EVAL_VIDEOS) and "batch" not in kept:
                kept["batch"] = (input_ids.clone(), seq_lens.clone(),
                                 feats.clone(), out.logits_last.clone(),
                                 rest, kw2)
            return out

        def decode_step(*a2, **kw2):
            stats["decode_steps"] += 1
            return decode_fn(*a2, **kw2)

        model.prefill, llm.decode_step = prefill, decode_step
        kept["engine"] = engine
        return engine

    tmp = tempfile.mkdtemp(prefix="eval13b_")
    ri.initialize_model = init
    cont_mod.RequestHandle.result = result
    ri.load_video = lambda path, num_frm=100, shape=None: eval_frames(
        os.path.basename(path)[2:].rsplit(".", 1)[0], num_frm)
    try:
        paths = write_eval_data(tmp)
        argv = ["--dataset", "activitynet", "--runner", "batched",
                "--batch_size", "8", "--quant", "int4", "--model_size",
                "13b", "--output_dir", os.path.join(tmp, "out"),
                "--output_name", "batched"]
        for key, path in paths.items():
            argv += [f"--{key}", path]
        torch.cuda.reset_peak_memory_stats()
        cuda_lib.reset_launch_counts()
        t = time.perf_counter()
        batched = ri.main(argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t - stats["init_s"]
        counts = dict(cuda_lib.LAUNCHES)
        peak = max(stats["peak_before"],
                   torch.cuda.max_memory_allocated()) / 2 ** 30
        engine = kept["engine"]
        with open(os.path.join(tmp, "out", "batched.json")) as f:
            written = json.load(f)
        ids = [r["id"] for r in batched]
        if written != batched or ids != [f"q{i}" for i in range(8)]:
            raise AssertionError(f"{label}: predictions {ids}, expected "
                                 "q0-q7 (q8's video is missing)")
        decode_s = stats["generate_s"] - stats["prefill_s"]
        steps = stats["decode_steps"]
        print(f"{label}: initialize_model(13b, int4) {stats['init_s']:.2f} "
              f"s; 8 videos x 100 frames (one of 37): encode "
              f"{stats['encode_s'] * 1e3:.1f} ms (CLIP over the 800 frames "
              f"at once: {stats['encode_peak']:.2f} GiB above the weights "
              f"at its peak), prefill (8 x "
              f"{kept['batch'][0].shape[1]}) {stats['prefill_s'] * 1e3:.1f} "
              f"ms, decode {steps} steps in {decode_s * 1e3:.1f} ms, "
              f"{stats['tokens']} tokens generated over the batch "
              f"({stats['tokens'] / decode_s:.2f} tok/s); runner wall "
              f"{wall:.2f} s (model build excluded); peak {peak:.2f} GiB",
              flush=True)
        print(f"{label} launches: {counts} ({stats['prefills']} prefills, "
              f"{steps} decode steps)", flush=True)
        missing = [k for k in INT4_PATH if not counts.get(k)]
        if missing:
            raise AssertionError(f"{label}: kernels never launched: "
                                 f"{missing}")
        per_step = len(engine.model.llm.layers) * 4
        if counts["w4a8_matvec"] < per_step * steps:
            raise AssertionError("kernel A launched fewer than 4 x 40 times "
                                 "a decode step")
        if counts["w4a8_block"] < per_step * stats["prefills"]:
            raise AssertionError("kernel B launched fewer than 4 x 40 times "
                                 "a prefill")
        if counts["spatio_temporal_pool"] != 1:
            raise AssertionError("kernel 2 pooled the batch in "
                                 f"{counts['spatio_temporal_pool']} launches")

        # the 37-frame clip's row against the same sample alone at b = 1
        input_ids, seq_lens, feats, logits, rest, kw = kept["batch"]
        row = EVAL_VIDEOS.index("dog")
        n = int(seq_lens[row])
        with torch.inference_mode():
            alone = engine.encode_video_frames(eval_frames("dog"), 37)
            pad = -(-n // engine.seq_pad_multiple) * engine.seq_pad_multiple
            one = engine.model.prefill(input_ids[row:row + 1, :pad],
                                       seq_lens[row:row + 1], alone[None],
                                       *rest, **kw).logits_last[0].float()
        feat_err = (alone.float() - feats[row].float()).abs().max().item()
        want = logits[row].float()
        err = (one - want).abs()
        scale = want.abs().max().item()
        print(f"{label}: row {row} (37 valid frames, {n} prompt tokens) "
              f"prefilled at b = 1 ({pad} positions) against b = 8 ("
              f"{input_ids.shape[1]}): logits max|err| {err.max().item():.3e}"
              f", mean {err.mean().item():.3e} of max|logit| {scale:.3e} "
              f"(limits {EVAL_LOGIT_LIMITS[0]} and {EVAL_LOGIT_LIMITS[1]} of "
              f"it); its pooled features alone vs in the batch max|err| "
              f"{feat_err:.3e}; argmax {int(one.argmax())} / "
              f"{int(want.argmax())}", flush=True)
        if not (torch.isfinite(one).all() and torch.isfinite(want).all()
                and err.max().item() <= EVAL_LOGIT_LIMITS[0] * scale
                and err.mean().item() <= EVAL_LOGIT_LIMITS[1] * scale):
            raise AssertionError(f"{label}: b = 8 and b = 1 prefill logits "
                                 "disagree")
        del kept["batch"], input_ids, feats, logits, alone

        # the continuous runner on the same engine, speculating
        engine.speculative = True
        samples = ri.load_dataset(types.SimpleNamespace(
            dataset="activitynet", **paths))
        cuda_lib.reset_launch_counts()
        torch.cuda.synchronize()
        t = time.perf_counter()
        cont = ri.run_qa_continuous(engine, samples, paths["video_dir"],
                                    "pg-video-llava", batch_size=8,
                                    num_slots=8, video_prefix="v_")
        torch.cuda.synchronize()
        cont_s = time.perf_counter() - t
        cont_counts = dict(cuda_lib.LAUNCHES)
        if [r["id"] for r in cont] != ids:
            raise AssertionError(f"{label}: continuous ids "
                                 f"{[r['id'] for r in cont]}")
        new_tokens = sum(delivered)
        same = sum(a["pred"] == b["pred"] for a, b in zip(batched, cont))
        print(f"{label}: run_qa_continuous (8 slots, speculative) "
              f"{cont_s:.2f} s (encode included), {new_tokens} tokens "
              f"generated ({new_tokens / cont_s:.2f} tok/s); rows answering "
              f"as the batched runner (which samples by engine.gen, without "
              f"speculation): {same} of {len(cont)}; launches "
              f"{cont_counts}; peak "
              f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB",
              flush=True)
        for k in ("flash_attention_bhsd", "spatio_temporal_pool",
                  "w4a8_block"):
            if not cont_counts.get(k):
                raise AssertionError(f"{label}: the continuous run never "
                                     f"launched {k}")
        for name in set(counts) | set(cont_counts):
            if name in results:
                results[name]["eval_13b_launches"] = (
                    counts.get(name, 0) + cont_counts.get(name, 0))
        # the batched runner samples by engine.gen (temperature 0.2, as
        # the reference), the continuous runner's requests are greedy:
        # made greedy, the batched runner answers row for row as the
        # continuous runner without speculation (PERF.md section 7)
        sampled, engine.speculative = engine.gen, False
        engine.gen = dataclasses.replace(sampled, do_sample=False,
                                         temperature=0.0)
        try:
            greedy = ri.run_qa_batched(engine, samples, paths["video_dir"],
                                       "pg-video-llava", batch_size=8,
                                       video_prefix="v_")
        finally:
            engine.gen = sampled
        plain = ri.run_qa_continuous(engine, samples, paths["video_dir"],
                                     "pg-video-llava", batch_size=8,
                                     num_slots=8, video_prefix="v_")
        parted = [g["id"] for g, c in zip(greedy, plain)
                  if g["pred"] != c["pred"]]
        print(f"{label}: the batched runner made greedy against "
              f"run_qa_continuous without speculation: {len(parted)} of "
              f"{len(plain)} rows answer otherwise {parted}", flush=True)
        if parted or len(greedy) != len(plain):
            raise AssertionError(f"{label}: greedy runners part on rows "
                                 f"{parted}")
    finally:
        ri.initialize_model, ri.load_video = real_init, real_load
        cont_mod.RequestHandle.result = real_result
        shutil.rmtree(tmp, ignore_errors=True)
        kept.clear()
        gc.collect()
        torch.cuda.empty_cache()
    print(f"{label} phase: {time.perf_counter() - t_phase:.2f} s",
          flush=True)
    return counts

# Kernels 7 and 8 at (b, sq, skv, h, h_kv, d, causal): Vicuna-7B's
# training layer (4 rows of 1,024 tokens, causal) first, then GQA, a
# ragged right-aligned pair (no length a multiple of a tile), no mask, and
# a ragged GQA pair at training width whose causal diagonal crosses the
# Hopper body's 128-row blocks and 64-row tiles.
FLASH_SHAPES = ((4, 1024, 1024, 32, 32, 128, True),
                (4, 1024, 1024, 32, 8, 128, True),
                (2, 1000, 1037, 16, 16, 128, True),
                (2, 512, 640, 32, 32, 128, False),
                (1, 1000, 1100, 32, 8, 128, True))
# Forward: absolute (TOL) as kernel 1 (P rounded to bf16 for the second
# product), and per (row, head) max|err| / max|ref| as kernel 10; lse in
# f32 from the same f32 scores summed in another order. Gradients: each
# within FLASH_GRAD_TOL of its tensor's max |ref|: bf16 inputs, P and dS
# rounded to bf16 for their products, sums in another order than the
# plain f32 version.
FLASH_ROW_TOL, FLASH_LSE_TOL, FLASH_GRAD_TOL = 2 ** -6, 1e-3, 2e-2


def visible_pairs(sq: int, skv: int, causal: bool) -> int:
    """The (query, key) pairs the mask lets through: the work a product
    over them needs (right-aligned causal: query i sees keys <= i + skv -
    sq)."""
    if not causal:
        return sq * skv
    return int(np.minimum(np.arange(sq) + skv - sq + 1, skv).sum())


def grad_rel_errs(got, want):
    """max|got - want| / max|want| of each of (dq, dk, dv)."""
    return [((a.float() - b.float()).abs().max()
             / b.float().abs().max()).item() for a, b in zip(got, want)]


def flash_checks(dev, results) -> None:
    """Kernels 7 and 8 against their plain versions on the same bf16
    inputs at FLASH_SHAPES (the backward fed the kernel forward's out and
    lse, D from flash_delta), then timed: the kernels, the plain forward
    and backward (one function gives dq, dk and dv: its time stands in
    both kernel 8 rows), and the library: SDPA (is_causal, or the
    right-aligned mask where sq != skv; enable_gqa for GQA) and its
    backward, torch.autograd.grad of its output (timed without a graph).
    Bounds count the visible pairs only: the forward's two products, dq's
    three (S, dP, dS K), dk/dv's four (S, dP, P^T dO, dS^T Q); beside
    each kernel's ms, the rate those operations reach and the share of
    the bound. On the training shape, two planted faults must fail: in
    the plain forward, the diagonal key tile of query tile 1 (the
    kernel's 128-row tiles) dropped from the mask, against the row check
    (the kernel masks only diagonal and ragged tiles); in the plain
    backward, query tile 1's diagonal 64-key tile dropped, against the
    gradient check."""
    g = torch.Generator(device=dev).manual_seed(3)
    rnd = lambda *s: torch.randn(*s, generator=g, device=dev).to(  # noqa
        torch.bfloat16)
    for shape in FLASH_SHAPES:
        b, sq, skv, h, hkv, d, causal = shape
        q, do = rnd(b, sq, h, d), rnd(b, sq, h, d)
        k, v = rnd(b, skv, hkv, d), rnd(b, skv, hkv, d)
        scale = d ** -0.5
        out, lse = attention.flash_forward(q, k, v, causal)
        want, want_lse = attention.flash_forward_plain(q, k, v, causal)
        err = (out.float() - want.float()).abs()
        fwd_err = err.max().item()
        row = (err.amax(-1) / want.float().abs().amax(-1)).max().item()
        lse_err = (lse - want_lse).abs().max().item()
        note = (f"max|err| {fwd_err:.3e} (tol {TOL['flash_forward']}), "
                f"(row, head) max|err|/max|ref| {row:.3e} (tol 2^-6), lse "
                f"max|err| {lse_err:.3e} (tol {FLASH_LSE_TOL})")
        if not (fwd_err <= TOL["flash_forward"] and row <= FLASH_ROW_TOL
                and lse_err <= FLASH_LSE_TOL):
            raise AssertionError(f"flash_forward {shape}: {note}")
        if shape == FLASH_SHAPES[0]:
            mask = attention.flash_mask(sq, skv, causal, dev).clone()
            mask[128:256, 128:256] = False
            faulty, _ = attention.flash_forward_masked(q, k, v, mask, scale)
            bad = (faulty.float() - want.float()).abs().amax(-1)
            caught = (bad / want.float().abs().amax(-1)).max().item()
            print("planted fault, query tile 1's diagonal key tile dropped "
                  f"from the plain forward: (row, head) max|err|/max|ref| "
                  f"{caught:.3e}", flush=True)
            if not caught > FLASH_ROW_TOL:
                raise AssertionError("the forward's row check passes a "
                                     "dropped diagonal tile")
            del faulty, bad, mask
        delta = attention.flash_delta(out, do)
        dq_fn = lambda: attention.flash_backward_dq(  # noqa: E731
            q, k, v, do, lse, delta, causal, scale)
        dkv_fn = lambda: attention.flash_backward_dkv(  # noqa: E731
            q, k, v, do, lse, delta, causal, scale)
        plain_bwd = lambda: attention.flash_backward_plain(  # noqa: E731
            q, k, v, out, lse, do, causal, scale)
        got, ref = (dq_fn(), *dkv_fn()), plain_bwd()
        rels = grad_rel_errs(got, ref)
        grad_note = ", ".join(f"{n} {e:.3e}" for n, e in
                              zip(("dq", "dk", "dv"), rels))
        if not all(np.isfinite(e) and e <= FLASH_GRAD_TOL for e in rels):
            raise AssertionError(f"flash backward {shape}: max|err|/max|ref| "
                                 f"{grad_note} (tol {FLASH_GRAD_TOL})")
        if shape == FLASH_SHAPES[0]:
            mask = attention.flash_mask(sq, skv, causal, dev).clone()
            mask[64:128, 64:128] = False
            faulty = attention.flash_backward_masked(q, k, v, out, lse, do,
                                                     mask, scale)
            caught = grad_rel_errs(faulty, ref)
            print("planted fault, query tile 1's diagonal key tile dropped "
                  "from the plain backward: max|err|/max|ref| "
                  + ", ".join(f"{n} {e:.3e}" for n, e in
                              zip(("dq", "dk", "dv"), caught)), flush=True)
            if not max(caught) > FLASH_GRAD_TOL:
                raise AssertionError("the gradient check passes a dropped "
                                     "diagonal tile")
            del faulty, mask

        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        mask_kw = ({"attn_mask": attention.flash_mask(sq, skv, True, dev)}
                   if causal and sq != skv else {"is_causal": causal})
        sdpa = lambda *a: F.scaled_dot_product_attention(  # noqa: E731
            *a, enable_gqa=hkv < h, **mask_kw)
        leaves = [t.detach().requires_grad_() for t in (qt, kt, vt)]
        lib_out = sdpa(*leaves)
        lib_bwd = lambda: torch.autograd.grad(  # noqa: E731
            lib_out, leaves, do.transpose(1, 2), retain_graph=True)
        fwd_ms = median_ms(lambda: attention.flash_forward(q, k, v, causal))
        dq_ms, dkv_ms = median_ms(dq_fn), median_ms(dkv_fn)
        plain_fwd_ms = median_ms(
            lambda: attention.flash_forward_plain(q, k, v, causal))
        plain_bwd_ms = median_ms(plain_bwd)
        lib_fwd_ms = median_ms(lambda: sdpa(qt, kt, vt))
        lib_bwd_ms = median_ms(lib_bwd, capture=False)
        del leaves, lib_out

        prod = 2 * b * h * visible_pairs(sq, skv, causal) * d
        qb, kb, sb = 2 * q.numel(), 2 * k.numel(), 4 * lse.numel()
        rows = (("flash_forward", fwd_err, fwd_ms, plain_fwd_ms, lib_fwd_ms,
                 2 * qb + 2 * kb + sb, 2 * prod),
                ("flash_backward_dq", (got[0].float() - ref[0].float())
                 .abs().max().item(), dq_ms, plain_bwd_ms, lib_bwd_ms,
                 3 * qb + 2 * kb + 2 * sb, 3 * prod),
                ("flash_backward_dkv", max(
                    (a.float() - r.float()).abs().max().item()
                    for a, r in zip(got[1:], ref[1:])), dkv_ms, plain_bwd_ms,
                 lib_bwd_ms, 2 * qb + 4 * kb + 2 * sb, 4 * prod))
        for name, e, ms, plain_ms, lib_ms, nbytes, ops in rows:
            bound_ms, bound_by = record(results, name, e, ms, plain_ms,
                                        lib_ms, nbytes, ops)
            print(f"check {name} {shape}: kernel {ms:.4f} ms "
                  f"({ops / ms * 1e-9:.1f} TFLOP/s, {bound_ms / ms:.3f} of "
                  f"the bound), plain {plain_ms:.4f} ms, library "
                  f"{lib_ms:.4f} ms, bound {bound_ms:.4f} ms by {bound_by}",
                  flush=True)
        print(f"check flash {shape}: forward {note}; backward "
              f"max|err|/max|ref| {grad_note} (tol {FLASH_GRAD_TOL})",
              flush=True)
        del q, k, v, do, out, lse, want, want_lse, err, delta, got, ref
        torch.cuda.empty_cache()


# (d, dtype) of each body of kernel 7 at b*h = 65,600 (b 16,400, h 4,
# s 16, causal): the Hopper body (bf16, d 64), the WMMA body (bf16, d
# 32), the f32 body; then head dim 24 (zero-padded to 32) at (b, sq, skv,
# h, h_kv) = FLASH_PAD_SHAPE, causal.
FLASH_WIDE_BODIES = ((64, torch.bfloat16), (32, torch.bfloat16),
                     (64, torch.float32))
FLASH_PAD_SHAPE = (2, 300, 340, 8, 4)


def flash_limit_checks(dev) -> None:
    """The raises kernel 7's wrapper lifted, on the card: b*h past the
    grid's y limit (now along x) through each body, forward against the
    plain forward and, in bf16, kernel 8 against the plain backward; head
    dims 24 (d % 16 == 8, zero-padded to 32 with the unpadded d's
    scale), 256 (the WMMA and f32 bodies in slabs of 128 output columns),
    200 (zero-padded to 256), and past 256 264 and 384 (padded to 384)
    and 512 (the SIMT body), each through the forward and backward in
    bf16 and f32. Limits: flash_checks' in bf16 (absolute and lse;
    gradients of max |ref|), F32_FLASH_TOL and F32_GRAD_TOL in f32. Not
    timed here (no path runs these shapes; flash_wide_times times d 256,
    384 and 512)."""
    g = torch.Generator(device=dev).manual_seed(7)
    cases = [((16400, 16, 16, 4, 4, d), dtype)
             for d, dtype in FLASH_WIDE_BODIES]
    cases += [(FLASH_PAD_SHAPE + (d,), dtype)
              for d in (24, 256, 200, 264, 384, 512)
              for dtype in (torch.bfloat16, torch.float32)]
    for (b, sq, skv, h, h_kv, d), dtype in cases:
        shape = (b, sq, skv, h, h_kv, d, True)
        q, do = (torch.randn(b, sq, h, d, generator=g, device=dev).to(dtype)
                 for _ in range(2))
        k, v = (torch.randn(b, skv, h_kv, d, generator=g, device=dev).to(
            dtype) for _ in range(2))
        before = dict(cuda_lib.LAUNCHES)
        out, lse = attention.flash_forward(q, k, v, True)
        want, want_lse = attention.flash_forward_plain(q, k, v, True)
        fwd_err = (out.float() - want.float()).abs().max().item()
        lse_err = (lse - want_lse).abs().max().item()
        f32 = dtype == torch.float32
        tol, lse_tol = ((F32_FLASH_TOL, F32_FLASH_TOL) if f32 else
                        (TOL["flash_forward"], FLASH_LSE_TOL))
        note = (f"max|err| {fwd_err:.3e} (tol {tol}), lse max|err| "
                f"{lse_err:.3e} (tol {lse_tol})")
        ok = (out.shape == want.shape and fwd_err <= tol
              and lse_err <= lse_tol)
        if b < 1000:  # the backward, but at b*h = 65,600
            gtol = F32_GRAD_TOL if f32 else FLASH_GRAD_TOL
            got = attention.flash_backward(q, k, v, out, lse, do, True)
            ref = attention.flash_backward_plain(q, k, v, out, lse, do, True)
            rels = grad_rel_errs(got, ref)
            note += "; backward max|err|/max|ref| " + ", ".join(
                f"{n} {e:.3e}" for n, e in zip(("dq", "dk", "dv"), rels))
            note += f" (tol {gtol})"
            ok = ok and all(np.isfinite(e) and e <= gtol for e in rels)
            del got, ref
        elif not f32:
            got = attention.flash_backward(q, k, v, out, lse, do, True)
            ref = attention.flash_backward_plain(q, k, v, out, lse, do, True)
            rels = grad_rel_errs(got, ref)
            note += "; backward max|err|/max|ref| " + ", ".join(
                f"{n} {e:.3e}" for n, e in zip(("dq", "dk", "dv"), rels))
            note += f" (tol {FLASH_GRAD_TOL})"
            ok = ok and all(np.isfinite(e) and e <= FLASH_GRAD_TOL
                            for e in rels)
            del got, ref
        torch.cuda.synchronize()
        ran = {n: cuda_lib.LAUNCHES[n] - before.get(n, 0)
               for n in cuda_lib.LAUNCHES if cuda_lib.LAUNCHES[n] !=
               before.get(n, 0)}
        print(f"check flash limits {shape} {dtype}: {note}; launches {ran}",
              flush=True)
        if not ok:
            raise AssertionError(f"flash limits {shape} {dtype}: {note}")
        del q, k, v, do, out, lse, want, want_lse
    torch.cuda.empty_cache()


# (b, sq, skv, h, h_kv) of the timed wide head dims: causal GQA, 1,024
# rows
FLASH_D256_SHAPE = (2, 1024, 1024, 8, 4)


def flash_wide_times(dev) -> None:
    """Kernels 7 and 8 at head dims 256, 384 and 512 (no ported model has
    them; the JAX package's Pallas forward takes them): the bf16
    forward, dq and dk/dv and the f32 forward at FLASH_D256_SHAPE,
    causal (past 256, the f32 dq and dk/dv too), each against its plain
    version at flash_checks' limits (F32_FLASH_TOL, F32_GRAD_TOL in
    f32), then timed beside the plain version, the library call (SDPA
    and its backward, enable_gqa) and the bound of the visible pairs'
    products: bf16 at the bf16 peak, f32 (whichever body runs) three
    times over at the TF32 peak, the least time for f32-accurate products
    on the tensor cores (3xTF32), with the f32-FMA bound printed beside
    it. Printed only: the kernels line keeps the training layer's
    shape."""
    for d in (256, 384, 512):
        for dtype in (torch.bfloat16, torch.float32):
            flash_wide_time(dev, d, dtype)


def flash_wide_time(dev, d: int, dtype) -> None:
    """flash_wide_times at one head dim and dtype."""
    g = torch.Generator(device=dev).manual_seed(8)
    b, sq, skv, h, h_kv = FLASH_D256_SHAPE
    prod = 2 * b * h * visible_pairs(sq, skv, True) * d
    f32 = dtype == torch.float32
    q, do = (torch.randn(b, sq, h, d, generator=g, device=dev).to(dtype)
             for _ in range(2))
    k, v = (torch.randn(b, skv, h_kv, d, generator=g, device=dev).to(
        dtype) for _ in range(2))
    out, lse = attention.flash_forward(q, k, v, True)
    want, want_lse = attention.flash_forward_plain(q, k, v, True)
    fwd_err = (out.float() - want.float()).abs().max().item()
    lse_err = (lse - want_lse).abs().max().item()
    tol = F32_FLASH_TOL if f32 else TOL["flash_forward"]
    lse_tol = F32_FLASH_TOL if f32 else FLASH_LSE_TOL
    if not (fwd_err <= tol and lse_err <= lse_tol):
        raise AssertionError(f"flash d {d} {dtype}: max|err| {fwd_err}, "
                             f"lse {lse_err}")
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    sdpa = lambda *a: F.scaled_dot_product_attention(  # noqa: E731
        *a, enable_gqa=True, is_causal=True)
    qb, kb, sb = q.element_size() * q.numel(), k.element_size() * \
        k.numel(), 4 * lse.numel()
    simt = d > 256
    rows = [("flash_forward_f32" if f32 else "flash_forward", fwd_err,
             lambda: attention.flash_forward(q, k, v, True),
             lambda: attention.flash_forward_plain(q, k, v, True),
             lambda: sdpa(qt, kt, vt), True, 2 * qb + 2 * kb + sb,
             2 * prod)]
    if not f32 or simt:
        sfx = "_f32" if f32 else ""
        gtol = F32_GRAD_TOL if f32 else FLASH_GRAD_TOL
        delta = attention.flash_delta(out, do)
        got = attention.flash_backward(q, k, v, out, lse, do, True)
        ref = attention.flash_backward_plain(q, k, v, out, lse, do, True)
        rels = grad_rel_errs(got, ref)
        if not all(np.isfinite(e) and e <= gtol for e in rels):
            raise AssertionError(f"flash d {d} {dtype} backward: {rels}")
        leaves = [t.detach().requires_grad_() for t in (qt, kt, vt)]
        lib_out = sdpa(*leaves)
        lib_bwd = lambda: torch.autograd.grad(  # noqa: E731
            lib_out, leaves, do.transpose(1, 2), retain_graph=True)
        plain_bwd = lambda: attention.flash_backward_plain(  # noqa
            q, k, v, out, lse, do, True)
        scale = d ** -0.5
        rows += [
            ("flash_backward_dq" + sfx, rels[0],
             lambda: attention.flash_backward_dq(
                 q, k, v, do, lse, delta, True, scale), plain_bwd,
             lib_bwd, False, 3 * qb + 2 * kb + 2 * sb, 3 * prod),
            ("flash_backward_dkv" + sfx, max(rels[1:]),
             lambda: attention.flash_backward_dkv(
                 q, k, v, do, lse, delta, True, scale), plain_bwd,
             lib_bwd, False, 2 * qb + 4 * kb + 2 * sb, 4 * prod)]
    for name, err, fn, plain, lib, capture, nbytes, ops in rows:
        ms, plain_ms = median_ms(fn), median_ms(plain)
        lib_ms = median_ms(lib, capture=capture)
        bound_ms, bound_by = (bound(nbytes, 3 * ops, TF32_PEAK) if f32
                              else bound(nbytes, ops, BF16_PEAK))
        fma = (f" (as f32 FMAs {bound(nbytes, ops, F32_PEAK)[0]:.4f} ms)"
               if f32 else "")
        print(f"check {name} {FLASH_D256_SHAPE + (d, True)} {dtype}: "
              f"err {err:.3e}, kernel {ms:.4f} ms ({bound_ms / ms:.3f} of "
              f"the bound), plain {plain_ms:.4f} ms, library "
              f"{lib_ms:.4f} ms, bound {bound_ms:.4f} ms by {bound_by}"
              f"{fma}", flush=True)
    del q, k, v, do, out, lse, want, want_lse, rows
    torch.cuda.empty_cache()


# Kernel 8's f32 body (the SIMT body) at (b, sq, skv, h, h_kv, d,
# causal): Whisper base's encoder over one 30 s chunk (the first, the
# kernels line's shape), a ragged causal GQA pair, d 256
FLASH_F32_BWD_SHAPES = ((1, 1500, 1500, 8, 8, 64, False),
                        (2, 100, 130, 8, 2, 128, True),
                        (2, 300, 340, 8, 4, 256, True))


def flash_f32_bwd_checks(dev, results) -> None:
    """Kernel 8's f32 body against the plain backward on the same f32
    inputs at FLASH_F32_BWD_SHAPES (fed the f32 forward's out and lse):
    dq, dk, dv each within F32_GRAD_TOL of its max |ref|; then timed as
    flash_checks times the bf16 body: the dq and dk/dv kernels, the
    plain backward, SDPA's f32 backward (torch.autograd.grad, no graph),
    beside the bound of the visible pairs' products three times over at
    the TF32 peak (3xTF32: the least time for f32-accurate products on
    the tensor cores, as audio_f32_checks bounds the f32 forward; the
    body itself runs f32 FMAs), the f32-FMA bound printed beside it."""
    g = torch.Generator(device=dev).manual_seed(9)
    for shape in FLASH_F32_BWD_SHAPES:
        b, sq, skv, h, hkv, d, causal = shape
        q, do = (torch.randn(b, sq, h, d, generator=g, device=dev)
                 for _ in range(2))
        k, v = (torch.randn(b, skv, hkv, d, generator=g, device=dev)
                for _ in range(2))
        scale = d ** -0.5
        out, lse = attention.flash_forward(q, k, v, causal)
        delta = attention.flash_delta(out, do)
        dq_fn = lambda: attention.flash_backward_dq(  # noqa: E731
            q, k, v, do, lse, delta, causal, scale)
        dkv_fn = lambda: attention.flash_backward_dkv(  # noqa: E731
            q, k, v, do, lse, delta, causal, scale)
        plain = lambda: attention.flash_backward_plain(  # noqa: E731
            q, k, v, out, lse, do, causal, scale)
        got, ref = (dq_fn(), *dkv_fn()), plain()
        rels = grad_rel_errs(got, ref)
        note = ", ".join(f"{n} {e:.3e}" for n, e in
                         zip(("dq", "dk", "dv"), rels))
        if not all(np.isfinite(e) and e <= F32_GRAD_TOL for e in rels):
            raise AssertionError(f"flash f32 backward {shape}: "
                                 f"max|err|/max|ref| {note} (tol "
                                 f"{F32_GRAD_TOL})")
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        mask_kw = ({"attn_mask": attention.flash_mask(sq, skv, True, dev)}
                   if causal and sq != skv else {"is_causal": causal})
        leaves = [t.detach().requires_grad_() for t in (qt, kt, vt)]
        lib_out = F.scaled_dot_product_attention(
            *leaves, enable_gqa=hkv < h, **mask_kw)
        lib_bwd = lambda: torch.autograd.grad(  # noqa: E731
            lib_out, leaves, do.transpose(1, 2), retain_graph=True)
        dq_ms, dkv_ms = median_ms(dq_fn), median_ms(dkv_fn)
        plain_ms = median_ms(plain)
        lib_ms = median_ms(lib_bwd, capture=False)
        del leaves, lib_out
        prod = 2 * b * h * visible_pairs(sq, skv, causal) * d
        qb, kb, sb = 4 * q.numel(), 4 * k.numel(), 4 * lse.numel()
        for name, e, ms, nbytes, ops in (
                ("flash_backward_dq_f32", (got[0] - ref[0]).abs().max()
                 .item(), dq_ms, 3 * qb + 2 * kb + 2 * sb, 3 * prod),
                ("flash_backward_dkv_f32", max(
                    (a - r).abs().max().item()
                    for a, r in zip(got[1:], ref[1:])), dkv_ms,
                 2 * qb + 4 * kb + 2 * sb, 4 * prod)):
            bound_ms, bound_by = record(results, name, e, ms, plain_ms,
                                        lib_ms, nbytes, 3 * ops, TF32_PEAK)
            fma_ms, _ = bound(nbytes, ops, F32_PEAK)
            print(f"check {name} {shape}: max|err|/max|ref| {note} (tol "
                  f"{F32_GRAD_TOL}), kernel {ms:.4f} ms "
                  f"({ops / ms * 1e-9:.1f} TFLOP/s, {bound_ms / ms:.3f} of "
                  f"the bound), plain {plain_ms:.4f} ms, library "
                  f"{lib_ms:.4f} ms, bound {bound_ms:.4f} ms by {bound_by} "
                  f"(3xTF32 at {TF32_PEAK * 1e-12:.0f} TFLOP/s; as f32 FMAs "
                  f"at {F32_PEAK * 1e-12:.0f} TFLOP/s {fma_ms:.4f} ms)",
                  flush=True)
        del q, k, v, do, out, lse, delta, got, ref
        torch.cuda.empty_cache()


def small_train_check(dev, llm_weights: str = "bf16",
                      card_dtype=torch.bfloat16) -> dict:
    """Two optimizer steps of a small VideoLLaVA (2 layers, GQA 4/2,
    head dim 64) tuning projector+embed, grad_accum 2, AdamW at lr 1e-3
    with no warmup, built by the entry point's build_model from one seed:
    on the card in bf16 (kernels 7 and 8, the dot_f32 gradient on CUDA)
    against the same weights in f32 on the CPU's plain path, on the same
    batch (4 rows of 256 tokens with a video block, different target
    counts). llm_weights "int8": the frozen LLM in --llm_weights int8's
    layout. Loss within 2e-2 and the gradient's global norm within 5e-2
    of the CPU's, relative: bf16 activations through 2 layers move both
    by ~1e-2, and step 2 sees step 1's Adam update, which a sign flip of
    a near-zero gradient moves by 2 lr. card_dtype float32: the card's
    model in f32 (kernel 7's f32 body and kernel 8's), within 1e-3 and
    1e-2 (f32 on both sides, but for such sign flips). Returns the
    launches of the card's two steps."""
    tok = load_tokenizer(None)
    cfg = dataclasses.replace(
        VideoLLaVAConfig.tiny(),
        llm=dataclasses.replace(LlamaConfig.tiny(vocab_size=512),
                                num_layers=2, num_heads=4, num_kv_heads=2,
                                head_dim=64, intermediate_size=512),
        vid_patch_token_id=tok.vid_patch_token_id,
        vid_start_token_id=tok.vid_start_token_id,
        vid_end_token_id=tok.vid_end_token_id,
    )
    args = types.SimpleNamespace(pretrained_dir=None, llm_weights=llm_weights,
                                 tune_mode="projector+embed", seed=0)
    src = train.build_model(args, cfg, "cpu")
    int8 = dict(llm_quant="int8", llm_skip_keys=("embed_tokens",))
    layout = int8 if llm_weights == "int8" else {}
    models = {}
    for where, dtype in ((dev, card_dtype), ("cpu", torch.float32)):
        models[where] = VideoLLaVA(cfg, device=where, dtype=dtype, **layout)
        models[where].load_state_dict(src.state_dict())
    rng = np.random.default_rng(0)
    b, s, n = 4, 256, cfg.video_token_len
    ids = rng.integers(3, 250, size=(b, s)).astype(np.int32)
    ids[:, 2] = cfg.vid_start_token_id
    ids[:, 3:3 + n] = cfg.vid_patch_token_id
    ids[:, 3 + n] = cfg.vid_end_token_id
    labels = ids.copy()
    for i in range(b):
        labels[i, :n + 4 + 9 * i] = -100
    batch = {"input_ids": ids, "labels": labels,
             "video_features": rng.standard_normal(
                 (b, n, cfg.vision.hidden_size)).astype(np.float32)}
    metrics = {}
    cuda_lib.reset_launch_counts()
    for where, model in models.items():
        tx = make_optimizer(1e-3, 0.0, warmup_steps=0, total_steps=4)
        state = init_train_state(model, tx, trainable_mask(model))
        step = make_train_step(tx, grad_accum=2)
        mb = {k: torch.from_numpy(v).to(where) for k, v in batch.items()}
        metrics[where] = []
        for _ in range(2):
            state, m = step(state, mb)
            metrics[where].append((float(m["loss"]), float(m["grad_norm"])))
    launches = dict(cuda_lib.LAUNCHES)
    path = TRAIN_PATH_F32 if card_dtype == torch.float32 else TRAIN_PATH
    if not all(launches.get(k) for k in path):
        raise AssertionError(f"small train step did not run {path}: "
                             f"{launches}")
    f32 = card_dtype == torch.float32
    limits = (1e-3, 1e-2) if f32 else (2e-2, 5e-2)
    label = f"small {llm_weights} train step{' (f32 on the card)' * f32}"
    for i, ((loss, norm), (loss_ref, norm_ref)) in enumerate(
            zip(metrics[dev], metrics["cpu"])):
        rel_loss = abs(loss - loss_ref) / abs(loss_ref)
        rel_norm = abs(norm - norm_ref) / norm_ref
        print(f"{label} {i}: loss {loss:.5f} (CPU f32 {loss_ref:.5f}, rel "
              f"{rel_loss:.2e}, limit {limits[0]}), grad norm {norm:.5f} "
              f"(CPU f32 {norm_ref:.5f}, rel {rel_norm:.2e}, limit "
              f"{limits[1]})", flush=True)
        if not (np.isfinite(loss) and np.isfinite(norm)
                and rel_loss <= limits[0] and rel_norm <= limits[1]):
            raise AssertionError(f"{label} {i} disagrees with the CPU")
    print(f"{label}: launches {launches}", flush=True)
    return launches


TRAIN_SAMPLES, TRAIN_LAYER = 16, 7  # samples; the frozen layer checksummed
# tokens of each sample: every row in the 1,024 bucket, and no two rows
# with the same count of answer tokens (so a sharded step's data ranks
# never hold equal counts of valid targets)
TRAIN_ROWS = tuple(1000 - 8 * i for i in range(TRAIN_SAMPLES))


def write_train_data(root: str):
    """TRAIN_SAMPLES samples of {"video", "conversations": [human
    "<video>\\n...", gpt "..."]} in root/data.json and a (356, 1024) f32
    .npy feature file each in root/features, from
    np.random.default_rng(0). Answers are sized with the byte tokenizer
    so that sample i takes TRAIN_ROWS[i] tokens (the video block and
    the template alone take 577). Returns (data path, feature
    folder)."""
    tok = load_tokenizer(None)
    cfg = model_config("7b")
    mm = MultimodalCfg(video_token_len=cfg.video_token_len,
                       use_vid_start_end=cfg.use_vid_start_end)
    question = DEFAULT_VIDEO_TOKEN + "\nWhat happens in this video?"

    def turns(answer):
        return [{"from": "human", "value": question},
                {"from": "gpt", "value": answer}]

    def n_tokens(answer):
        src = preprocess_multimodal([turns(answer)], mm)
        return len(preprocess(src, tok)["input_ids"][0])

    base = n_tokens("")
    rng = np.random.default_rng(0)
    folder = os.path.join(root, "features")
    os.makedirs(folder)
    samples = []
    for i in range(TRAIN_SAMPLES):
        target = TRAIN_ROWS[i]
        answer = " ".join(rng.choice(SERVING_WORDS, 400))[:target - base]
        answer = answer[:-1] + "."
        if n_tokens(answer) != target:
            raise AssertionError(f"sample {i}: {n_tokens(answer)} tokens")
        np.save(os.path.join(folder, f"video_{i}.npy"), rng.standard_normal(
            (cfg.video_token_len, cfg.vision.hidden_size), dtype=np.float32))
        samples.append({"video": f"video_{i}.npy",
                        "conversations": turns(answer)})
    path = os.path.join(root, "data.json")
    with open(path, "w") as f:
        json.dump(samples, f)
    return path, folder


def digest(module) -> str:
    """sha256 over the bytes of every parameter of `module`."""
    h = hashlib.sha256()
    for _, p in sorted(module.named_parameters()):
        h.update(p.detach().contiguous().view(torch.uint8).cpu().numpy()
                 .tobytes())
    return h.hexdigest()


def train_7b(dev, root: str, data: str, folder: str) -> dict:
    """The training entry point at full width: python -m
    video_llava_tpu_torch.train.train --model_size 7b (Vicuna-7B + the
    linear projector, bf16, random weights from --seed, tune_mode
    projector+embed) on write_train_data's 16 samples of 880-1,000 tokens,
    batch 2 x gradient accumulation 2, one epoch: 4 optimizer steps of
    4 rows, the profile on step 3, the final checkpoint-4 (the whole
    state, the frozen LLM included) and mm_projector.bin, under `root`.
    Launch counts over exactly train.main; kernel 7 must run 2 x 32 x 2
    times a step (forward and the remat recompute of each layer of each
    microbatch), dq and dk/dv 32 x 2. A frozen layer must keep its bytes
    and the projector and embed_tokens must move. Then the same command
    for two epochs must resume: restore checkpoint-4 with the trainables
    run 1 ended with and take steps 5-12. Returns run 1's counts, its
    summary, argv and export (mm_projector.bin, read back): the one
    process that train_mesh_phase's sharded run is held against."""
    out, prof = os.path.join(root, "out"), os.path.join(root, "profile")
    usage = shutil.disk_usage(root)
    print(f"train data in {root}: {TRAIN_SAMPLES} samples; disk "
          f"{usage.free / 2**30:.1f} GiB free of "
          f"{usage.total / 2**30:.1f} GiB", flush=True)
    built = {}
    build = train.build_model

    def build_model(args, cfg, device):  # note the weights on entry
        model = build(args, cfg, device)
        built.update(
            model=model, frozen=digest(model.llm.layers[TRAIN_LAYER]),
            projector=[p.detach().clone()
                       for p in model.projector.parameters()],
            embed=model.llm.embed_tokens.weight.detach().clone())
        return model

    accum, steps = 2, TRAIN_SAMPLES // 4
    argv = ["--data_path", data, "--video_folder", folder,
            "--output_dir", out, "--model_size", "7b",
            "--per_device_train_batch_size", "2",
            "--gradient_accumulation_steps", str(accum),
            "--num_train_epochs", "1", "--save_steps", "0",
            "--profile", prof]
    print(f"train.main({' '.join(argv)})", flush=True)
    train.build_model = build_model
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    cuda_lib.reset_launch_counts()
    t0 = time.perf_counter()
    try:
        summary = train.main(argv)
    finally:
        train.build_model = build
    torch.cuda.synchronize()
    launches = dict(cuda_lib.LAUNCHES)
    total_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2 ** 30

    for i, (loss, norm, step_s, tokens, bucket) in enumerate(zip(
            summary["loss"], summary["grad_norm"], summary["step_s"],
            summary["tokens"], summary["bucket"])):
        note = " (profiled)" if i == train.PROFILE_STEP else ""
        print(f"train 7b step {i}: loss {loss:.5f}, grad norm "
              f"{norm:.5f}, bucket {bucket}, {step_s:.3f} s, "
              f"{tokens / step_s:.0f} tokens/s ({tokens} tokens with "
              f"padding){note}", flush=True)
    if summary["steps"] != steps or not all(
            np.isfinite(summary["loss"] + summary["grad_norm"])):
        raise AssertionError(f"train 7b: {summary['steps']} steps, "
                             f"losses {summary['loss']}")
    model = built.pop("model")
    layers = len(model.llm.layers)
    frozen_ok = digest(model.llm.layers[TRAIN_LAYER]) == built["frozen"]
    d_proj = max((p.detach().float() - p0.float()).abs().max().item()
                 for p, p0 in zip(model.projector.parameters(),
                                  built["projector"]))
    d_embed = (model.llm.embed_tokens.weight.detach().float()
               - built["embed"].float()).abs()
    rows_moved = int((d_embed.amax(1) > 0).sum())
    trained = (digest(model.projector), digest(model.llm.embed_tokens))
    ckpt = os.path.join(out, f"checkpoint-{steps}")
    ckpt_bytes = sum(os.path.getsize(os.path.join(ckpt, f))
                     for f in os.listdir(ckpt))
    print(f"train 7b: {total_s:.2f} s in train.main (init, data, "
          f"{steps} steps, checkpoint); peak device memory {peak:.2f} "
          f"GiB; launches {launches}; layer {TRAIN_LAYER} sha256 "
          f"{built['frozen'][:16]} before, "
          f"{'the same' if frozen_ok else 'CHANGED'} after; projector "
          f"max|change| {d_proj:.3e}; embed_tokens max|change| "
          f"{d_embed.max().item():.3e} over {rows_moved} rows; "
          f"checkpoint-{steps} {ckpt_bytes / 2**30:.2f} GiB and "
          f"mm_projector.bin written in {summary['save_s']:.2f} s",
          flush=True)
    del model, built, d_embed
    export = torch.load(os.path.join(out, "mm_projector.bin"))
    want = {"flash_forward": 2 * layers * accum * steps,
            "flash_backward_dq": layers * accum * steps,
            "flash_backward_dkv": layers * accum * steps}
    wrong = {k: launches.get(k, 0) for k, n in want.items()
             if launches.get(k, 0) != n}
    if wrong:
        raise AssertionError(f"train 7b launches {wrong}, want {want}")
    if not frozen_ok or not d_proj > 0 or not rows_moved:
        raise AssertionError("train 7b: a frozen layer moved or a "
                             "trainable one did not")
    for name in (f"checkpoint-{steps}", "mm_projector.bin",
                 "train_summary.json"):
        if not os.path.exists(os.path.join(out, name)):
            raise AssertionError(f"train 7b wrote no {name}")

    busy_ms, by_name = trace_busy(os.path.join(prof, "trace.json"))
    if not by_name:
        raise AssertionError("train 7b profile: no device activity")
    step_ms = summary["step_s"][train.PROFILE_STEP] * 1e3
    calm_ms = statistics.mean(
        summary["step_s"][1:train.PROFILE_STEP]) * 1e3
    print(f"train 7b profile, step {train.PROFILE_STEP}: device busy "
          f"{busy_ms:.1f} ms over {sum(c for _, c in by_name.values())} "
          f"device activities; idle share {1 - busy_ms / step_ms:.3f} of "
          f"the profiled step's {step_ms:.1f} ms, "
          f"{1 - busy_ms / calm_ms:.3f} of the unprofiled steps 1-2's "
          f"mean {calm_ms:.1f} ms")
    for name, (total, calls) in sorted(by_name.items(),
                                       key=lambda kv: -kv[1][0])[:14]:
        print(f"train 7b profile: {total / 1e3:9.2f} ms {calls:6d} "
              f"calls  {name[:90]}")
    for kind in ("fwd", "dq", "dkv"):  # kernels 7 and 8, wherever ranked
        hits = [v for n, v in by_name.items()
                if f"flash::hopper::{kind}_kernel" in n]
        print(f"train 7b profile: kernel {kind} "
              f"{sum(t for t, _ in hits) / 1e3:.2f} ms over "
              f"{sum(c for _, c in hits)} calls in the step", flush=True)

    restore, restored = train.restore_checkpoint, {}

    def restore_checkpoint(path, state):  # note what was restored
        state = restore(path, state)
        restored.update(path=path, trainables=(
            digest(state.model.projector),
            digest(state.model.llm.embed_tokens)))
        return state

    ref = {"launches": launches, "summary": summary, "export": export,
           "argv": argv[:argv.index("--output_dir")]
           + argv[argv.index("--model_size"):argv.index("--profile")]}
    argv = argv[:argv.index("--num_train_epochs")] + [
        "--num_train_epochs", "2", "--save_steps", "0"]
    train.restore_checkpoint = restore_checkpoint
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    try:
        resumed = train.main(argv)
    finally:
        train.restore_checkpoint = restore
    same = restored.get("trainables") == trained
    print(f"train 7b resumed from {restored.get('path')} (trainables "
          f"{'as' if same else 'NOT as'} run 1 ended them): steps "
          f"{resumed['steps']}, losses "
          f"{', '.join(f'{x:.4f}' for x in resumed['loss'])}, "
          f"{time.perf_counter() - t0:.2f} s in train.main, "
          f"checkpoint-{resumed['steps']} written in "
          f"{resumed['save_s']:.2f} s", flush=True)
    if (restored.get("path") != ckpt or not same
            or resumed["steps"] != 3 * steps
            or not all(np.isfinite(resumed["loss"]))):
        raise AssertionError("train 7b did not resume from "
                             f"checkpoint-{steps}")
    shutil.rmtree(out, ignore_errors=True)
    return ref


def training_phase(dev, results) -> dict:
    """Kernels 7 and 8 (flash_checks, then flash_limit_checks), the small
    train steps in bf16 and with an int8 LLM (small_train_check), then 7B
    through the entry point (train_7b). Returns the 7B run's launch
    counts."""
    t0 = time.perf_counter()
    flash_checks(dev, results)
    flash_limit_checks(dev)
    flash_wide_times(dev)
    flash_f32_bwd_checks(dev, results)
    torch.cuda.empty_cache()
    small_train_check(dev)
    small_train_check(dev, "int8")
    # an f32 train step on the card: kernel 7's f32 body and kernel 8's
    # f32 body, whose launches the kernels line carries
    f32 = small_train_check(dev, card_dtype=torch.float32)
    root = tempfile.mkdtemp(prefix="vlt_train_")
    try:
        data, folder = write_train_data(root)
        ref = train_7b(dev, root, data, folder)
        launches = ref.pop("launches")
        launches.update({k: f32[k] for k in TRAIN_PATH_F32[1:]})
        gc.collect()
        torch.cuda.empty_cache()
        print(f"training phase: {time.perf_counter() - t0:.2f} s",
              flush=True)
        train_mesh_phase(dev, root, data, folder, ref, results)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return launches


# -- sharded training (train_mesh_phase) -----------------------------------

MESH_ENV = "VLT_SMOKE_MESH"  # what the phase asks of each rank (json)
MESH = ["--mesh_data", "2", "--mesh_model", "2", "--dist_backend", "gloo"]
MESH_FSDP_LAYERS, MESH_FSDP_SAMPLES = 2, 8  # FSDP's depth cut; 2 steps
# Limits of a sharded bf16 run against one process on the same data and
# seed, set before the first reading: each step's loss within 2^-8 and
# grad norm within 2^-5 relative; the exported projector and embed_tokens
# on average within 5% of one step's size lr, no element further than 2
# lr a step (Adam moves each element by about lr times its gradient's
# sign, and a nearly cancelling bf16 gradient element may take either).
MESH_LIMITS = {"loss": 2 ** -8, "grad_norm": 2 ** -5, "mean_lr": 0.05,
               "max_lr_a_step": 2.0}
MESH_LR = 2e-3  # train.py's default learning rate
MESH_POOL_COUNTS = (100, 73, 50, 30)
# kernel 2 sharded over 2 data ranks against one process's launch, bf16
# out: the spatial partials add in f32 in another order, so a value may
# round one bf16 ulp away: of max |ref|
POOL_SHARD_TOL = 2 ** -7


@contextlib.contextmanager
def depth_cut(layers):
    """train.main's model at `layers` LLM layers and as many CLIP layers
    (None: as it is; training reads precomputed features, so the tower
    only adds its parameters and their optimizer state)."""
    config = train.model_config

    def cut(size):
        cfg = config(size)
        return dataclasses.replace(
            cfg, llm=dataclasses.replace(cfg.llm, num_layers=layers),
            vision=dataclasses.replace(cfg.vision, num_layers=layers))

    if layers:
        train.model_config = cut
    try:
        yield
    finally:
        train.model_config = config


def pool_shard_rank_check(mesh, dev) -> dict:
    """Kernel 2's frame-sharded form on this rank of `mesh`: 100 frames
    of ViT-L's 256 x 1024 features (seeded, the same on every rank) at
    each of MESH_POOL_COUNTS valid, bf16 out as encode_video pools,
    against one process's kernel 2 on the same features; the sharded
    call's launches counted alone."""
    g = torch.Generator(device=dev).manual_seed(7)
    x = torch.randn(100, 256, 1024, generator=g, device=dev).to(
        torch.bfloat16)
    out = {}
    for n in MESH_POOL_COUNTS:
        cuda_lib.reset_launch_counts()
        got = pooling.spatio_temporal_pool_sharded(x, n, mesh)
        torch.cuda.synchronize()
        launches = cuda_lib.LAUNCHES["spatio_temporal_pool"]
        want = pooling.spatio_temporal_pool_fused(x, n)
        err = (got.float() - want.float()).abs().max().item()
        d = mesh.coords["data"]
        out[str(n)] = {"rel_err": err / want.float().abs().max().item(),
                       "launches": launches,
                       "n_local": min(max(n - d * 50, 0), 50)}
    cuda_lib.reset_launch_counts()
    return out


def planted_first(step, report):
    """`step`, whose first call first takes the same step with the
    planted fault (no gradient sum over 'data': each data rank updates
    from its own rows alone), notes its loss and grad norm in `report`,
    puts the trainable parameters back and zeroes the launch counts."""
    def first(state, batch):
        if "fault" not in report:
            params = dict(state.model.named_parameters())
            saved = {n: params[n].detach().clone() for n in state.trainable}
            sum_data = train_step_mod._sum_data
            train_step_mod._sum_data = lambda g, mesh: g
            try:
                _, m = step(state, batch)
                report["fault"] = {"loss": float(m["loss"]),
                                   "grad_norm": float(m["grad_norm"])}
            finally:
                train_step_mod._sum_data = sum_data
            with torch.no_grad():
                for n, t in saved.items():
                    params[n].copy_(t)
            del saved
            cuda_lib.reset_launch_counts()
        return step(state, batch)
    return first


def mesh_rank(argv):
    """train.main(argv) on this rank of a sharded run (rank 0's call, and
    the entry of the ranks train.main spawns), as MESH_ENV asks
    (a depth cut, kernel 2's sharded check, the planted fault); each
    rank writes its report (launches over the real steps and the save,
    peak memory, the checks, each microbatch's count of valid targets on
    this rank) to the asked directory."""
    spec = json.loads(os.environ[MESH_ENV])
    torch.backends.cuda.matmul.allow_tf32 = False
    report = {"counts": []}
    make, ll = train.make_train_step, train_step_mod.log_likelihood

    def log_likelihood(model, batch):  # note this rank's count
        logp, n = ll(model, batch)
        report["counts"].append(int(n))
        return logp, n

    def make_step(tx, grad_accum=1, mesh=None):
        step = make(tx, grad_accum, mesh)
        report.update(rank=multihost.get_rank(), coords=dict(mesh.coords))
        if spec.get("pool"):
            report["pool"] = pool_shard_rank_check(
                mesh, torch.device("cuda", torch.cuda.current_device()))
        return planted_first(step, report) if spec.get("fault") else step

    train.make_train_step = make_step
    train_step_mod.log_likelihood = log_likelihood
    # the ranks train.main spawns run this function too
    start = multihost.start_ranks

    def start_ranks(*args, **kwargs):
        return start(*args,
                     **dict(kwargs, entry=("chip_smoke", "mesh_rank")))

    multihost.start_ranks = start_ranks
    cuda_lib.reset_launch_counts()
    cuda = torch.cuda.is_available()
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    try:
        with depth_cut(spec.get("layers")):
            summary = train.main(argv)
    finally:
        train.make_train_step = make
        train_step_mod.log_likelihood = ll
        multihost.start_ranks = start
    report.update(launches=dict(cuda_lib.LAUNCHES), peak_gib=(
        torch.cuda.max_memory_allocated() / 2 ** 30 if cuda else 0.0))
    with open(os.path.join(spec["reports"], f"rank{report['rank']}.json"),
              "w") as f:
        json.dump(report, f)
    return summary


def mesh_run(argv, **spec):
    """train.main(argv) sharded, this process rank 0 and the others
    spawned (mesh_rank), every rank as `spec` asks -> (rank 0's summary,
    every rank's report in rank order, wall seconds)."""
    reports = tempfile.mkdtemp(prefix="mesh_reports_")
    os.environ[MESH_ENV] = json.dumps(dict(spec, reports=reports))
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    try:
        summary = mesh_rank(argv)
    finally:
        del os.environ[MESH_ENV]
    wall = time.perf_counter() - t0
    got = []
    for name in sorted(os.listdir(reports)):
        with open(os.path.join(reports, name)) as f:
            got.append(json.load(f))
    shutil.rmtree(reports, ignore_errors=True)
    got.sort(key=lambda r: r["rank"])
    return summary, got, wall


def mesh_compare(label, got, want, got_export, want_export, steps,
                 failed) -> dict:
    """Hold a sharded run's summary and export against one process's
    within MESH_LIMITS; print the readings; note failures."""
    readings = {}
    for key in ("loss", "grad_norm"):
        rel = [abs(a - b) / abs(b) for a, b in zip(got[key], want[key])]
        readings[key] = max(rel)
        print(f"{label}: {key} {['%.5f' % x for x in got[key]]} against "
              f"one process's {['%.5f' % x for x in want[key]]}: max rel "
              f"{max(rel):.3e} (limit {MESH_LIMITS[key]:.3e})", flush=True)
        if not (len(got[key]) == len(want[key]) == steps
                and all(np.isfinite(got[key])) and max(rel) <= MESH_LIMITS[
                    key]):
            failed.append(f"{label}: {key} out of its limit")
    for k in sorted(want_export):
        diff = (got_export[k].float() - want_export[k].float()).abs()
        mean_lr = diff.mean().item() / MESH_LR
        max_lr = diff.max().item() / MESH_LR
        readings[k] = [mean_lr, max_lr]
        print(f"{label}: {k} mean|diff| {mean_lr:.4f} lr (limit "
              f"{MESH_LIMITS['mean_lr']}), max {max_lr:.3f} lr (limit "
              f"{MESH_LIMITS['max_lr_a_step'] * steps})", flush=True)
        if not (mean_lr <= MESH_LIMITS["mean_lr"]
                and max_lr <= MESH_LIMITS["max_lr_a_step"] * steps):
            failed.append(f"{label}: {k} out of its limit")
    return readings


def subset_data(data: str, n: int, root: str) -> str:
    """The first n samples of `data` as a data file of their own."""
    with open(data) as f:
        samples = json.load(f)[:n]
    path = os.path.join(root, f"data_{n}.json")
    with open(path, "w") as f:
        json.dump(samples, f)
    return path


def link_checkpoint(src: str, dst: str) -> None:
    """dst/ holding src's checkpoint directory (hard links: no copy)."""
    name = os.path.basename(src)
    shutil.copytree(src, os.path.join(dst, name), copy_function=os.link)


def train_mesh_phase(dev, root, data, folder, ref, results) -> dict:
    """Sharded training on the card (4 gloo ranks share it; NCCL takes a
    card a rank), through train.main as a user runs it, this process
    rank 0 and the others spawned:

      * DP x TP: `--mesh_data 2 --mesh_model 2` at full width and depth
        (Vicuna-7B + CLIP ViT-L/14, bf16, projector+embed) on train_7b's
        data and seed, a global batch of 4 rows of 1,024 whose counts of
        valid targets all differ (checked on each rank; 1 a rank x
        accumulation 2 x 2 data ranks), 4 steps, against train_7b's
        one process (ref) within MESH_LIMITS: the per-step loss and grad
        norm, the exported projector and embed_tokens. Before it, every
        rank takes the first step once with a planted fault (no gradient
        sum over 'data'), whose grad norm must fall outside the limit,
        and checks kernel 2's frame-sharded form on its data axis
        (pool_shard_rank_check: 100 frames at MESH_POOL_COUNTS valid).
        Each rank's launches of kernels 7, 8 and 2, its peak, the step
        seconds and the one save's seconds are printed.
      * FSDP: `--tune_mode full` on the same mesh (every big matched
        kernel's free dim on 'data') at 7B width, depth cut to
        MESH_FSDP_LAYERS (the LLM's and CLIP's), 2 steps, against one
        process of the same cut;
        then its checkpoint (the one-process format) resumed in one
        process and at 2 x 1: the next step's loss equal within the
        loss limit."""
    t_phase = time.perf_counter()
    card = card_line()
    failed = []
    out = os.path.join(root, "mesh")
    argv = ref["argv"] + ["--output_dir", out]
    argv[argv.index("--per_device_train_batch_size") + 1] = "1"
    print(f"train_mesh_phase: train.main({' '.join(argv + MESH)})",
          flush=True)
    summary, ranks, wall = mesh_run(argv + MESH, pool=True, fault=True)
    accum, steps = 2, TRAIN_SAMPLES // 4
    layers = LlamaConfig.vicuna_7b().num_layers
    want = {"flash_forward": 2 * layers * accum * steps,
            "flash_backward_dq": layers * accum * steps,
            "flash_backward_dkv": layers * accum * steps}
    export = torch.load(os.path.join(out, "mm_projector.bin"))
    readings = mesh_compare("DP 2 x TP 2 7B", summary, ref["summary"],
                            export, ref["export"], steps, failed)
    # a mean of the ranks' means equals the global mean only where the
    # data ranks hold equal counts: every microbatch's must differ
    by_data = {r["coords"]["data"]: r["counts"] for r in ranks
               if r["coords"]["model"] == 0}
    print(f"train_mesh_phase: valid targets of each microbatch (the "
          f"planted fault's step first), data rank 0 {by_data[0]}, data "
          f"rank 1 {by_data[1]}", flush=True)
    if (len(by_data[0]) != len(by_data[1]) or not by_data[0]
            or any(a == b for a, b in zip(by_data[0], by_data[1]))):
        failed.append("the data ranks hold equal counts of targets")
    want0 = ref["summary"]["grad_norm"][0]
    for r in ranks:
        f = r["fault"]
        rel = abs(f["grad_norm"] - want0) / want0
        print(f"train_mesh_phase rank {r['rank']} {r['coords']}: planted "
              f"fault (no sum over 'data'): first step's grad norm "
              f"{f['grad_norm']:.5f} against {want0:.5f}, rel {rel:.3e}, "
              f"which must exceed {MESH_LIMITS['grad_norm']:.3e}",
              flush=True)
        if not rel > MESH_LIMITS["grad_norm"]:
            failed.append(f"rank {r['rank']}: the planted fault passed")
        kern = {k: r["launches"].get(k, 0) for k in want}
        print(f"train_mesh_phase rank {r['rank']}: launches over the 4 "
              f"steps and the save {kern} (want {want}); peak "
              f"{r['peak_gib']:.2f} GiB (the whole model drawn, then "
              f"sharded)", flush=True)
        if kern != want:
            failed.append(f"rank {r['rank']}: launches {kern}")
        for n, p in r["pool"].items():
            print(f"train_mesh_phase rank {r['rank']}: kernel 2 sharded, "
                  f"{n} of 100 valid ({p['n_local']} of this rank's 50): "
                  f"max|err|/max|ref| {p['rel_err']:.3e} (tol "
                  f"{POOL_SHARD_TOL:.3e}) against one process, "
                  f"{p['launches']} launch", flush=True)
            if not (p["launches"] == 1 and p["rel_err"] <= POOL_SHARD_TOL):
                failed.append(f"rank {r['rank']}: kernel 2 sharded at {n}")
    secs = lambda xs: ", ".join(f"{x:.3f}" for x in xs)  # noqa: E731
    print(f"train_mesh_phase DP x TP: steps {secs(summary['step_s'])} s "
          f"(one process: {secs(ref['summary']['step_s'])}), the "
          f"save (checkpoint-{steps} gathered to rank 0 and written, "
          f"export) {summary['save_s']:.2f} s (one process "
          f"{ref['summary']['save_s']:.2f}), train.main {wall:.2f} s; "
          f"{card}", flush=True)
    shutil.rmtree(out, ignore_errors=True)
    del export

    # FSDP at 7B width, MESH_FSDP_LAYERS deep
    data8 = subset_data(data, MESH_FSDP_SAMPLES, root)
    fargv = ["--data_path", data8] + ref["argv"][2:] + ["--tune_mode",
                                                        "full"]
    one, four = os.path.join(root, "fsdp_one"), os.path.join(root,
                                                             "fsdp_four")
    gc.collect()
    torch.cuda.empty_cache()
    with depth_cut(MESH_FSDP_LAYERS):
        t0 = time.perf_counter()
        fref = train.main(fargv + ["--output_dir", one])
        one_s = time.perf_counter() - t0
    fargv[fargv.index("--per_device_train_batch_size") + 1] = "1"
    fsum, franks, fwall = mesh_run(fargv + ["--output_dir", four] + MESH,
                                   layers=MESH_FSDP_LAYERS)
    fsteps = MESH_FSDP_SAMPLES // 4
    readings["fsdp"] = mesh_compare(
        f"FSDP 2 x 2 7B width, {MESH_FSDP_LAYERS} layers", fsum, fref,
        torch.load(os.path.join(four, "mm_projector.bin")),
        torch.load(os.path.join(one, "mm_projector.bin")), fsteps, failed)
    for r in franks:
        kern = {k: r["launches"].get(k, 0) for k in TRAIN_PATH}
        print(f"train_mesh_phase FSDP rank {r['rank']}: launches {kern}, "
              f"peak {r['peak_gib']:.2f} GiB", flush=True)
        if not all(kern.values()):
            failed.append(f"FSDP rank {r['rank']}: launches {kern}")
    print(f"train_mesh_phase FSDP: steps {secs(fsum['step_s'])} s, save "
          f"{fsum['save_s']:.2f} s, train.main {fwall:.2f} s (one "
          f"process: {one_s:.2f} s)", flush=True)
    # the round trip: checkpoint-2 of the 2 x 2 run, resumed in one
    # process and at 2 x 1 for one more step on the first 4 rows
    ckpt = os.path.join(four, f"checkpoint-{fsteps}")
    rargv = ["--data_path", subset_data(data, 4, root)] + fargv[2:]
    next_loss = {}
    for label, mesh in (("one process", None),
                        ("2 x 1", ["--mesh_data", "2", "--mesh_model", "1",
                                   "--dist_backend", "gloo"])):
        dst = tempfile.mkdtemp(prefix="fsdp_resume_", dir=root)
        link_checkpoint(ckpt, dst)
        argv1 = rargv + ["--output_dir", dst]
        if mesh is None:
            argv1[argv1.index("--per_device_train_batch_size") + 1] = "2"
            with depth_cut(MESH_FSDP_LAYERS):
                got = train.main(argv1)
        else:
            got, _, _ = mesh_run(argv1 + mesh, layers=MESH_FSDP_LAYERS)
        next_loss[label] = got["loss"][0]
        if got["steps"] != fsteps + 1:
            failed.append(f"FSDP resume ({label}): {got['steps']} steps")
        shutil.rmtree(dst, ignore_errors=True)
    a, b = next_loss["2 x 1"], next_loss["one process"]
    rel = abs(a - b) / abs(b)
    readings["fsdp_resume"] = rel
    print(f"train_mesh_phase FSDP round trip: checkpoint-{fsteps} saved at "
          f"2 x 2, resumed at 2 x 1: next step's loss {a:.5f}, in one "
          f"process {b:.5f}, rel {rel:.3e} (limit {MESH_LIMITS['loss']:.3e})",
          flush=True)
    if not rel <= MESH_LIMITS["loss"]:
        failed.append("FSDP round trip: the next step's loss")
    shutil.rmtree(one, ignore_errors=True)
    shutil.rmtree(four, ignore_errors=True)
    if failed:
        raise AssertionError(f"train_mesh_phase: {failed}")
    wall = time.perf_counter() - t_phase
    print(f"train_mesh_phase: {wall:.2f} s; no multi-GPU speed is "
          f"measured: 4 ranks share one card; {card}", flush=True)
    results["spatio_temporal_pool"]["sharded"] = {
        n: max(r["pool"][n]["rel_err"] for r in ranks)
        for n in ranks[0]["pool"]}
    return {"wall_s": wall, "readings": readings,
            "launches": [r["launches"] for r in ranks]}


# -- grounding ------------------------------------------------------------

LEVELS_800 = ((100, 100), (50, 50), (25, 25), (13, 13))  # GroundingDINO


def msda_inputs(dev, g, q, b, dtype, nh=8, hd=32, p=4):
    """Kernel 12's inputs at GroundingDINO's 800 px shapes: value (b,
    13294, 8, 32); locations as the model makes them, reference points
    (the raster grid for the encoder, q = 13294; spread boxes for the
    decoder) plus offsets of a few pixels of each level, some off the
    map; softmaxed weights."""
    sum_hw = sum(h * w for h, w in LEVELS_800)
    value = torch.randn(b, sum_hw, nh, hd, generator=g, device=dev).to(dtype)
    if q == sum_hw:
        ref = torch.cat([torch.stack(torch.meshgrid(
            (torch.arange(w, device=dev) + 0.5) / w,
            (torch.arange(h, device=dev) + 0.5) / h, indexing="xy"),
            -1).reshape(-1, 2) for h, w in LEVELS_800])
        ref = ref[None].expand(b, q, 2)
    else:
        ref = torch.rand(b, q, 2, generator=g, device=dev)
    scale = torch.tensor([[w, h] for h, w in LEVELS_800], device=dev,
                         dtype=torch.float32)
    offsets = torch.randn(b, q, nh, len(LEVELS_800), p, 2, generator=g,
                          device=dev) * 2.0
    locs = ref[:, :, None, None, None, :] + offsets / scale[:, None, :]
    weights = torch.softmax(torch.randn(b, q, nh, len(LEVELS_800) * p,
                                        generator=g, device=dev),
                            -1).reshape(b, q, nh, len(LEVELS_800), p)
    return value, locs, weights


def grid_sample_msda(value, shapes, locs, weights):
    """HF GroundingDINO's multi_scale_deformable_attention: one
    F.grid_sample per level, then the weighted sum (a composition of
    PyTorch calls; the library yardstick for kernel 12)."""
    b, _, nh, hd = value.shape
    q, n_levels, n_points = locs.shape[1], locs.shape[3], locs.shape[4]
    grids = (2 * locs - 1).to(value.dtype)
    outs = []
    for lvl, v in enumerate(value.split([h * w for h, w in shapes], dim=1)):
        h, w = shapes[lvl]
        v = v.flatten(2).transpose(1, 2).reshape(b * nh, hd, h, w)
        grid = grids[:, :, :, lvl].transpose(1, 2).flatten(0, 1)
        outs.append(F.grid_sample(v, grid, mode="bilinear",
                                  padding_mode="zeros", align_corners=False))
    aw = weights.transpose(1, 2).reshape(b * nh, 1, q, n_levels * n_points)
    out = (torch.stack(outs, dim=-2).flatten(-2) * aw.to(value.dtype)).sum(-1)
    return out.view(b, nh * hd, q).transpose(1, 2)


def deformable_checks(dev, results) -> None:
    """Kernel 12 against its plain version at the encoder (b 4, q 13,294)
    and decoder (q 900) shapes in f32 and bf16 (times of the first, the
    f32 encoder call: the stack runs in f32), the same inputs through
    set_tile2d(True) (kernel 13's switch: the one kernel, the same
    result), locations all non-finite for some queries (exact zeros),
    and a planted fault in the plain version (the smallest level's
    weights dropped) that the check must catch."""
    name = "multi_scale_deformable_attention"
    g = torch.Generator(device=dev).manual_seed(12)
    for q, b, dtype in ((13294, 4, torch.float32), (900, 4, torch.float32),
                        (13294, 4, torch.bfloat16), (900, 4, torch.bfloat16)):
        value, locs, weights = msda_inputs(dev, g, q, b, dtype)
        run = lambda: deformable.multi_scale_deformable_attention(  # noqa
            value, LEVELS_800, locs, weights)
        nbytes = (value.numel() * value.element_size() + locs.numel() * 4
                  + weights.numel() * 4 + b * q * 256 * value.element_size())
        check(results, name, (b, q, 8, 32, 4, 4, str(dtype)[6:]), run,
              lambda: deformable.msda_plain(value, LEVELS_800, locs,
                                            weights),
              nbytes=nbytes,
              library=lambda: grid_sample_msda(value, LEVELS_800, locs,
                                               weights))
        lib_err = (grid_sample_msda(value, LEVELS_800, locs, weights).float()
                   - run().float()).abs().max().item()
        print(f"  grid_sample composition vs kernel: max|err| {lib_err:.3e}")
        got = run()
        deformable.set_tile2d(True)
        try:
            tiled = run()
        finally:
            deformable.set_tile2d(False)
        if not torch.equal(tiled, got):
            raise AssertionError(f"{name}: set_tile2d(True) changed the "
                                 "result")
        if q == 900 and dtype == torch.float32:
            bad = locs.clone()
            bad[:, :7, :, :, :, 0] = float("nan")
            bad[:, 7:11, :, :, :, 1] = float("inf")
            bad[:, 11:13] = float("-inf")
            out = deformable.multi_scale_deformable_attention(
                value, LEVELS_800, bad, weights)
            torch.cuda.synchronize()
            if out[:, :13].abs().max().item() != 0.0:
                raise AssertionError(f"{name}: non-finite locations gave "
                                     "non-zero output")
            if not torch.isfinite(out).all():
                raise AssertionError(f"{name}: non-finite output")
            print(f"check {name}: non-finite locations of 13 queries give "
                  "exact zeros")
            faulty = weights.clone()
            faulty[:, :, :, 3] = 0.0  # drop the 13 x 13 level
            try:
                check({}, name, (b, q, "planted fault: level 3 dropped"),
                      run, lambda: deformable.msda_plain(
                          value, LEVELS_800, locs, faulty), nbytes=nbytes)
            except AssertionError as e:
                print(f"planted fault caught: {e}")
            else:
                raise AssertionError(f"{name}: the check passed a plain "
                                     "version with a level dropped")
        del value, locs, weights


def small_grounding_check(dev) -> None:
    """A small GroundingDINO (the tiny test config, 3 levels) on the card
    (kernel 12, f32) against the same weights on the CPU (the plain
    version): logits and boxes relative to their scale."""
    cfg = gdino.GroundingDinoConfig.tiny_test()
    params = gdino.init_params(TreeInit(0, "cpu"), cfg)
    on_dev = tree_to(params, dev)
    rng = np.random.default_rng(0)
    px = torch.from_numpy(rng.normal(size=(2, 64, 64, 3)).astype(np.float32))
    ids = np.asarray([[101, 5, 6, 1012, 7, 8, 9, 1012, 102]] * 2)
    before = cuda_lib.LAUNCHES["multi_scale_deformable_attention"]
    with torch.inference_mode():
        ref = gdino.forward(params, cfg, px, ids)
        got = gdino.forward(on_dev, cfg, px.to(dev), ids)
    launched = cuda_lib.LAUNCHES["multi_scale_deformable_attention"] - before
    if launched != cfg.encoder_layers + cfg.decoder_layers:
        raise AssertionError(f"small GroundingDINO launched kernel 12 "
                             f"{launched} times")
    for label, a, b in (("logits", got[0], ref[0]), ("boxes", got[1],
                                                     ref[1])):
        a, fin = a.cpu(), torch.isfinite(b)
        rel = ((a[fin] - b[fin]).abs().max() / b[fin].abs().max()).item()
        print(f"small GroundingDINO {label}: shape {tuple(a.shape)}, "
              f"max|err| / max|ref| = {rel:.3e} (f32 CUDA vs f32 CPU, limit "
              "1e-3)")
        if not torch.equal(torch.isfinite(a), fin) or rel > 1e-3:
            raise AssertionError(f"small GroundingDINO {label}: {rel}")


def tree_to(tree, dev):
    if isinstance(tree, dict):
        return {k: tree_to(v, dev) for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_to(v, dev) for v in tree]
    return tree.to(dev)


def grounding_clip(t: int, h: int, w: int, seed: int = 0) -> np.ndarray:
    """A seeded (t, h, w, 3) uint8 clip: a smooth background (a bilinear
    blend of four corner colors) with four squares moving across it. Not
    white noise: detect_scenes would cut noise into one scene a frame."""
    rng = np.random.default_rng(seed)
    corners = rng.uniform(0, 255, (2, 2, 3))
    yy = np.linspace(0, 1, h)[:, None, None]
    xx = np.linspace(0, 1, w)[None, :, None]
    bg = ((1 - yy) * ((1 - xx) * corners[0, 0] + xx * corners[0, 1])
          + yy * ((1 - xx) * corners[1, 0] + xx * corners[1, 1]))
    frames = np.repeat(bg[None].astype(np.uint8), t, axis=0)
    for k in range(4):
        size = int(rng.integers(h // 8, h // 3))
        y0, x0 = rng.integers(0, h - size), rng.integers(0, w - size)
        vy, vx = rng.uniform(-3, 3), rng.uniform(-4, 4)
        color = rng.integers(0, 256, 3)
        for i in range(t):
            y = int(np.clip(y0 + vy * i, 0, h - size))
            x = int(np.clip(x0 + vx * i, 0, w - size))
            frames[i, y:y + size, x:x + size] = color
    return frames


class StubMatchClient:
    """Entity matching's OpenAI-compatible client, answered here (the
    card's machine has no network): pairs a phrase with each of the first
    three entities of the request's list."""

    def chat_text(self, model, messages, **kw):
        import ast

        listed = ast.literal_eval(messages[-1]["content"].split("<List>")[1])
        return "\n".join(f"entity {i} - {e}"
                         for i, e in enumerate(listed[:3]))


def timed(stats, key, fn):
    """fn, with its synchronized wall time added to stats[key]."""

    def run(*a, **kw):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn(*a, **kw)
        torch.cuda.synchronize()
        stats[key] = stats.get(key, 0.0) + time.perf_counter() - t
        return out

    return run


def grounding_phase(engine, dev, results) -> int:
    """Kernel 12's checks, the small detector check, then `--with_
    grounding` at full width on the 7B int4 engine: build_grounding_stack
    on the card, PGVideoLLaVA.answer over a seeded 100-frame 480 x 832
    clip (uploaded through upload_frames; the mp4 writer replaced by a
    recorder, since the card's machine has no libav; entity matching
    through StubMatchClient). A 10-frame answer warms up (the detector,
    SAM and tagger batches are padded, so it runs the same shapes); the
    100-frame answer counts launches and times the stages (host wall
    around synchronized calls); a third runs under torch.profiler, with
    the counted answer's scene cuts in place of the host's scene
    detection. Then the qualitative demo (demo_phase) and the detector's
    stage profile (gdino_profile) on the same stack. Returns kernel 12's
    launches of the counted answer."""
    name = "multi_scale_deformable_attention"
    t0 = time.perf_counter()
    with torch.inference_mode():
        deformable_checks(dev, results)
    small_grounding_check(dev)
    torch.cuda.empty_cache()
    t = time.perf_counter()
    print(f"grounding checks: {t - t0:.2f} s", flush=True)
    tracker, tagger, matcher = build_grounding_stack(device=dev, seed=0)
    torch.cuda.synchronize()
    print(f"build_grounding_stack on the card: "
          f"{time.perf_counter() - t:.2f} s", flush=True)
    # random tag heads give probabilities near 0.5, under the 0.95 a
    # trained head clears; 0.5 lets some tags through so the tracker runs
    tagger.threshold = 0.5
    matcher.client = StubMatchClient()
    videos = []
    print("chip_smoke: the output video goes to an in-memory recorder, not "
          "encode_video (no libav on this machine)")
    stats: dict = {}
    runs = []
    forwards = [0]
    detector, segmenter = tracker.detector, tracker.segmenter
    patched = [  # (owner, attribute, stage)
        (tagger, "run_on_video", "tagging"),
        (detector, "detect_batch", "detection"),
        (segmenter, "decode_masks_batch_device", "sam"),
        (fused_clip, "run_clip_fused_stm", "propagation"),
        (gresults, "annotate_frame", "annotation"),
        (scene_mod, "detect_scenes", "scenes"),
        (chat_mod, "generate_with_keywords", "llm"),
    ]
    saved = [(o, a, getattr(o, a)) for o, a, _ in patched]
    for o, a, stage in patched:
        setattr(o, a, timed(stats, stage, getattr(o, a)))
    detect_batch = detector.detect_batch

    def count_forward(*a, **kw):
        forwards[0] += 1
        return detect_batch(*a, **kw)

    run_on_list = tracker.run_on_list_of_images

    def record(frames, classes):
        out = run_on_list(frames, classes)
        runs.append(out)
        return out

    real_encode = chat_mod.encode_video
    chat_mod.encode_video = lambda path, frames, fps: videos.append(frames)
    detector.detect_batch = count_forward
    tracker.run_on_list_of_images = record
    cuts = []
    detect_scenes = scene_mod.detect_scenes

    def record_cuts(*a, **kw):
        out = detect_scenes(*a, **kw)
        cuts.append(out)
        return out

    scene_mod.detect_scenes = record_cuts
    clip = grounding_clip(100, 480, 832)
    try:
        chat = PGVideoLLaVA(engine, tracker, tagger, matcher,
                            temperature=0.0,
                            max_output_tokens=MAX_NEW_TOKENS,
                            generator=torch.Generator(
                                device=dev).manual_seed(0))
        out_dir = tempfile.mkdtemp()

        def answer(frames):
            chat.clear_history()
            chat.upload_frames(frames)
            chat.add_text(QUESTION, None)
            return chat.answer(output_dir=out_dir)

        answer(clip[:10])  # warm-up
        torch.cuda.synchronize()
        stats.clear()
        runs.clear()
        videos.clear()
        forwards[0] = 0
        torch.cuda.reset_peak_memory_stats()
        cuda_lib.reset_launch_counts()
        t = time.perf_counter()
        text, path, _, match_state = answer(clip)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        launches = dict(cuda_lib.LAUNCHES)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        scenes = len(runs)
        n_frames = sum(len(r) for r in runs)
        masked = sum(int(fr.masks.any()) for r in runs for fr in r)
        print(f"grounded answer: {len(text)} chars, tags -> match_state "
              f"{match_state}, {scenes} scene(s), {n_frames} tracked "
              f"frames, {masked} with a non-empty mask, output {path}")
        print("grounded answer stages (s): " + ", ".join(
            f"{k} {v:.3f}" for k, v in stats.items())
            + f"; whole answer {wall:.3f} (the rest "
            f"{wall - sum(stats.values()):.3f})")
        print(f"grounded answer launches: {launches} ({forwards[0]} "
              f"detector forwards); peak device memory {peak:.2f} GiB")
        if not (videos and len(videos[0]) == 100 and n_frames == 100):
            raise AssertionError("the grounded answer did not annotate the "
                                 "100 frames")
        if masked == 0:
            raise AssertionError("the grounded answer's masks are all empty")
        shapes = {fr.masks.shape for r in runs for fr in r}
        if shapes != {(tracker.tracker_cfg.max_objects, 480, 832)}:
            raise AssertionError(f"mask shapes {shapes}")
        # a detection every 5 frames, 4 detection frames a forward
        want_forwards = sum(-(-(-(-len(r) // 5)) // 4) for r in runs)
        if (launches.get(name, 0) != 12 * forwards[0]
                or forwards[0] != want_forwards):
            raise AssertionError(f"{name} launched {launches.get(name)} "
                                 f"times over {forwards[0]} forwards")
        t = time.perf_counter()
        # the profiled pass reuses the counted run's scene cuts: the host's
        # scene detection (numpy, ~10 s over these 100 frames, no device
        # activity) runs in the counted answer only
        scene_mod.detect_scenes = lambda *a, **kw: list(cuts[-1])
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            answer(clip)
            torch.cuda.synchronize()
        scene_mod.detect_scenes = record_cuts
        spans = [(e.name(), e.start_ns(), e.end_ns())
                 for e in prof.profiler.kineto_results.events()
                 if e.device_type() == DeviceType.CUDA]
        if not spans:
            raise AssertionError("grounding profile: no device activity")
        busy_ms, by_name = busy_and_names(spans)
        print(f"grounded answer profile: device busy {busy_ms:.1f} ms over "
              f"{len(spans)} device activities, wall {wall * 1e3:.1f} ms "
              f"(unprofiled run), idle share {1 - busy_ms / (wall * 1e3):.3f}"
              f" (profiled pass {time.perf_counter() - t:.2f} s)")
        for i, (name_, (total, calls)) in enumerate(sorted(
                by_name.items(), key=lambda kv: -kv[1][0])):
            if i < 12 or port_kernel(name_):
                print(f"grounded profile: {total / 1e3:9.2f} ms {calls:6d} "
                      f"calls  {name_[:90]}")
        runs.clear()
        demo_phase(engine, tracker, tagger, matcher, stats, runs, dev)
        gdino_profile(detector)
    finally:
        chat_mod.encode_video = real_encode
        for o, a, fn in saved:
            setattr(o, a, fn)
        tracker.run_on_list_of_images = run_on_list
    del tracker, tagger, matcher, chat
    gc.collect()
    torch.cuda.empty_cache()
    print(f"grounding phase: {time.perf_counter() - t0:.2f} s", flush=True)
    return launches[name]



DEMO_FRAMES = 24
DEMO_PATH = ("flash_attention_bhsd", "spatio_temporal_pool",
             "decode_attention_stacked", "w4a8_matvec", "w4a8_block",
             "multi_scale_deformable_attention")


def demo_phase(engine, tracker, tagger, matcher, stats, runs, dev) -> dict:
    """scripts/qualitative_demo.run_demo on the grounding phase's engine
    and stack (its stage timers and run recorder still in place) over a
    seeded DEMO_FRAMES-frame 480 x 832 clip and its 224 px resize (what
    media/loader's load_video and load_video_native_size give the demo;
    no libav here), greedy, MAX_NEW_TOKENS new tokens: the stage seconds,
    the classes, the masks a frame and the launches of kernels 1, 2, 3,
    A, B and 12, each of which must launch; the annotated frames must be
    (DEMO_FRAMES, 480, 832, 3) uint8."""
    native = grounding_clip(DEMO_FRAMES, 480, 832, seed=1)
    frames = F.interpolate(
        torch.from_numpy(native).permute(0, 3, 1, 2).float(), size=(224, 224),
        mode="bilinear", antialias=True, align_corners=False)
    frames = frames.round().clamp(0, 255).to(torch.uint8).permute(
        0, 2, 3, 1).contiguous().numpy()
    gen = engine.gen
    engine.gen = dataclasses.replace(gen, do_sample=False,
                                     max_new_tokens=MAX_NEW_TOKENS)
    engine.infer = timed(stats, "llm", engine.infer)
    try:
        stats.clear()
        torch.cuda.synchronize()
        cuda_lib.reset_launch_counts()
        t = time.perf_counter()
        answer, classes, annotated = qualitative_demo.run_demo(
            engine, tracker, tagger, matcher, frames, native, QUESTION)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        launches = dict(cuda_lib.LAUNCHES)
    finally:
        engine.gen = gen
        del engine.infer  # the class's method again
    out = np.stack(annotated) if annotated else np.zeros((0,), np.uint8)
    if out.shape != (DEMO_FRAMES, 480, 832, 3) or out.dtype != np.uint8:
        raise AssertionError(f"demo: annotated frames {out.shape} "
                             f"{out.dtype}")
    masks = [int(np.asarray(fr.masks).reshape(len(fr.masks), -1).any(1)
                 .sum()) for r in runs for fr in r]
    missing = [k for k in DEMO_PATH if not launches.get(k)]
    print(f"qualitative demo over {DEMO_FRAMES} frames of 480 x 832: wall "
          f"{wall:.3f} s; stages (s): " + ", ".join(
              f"{k} {v:.3f}" for k, v in sorted(stats.items()))
          + f"; answer {len(answer)} chars, classes {classes}, {len(runs)} "
          f"scene(s), masks a frame {masks}; annotated {out.shape} "
          f"{out.dtype}; launches {launches}", flush=True)
    if missing:
        raise AssertionError(f"demo: kernels never launched: {missing}")
    return launches


def gdino_profile(detector) -> dict:
    """scripts/profile_gdino.run on the grounding stack's detector
    (GroundingDINO Swin-T at 800 px, random weights, f32) at batch 4: the
    stage prefixes' cumulative and delta ms; the whole forward's output
    (stage None) must equal the detector's forward on the same inputs
    bit for bit."""
    t = time.perf_counter()
    out, full = profile_gdino.run(
        detector, batch=4, iters=3,
        print_fn=lambda s: print(f"profile_gdino: {s}", flush=True))
    args = profile_gdino.device_args(detector, 4)
    with torch.inference_mode():
        ref = gdino.forward(detector.params, detector.cfg, args[0],
                            args[1].cpu().numpy())
    if not all(torch.equal(a, b) for a, b in zip(full, ref)):
        raise AssertionError("profile_gdino: stage None differs from the "
                             "detector's forward")
    print(f"profile_gdino: stage None equal to the forward bit for bit; "
          f"{time.perf_counter() - t:.2f} s", flush=True)
    return out


# -- grounding from released checkpoints, and the sIoU evaluation ------------

# BASELINE config 5's harness: the stack from checkpoints written here in
# the released layouts from seeded weights (no released file is on this
# machine), then evaluate_dataset over VidSTG and HC-STVG samples made from
# synthetic annotations with seeded frames.
GEVAL_HW = (360, 640)  # the datasets' frames (the videos' 640 x 360)
GEVAL_RAM_SWIN = dict(image_size=384, window_size=12)  # RAM's Swin-L at 384
GEVAL_SMALL_TOL = 1e-4  # card f32 vs CPU f32: SAM ViT and RAM, of max|ref|
GEVAL_DETECTOR_TOL = 1e-3  # kernel 12 vs plain over a whole detector


def tree_leaves(tree, path=""):
    """[(path, tensor)] of a nested dict / list tree."""
    if isinstance(tree, dict):
        return [x for k, v in tree.items()
                for x in tree_leaves(v, f"{path}.{k}" if path else k)]
    if isinstance(tree, (list, tuple)):
        return [x for i, v in enumerate(tree)
                for x in tree_leaves(v, f"{path}.{i}")]
    return [(path, tree)]


def trees_equal(label, want, got) -> int:
    """Every leaf of `got` equal to `want`'s bit for bit (same paths and
    shapes); -> the leaf count."""
    a, b = dict(tree_leaves(want)), dict(tree_leaves(got))
    if set(a) != set(b):
        raise AssertionError(f"{label}: paths differ: "
                             f"{sorted(set(a) ^ set(b))[:8]}")
    for path, x in a.items():
        y = b[path]
        if x.shape != y.shape or not torch.equal(x.cpu(), y.cpu()):
            raise AssertionError(f"{label}: {path} differs")
    return len(a)


def grounding_ckpt_configs() -> dict:
    """The released models' configurations (write_grounding_checkpoints
    writes these; a smaller set runs the same code on a CPU)."""
    from video_llava_tpu_torch.models import ram as ram_mod
    from video_llava_tpu_torch.models import sam as sam_mod
    from video_llava_tpu_torch.models import swin as swin_mod
    from video_llava_tpu_torch.models import tiny_vit as tv

    tiny = tv.TinyViTConfig()
    return dict(
        dino=gdino.GroundingDinoConfig(), sam=sam_mod.SamConfig(), tiny=tiny,
        mobile=sam_mod.SamConfig(vision=dataclasses.replace(
            sam_mod.SamConfig().vision, image_size=tiny.image_size)),
        ram_swin=dataclasses.replace(swin_mod.SwinConfig.swin_l(),
                                     **GEVAL_RAM_SWIN),
        ram=ram_mod.RamConfig(), vocab=30522)


def write_grounding_checkpoints(root: str, cfgs=None) -> dict:
    """Seeded weights drawn on the CPU and written under `root` in the
    released layouts (grounding/synthetic's writers): GroundingDINO
    Swin-T as the original repo's .pth beside a vocab.txt directory, SAM
    ViT-B (1024 px, 12 layers of 768, windows of 14, global layers 2, 5,
    8, 11) as an HF directory (model.safetensors), MobileSAM as the
    official mobile_sam.pt, RAM Swin-L at 384 px (window 12) with 4,585
    tags, width 512 and 2 decoder layers as ram_swin_large_14m.pth, with
    ram_tag_list.txt and its thresholds. -> the paths and the seeded
    trees (what each converted leaf must equal)."""
    from video_llava_tpu_torch.grounding import synthetic
    from video_llava_tpu_torch.models import ram as ram_mod
    from video_llava_tpu_torch.models import sam as sam_mod
    from video_llava_tpu_torch.models import swin as swin_mod
    from video_llava_tpu_torch.models import tiny_vit as tv

    cfgs = cfgs or grounding_ckpt_configs()
    out = {"root": root}
    t = time.perf_counter()
    dcfg = cfgs["dino"]
    out["dino"] = gdino.init_params(TreeInit(20, "cpu"), dcfg)
    out["dino_path"] = os.path.join(root, "groundingdino_swint_ogc.pth")
    torch.save({"model": synthetic.gdino_original_state(out["dino"], dcfg)},
               out["dino_path"])
    out["vocab_dir"] = synthetic.write_bert_vocab(os.path.join(root, "bert"),
                                                  cfgs["vocab"])

    scfg = cfgs["sam"]
    out["sam"] = {"vision": sam_mod.init_vision_params(TreeInit(21, "cpu"),
                                                       scfg.vision),
                  **sam_mod.init_decoder_params(TreeInit(22, "cpu"), scfg)}
    out["sam_dir"] = os.path.join(root, "sam-vit-base")
    os.makedirs(out["sam_dir"])
    weights_mod.save_safetensors(
        os.path.join(out["sam_dir"], "model.safetensors"),
                      list(synthetic.sam_hf_state(out["sam"], scfg).items()))

    tcfg, mcfg = cfgs["tiny"], cfgs["mobile"]
    out["mobile"] = {"vision": tv.init_params(TreeInit(23, "cpu"), tcfg),
                     **sam_mod.init_decoder_params(TreeInit(24, "cpu"),
                                                   mcfg)}
    out["mobile_path"] = os.path.join(root, "mobile_sam.pt")
    torch.save(synthetic.mobile_sam_state(out["mobile"], tcfg),
               out["mobile_path"])

    rswin, rcfg = cfgs["ram_swin"], cfgs["ram"]
    init = TreeInit(25, "cpu")
    out["ram_backbone"] = swin_mod.init_params(init, rswin)
    raw = ram_mod.init_params(init, rcfg, rswin.num_features)
    # raw label embeddings of unit scale, as the release's text embeddings
    # are before wordvec_proj: init_params' 0.02 would fold to near-equal
    # queries, every tag's logit alike
    raw["label_embeddings"] = init.normal((rcfg.num_tags, rcfg.hidden_size))
    wordvec = {"kernel": init.normal((rcfg.hidden_size, rcfg.hidden_size),
                                     rcfg.hidden_size ** -0.5),
               "bias": init.normal((rcfg.hidden_size,), 0.02)}
    rng = np.random.default_rng(25)
    sd = synthetic.ram_state(out["ram_backbone"], raw, rswin, wordvec,
                             rng.uniform(0.5, 0.9, rcfg.num_tags))
    # the converter folds relu(label_embed @ wordvec_proj^T + b) on the host
    folded = np.maximum(sd["label_embed"].numpy()
                        @ sd["wordvec_proj.weight"].numpy().T
                        + sd["wordvec_proj.bias"].numpy(), 0.0)
    out["ram"] = {**raw, "label_embeddings": torch.from_numpy(folded)}
    out["ram_swin"] = rswin
    out["ram_path"] = os.path.join(root, "ram_swin_large_14m.pth")
    torch.save({"model": sd}, out["ram_path"])
    out["tags"] = [f"tag{i:04d}" for i in range(rcfg.num_tags)]
    # the file's thresholds (they override class_threshold) sit where a
    # random head's probabilities fall (0.05-0.5), so that some tags pass
    out["thresholds"] = rng.uniform(0.3, 0.6, rcfg.num_tags).astype(
        np.float32)
    out["tag_path"] = os.path.join(root, "ram_tag_list.txt")
    out["threshold_path"] = os.path.join(root,
                                         "ram_tag_list_threshold.txt")
    with open(out["tag_path"], "w") as f:
        f.write("\n".join(out["tags"]) + "\n")
    with open(out["threshold_path"], "w") as f:
        f.write("\n".join(repr(float(v)) for v in out["thresholds"]) + "\n")
    sizes = {k: os.path.getsize(out[k]) for k in ("dino_path", "mobile_path",
                                                   "ram_path")}
    sizes["sam_dir"] = os.path.getsize(os.path.join(out["sam_dir"],
                                                    "model.safetensors"))
    print("grounding checkpoints written (seeded, on the CPU) in "
          f"{time.perf_counter() - t:.2f} s: " + ", ".join(
              f"{os.path.basename(out[k].rstrip('/'))} {v / 2 ** 20:.1f} MiB"
              for k, v in sizes.items()), flush=True)
    return out


def grounding_small_checks(dev) -> None:
    """SAM's ViT encoder (256 px, 4 layers of 192, windows of 4, two
    global layers) and RAM's tag_logits (the tiny Swin, 64 tags of 32)
    on the card in f32 against the same weights on the CPU, within
    GEVAL_SMALL_TOL of max|ref|."""
    from video_llava_tpu_torch.models import ram as ram_mod
    from video_llava_tpu_torch.models import sam as sam_mod
    from video_llava_tpu_torch.models import swin as swin_mod

    rng = np.random.default_rng(3)
    vcfg = sam_mod.SamVisionConfig(image_size=256, hidden_size=192,
                                   num_layers=4, num_heads=3, mlp_dim=768,
                                   window_size=4, global_attn_indexes=(1, 3),
                                   output_channels=64)
    vp = sam_mod.init_vision_params(TreeInit(30, "cpu"), vcfg)
    px = torch.from_numpy(rng.normal(size=(2, 256, 256, 3)).astype(
        np.float32))
    scfg = swin_mod.SwinConfig.tiny_test()
    rcfg = ram_mod.RamConfig(num_tags=64, hidden_size=32, num_heads=4,
                             decoder_layers=2, intermediate_size=64)
    init = TreeInit(31, "cpu")
    bp = swin_mod.init_params(init, scfg)
    rp = ram_mod.init_params(init, rcfg, scfg.num_features)
    rpx = torch.from_numpy(rng.normal(size=(3, 64, 64, 3)).astype(np.float32))
    with torch.inference_mode():
        pairs = (
            ("SAM ViT encoder (2, 256, 256) -> (2, 16, 16, 64)",
             sam_mod.vision_encoder(tree_to(vp, dev), px.to(dev), vcfg),
             sam_mod.vision_encoder(vp, px, vcfg)),
            ("RAM tag_logits (3, 64, 64) -> (3, 64)",
             ram_mod.tag_logits(tree_to(bp, dev), tree_to(rp, dev),
                                rpx.to(dev), scfg, rcfg),
             ram_mod.tag_logits(bp, rp, rpx, scfg, rcfg)))
        for label, got, want in pairs:
            rel = ((got.cpu() - want).abs().max() / want.abs().max()).item()
            print(f"{label}: f32 card vs CPU max|err| / max|ref| = "
                  f"{rel:.3e} (limit {GEVAL_SMALL_TOL})", flush=True)
            if not rel <= GEVAL_SMALL_TOL:
                raise AssertionError(f"{label}: {rel}")


def detector_kernel_check(detector, dev) -> None:
    """One 800 px detector forward of the converted GroundingDINO through
    kernel 12 (12 launches) against the same forward on the plain
    versions (deformable.set_default_impl('xla'): no launch): logits
    and boxes within GEVAL_DETECTOR_TOL of their scale."""
    rng = np.random.default_rng(4)
    frame = torch.from_numpy(rng.integers(0, 256, (1,) + GEVAL_HW + (3,),
                                          dtype=np.uint8)).to(dev)
    ids = np.asarray([detector.tokenize("adult . dog .")])
    outs = []
    for impl in ("auto", "xla"):
        deformable.set_default_impl(impl)
        cuda_lib.reset_launch_counts()
        try:
            with torch.inference_mode():
                outs.append(gdino.forward(detector.params, detector.cfg,
                                          detector._preprocess(frame), ids))
            torch.cuda.synchronize()
        finally:
            deformable.set_default_impl("auto")
        outs[-1] += (cuda_lib.LAUNCHES["multi_scale_deformable_attention"],)
    (logits, boxes, n), (p_logits, p_boxes, p_n) = outs
    if n != 12 or p_n != 0:
        raise AssertionError(f"detector forward launched kernel 12 {n} "
                             f"times, its plain run {p_n}")
    fin = torch.isfinite(p_logits)
    if not torch.equal(torch.isfinite(logits), fin):
        raise AssertionError("detector: finite logits differ")
    for label, a, b in (("logits", logits[fin], p_logits[fin]),
                        ("boxes", boxes, p_boxes)):
        rel = ((a - b).abs().max() / b.abs().max()).item()
        print(f"converted GroundingDINO at 800 px, kernel 12 vs plain: "
              f"{label} {tuple(b.shape)} max|err| / max|ref| = {rel:.3e} "
              f"(limit {GEVAL_DETECTOR_TOL}); launches {n} vs {p_n}",
              flush=True)
        if not rel <= GEVAL_DETECTOR_TOL:
            raise AssertionError(f"detector {label}: {rel}")


class AnnotatorStub:
    """The referring-expression annotator's OpenAI-compatible client,
    answered here (the reference calls a FastChat server; this machine
    has no network): a well-formed {'OBJECT': ...} for the first and
    third requests, text that is no dictionary for the second (the
    expression falls back to the question)."""

    def __init__(self):
        self.calls = 0

    def chat_text(self, model, messages, **kw):
        self.calls += 1
        if self.calls == 2:
            return "The person next to the dog, I think."
        return "{'OBJECT': 'adult'}" if self.calls == 1 else \
            "{'OBJECT': 'man'}"


def grounding_datasets(root: str):
    """Synthetic VidOR / VidSTG and HC-STVG annotations through
    preprocess_grounding_annotations, then (VidSTGDataset test split,
    HCSTVGDataset) over its output."""
    from video_llava_tpu_torch.datasets import grounding_datasets as gds
    from video_llava_tpu_torch.grounding import synthetic
    from video_llava_tpu_torch.scripts import (
        preprocess_grounding_annotations as pre,
    )

    vidor, vidstg = os.path.join(root, "vidor"), os.path.join(root, "vidstg")
    hc_videos, hc_ann = (os.path.join(root, "hcstvg_videos"),
                         os.path.join(root, "hcstvg_ann"))
    synthetic.write_vidstg_annotations(vidor, vidstg, n_videos=2,
                                       frames=600, hw=GEVAL_HW)
    synthetic.write_hcstvg_annotations(hc_videos, hc_ann, n_videos=1,
                                       frames=500, hw=GEVAL_HW)
    pre.main(["vidstg", "--vidor_annotations_dir", vidor,
              "--vidstg_annotations_dir", vidstg])
    pre.main(["hcstvg", "--video_dir", hc_videos, "--ann_dir", hc_ann])
    return (gds.VidSTGDataset(vidstg, os.path.join(root, "videos"),
                              image_set="test"),
            gds.HCSTVGDataset(os.path.join(hc_ann, "val_v2_proc.json"),
                              hc_videos))


def grounding_eval_phase(engine, dev, results) -> dict:
    """BASELINE config 5 at full width on the 7B int4 engine: seeded
    checkpoints written in the released layouts and read back through
    build_grounding_stack (GroundingDINO's .pth with the vocab.txt
    directory, SAM ViT-B's HF directory, sam_variant 'vit_b'), build_sam
    (MobileSAM's mobile_sam.pt) and build_tagger (RAM), every converted
    leaf equal to the seeded one; SAM's ViT and RAM's tag_logits on the
    card against the CPU; the converted detector through kernel 12
    against its plain version; the chat CLI's --sam_variant vit_b up to
    its prompt; then evaluate_dataset over 2 VidSTG and 1 HC-STVG samples
    (preprocess_grounding_annotations over synthetic annotation files;
    grounding_datasets._decode_frames replaced by seeded frames, since
    this machine has no libav, as eval_frames stands in for load_video in
    eval_13b_phase), the answer from the engine's chat over the sample's
    frames, the annotator through AnnotatorStub; each sample's sIoU,
    m_sIoU, stage seconds (host clock around synchronized calls),
    kernel 12's launches (held to 12 a detector forward), peak memory;
    then the RAM tagger over one sample's frames. Returns kernel 12's
    launches over the evaluation."""
    from video_llava_tpu_torch.datasets import grounding_datasets as gds
    from video_llava_tpu_torch.grounding import eval_grounding
    from video_llava_tpu_torch.grounding.builders import build_tagger
    from video_llava_tpu_torch.grounding.synthetic import seeded_frames
    from video_llava_tpu_torch.grounding.tagging import get_unique_tags

    name = "multi_scale_deformable_attention"
    t0 = time.perf_counter()
    root = tempfile.mkdtemp(prefix="vlt_geval_")
    real_decode = gds._decode_frames
    try:
        ck = write_grounding_checkpoints(root)
        t = time.perf_counter()
        tracker, _, _ = build_grounding_stack(
            dino_checkpoint=ck["dino_path"], sam_checkpoint=ck["sam_dir"],
            sam_variant="vit_b", device=dev, tokenizer_name=ck["vocab_dir"])
        mobile = build_sam(ck["mobile_path"], variant="mobile", device=dev)
        tagger = build_tagger(ram_checkpoint=ck["ram_path"],
                              tag_list_path=ck["tag_path"],
                              threshold_path=ck["threshold_path"],
                              device=dev)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t
        counts = {
            "GroundingDINO (.pth)": trees_equal(
                "GroundingDINO", ck["dino"], tracker.detector.params),
            "SAM ViT-B (HF)": trees_equal("SAM ViT-B", ck["sam"],
                                          tracker.segmenter.params),
            "MobileSAM (mobile_sam.pt)": trees_equal(
                "MobileSAM", ck["mobile"], mobile.params),
            "RAM Swin-L": trees_equal("RAM backbone", ck["ram_backbone"],
                                      tagger.backbone_params),
            "RAM decoder": trees_equal("RAM decoder", ck["ram"],
                                       tagger.head_params)}
        if tagger.cfg.window_size != 12 or tagger.tag_list != ck["tags"]:
            raise AssertionError("RAM tagger: window or tags not read")
        if not np.array_equal(tagger.threshold, ck["thresholds"]):
            raise AssertionError("RAM tagger: thresholds not read")
        if tracker.detector.tokenize("a dog .")[-2:] != [1012, 102]:
            raise AssertionError("the BERT tokenizer's ids")
        print(f"released-layout round trips, read onto the card in "
              f"{load_s:.2f} s: every converted leaf equal to the seeded "
              "one (" + ", ".join(f"{k} {v} leaves" for k, v in
                                  counts.items())
              + f"); RAM: window {tagger.cfg.window_size}, "
              f"{len(tagger.tag_list)} tags, thresholds from the file",
              flush=True)
        del mobile, ck
        gc.collect()
        grounding_small_checks(dev)
        detector_kernel_check(tracker.detector, dev)

        # the chat CLI's --sam_variant vit_b builds the stack and reaches
        # its prompt (no input here: the REPL quits at the first read)
        t = time.perf_counter()
        real_input = builtins.input

        def no_input(*a):
            raise EOFError

        builtins.input = no_input
        try:
            chat_mod.main(["--model_size", "7b", "--quant", "int4",
                           "--with_grounding", "--sam_variant", "vit_b"])
        finally:
            builtins.input = real_input
        gc.collect()
        torch.cuda.empty_cache()
        print(f"chat CLI --with_grounding --sam_variant vit_b: built and "
              f"reached its prompt in {time.perf_counter() - t:.2f} s",
              flush=True)

        vidstg, hcstvg = grounding_datasets(root)
        gds._decode_frames = lambda path, ids: seeded_frames(path, ids,
                                                             GEVAL_HW)
        print(f"grounding datasets: VidSTG test {len(vidstg)} query-videos, "
              f"HC-STVG val {len(hcstvg)} (frames from seeded_frames: no "
              "libav on this machine)", flush=True)

        stats: dict = {}
        forwards = [0]
        det, seg = tracker.detector, tracker.segmenter
        patched = [(det, "detect_batch", "detection"),
                   (seg, "_encode", "sam_vit_b_encode"),
                   (seg, "decode_masks_batch_device", "sam"),
                   (fused_clip, "run_clip_fused_stm", "propagation")]
        saved = [(o, a, getattr(o, a)) for o, a, _ in patched]
        for o, a, stage in patched:
            setattr(o, a, timed(stats, stage, getattr(o, a)))
        counted = det.detect_batch

        def count_forward(*a, **kw):
            forwards[0] += 1
            return counted(*a, **kw)

        det.detect_batch = count_forward
        chat = VideoChatGPTInterface(
            engine, temperature=0.0, max_output_tokens=32,
            generator=torch.Generator(device=dev).manual_seed(0))

        def infer_answer(frames, question):
            chat.clear_history()
            chat.upload_frames(frames)
            chat.add_text(question, None)
            return chat.answer()

        infer_answer = timed(stats, "llm", infer_answer)
        client = AnnotatorStub()
        try:
            # warm-up on one sample's first 10 frames (the same shapes)
            warm = vidstg[0]
            tracker.run_on_list_of_images(list(warm.frames[:10]), ["adult"])
            infer_answer(warm.frames[:10], warm.caption)
            torch.cuda.synchronize()
            stats.clear()
            forwards[0] = 0
            torch.cuda.reset_peak_memory_stats()
            cuda_lib.reset_launch_counts()
            t = time.perf_counter()
            evals = [eval_grounding.evaluate_dataset(
                ds, tracker, infer_answer=infer_answer, client=client,
                output_dir=os.path.join(root, "out", label), max_samples=n)
                for label, ds, n in (("vidstg", vidstg, 2),
                                     ("hcstvg", hcstvg, 1))]
            torch.cuda.synchronize()
            wall = time.perf_counter() - t
            launches = dict(cuda_lib.LAUNCHES)
            peak = torch.cuda.max_memory_allocated() / 2 ** 30
        finally:
            for o, a, fn in saved:
                setattr(o, a, fn)
        per = [s for e in evals for s in e["per_sample"]]
        if len(per) != 3 or [e["num_samples"] for e in evals] != [2, 1]:
            raise AssertionError(f"evaluate_dataset scored {len(per)} "
                                 "samples of 3")
        sious = [s["sIoU"] for s in per]
        if not all(np.isfinite(sious)) or not all(0 <= v <= 1 for v in
                                                  sious):
            raise AssertionError(f"sIoU values {sious}")
        exprs = [s["referring_expression"] for s in per]
        if exprs[0] != "adult" or exprs[1] != per[1]["caption"]:
            raise AssertionError(f"referring expressions {exprs}")
        frames_seen = [len(vidstg[0].frame_ids), len(vidstg[1].frame_ids),
                       len(hcstvg[0].frame_ids)]
        want = sum(-(-(-(-n // 5)) // 4) for n in frames_seen)
        if (launches.get(name, 0) != 12 * forwards[0]
                or forwards[0] != want):
            raise AssertionError(f"{name} launched {launches.get(name)} "
                                 f"times over {forwards[0]} detector "
                                 f"forwards ({want} expected)")
        m_siou = float(np.mean(sious))
        for s, n in zip(per, frames_seen):
            print(f"grounding eval sample {s['video_id']}: {n} frames, "
                  f"question {s['caption']!r}, answer {len(s['answer'] or '')}"
                  f" chars, expression {s['referring_expression']!r}, sIoU "
                  f"{s['sIoU']:.6f}", flush=True)
        print(f"grounding eval: m_sIoU {m_siou:.6f} over {len(per)} samples "
              f"(VidSTG {evals[0]['m_sIoU']:.6f} over 2, HC-STVG "
              f"{evals[1]['m_sIoU']:.6f} over 1; random weights: not a "
              f"quality figure); wall {wall:.3f} s; stages (s): " + ", ".join(
                  f"{k} {v:.3f}" for k, v in sorted(stats.items()))
              + f" (sam_vit_b_encode inside sam); {forwards[0]} detector "
              f"forwards, kernel 12 launches {launches.get(name, 0)}; "
              f"launches {launches}; peak device memory {peak:.2f} GiB "
              f"[{card_line()}]", flush=True)

        # the RAM tagger over the HC-STVG sample's frames
        frames = hcstvg[0].frames
        torch.cuda.synchronize()
        t = time.perf_counter()
        torch.cuda.reset_peak_memory_stats()
        per_frame = tagger.run_on_frames_raw(frames, batch_size=10)
        torch.cuda.synchronize()
        tag_s = time.perf_counter() - t
        tag_peak = torch.cuda.max_memory_allocated() / 2 ** 30
        if len(per_frame) != len(frames):
            raise AssertionError("RAM tagger: a row a frame")
        top = get_unique_tags(per_frame)[:10]
        print(f"RAM tagger (Swin-L 384 px, 4,585 tags) over "
              f"{len(frames)} frames: {tag_s:.3f} s, "
              f"{sum(map(len, per_frame))} tags over their thresholds, top "
              f"{top}; peak device memory {tag_peak:.2f} GiB [{card_line()}]",
              flush=True)
        results[name]["grounding_eval"] = dict(
            launches=launches.get(name, 0), detector_forwards=forwards[0],
            m_sIoU=m_siou, per_sample_sIoU=sious, wall_s=wall,
            stages_s=dict(stats), ram_tagging_s=tag_s, peak_gib=peak)
    finally:
        gds._decode_frames = real_decode
        shutil.rmtree(root, ignore_errors=True)
    del tracker, tagger
    gc.collect()
    torch.cuda.empty_cache()
    print(f"grounding eval phase: {time.perf_counter() - t0:.2f} s "
          f"[{card_line()}]", flush=True)
    return launches


# -- audio ------------------------------------------------------------------

# Kernel 7 at the audio path's (b, s, h, d), non-causal: the Whisper
# large-v2 encoder over two 30 s chunks, then the TL-TR head over 60 s:
# its time transformer (32 layers x 2 chunks x 3 windows of 25 pooled
# tokens) and its layer transformer (6 windows of 32 layer tokens).
AUDIO_FLASH_SHAPES = ((2, 1500, 20, 64), (192, 25, 4, 128), (6, 32, 4, 128))
AUDIO_SECONDS, AUDIO_NEW_TOKENS = 60, 112  # bench.py's audio stack
# The small audio stack, bf16 on the card against f32 on the CPU with the
# same (bf16-valued) weights: every output within 2^-4 of its max |ref|
# at most and 2^-6 of its mean |ref| on average (bf16 activations through
# 2 layers of 64 wide, P rounded to bf16 in kernel 7). Decoder: at each
# greedy step of the card, the CPU's f32 logit of the token it chose
# within SMALL_AUDIO_MARGIN of the CPU's best.
SMALL_AUDIO_TOL = (2 ** -4, 2 ** -6)
SMALL_AUDIO_MARGIN = 0.25


def bench_wave(seconds: float = AUDIO_SECONDS):
    """bench.py's synthetic waveform as its 16-bit WAV holds it, read
    back as float32 PCM (no noise)."""
    return speech_wave(seconds, noise=0.0, pcm16=True)


def audio_flash_checks(dev) -> list:
    """Kernel 7 at AUDIO_FLASH_SHAPES against its plain forward (the
    training check's limits: absolute, per (row, head) and lse), timed
    beside the plain forward, SDPA and the bound (bytes of q, k, v, out
    and lse; operations of the two products over every pair). Returns a
    record per shape for the kernels line."""
    g = torch.Generator(device=dev).manual_seed(5)
    out_rows = []
    for b, s, h, d in AUDIO_FLASH_SHAPES:
        q, k, v = (torch.randn(b, s, h, d, generator=g, device=dev).to(
            torch.bfloat16) for _ in range(3))
        out, lse = attention.flash_forward(q, k, v)
        want, want_lse = attention.flash_forward_plain(q, k, v)
        err = (out.float() - want.float()).abs()
        fwd_err = err.max().item()
        row = (err.amax(-1) / want.float().abs().amax(-1)).max().item()
        lse_err = (lse - want_lse).abs().max().item()
        note = (f"max|err| {fwd_err:.3e} (tol {TOL['flash_forward']}), "
                f"(row, head) max|err|/max|ref| {row:.3e} (tol 2^-6), lse "
                f"max|err| {lse_err:.3e} (tol {FLASH_LSE_TOL})")
        if not (fwd_err <= TOL["flash_forward"] and row <= FLASH_ROW_TOL
                and lse_err <= FLASH_LSE_TOL):
            raise AssertionError(f"flash_forward audio {(b, s, h, d)}: "
                                 f"{note}")
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        ms = median_ms(lambda: attention.flash_forward(q, k, v))
        plain_ms = median_ms(lambda: attention.flash_forward_plain(q, k, v))
        lib_ms = median_ms(lambda: F.scaled_dot_product_attention(qt, kt,
                                                                  vt))
        ops = 4 * b * h * s * s * d
        bound_ms, bound_by = bound(8 * q.numel() + 4 * lse.numel(), ops)
        print(f"check flash_forward audio {(b, s, h, d)}: {note}; kernel "
              f"{ms:.4f} ms ({ops / ms * 1e-9:.1f} TFLOP/s, "
              f"{bound_ms / ms:.3f} of the bound), plain {plain_ms:.4f} ms, "
              f"library {lib_ms:.4f} ms, bound {bound_ms:.4f} ms by "
              f"{bound_by}", flush=True)
        out_rows.append({"shape": [b, s, h, d], "max_abs_err": fwd_err,
                         "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                         "bound_by": bound_by, "library_ms": lib_ms})
        del q, k, v, out, lse, want, want_lse, err, qt, kt, vt
    torch.cuda.empty_cache()
    return out_rows


# Kernel 7's f32 body (csrc/flash_attention_f32.cu) at Whisper base's
# encoder shape as the chat CLI's --use_asr transcriber gives it, one 30 s
# chunk (the main path's shape, timed first) then two; then a ragged
# causal GQA pair at d 128 and a ragged d 48. (b, sq, skv, h, h_kv, d,
# causal)
AUDIO_F32_SHAPES = ((1, 1500, 1500, 8, 8, 64, False),
                    (2, 1500, 1500, 8, 8, 64, False),
                    (2, 100, 130, 8, 2, 128, True),
                    (3, 77, 77, 4, 4, 48, False))
# f32 on both sides, every product and sum an f32 operation in another
# order: outputs (magnitude < 4) and lse within a few f32 ulps of their
# magnitude, 2e-5 absolute each. The plain version with the last key
# tile dropped must fail it (the limit is fine enough to see a tile).
F32_FLASH_TOL = 2e-5
# Kernel 8's f32 body against the plain backward: f32 on both sides, sums
# in another order (dk and dv over up to 2 x 1,500 query rows), each
# gradient within this share of its max |ref|.
F32_GRAD_TOL = 1e-5
# The CLI transcriber's encoder on the card against the same f32 weights
# on the CPU: 6 layers of width 512 in f32, cuBLAS against the CPU's sum
# orders: max|err| / max|ref| <= 1e-4.
BASE_ENCODER_TOL = 1e-4


def audio_f32_checks(dev, results) -> None:
    """Kernel 7's f32 body at AUDIO_F32_SHAPES against the plain forward
    (out and lse within F32_FLASH_TOL; a dropped last key tile in the
    plain version must fail the same check), timed beside the plain
    forward, SDPA (the causal shape through the right-aligned bool mask,
    enable_gqa where h_kv < h) and the bound: bytes of q, k, v, out and
    lse, or the body's operations, the two products over the visible
    pairs three times over (3xTF32) at the TF32 rate; the same products
    as f32 FMAs at the f32 rate printed beside it. Kept in
    results["flash_forward_f32"]."""
    g = torch.Generator(device=dev).manual_seed(6)
    for b, sq, skv, h, h_kv, d, causal in AUDIO_F32_SHAPES:
        shape = (b, sq, skv, h, h_kv, d, causal)
        q = torch.randn(b, sq, h, d, generator=g, device=dev)
        k, v = (torch.randn(b, skv, h_kv, d, generator=g, device=dev)
                for _ in range(2))
        out, lse = attention.flash_forward(q, k, v, causal)
        want, want_lse = attention.flash_forward_plain(q, k, v, causal)
        mask = attention.flash_mask(sq, skv, causal, dev)
        mask[:, (skv - 1) // 64 * 64:] = False
        dropped, _ = attention.flash_forward_masked(q, k, v, mask, d ** -0.5)
        torch.cuda.synchronize()
        if out.dtype != torch.float32 or out.shape != want.shape:
            raise AssertionError(f"flash_forward_f32 {shape}: {out.dtype} "
                                 f"{tuple(out.shape)}")
        fwd_err = (out - want).abs().max().item()
        lse_err = (lse - want_lse).abs().max().item()
        caught = (dropped - want).abs().max().item()
        note = (f"max|err| {fwd_err:.3e}, lse max|err| {lse_err:.3e} (tol "
                f"{F32_FLASH_TOL} each; the plain version without the last "
                f"key tile is off by {caught:.3e})")
        if not (fwd_err <= F32_FLASH_TOL and lse_err <= F32_FLASH_TOL
                and caught > F32_FLASH_TOL):
            raise AssertionError(f"flash_forward_f32 {shape}: {note}")
        ms = median_ms(lambda: attention.flash_forward(q, k, v, causal))
        plain_ms = median_ms(
            lambda: attention.flash_forward_plain(q, k, v, causal))
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        mask_kw = ({"attn_mask": attention.flash_mask(sq, skv, True, dev)}
                   if causal else {})
        lib_ms = median_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, enable_gqa=h_kv < h, **mask_kw))
        ops = 4 * b * h * visible_pairs(sq, skv, causal) * d
        nbytes = 4 * (2 * q.numel() + k.numel() + v.numel() + lse.numel())
        bound_ms, bound_by = record(results, "flash_forward_f32", fwd_err,
                                    ms, plain_ms, lib_ms, nbytes, 3 * ops,
                                    TF32_PEAK)
        fma_ms, _ = bound(nbytes, ops, F32_PEAK)
        print(f"check flash_forward_f32 {shape}: {note}; kernel {ms:.4f} ms "
              f"({ops / ms * 1e-9:.1f} TFLOP/s of the products, "
              f"{bound_ms / ms:.3f} of the bound), plain {plain_ms:.4f} ms, "
              f"library {lib_ms:.4f} ms, bound {bound_ms:.4f} ms by "
              f"{bound_by} (3xTF32 at {TF32_PEAK * 1e-12:.0f} TFLOP/s; as "
              f"f32 FMAs at {F32_PEAK * 1e-12:.0f} TFLOP/s {fma_ms:.4f} ms)",
              flush=True)
        del q, k, v, out, lse, want, want_lse, dropped, mask, qt, kt, vt
    torch.cuda.empty_cache()


def base_transcriber_run(dev) -> int:
    """The chat CLI's --use_asr transcriber, build_default_transcriber()
    (Whisper base, f32), over 5 s: the launch counts set to 0 just before
    and read just after (kernel 7's f32 body once an encoder layer, no
    other kernel), and its encoder states held against the same weights
    on the CPU (BASE_ENCODER_TOL). Returns the f32 body's launches."""
    t = time.perf_counter()
    base = build_default_transcriber(device=dev)
    seen = {}

    encode_fn = whisper_mod.encode

    def encode(params, mel, cfg, *a, **kw):
        seen["mel"] = mel
        seen["out"] = encode_fn(params, mel, cfg, *a, **kw)
        return seen["out"]

    whisper_mod.encode = encode
    try:
        cuda_lib.reset_launch_counts()
        segs = base.transcribe_audio(bench_wave(5))
        torch.cuda.synchronize()
        counts = dict(cuda_lib.LAUNCHES)
    finally:
        whisper_mod.encode = encode_fn
    wall = time.perf_counter() - t
    n = counts.get("flash_forward_f32", 0)
    if counts != {"flash_forward_f32": base.cfg.encoder_layers} or len(
            segs) != 1:
        raise AssertionError(f"the f32 base transcriber: launches {counts}, "
                             f"{len(segs)} segments")
    with torch.inference_mode():
        ref = whisper_mod.encode(tree_to(base.params, "cpu"),
                                 seen["mel"].cpu(), base.cfg)
    mx, mean = rel_errs(seen["out"], ref)
    print(f"build_default_transcriber() (Whisper base, f32): 5 s "
          f"transcribed in {wall:.2f} s (build included), {len(segs)} "
          f"segment, launches {counts} (kernel 7's f32 body, one an encoder "
          f"layer); encoder states {tuple(seen['out'].shape)} "
          f"{seen['out'].dtype} vs the CPU: max|err|/max|ref| {mx:.3e} (tol "
          f"{BASE_ENCODER_TOL}), mean|err|/mean|ref| {mean:.3e}", flush=True)
    if not (bool(torch.isfinite(seen["out"]).all()) and mx
            <= BASE_ENCODER_TOL):
        raise AssertionError(f"the f32 base encoder: {mx}")
    del base, seen
    torch.cuda.empty_cache()
    return n


def rel_errs(got, want):
    """(max|err| / max|ref|, mean|err| / mean|ref|) of got against the
    f32 CPU reference."""
    err = (got.float().cpu() - want).abs()
    return ((err.max() / want.abs().max()).item(),
            (err.mean() / want.abs().mean()).item())


def small_audio_check(dev) -> None:
    """The tiny Whisper (head dim 16), TL-TR head and wav2vec2 in bf16 on
    the card against the same weights in f32 on the CPU: encoder states
    (kernel 7 in every encoder layer), windowed TL-TR logits (kernel 7 in
    both blocks), the greedy decode (see SMALL_AUDIO_MARGIN) and the
    aligner's emissions (wav2vec2 computes in the audio's f32)."""
    wcfg, atc = whisper_mod.WhisperConfig.tiny_test(), \
        whisper_mod.WhisperATConfig.tiny_test()
    w2cfg = w2v.Wav2Vec2Config.tiny_test()
    init = TreeInit(3, "cpu", torch.bfloat16)
    trees = {"whisper": {**whisper_mod.init_params(init, wcfg),
                         "at_head": whisper_mod.init_at_head_tltr(init, atc)},
             "w2v": w2v.init_params(init, w2cfg)}
    cpu = {k: tree_to(v, torch.float32) for k, v in trees.items()}
    card = {k: tree_to(v, dev) for k, v in trees.items()}
    rng = np.random.default_rng(2)
    mel = torch.from_numpy(rng.normal(size=(2, 80, 3000)).astype(np.float32))
    wave = torch.from_numpy(bench_wave(3))
    before = cuda_lib.LAUNCHES["flash_forward"]
    with torch.inference_mode():
        ref, ref_states = whisper_mod.encode(cpu["whisper"], mel, wcfg, True)
        got, states = whisper_mod.encode(card["whisper"],
                                         mel.to(dev, torch.bfloat16), wcfg,
                                         True)
        ref_tags = whisper_mod.audio_tag_logits_tltr(
            cpu["whisper"]["at_head"], ref_states, atc, window_tokens=25)
        tags = whisper_mod.audio_tag_logits_tltr(
            card["whisper"]["at_head"], states, atc, window_tokens=25)
        launched = cuda_lib.LAUNCHES["flash_forward"] - before
        start = torch.tensor([[1, 3], [1, 4]], dtype=torch.int32)
        toks, lens = whisper_mod.greedy_decode_cached(
            card["whisper"], got, wcfg, start.to(dev), 12, eot_token=2)
        seq = torch.cat([start, toks.cpu()], dim=1)[:, :-1].long()
        ref_logits = whisper_mod.decoder_forward(cpu["whisper"], seq, ref,
                                                 wcfg)[:, 1:]
        ref_em = w2v.forward(cpu["w2v"], wave, w2cfg)
        em = w2v.forward(card["w2v"], wave.to(dev), w2cfg)
    if launched != wcfg.encoder_layers + atc.time_blocks + atc.layer_blocks:
        raise AssertionError(f"small audio stack: kernel 7 launched "
                             f"{launched} times")
    chosen = ref_logits.gather(-1, toks.cpu().long()[..., None])[..., 0]
    gap = (ref_logits.amax(-1) - chosen).max().item()
    for label, a, b in (("encoder states", got, ref),
                        ("layer states", states, ref_states),
                        ("TL-TR window logits", tags, ref_tags),
                        ("wav2vec2 emissions", em, ref_em)):
        mx, mean = rel_errs(a, b)
        print(f"small audio {label}: shape {tuple(a.shape)} {a.dtype}, "
              f"max|err|/max|ref| {mx:.3e}, mean|err|/mean|ref| {mean:.3e} "
              f"(bf16 CUDA vs f32 CPU, limits {SMALL_AUDIO_TOL})")
        if not (bool(torch.isfinite(a).all()) and mx <= SMALL_AUDIO_TOL[0]
                and mean <= SMALL_AUDIO_TOL[1]):
            raise AssertionError(f"small audio {label}: {mx}, {mean}")
    print(f"small audio greedy decode: {toks.tolist()}, lengths "
          f"{lens.tolist()}; the CPU's f32 logit of each chosen token is "
          f"within {gap:.3e} of its best (limit {SMALL_AUDIO_MARGIN})")
    if gap > SMALL_AUDIO_MARGIN:
        raise AssertionError(f"small audio decode: gap {gap}")


def audio_stack(dev):
    """bench.py's audio stack at full width on the card (its
    _build_transcriber): Whisper large-v2 in bf16, the TL-TR head
    WhisperATConfig() and the wav2vec2-base aligner, random weights from
    seeds 11-13; ids decoded to letter words, every segment kept (random
    tag logits would drop them), AUDIO_NEW_TOKENS new tokens a chunk."""
    cfg, atc = whisper_mod.WhisperConfig.large_v2(), \
        whisper_mod.WhisperATConfig()
    params = whisper_mod.init_params(TreeInit(11, dev, torch.bfloat16), cfg)
    params["at_head"] = whisper_mod.init_at_head_tltr(
        TreeInit(12, dev, torch.bfloat16), atc)
    w2cfg = w2v.Wav2Vec2Config.base()
    n_letters = min(26, w2cfg.vocab_size - 5)
    aligner = ForcedAligner(
        w2v.init_params(TreeInit(13, dev, torch.bfloat16), w2cfg), w2cfg,
        char_vocab(n_letters))
    return Transcriber(params, cfg, letter_words(n_letters),
                       start_tokens=(1,),
                       eot_token=2, max_new_tokens=AUDIO_NEW_TOKENS,
                       at_cfg=atc, music_tags=(), aligner=aligner)


def audio_phase(engine, clips, dev, results) -> dict:
    """--use_asr on the 7B int4 engine: kernel 7 at the audio shapes
    (audio_flash_checks) and its f32 body at Whisper base's
    (audio_f32_checks), the small stack against the CPU
    (small_audio_check), the chat CLI's own transcriber (Whisper base in
    f32, base_transcriber_run), then bench.py's stack at full width
    (audio_stack): a warm-up transcribe of 10 s, then the counted run --
    upload_frames(100-frame clip, audio=60 s waveform) (CLIP and pooling,
    then the transcribe: mel, encode, decode, TL-TR), the aligner over
    the kept segments, then add_text and answer (the transcript spliced
    into the prompt) -- with stage times (host wall around synchronized
    calls), every kernel's launches (counts set to 0 just before, kernel
    7's read after the upload, the chat kernels' after the answer) and
    peak memory; then one transcribe under torch.profiler. Returns
    {"flash_forward": kernel 7's launches over the transcribe,
    "flash_forward_f32": its f32 body's over the CLI transcriber's run,
    "checks": the audio shapes' records}."""
    t0 = time.perf_counter()
    with torch.inference_mode():
        checks = audio_flash_checks(dev)
        audio_f32_checks(dev, results)
    small_audio_check(dev)
    print(f"audio checks: {time.perf_counter() - t0:.2f} s", flush=True)
    f32_launches = base_transcriber_run(dev)

    t = time.perf_counter()
    tr = audio_stack(dev)
    torch.cuda.synchronize()
    print(f"bench audio stack (Whisper large-v2 bf16 + TL-TR + wav2vec2-"
          f"base) on the card: {time.perf_counter() - t:.2f} s", flush=True)
    wave = bench_wave()
    tr.transcribe_audio(wave[:160000])  # warm-up: cuFFT, cuBLAS, caches
    torch.cuda.synchronize()

    stats: dict = {}
    seen: dict = {}

    def keep(key, fn):
        def run(*a, **kw):
            seen[key + " args"] = a
            seen[key] = fn(*a, **kw)
            return seen[key]
        return run

    patched = [(transcribe_mod, "log_mel_spectrogram", "mel"),
               (whisper_mod, "encode", "encode"),
               (whisper_mod, "greedy_decode_cached", "decode"),
               (whisper_mod, "audio_tag_logits_tltr", "tltr"),
               (tr, "transcribe_audio", "transcribe"),
               (tr.aligner, "align_segments", "align"),
               (chat_mod, "generate_with_keywords", "llm")]
    saved = [(o, a, getattr(o, a)) for o, a, _ in patched]
    for o, a, stage in patched:
        setattr(o, a, keep(stage, timed(stats, stage, getattr(o, a))))
    try:
        chat = VideoChatGPTInterface(
            engine, use_asr=True, transcriber=tr, temperature=0.0,
            max_output_tokens=MAX_NEW_TOKENS,
            generator=torch.Generator(device=dev).manual_seed(0))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        cuda_lib.reset_launch_counts()
        t = time.perf_counter()
        chat.upload_frames(clips["long"], audio=wave)
        torch.cuda.synchronize()
        upload_s = time.perf_counter() - t
        launches = cuda_lib.LAUNCHES["flash_forward"]
        segments = seen["transcribe"]
        kept = [s for s in segments if s.keep and s.text]
        words = tr.aligner.align_segments(wave, kept)
        t = time.perf_counter()
        chat.add_text(QUESTION, None)
        text = chat.answer()
        torch.cuda.synchronize()
        splice_s = time.perf_counter() - t
        chat_counts = {k: cuda_lib.LAUNCHES[k] for k in INT4_PATH}
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
    finally:
        for o, a, fn in saved:
            setattr(o, a, fn)
    enc = seen["encode"][0]
    tags = seen["tltr"]
    toks, lens = seen["decode"]
    want_launches = (tr.cfg.encoder_layers + tr.at_cfg.time_blocks
                     + tr.at_cfg.layer_blocks)
    n_words = len(chat.transcript_text.split())
    bounds = [(s.start, s.end) for s in segments]
    first = [(w.word, round(w.start, 2), round(w.end, 2)) for w in words[:3]]
    print(f"audio: {len(segments)} segments {bounds}, decoded lengths "
          f"{lens.tolist()}, transcript {n_words} words "
          f"({len(chat.transcript_text)} chars), {len(words)} aligned words "
          f"(first {first}), encoder states {tuple(enc.shape)} {enc.dtype}, "
          f"TL-TR logits {tuple(tags.shape)}; answer {len(text)} chars")
    print("audio stages (s): " + ", ".join(f"{k} {v:.3f}" for k, v in
                                           stats.items())
          + f"; upload_frames with audio {upload_s:.3f} (CLIP encode and "
          f"pooling included), splice and answer {splice_s:.3f}")
    print(f"audio launches: kernel 7 {launches} over the transcribe "
          f"({want_launches}: a launch an encoder layer and a TL-TR block); "
          f"over the upload and the answer {chat_counts}; peak device "
          f"memory {peak:.2f} GiB", flush=True)
    missing = [k for k in INT4_PATH if not chat_counts[k]]
    if missing:
        raise AssertionError(f"audio chat: kernels never launched on the "
                             f"path: {missing}")
    if not (bool(torch.isfinite(enc).all()) and bool(
            torch.isfinite(tags).all())):
        raise AssertionError("audio: non-finite encoder states or tags")
    if (tuple(enc.shape) != (2, 1500, tr.cfg.d_model) or tuple(tags.shape)
            != (2, 3, tr.at_cfg.n_class) or len(segments) != 2):
        raise AssertionError(f"audio shapes: {enc.shape}, {tags.shape}, "
                             f"{len(segments)} segments")
    if launches != want_launches:
        raise AssertionError(f"kernel 7 launched {launches} times over the "
                             f"transcribe, not {want_launches}")
    if not (n_words and words and all(
            0 <= w.start <= w.end <= AUDIO_SECONDS for w in words)):
        raise AssertionError("audio: no transcript or alignment")
    _, _, ids, seq_lens = seen["llm args"][:4]
    prompt = engine.tokenizer.decode(ids[0, :int(seq_lens[0])].tolist())
    spliced = f'{DEFAULT_TRANSCRIPT_START}\n"{chat.transcript_text}"'
    if spliced not in prompt or DEFAULT_AUDIO_TOKEN in prompt:
        raise AssertionError("audio: the transcript was not spliced")
    print(f"audio: the answer's prompt holds the {len(spliced)}-char "
          f"transcript splice ({int(seq_lens[0])} tokens in all)")

    wall = stats["transcribe"]  # the counted run's, unprofiled
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        tr.transcribe_audio(wave)
        torch.cuda.synchronize()
    spans = [(e.name(), e.start_ns(), e.end_ns())
             for e in prof.profiler.kineto_results.events()
             if e.device_type() == DeviceType.CUDA]
    if not spans:
        raise AssertionError("audio profile: no device activity")
    busy_ms, by_name = busy_and_names(spans)
    print(f"audio transcribe profile (60 s): device busy {busy_ms:.1f} ms "
          f"over {len(spans)} device activities, wall {wall * 1e3:.1f} ms "
          f"(the counted run's, unprofiled), idle share "
          f"{1 - busy_ms / (wall * 1e3):.3f}")
    for i, (name_, (total, calls)) in enumerate(sorted(
            by_name.items(), key=lambda kv: -kv[1][0])):
        if i < 10 or port_kernel(name_):
            print(f"audio profile: {total / 1e3:9.2f} ms {calls:6d} calls  "
                  f"{name_[:90]}")
    del tr, chat, seen
    gc.collect()
    torch.cuda.empty_cache()
    print(f"audio phase: {time.perf_counter() - t0:.2f} s", flush=True)
    return {"flash_forward": launches, "flash_forward_f32": f32_launches,
            "checks": checks}


# -- learned grounding ------------------------------------------------------

# bench_grounding.py's build (BASELINE config 5): 100 seeded frames of 480
# x 832, a detection every 5 frames, the detector's top 8 boxes, box
# threshold 0, the random ViT-B/32 crop filter at thresholds 0 / 0, XMem
# (ResNet-50 / ResNet-18, key 64, value 512) with 4 object slots, binary
# masks, classes "person" and "dog".
LEARNED_FRAMES, LEARNED_HW = 100, (480, 832)
LEARNED_CLASSES = ["person", "dog"]
LEARNED_HOST_FRAMES = 20  # the host loop's run, against the fused one's
LEARNED_BOXES, LEARNED_OBJECTS = 8, 4
LEARNED_MASK_SHARE = 5e-3  # masks may differ on under 0.5% of a frame
LEARNED_SCORE_TOL = 1e-4  # detection scores, kernels against plain
# Kernel 7's f32 body at the crop filter's text tower: 10 templates x 2
# classes, 77 tokens, 8 heads of 64, causal (b, sq, skv, h, h_kv, d, causal)
TEXT_F32_SHAPE = (20, 77, 77, 8, 8, 64, True)


class TopKDetector:
    """bench_grounding.py's _TopKDetector: the detector's raw detections
    cut to the top `k` a frame (random weights clear the detector's
    threshold on most of its 900 queries); counts and times the
    forwards."""

    def __init__(self, det, k: int, stats: dict, forwards: list):
        self._det, self._k = det, k
        self._stats, self._forwards = stats, forwards

    def detect_batch(self, images, prompts):
        self._forwards[0] += 1
        out = []
        for boxes, conf, cids in timed(self._stats, "detection",
                                       self._det.detect_batch)(images,
                                                               prompts):
            order = np.argsort(-conf)[:self._k]
            out.append((boxes[order], conf[order], cids[order]))
        return out

    def __call__(self, image, prompts):
        return self.detect_batch(np.asarray(image)[None], prompts)[0]


class TimedSegmenter:
    """A segmenter whose SAM calls (the per-frame decode, the batched
    encodes and the clip-wide batched decode) add to stats['sam']."""

    def __init__(self, seg, stats: dict):
        self._seg, self._stats = seg, stats

    def __getattr__(self, name):
        attr = getattr(self._seg, name)
        if name in ("precompute_embeddings", "decode_masks_batch_device"):
            return timed(self._stats, "sam", attr)
        return attr

    def __call__(self, *a, **kw):
        return timed(self._stats, "sam", self._seg)(*a, **kw)


def text_f32_check(dev, results) -> None:
    """Kernel 7's f32 body at TEXT_F32_SHAPE (the crop filter's text
    tower) against the plain forward within F32_FLASH_TOL; timed beside
    the plain forward, SDPA in f32 with the causal boolean mask, and the
    bound (bytes, or the visible pairs' two products three times over at
    the TF32 rate). Its error joins results['flash_forward_f32'] (whose
    times stay Whisper base's), its times that entry's "text_tower"."""
    g = torch.Generator(device=dev).manual_seed(10)
    b, sq, skv, h, h_kv, d, causal = TEXT_F32_SHAPE
    q = torch.randn(b, sq, h, d, generator=g, device=dev)
    k, v = (torch.randn(b, skv, h_kv, d, generator=g, device=dev)
            for _ in range(2))
    out, lse = attention.flash_forward(q, k, v, causal)
    want, want_lse = attention.flash_forward_plain(q, k, v, causal)
    err = max((out - want).abs().max().item(),
              (lse - want_lse).abs().max().item())
    if not err <= F32_FLASH_TOL:
        raise AssertionError(f"flash_forward_f32 {TEXT_F32_SHAPE}: {err}")
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    mask = attention.flash_mask(sq, skv, True, dev)
    ms = median_ms(lambda: attention.flash_forward(q, k, v, causal))
    plain_ms = median_ms(lambda: attention.flash_forward_plain(q, k, v,
                                                               causal))
    lib_ms = median_ms(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, attn_mask=mask))
    ops = 4 * b * h * visible_pairs(sq, skv, causal) * d
    nbytes = 4 * (2 * q.numel() + k.numel() + v.numel() + lse.numel())
    record(results, "flash_forward_f32", err, ms, plain_ms, lib_ms, nbytes,
           3 * ops, TF32_PEAK)
    bound_ms, bound_by = bound(nbytes, 3 * ops, TF32_PEAK)
    results["flash_forward_f32"]["text_tower"] = dict(
        shape=list(TEXT_F32_SHAPE), max_abs_err=err, ms=ms,
        plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bound_ms,
        bound_by=bound_by)
    print(f"check flash_forward_f32 {TEXT_F32_SHAPE} (the text tower): "
          f"max|err| {err:.3e} (tol {F32_FLASH_TOL}), kernel {ms:.4f} ms, "
          f"plain {plain_ms:.4f} ms, library (SDPA f32, bool mask) "
          f"{lib_ms:.4f} ms, bound {bound_ms:.4f} ms by {bound_by}",
          flush=True)


def same_tracks(got, want, label, score_tol=1e-6) -> float:
    """Frame indices and objects (id, category; scores within
    score_tol) equal and masks differing on under LEARNED_MASK_SHARE of
    each frame's pixels; returns the largest share."""
    if len(got) != len(want):
        raise AssertionError(f"{label}: {len(got)} != {len(want)} frames")
    worst = 0.0
    for g, w in zip(got, want):
        if g.frame_index != w.frame_index or [
                (o.id, o.category_id) for o in g.objects] != [
                (o.id, o.category_id) for o in w.objects] or any(
                abs(a.score - b.score) > score_tol
                for a, b in zip(g.objects, w.objects)):
            raise AssertionError(f"{label}: frame {g.frame_index} objects "
                                 f"{g.objects} != {w.objects}")
        share = float(np.mean(g.masks != w.masks))
        worst = max(worst, share)
        if share >= LEARNED_MASK_SHARE:
            shares = [round(float(np.mean(a.masks != b.masks)), 4)
                      for a, b in zip(got, want)]
            raise AssertionError(f"{label}: frame {g.frame_index} masks "
                                 f"differ on {share:.4f} of the pixels "
                                 f"(each frame's share: {shares})")
    return worst


def learned_grounding_phase(dev, results) -> dict:
    """bench_grounding.py's learned build at full width on the card
    (LEARNED_*: GroundingDINO Swin-T at 800 px, MobileSAM, the ViT-B/32
    crop filter in f32, XMem with random weights from seeds): kernel 7's
    f32 check at the text tower's shape (its times join the kernels
    line's flash_forward_f32 entry as "text_tower"); a warm-up of both
    paths on 10
    frames; then, each with the launch counts set to 0 just before and
    read just after, GroundedTracker.run_on_list_of_images (the fused
    path) over the 100 frames and run_host_loop (the chunked host loop)
    over the first LEARNED_HOST_FRAMES, with wall, stage seconds (host
    clock around synchronized calls; host glue the rest), detector
    forwards and kernel 1 / 7 / 12 launches; the two must agree on those
    frames (same_tracks), the filter must drop a
    detection, the masks must not be all empty, and the path's kernels
    must all launch. Then 12 frames with the kernels against the same
    path on their plain versions (set_default_impl('xla') for attention
    and deformable attention: nothing launches), and a profiled fused
    run (device busy, idle share, the top device activities). Returns
    the fused run's launches."""
    t0 = time.perf_counter()
    text_f32_check(dev, results)
    stats: dict = {}
    forwards, dropped, scored = [0], [0], [0]
    detector = gdino.build_detector(device=dev, seed=0)
    segmenter = build_sam(device=dev, seed=1)
    crop_filter = random_clip_filter(seed=2, prob_threshold=0.0,
                                     score_threshold=0.0, device=dev)
    xcfg = xmem_mod.XMemConfig(max_objects=LEARNED_OBJECTS)
    xparams = xmem_mod.init_params(TreeInit(3, dev), xcfg)
    filter_device = crop_filter.filter_frames_device

    def count_filter(frames, boxes, valid, class_ids, classes, chunk=4):
        keep = timed(stats, "filter", filter_device)(
            frames, boxes, valid, class_ids, classes, chunk=chunk)
        dropped[0] += int((np.asarray(valid, bool) & ~keep).sum())
        scored[0] += int(np.asarray(valid, bool).sum())
        return keep

    crop_filter.filter_frames_device = count_filter

    def tracker():
        prop = LearnedMemoryTracker(xparams, xcfg)
        for name in ("step", "step_chunk", "add_reference"):
            setattr(prop, name, timed(stats, "propagation",
                                      getattr(prop, name)))
        return GroundedTracker(
            detector=TopKDetector(detector, LEARNED_BOXES, stats, forwards),
            segmenter=TimedSegmenter(segmenter, stats),
            crop_filter=crop_filter, detection_every=5, box_threshold=0.0,
            tracker_cfg=TrackerConfig(max_objects=LEARNED_OBJECTS),
            propagator=prop, binary_masks=True)

    fused_tracker, host_tracker = tracker(), tracker()
    if not fused_tracker.fused_eligible():
        raise AssertionError("the learned build is not fused-eligible")
    torch.cuda.synchronize()
    print(f"learned grounding build on the card: "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    frames = list(np.random.default_rng(1).integers(
        0, 255, size=(LEARNED_FRAMES,) + LEARNED_HW + (3,), dtype=np.uint8))
    run_fused = fused_clip.run_clip_fused

    def run(path, clip):
        stats.clear()
        forwards[0] = dropped[0] = scored[0] = 0
        crop_filter._text_cache.clear()  # the text tower runs, as for a
        # request with a new class list
        torch.cuda.synchronize()
        cuda_lib.reset_launch_counts()
        t = time.perf_counter()
        out = (fused_tracker.run_on_list_of_images(clip, LEARNED_CLASSES)
               if path == "fused"
               else host_tracker.run_host_loop(clip, LEARNED_CLASSES))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        launches = dict(cuda_lib.LAUNCHES)
        glue = wall - sum(stats.values())
        print(f"learned {path} over {len(clip)} frames: wall {wall:.3f} s; "
              "stages (s): " + ", ".join(f"{k} {v:.3f}" for k, v in
                                         sorted(stats.items()))
              + f", host glue {glue:.3f}; {forwards[0]} detector forwards, "
              f"{dropped[0]} of {scored[0]} detections dropped by the "
              f"filter; launches "
              f"{launches}", flush=True)
        return out, launches, wall

    fused_clip.run_clip_fused = timed(stats, "propagation", run_fused)
    try:
        for path in ("fused", "host"):  # warm-up
            run(path, frames[:10])
        torch.cuda.reset_peak_memory_stats()
        fused, launches, fused_wall = run("fused", frames)
        fused_dropped = dropped[0]
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        # the host loop over the first LEARNED_HOST_FRAMES frames (its
        # chunks and detection batches are the fused run's there)
        host, host_launches, _ = run("host", frames[:LEARNED_HOST_FRAMES])
        missing = [k for k in LEARNED_PATH if not launches.get(k)]
        if missing or any(not host_launches.get(k) for k in LEARNED_PATH):
            raise AssertionError(f"learned grounding: kernels never "
                                 f"launched on the path: {missing}")
        if not (fused_dropped and dropped[0]):
            raise AssertionError("the crop filter dropped no detection")
        if not any(fr.masks.any() for fr in fused):
            raise AssertionError("the learned build's masks are all empty")
        if {fr.masks.shape for fr in fused} != {
                (LEARNED_OBJECTS,) + LEARNED_HW}:
            raise AssertionError("learned grounding: mask shapes")
        worst = same_tracks(fused[:LEARNED_HOST_FRAMES], host,
                            "fused vs host loop")
        masked = sum(int(fr.masks.any()) for fr in fused)
        print(f"learned fused vs host loop: objects equal, masks differ on "
              f"at most {worst:.5f} of a frame's pixels (limit "
              f"{LEARNED_MASK_SHARE}); {masked} frames with a mask, "
              f"{len(fused[-1].objects)} objects; peak device memory "
              f"{peak:.2f} GiB", flush=True)

        # the same 12 frames with the kernels and on their plain versions
        with_kernels, _, _ = run("fused", frames[:12])
        attention.set_default_impl("xla")
        deformable.set_default_impl("xla")
        try:
            plain, plain_launches, _ = run("fused", frames[:12])
        finally:
            attention.set_default_impl("auto")
            deformable.set_default_impl("auto")
        if plain_launches:
            raise AssertionError(f"the plain run launched {plain_launches}")
        worst = same_tracks(with_kernels, plain, "kernels vs plain",
                            score_tol=LEARNED_SCORE_TOL)
        print(f"learned fused, 12 frames, kernels vs plain versions: objects "
              f"equal (scores within {LEARNED_SCORE_TOL}), masks differ on "
              f"at most {worst:.5f} of a frame's pixels (limit "
              f"{LEARNED_MASK_SHARE})", flush=True)

        wall = time.perf_counter()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            run("fused", frames)
        profiled_s = time.perf_counter() - wall
    finally:
        fused_clip.run_clip_fused = run_fused
        crop_filter.filter_frames_device = filter_device
    spans = [(e.name(), e.start_ns(), e.end_ns())
             for e in prof.profiler.kineto_results.events()
             if e.device_type() == DeviceType.CUDA]
    if not spans:
        raise AssertionError("learned grounding profile: no device activity")
    busy_ms, by_name = busy_and_names(spans)
    print(f"learned fused profile: device busy {busy_ms:.1f} ms over "
          f"{len(spans)} device activities, wall {fused_wall * 1e3:.1f} ms "
          f"(unprofiled run), idle share "
          f"{1 - busy_ms / (fused_wall * 1e3):.3f} (profiled pass "
          f"{profiled_s:.2f} s)", flush=True)
    for i, (name_, (total, calls)) in enumerate(sorted(
            by_name.items(), key=lambda kv: -kv[1][0])):
        if i < 15 or port_kernel(name_):
            print(f"learned profile: {total / 1e3:9.2f} ms {calls:6d} calls  "
                  f"{name_[:90]}")
    del fused_tracker, host_tracker, fused, host, xparams, crop_filter
    del detector, segmenter
    gc.collect()
    torch.cuda.empty_cache()
    print(f"learned grounding phase: {time.perf_counter() - t0:.2f} s",
          flush=True)
    return launches


TRACKING_ARGS = ["--train_steps", "150", "--clips", "3", "--frames", "8"]
TRACKING_FUSED_TOL = 1e-3  # fused dispatch vs propagator, J and F


def tracking_quality_phase(dev, card) -> dict:
    """scripts/tracking_quality.main on the card (TRACKING_ARGS: 150
    steps of the brief XMem training, then the handcrafted STM and the
    trained XMem over 3 clips a kind of 8 frames, each as the propagator
    and through the fused dispatch): the J&F table, the training's and
    evaluation's seconds, peak device memory and the TF32 flags it ran
    under. Every J and F finite and in [0, 1]; the mean loss of the last
    25 steps under that of the first 25; each tracker's fused J, F and
    J&F within TRACKING_FUSED_TOL of its propagator's, kind by kind.
    XMem runs no port kernel: convolutions and top-k only. Returns the
    summary."""
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    summary = tracking_quality.main(TRACKING_ARGS + ["--device", str(dev)])
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    detail = summary["detail"]
    for tracker, table in detail.items():
        for kind, r in table.items():
            for k in ("J", "F", "JF"):
                if not (math.isfinite(r[k]) and 0.0 <= r[k] <= 1.0):
                    raise AssertionError(f"tracking quality: {tracker} "
                                         f"{kind} {k} = {r[k]}")
    worst = 0.0
    for tracker in ("handcrafted", "xmem(brief)"):
        for kind, r in detail[tracker].items():
            for k in ("J", "F", "JF"):
                worst = max(worst, abs(detail[tracker + "(fused)"][kind][k]
                                       - r[k]))
    if worst > TRACKING_FUSED_TOL:
        raise AssertionError(f"tracking quality: fused dispatch differs "
                             f"from the propagator by {worst}")
    first, last = summary["train_loss_first"], summary["train_loss_last"]
    if not last < first:
        raise AssertionError(f"tracking quality: the training loss did not "
                             f"fall ({first} -> {last})")
    steps = summary["train_steps"]
    print(f"tracking quality: J&F {summary['value']} (xmem(brief)), fused "
          f"{summary['fused_jf_mean']}, handcrafted "
          f"{detail['handcrafted']['mean']['JF']:.4f}; fused vs propagator "
          f"at most {worst:.2e} apart (limit {TRACKING_FUSED_TOL}); "
          f"training {steps} steps in {summary['train_seconds']:.2f} s "
          f"({steps / summary['train_seconds']:.1f} steps/s), mean loss of "
          f"the first 25 {first:.4f}, of the last 25 {last:.4f}; "
          f"evaluation {summary['eval_seconds']:.2f} s; peak device memory "
          f"{peak:.2f} GiB; TF32 {summary['tf32']}; phase "
          f"{time.perf_counter() - t0:.2f} s [{card}]", flush=True)
    gc.collect()
    torch.cuda.empty_cache()
    return summary


XMEM_PROFILE_ARGS = ["--frames", "4"]


def profile_xmem_phase(dev, card) -> dict:
    """scripts/profile_xmem at 4 frames of 480 x 832 (XMem with 4
    objects, random weights, f32): the key encode of the chunk and the
    whole propagate_chunk, then a torch.profiler trace of three chunks
    read back through utils/trace_tools (its top 25 device ops)."""
    t0 = time.perf_counter()
    trace_dir = tempfile.mkdtemp(prefix="xmem_trace_")
    try:
        out = profile_xmem.main(XMEM_PROFILE_ARGS + [
            "--trace_dir", trace_dir, "--device", str(dev)],
            print_fn=lambda s: print(f"profile_xmem: {s}", flush=True))
    finally:
        shutil.rmtree(trace_dir, ignore_errors=True)
    if out["trace_source"] != "device":
        raise AssertionError("profile_xmem: the trace holds no device "
                             "activity")
    print(f"profile_xmem phase: {time.perf_counter() - t0:.2f} s [{card}]",
          flush=True)
    gc.collect()
    torch.cuda.empty_cache()
    return out


DECODE_PROFILE_STEPS = 64


def profile_decode_phase(engine, card) -> dict:
    """scripts/profile_decode.run on the 7B int4 engine (bench.py's
    construction: W4A8, fused, a bf16 cache, the 100-frame clip and the
    512-token prompt): the warm step over bursts of 16, then
    DECODE_PROFILE_STEPS profiled steps, whose top ops must name kernels
    A (w4a8_matvec_kernel) and 3 (decode_mha_kernel)."""
    t0 = time.perf_counter()
    out = profile_decode.run(
        engine, steps=DECODE_PROFILE_STEPS, kv="bf16",
        labels={"model": "7b", "llm_dtype": "int4"},
        print_fn=lambda s: print(f"profile_decode: {s}", flush=True))
    top = out["top_ops"]
    for kernel in ("w4a8_matvec_kernel", "decode_mha_kernel"):
        if not any(kernel in name for name in top):
            raise AssertionError(f"profile_decode: {kernel} is not among "
                                 f"the top ops")
    print(f"profile_decode phase: {time.perf_counter() - t0:.2f} s [{card}]",
          flush=True)
    return out


BATCHING_PATH = ("flash_attention_bhsd", "spatio_temporal_pool",
                 "decode_attention_stacked", "w4a8_matvec", "w4a8_block")
# the W8A8 tower's four products at 100 frames (100 x 272 padded rows):
# name -> (K, N); q, k and v share o's shape
CLIP_GEMMS = {"q/k/v": (1024, 1024), "o": (1024, 1024),
              "fc1": (1024, 4096), "fc2": (4096, 1024)}


def percentile(values, q: float) -> float:
    vals = sorted(values)
    return vals[min(len(vals) - 1, round(q * (len(vals) - 1)))]


def clip_w8a8_checks(engine, clips, dev, card) -> None:
    """The W8A8 tower of initialize_model(clip_dtype="int8") against the
    bf16 tower of the same seed (random_init_ draws the vision tower
    first, so a tower drawn alone from seed 0 holds the engine's bf16
    weights; quantize_a8_ of it must equal the engine's leaves): the
    100-frame encode's device time each, the per-token cosine of their
    penultimate features (mean and p5, as validate_quant_quality's
    vision gate computes it), and torch._int_mm's device time at the
    tower's four product shapes beside cuBLAS bf16's and the int8
    bound."""
    vision = engine.model.vision
    kinds = {type(getattr(layer, n).kernel) for layer in vision.layers
             for n in ("q", "k", "v", "o", "fc1", "fc2")}
    if kinds != {Int8A8Kernel}:
        raise AssertionError(f"clip_dtype=int8: kernels {kinds}")
    tower = CLIPVisionTower(engine.cfg.vision, device=dev,
                            dtype=torch.bfloat16)
    random_init_(tower, torch.Generator(device=dev).manual_seed(0))
    tower.requires_grad_(False)
    mine = quantize_a8_(copy.deepcopy(tower))
    for (name, a), b in zip(mine.named_parameters(), vision.parameters()):
        if not torch.equal(a, b):
            raise AssertionError(f"W8A8 tower: {name} is not quantize_a8_ "
                                 "of the seed's bf16 tower")
    del mine
    frames = torch.from_numpy(clips["long"]).to(dev)
    pixels = preprocess_frames(frames, engine.cfg.vision.image_size)
    ms = {}
    for label, t in (("W8A8", vision), ("bf16", tower)):
        ms[label] = median_ms(lambda t=t: t.encode_frames(pixels), calls=1,
                              reps=5, capture=False)
    ref = tower.penultimate_patches(pixels).float().flatten(0, 1)
    got = vision.penultimate_patches(pixels).float().flatten(0, 1)
    cos = F.cosine_similarity(ref, got, dim=-1, eps=1e-8).cpu().numpy()
    if not np.isfinite(cos).all():
        raise AssertionError("W8A8 tower: non-finite features")
    print(f"clip W8A8 (100 frames, 224 px): encode {ms['W8A8']:.2f} ms, "
          f"bf16 tower {ms['bf16']:.2f} ms (device ms, CUDA events, median "
          f"of 5); per-token cosine to bf16 mean {cos.mean():.5f}, p5 "
          f"{np.percentile(cos, 5):.5f} over {cos.size} tokens (seeded "
          f"weights: no quality figure) [{card}]", flush=True)
    del tower, ref, got
    rows = pixels.shape[0] * padded_length(engine.cfg.vision.num_positions)
    g = torch.Generator(device=dev).manual_seed(0)
    for name, (k, n) in CLIP_GEMMS.items():
        xq = torch.randint(-127, 128, (rows, k), generator=g, device=dev,
                           dtype=torch.int8)
        wq = torch.randint(-127, 128, (n, k), generator=g, device=dev,
                           dtype=torch.int8).t()  # column-major, as stored
        x16 = torch.randn((rows, k), generator=g, device=dev,
                          dtype=torch.bfloat16)
        w16 = torch.randn((k, n), generator=g, device=dev,
                          dtype=torch.bfloat16)
        int8_ms = median_ms(lambda: torch._int_mm(xq, wq))
        bf16_ms = median_ms(lambda: torch.mm(x16, w16))
        ops = 2 * rows * k * n
        b8, by8 = bound(rows * k + k * n + 4 * rows * n, ops, INT8_PEAK)
        b16, _ = bound(2 * (rows * k + k * n + rows * n), ops, BF16_PEAK)
        print(f"clip W8A8 GEMM {name} ({rows}, {k}) x ({k}, {n}): "
              f"torch._int_mm {int8_ms:.4f} ms (int8 bound {b8:.4f} ms by "
              f"{by8}), cuBLAS bf16 {bf16_ms:.4f} ms (bound {b16:.4f}) "
              f"[{card}]", flush=True)
        del xq, wq, x16, w16


def batching_phase(clips, dev, results, card) -> dict:
    """The windowed batcher on a 7B int4 engine with the W8A8 CLIP tower
    (initialize_model(llm_quant="int4", llm_fuse=True, clip_dtype="int8"),
    serving/__main__.py --batching --quant int4 on such weights), served
    as serve(batching=True, max_batch=8, window_ms=30) would be on
    127.0.0.1, no speculation (decode through kernels A and 3): 8 text
    requests sent at once (SERVING_PROMPT tokens, 64 greedy tokens),
    then a video request (its video_url decodes to the seeded 100-frame
    clip: no libav here) and a streamed request, each alone on the
    worker; client latencies, the batches the worker formed, aggregate
    tok/s, and launches over that traffic. Then a greedy request served
    at max_batch 1 must equal ChatModel.chat of the same request. First
    clip_w8a8_checks. Returns the launch counts."""
    t_phase = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    engine = initialize_model(model_size="7b", device=dev, seed=0,
                              llm_quant="int4", llm_fuse=True,
                              clip_dtype="int8")
    torch.cuda.synchronize()
    print(f"batching: initialize_model(7b, llm_quant=int4, clip_dtype=int8) "
          f"{time.perf_counter() - t:.2f} s", flush=True)
    clip_w8a8_checks(engine, clips, dev, card)
    chat = ChatModel(model=engine.model, cfg=engine.cfg,
                     tokenizer=engine.tokenizer, speculative=False)
    messages = serving_messages(chat)
    tokens, rows = [], []  # tokens generated a call; each row's ids
    gen_fn, kw_fn = server_mod.generate, server_mod.generate_with_keywords

    def kept(res):
        tokens.append(int(res.lengths.sum()))
        rows.extend(r[:n].tolist() for r, n in zip(res.tokens.cpu(),
                                                    res.lengths.tolist()))

    def counted_generate(*a, **kw):
        res = gen_fn(*a, **kw)
        kept(res)
        return res

    def counted_keywords(*a, **kw):
        text, res = kw_fn(*a, **kw)
        kept(res)
        return text, res

    def seeded_video(url, image_size):
        if url != "seeded://long":
            raise ValueError(f"no decoder for {url} here (no libav)")
        return clips["long"]

    load_fn = server_mod._load_video_frames
    server_mod.generate = counted_generate
    server_mod.generate_with_keywords = counted_keywords
    server_mod._load_video_frames = seeded_video
    video_msgs = [{"role": "user", "content": [
        {"type": "text", "text": QUESTION},
        {"type": "video_url", "video_url": {"url": "seeded://long"}}]}]
    bodies = [{"model": "vicuna", "messages": m, "temperature": 0.0,
               "max_tokens": MAX_NEW_TOKENS} for m in messages]
    bodies += [{"model": "vicuna", "messages": video_msgs,
                "temperature": 0.0, "max_tokens": MAX_NEW_TOKENS},
               {**bodies[0], "stream": True}]
    try:
        # warm-up: one text request and the video encode, unserved
        chat.chat(messages[0], temperature=0.0, max_tokens=4)
        with torch.inference_mode():
            engine.model.encode_video(preprocess_frames(
                torch.from_numpy(clips["short"]).to(dev),
                engine.cfg.vision.image_size))
        server = serve(chat, host="127.0.0.1", port=0, block=False,
                       model_name="vicuna", batching=True, max_batch=8,
                       window_ms=30.0)
        batcher = server.chat_model
        base = f"http://127.0.0.1:{server.server_address[1]}/v1"
        torch.cuda.synchronize()
        tokens.clear()
        cuda_lib.reset_launch_counts()
        t0 = time.perf_counter()
        try:
            with concurrent.futures.ThreadPoolExecutor(10) as pool:
                futs = [pool.submit(http_chat, base, b) for b in bodies[:8]]
                time.sleep(0.05)  # the 8 texts first, in one window
                futs += [pool.submit(http_chat, base, b)
                         for b in bodies[8:]]
                answers = [f.result() for f in futs]
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = dict(cuda_lib.LAUNCHES)
            sizes = list(batcher.batch_sizes)
        finally:
            server.shutdown()
            server.server_close()
        if batcher._worker.is_alive():
            raise AssertionError("batching: shutdown() left the worker")
        # a greedy request alone at max_batch 1 against ChatModel.chat:
        # the same token ids (the byte tokenizer decodes most of a random
        # model's ids to nothing, so the texts alone would say little)
        one = serve(chat, host="127.0.0.1", port=0, block=False,
                    model_name="vicuna", batching=True, max_batch=1)
        try:
            rows.clear()
            served, _ = http_chat(
                f"http://127.0.0.1:{one.server_address[1]}/v1",
                {**bodies[2], "max_tokens": 32})
            served_ids = rows[-1]
        finally:
            one.shutdown()
            one.server_close()
        alone = chat.chat(messages[2], temperature=0.0, max_tokens=32)
        alone_ids = rows[-1]
    finally:
        server_mod.generate, server_mod.generate_with_keywords = (gen_fn,
                                                                  kw_fn)
        server_mod._load_video_frames = load_fn
    lat = [s for _, s in answers]
    print(f"batching: 8 text + 1 video + 1 streamed request in {wall:.2f} "
          f"s, {sum(tokens)} tokens generated ({sum(tokens) / wall:.1f} "
          f"tok/s aggregate); latency p50 {statistics.median(lat):.2f} s, "
          f"p95 {percentile(lat, 0.95):.2f} s (each: "
          f"{', '.join(f'{s:.2f}' for s in lat)}; the last two the video "
          f"and the stream); batches formed {sizes}; peak "
          f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB [{card}]",
          flush=True)
    print(f"batching launches: {launches}")
    same = served == alone and served_ids == alone_ids
    print(f"batching: greedy request at max_batch 1, {len(served_ids)} "
          f"token ids {served_ids[:8]}... text {served!r}; ChatModel.chat "
          f"{len(alone_ids)} ids, text {alone!r}: equal {same}", flush=True)
    if not same:
        raise AssertionError("batching: a greedy answer at max_batch 1 "
                             "differs from ChatModel.chat's")
    if max(sizes) < 2:
        raise AssertionError(f"batching: no batch past one request {sizes}")
    missing = [k for k in BATCHING_PATH if not launches.get(k)]
    if missing:
        raise AssertionError(f"batching: kernels never launched: {missing}")
    for name in BATCHING_PATH:
        results[name]["batching_launches"] = launches[name]
    del engine, chat
    gc.collect()
    torch.cuda.empty_cache()
    print(f"batching phase: {time.perf_counter() - t_phase:.2f} s [{card}]",
          flush=True)
    return launches


def save_features_phase(dev, results, card) -> dict:
    """scripts/save_features at full width: build_extractor() (ViT-L/14
    at 224 px in f32, seed 0; TF32 off, as main sets it) and
    process_videos over three seeded "videos" into a temp directory: 100
    frames, 37 frames (zero-padded to 100 and masked) and one whose read
    raises (no libav here: the reader gives seeded frames in place of
    load_video), which is printed and skipped; then the same call again
    writes nothing (resume by existence). Each pickle a finite (356,
    1024) f32 array; the 100-frame one against the extract step with
    attention's plain versions (set_default_impl('xla')). Kernel 1's
    f32 body's launches over the run. Returns the launch counts."""
    t_phase = time.perf_counter()
    _, tower, extract = save_features.build_extractor(device=dev)
    rng = np.random.default_rng(5)
    frames = {"v100.mp4": rng.integers(0, 256, (100, 224, 224, 3), np.uint8),
              "v37.mp4": rng.integers(0, 256, (37, 224, 224, 3), np.uint8)}
    names = ["v100.mp4", "v37.mp4", "broken.mp4"]
    secs = []

    def read(name):
        if name not in frames:
            raise OSError(f"cannot decode {name}")
        return frames[name]

    def timed(*a):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = extract(*a)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t)
        return out

    extract(tower, frames["v37.mp4"][:2], 2)  # warm-up
    root = tempfile.mkdtemp(prefix="feats_")
    try:
        cuda_lib.reset_launch_counts()
        done = save_features.process_videos(names, read, root, tower, timed)
        launches = dict(cuda_lib.LAUNCHES)
        again = save_features.process_videos(names, read, root, tower, timed)
        files = sorted(os.listdir(root))
        if (done, again, files) != (2, 0, ["v100.pkl", "v37.pkl"]):
            raise AssertionError(f"save_features: {done} then {again} new "
                                 f"files, {files}")
        feats = {}
        for name in files:
            with open(os.path.join(root, name), "rb") as f:
                feats[name] = pickle.load(f)
            a = feats[name]
            if (a.shape, a.dtype) != ((356, 1024), np.float32) or (
                    not np.isfinite(a).all()):
                raise AssertionError(f"save_features {name}: {a.shape} "
                                     f"{a.dtype}")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    attention.set_default_impl("xla")
    try:
        plain = save_features.video_features(tower, extract,
                                             frames["v100.mp4"])
    finally:
        attention.set_default_impl("auto")
    rel = (np.abs(feats["v100.pkl"] - plain).max()
           / np.abs(plain).max())
    print(f"save_features: 2 videos written ({', '.join(files)}), "
          f"broken.mp4 skipped, the rerun wrote {again}; extract "
          f"{', '.join(f'{s:.3f}' for s in secs)} s a video (100 and 37 "
          f"frames); 100-frame features vs attention's plain versions "
          f"max|err|/max|ref| {rel:.2e} (tol 1e-3); launches {launches} "
          f"[{card}]", flush=True)
    if rel > 1e-3:
        raise AssertionError(f"save_features: kernel vs plain {rel:.2e}")
    if not launches.get("flash_attention_bhsd_f32"):
        raise AssertionError("save_features: kernel 1's f32 body never "
                             "launched")
    results["flash_attention_bhsd_f32"]["save_features_launches"] = launches[
        "flash_attention_bhsd_f32"]
    del tower
    gc.collect()
    torch.cuda.empty_cache()
    print(f"save_features phase: {time.perf_counter() - t_phase:.2f} s "
          f"[{card}]", flush=True)
    return launches


def preflight_text(tok, n_tokens: int = 2048, seed: int = 0) -> str:
    """Seeded words (SERVING_WORDS and numbers) until the checkpoint's
    tokenizer makes at least n_tokens of them."""
    rng = np.random.default_rng(seed)
    words = []
    while True:
        words += [str(w) for w in rng.choice(SERVING_WORDS, 200)]
        words += [str(n) for n in rng.integers(0, 1000, 20)]
        text = " ".join(words) + "."
        if len(tok.encode(text)) >= n_tokens:
            return text


def quant_preflight(root: str, llm_dir: str, dev, card: str) -> None:
    """validate_quant_quality --preflight --record --vision at full
    width on the phase's seeded 7B checkpoint (bf16, int8 and int4 over
    ~2,048 tokens of seeded text in 1,024-token windows; the vision gate
    on a random ViT-L/14, 16 seeded frames), then the port's
    resolve_quant('auto') and resolve_clip_dtype('auto') must give the
    record's decisions. Seeded weights: the numbers are no quality
    figures."""
    t = time.perf_counter()
    text = os.path.join(root, "preflight.txt")
    with open(text, "w") as f:
        f.write(preflight_text(load_tokenizer(llm_dir)))
    validate_quant_quality.main([
        "--weights", llm_dir, "--tokenizer", llm_dir, "--text", text,
        "--formats", "bf16,int8,int4", "--vision", "--preflight", "--record",
        "--device", str(dev)])
    with open(os.path.join(llm_dir, "quant_preflight.json")) as f:
        rec = json.load(f)
    llm_fmt, vis_fmt = rec["preflight_llm_format"], rec[
        "preflight_vision_format"]
    got = (resolve_quant("auto", llm_dir), resolve_clip_dtype("auto",
                                                             llm_dir))
    want = (None if llm_fmt == "bf16" else llm_fmt, vis_fmt)
    print(f"checkpoint preflight: record {llm_fmt} / vision {vis_fmt} "
          f"(seeded weights: no quality figure) in "
          f"{time.perf_counter() - t:.2f} s; resolve_quant('auto') "
          f"{got[0]}, resolve_clip_dtype('auto') {got[1]} [{card}]",
          flush=True)
    if got != want:
        raise AssertionError(f"preflight: resolved {got}, record {want}")


def weight_bytes(module, leaves) -> int:
    return sum(p.numel() * p.element_size()
               for n, p in module.named_parameters()
               if n.rsplit(".", 1)[-1] in leaves)


# -- tensor parallel (tp_phase) ---------------------------------------------

TP_RANKS = 2
TP_VOCAB_MULTIPLE = 256
TP_CONTINUOUS = 2  # requests through the paged continuous engine
TP_TOKENS = 32  # greedy tokens of the 100-frame request
TP_PAGED_TOKENS = 16  # a paged request's tokens
# teacher-forced logits, TP against the single-process engine on the same
# token stream: (max, mean) |err| as fractions of max |logit|, checked on
# the 100-frame request end to end (TP features into the TP LLM) and on
# each paged request through the paged pool. Sound runs read 4.1-5.2% /
# 0.58-0.64%, the planted wrong-heads fault 138-146% / 22-25% (tp_phase
# prints both; PERF.md section 6)
TP_LIMITS = (0.10, 0.02)
TP_FAULT_TOKENS = 8
# the video features, TP against the reference: fractions of max |feature|
TP_FEATURE_LIMITS = (0.02, 0.001)
TP_PATH = ("flash_attention_bhsd", "spatio_temporal_pool",
           "decode_attention_stacked", "w4a8_matvec", "w4a8_block")


def tp_kernel_checks(dev, g, rnd, results) -> None:
    """The kernels at a rank's shapes under make_mesh(1, 2) for Vicuna-7B
    int4 and CLIP-L (tp_phase): kernel 1 at 8 of CLIP's 16 heads, kernel
    3 at 16 of the 32 heads of the chat cache, A and B at wq/wk/wv's
    2,048 and gate/up's 5,504 columns a rank (wo and down run whole, the
    shapes above). After every main-path shape: record() keeps the
    first."""
    s, s_pad = 257, 272
    q, k, v = (rnd(100, 8, s_pad, 64) for _ in range(3))
    k[:, :, s:], v[:, :, s:] = 30.0, 100.0
    mask = (torch.arange(s_pad, device=dev) < s)[None, None, None]
    check(results, "flash_attention_bhsd", (100, 8, s_pad, 64, s, "TP rank"),
          lambda: attention.flash_attention_bhsd(q, k, v, kv_len=s),
          lambda: attention.flash_attention_bhsd_plain(q, k, v, kv_len=s),
          nbytes=(2 * s_pad + 2 * s) * 100 * 8 * 64 * 2,
          ops=4 * 100 * 8 * s_pad * s * 64,
          library=lambda: F.scaled_dot_product_attention(q, k, v,
                                                         attn_mask=mask))
    del q, k, v
    n_prompt, L = chat_cache_len(VideoLLaVAConfig())
    n = n_prompt + MAX_NEW_TOKENS // 2
    lens = torch.tensor([n], dtype=torch.int32, device=dev)
    q = rnd(1, 1, 16, 128)
    kc, vc = rnd(32, 1, L, 16, 128), rnd(32, 1, L, 16, 128)
    check(results, "decode_attention_stacked",
          (32, 1, L, 16, 128, "bf16", "TP rank"),
          lambda: attention.decode_attention_stacked(q, kc, vc, 17, lens),
          lambda: attention.decode_attention_stacked_plain(q, kc, vc, 17,
                                                           lens),
          nbytes=2 * n * 16 * 128 * 2, ops=4 * n * 16 * 128)
    del q, kc, vc
    d = LlamaConfig.vicuna_7b().hidden_size
    for f in (2048, 5504):
        w = torch.randn(d, f, generator=g, device=dev)
        p, sc = quant4.quantize_tensor_int4(w * d ** -0.5, 128)
        for name, nb in (("w4a8_matvec", 1), ("w4a8_block", 768)):
            x = torch.randn(nb, d, generator=g, device=dev).to(torch.bfloat16)
            kernel = getattr(quant4, name)
            plain = (quant4.int4_matmul_w4a8_xla if name == "w4a8_matvec"
                     else quant4.int4_matmul_w4a8_block_xla)
            check(results, name, (nb, d, f, "bf16 out", "TP rank"),
                  lambda: kernel(x, p, sc, torch.bfloat16),
                  lambda: plain(x, p, sc).to(torch.bfloat16),
                  nbytes=p.numel() + 2 * sc.numel() + 4 * x.numel(),
                  ops=2 * nb * d * f, peak=INT8_PEAK)


class TPProbe:
    """Built on every rank of tp_phase (driver.new). Its replicated
    methods reset each rank's launch counts and peak memory, write them
    to `out_dir` (one JSON file a rank and tag), and run a
    teacher-forced pass."""

    def __init__(self, out_dir: str):
        self.out_dir = out_dir

    @driver.replicated
    def reset(self) -> None:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        cuda_lib.reset_launch_counts()

    @driver.replicated
    def report(self, tag: str) -> None:
        peak = 0.0
        if torch.cuda.is_available():
            torch.cuda.synchronize()
            peak = torch.cuda.max_memory_allocated() / 2**30
        rank = torch.distributed.get_rank()
        with open(os.path.join(self.out_dir, f"{tag}.{rank}.json"), "w") as f:
            json.dump({"rank": rank, "launches": dict(cuda_lib.LAUNCHES),
                       "peak_gib": peak}, f)

    @driver.replicated
    def teacher(self, engine, input_ids, seq_lens, feats, tokens):
        return teacher_forced(engine.model, input_ids, seq_lens, feats,
                              tokens)

    @driver.replicated
    def teacher_paged(self, ceng, prompts, feats, forced, fault=False):
        return teacher_forced_paged(ceng.model, ceng.cache, prompts, feats,
                                    forced, fault)

    def read(self, tag: str) -> list:
        out = []
        for rank in range(TP_RANKS):
            with open(os.path.join(self.out_dir, f"{tag}.{rank}.json")) as f:
                out.append(json.load(f))
        return out


@torch.inference_mode()
def teacher_forced(model, input_ids, seq_lens, feats, tokens):
    """Prefill, then decode `tokens` (1-D) one at a time -> the logits
    after the prompt and after each token but the last, (len, vocab) f32
    on the host."""
    cap = input_ids.shape[1] + len(tokens) + 1
    pre = model.prefill(input_ids, seq_lens, feats, cap)
    out, cache = [pre.logits_last], pre.cache
    for t in tokens[:-1]:
        logits, cache = model.llm.decode_step(t.view(1), cache)
        out.append(logits)
    return torch.cat(out).float().cpu()


@torch.inference_mode()
def teacher_forced_paged(model, pool, prompts, feats, forced,
                         fault: bool = False):
    """teacher_forced through a continuous engine's paged pool (idle: its
    blocks are overwritten), a row a request: `prompts` [(ids (1, s_pad),
    seq_lens (1,))], `feats` each row's video features or None, `forced`
    each row's tokens (1-D). Each row's prompt is prefilled alone over
    blocks of its own, as the engine's _prefill_slot prefills it; then
    decode_step runs every row at once on the pool (kernel 10 at the
    engine's batch), a row past its tokens repeating its last. fault=True
    rolls the pool's heads by one after the prefills, so each decode step
    reads the prompts' keys and values at the neighbour head: a wrong
    layout, which TP_LIMITS must reject. -> a (len, vocab) f32 tensor on
    the host a row."""
    dev = prompts[0][0].device
    bs, steps = pool.block_size, max(len(t) for t in forced)
    table = torch.zeros_like(pool.table[:len(prompts)])
    length = torch.zeros((len(prompts),), dtype=torch.int32, device=dev)
    out, first = [], 1  # block 0 is the pad block
    for i, ((ids, lens), f) in enumerate(zip(prompts, feats)):
        s, n = ids.shape[1], int(lens[0])
        blocks = -(-(s + steps) // bs)
        if first + blocks > pool.k.shape[1] or blocks > table.shape[1]:
            raise ValueError("teacher_forced_paged: the rows outgrow the "
                             "pool")
        table[i, :blocks] = torch.arange(first, first + blocks,
                                         dtype=table.dtype, device=dev)
        first += blocks
        row = dataclasses.replace(
            pool, table=table[i:i + 1],
            length=torch.zeros((1,), dtype=torch.int32, device=dev))
        embeds = model.build_inputs_embeds(ids, f)
        positions = torch.arange(s, dtype=torch.int32, device=dev)[None]
        hidden, row = model.llm.forward_hidden(embeds, positions, row,
                                               new_length=lens)
        length[i] = row.length[0]
        out.append([model.llm.logits(hidden[:, n - 1])])
    cache = dataclasses.replace(pool, table=table, length=length)
    if fault:
        roll = lambda a: None if a is None else a.roll(1, dims=3)  # noqa: E731
        cache = dataclasses.replace(cache, k=roll(cache.k), v=roll(cache.v),
                                    k_scale=roll(cache.k_scale),
                                    v_scale=roll(cache.v_scale))
    for j in range(steps - 1):
        tok = torch.stack([t[min(j, len(t) - 1)] for t in forced])
        logits, cache = model.llm.decode_step(tok, cache)
        for i, t in enumerate(forced):
            if j < len(t) - 1:
                out[i].append(logits[i:i + 1])
    return [torch.cat(o).float().cpu() for o in out]


def tp_engine(device, model_size: str = "7b"):
    """The tp_phase engine on every rank (and, unsharded, its reference):
    Vicuna-7B int4, unfused (the layout a mesh shards), the vocab padded
    to 256 (bench.py pads to m * 128), seed 0, no speculation."""
    engine = initialize_model(
        model_size=model_size, device=device, seed=0, llm_quant="int4",
        llm_fuse=False, vocab_multiple=TP_VOCAB_MULTIPLE,
        mesh_model=TP_RANKS if driver.active() else None)
    engine.speculative = False
    return engine


def tp_follower(argv) -> None:
    """A follower rank of tp_phase (spawned by driver.start with argv
    [model size, device])."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    session = driver.start(TP_RANKS, "gloo", None, argv[1])
    try:
        tp_engine(session.device, argv[0])
        driver.follow()
    finally:
        driver.stop()


def tp_prompts(engine):
    """The 100-frame video request's padded prompt and the continuous
    engine's requests: the video one (its features) and text ones."""
    conv = conv_templates["pg-video-llava"].copy()
    video = (DEFAULT_VID_START_TOKEN
             + DEFAULT_VIDEO_PATCH_TOKEN * engine.cfg.video_token_len
             + DEFAULT_VID_END_TOKEN)
    conv.append_message(conv.roles[0], QUESTION + "\n" + video)
    conv.append_message(conv.roles[1], None)
    ids, lens, _ = engine.padded_prompt(conv.get_prompt())
    texts = []
    for i, q in enumerate(("Name a colour.", "Count to five.",
                           "What is a video?")[:TP_CONTINUOUS - 1]):
        c = conv_templates["vicuna_v1_1"].copy()
        c.append_message(c.roles[0], q)
        c.append_message(c.roles[1], None)
        texts.append(engine.tokenizer.encode(c.get_prompt()))
    return ids, lens, texts


def tp_padded(tokens, dev):
    """A paged request's prompt as the engine pads it (prompt_pad 128):
    ((1, s_pad) int64, (1,) int32 length) on `dev`."""
    n = len(tokens)
    ids = torch.zeros((1, n + (-n % 128)), dtype=torch.int64, device=dev)
    ids[0, :n] = torch.tensor(tokens)
    return ids, torch.tensor([n], dtype=torch.int32, device=dev)


def tp_requests(engine, feats, ids, lens, texts, new_engine, probe=None):
    """The phase's work on one engine: the 100-frame request (greedy, up
    to TP_TOKENS tokens), then the continuous requests through the paged
    engine. Returns (video tokens, the continuous requests' tokens, the
    continuous engine, idle)."""
    tok = engine.tokenizer
    gen = GenerationConfig(max_new_tokens=TP_TOKENS, do_sample=False,
                           temperature=0.0, eos_token_id=tok.eos_token_id,
                           pad_token_id=tok.pad_token_id)
    res = engine.generate_tokens(ids, lens, feats[None], gen, 0, False)
    video = res.tokens[0, :int(res.lengths[0])].clone()
    if probe is not None:
        probe.report("request")
        probe.reset()
    ceng = new_engine(ContinuousEngine, engine.model, engine.cfg,
                      num_slots=TP_CONTINUOUS, max_cache_len=1024,
                      prompt_pad=128, paged=True, speculative=False)
    reqs = [SlotRequest(ids[0, :int(lens[0])].tolist(),
                        max_new_tokens=TP_PAGED_TOKENS,
                        eos_token_id=tok.eos_token_id, video_features=feats)]
    reqs += [SlotRequest(t, max_new_tokens=TP_PAGED_TOKENS,
                         eos_token_id=tok.eos_token_id) for t in texts]
    handles = [ceng.submit(r) for r in reqs]
    for _ in range(500):
        if all(h.done for h in handles):
            break
        ceng.step_once()
    if not all(h.done for h in handles):
        raise AssertionError("tp_phase: continuous requests unfinished")
    if probe is not None:
        probe.report("paged")
    return video, [list(h.tokens) for h in handles], ceng


def tp_agree(label, got, want, tp_logits, ref_logits) -> str:
    """Tokens equal, or parting first at a step k where both tokens lie
    within eps of the maximum of step k's teacher-forced logits, TP's and
    the reference's alike; eps is twice that step's measured max |TP -
    reference| (an error that size can swap two tokens no further apart;
    the logits themselves are held to TP_LIMITS apart from this)."""
    k = next((i for i, (a, b) in enumerate(zip(got, want)) if a != b),
             None)
    if k is None and len(got) == len(want):
        return f"{label}: {len(got)} tokens equal"
    if k is None or k >= len(tp_logits):
        raise AssertionError(f"{label}: tokens part at {k}: lengths "
                             f"{len(got)} vs {len(want)}")
    tp, ref = tp_logits[k], ref_logits[k]
    eps = 2 * (tp - ref).abs().max().item()
    gaps = [(row.max() - row[tok]).item() for row in (tp, ref)
            for tok in (got[k], want[k])]
    if max(gaps) > eps:
        raise AssertionError(
            f"{label}: tokens part at {k} ({got[k]} vs {want[k]}) where a "
            f"token is {max(gaps):.4f} below a step's maximum > eps "
            f"{eps:.4f}")
    return (f"{label}: tokens equal up to {k} of {len(want)}, then part "
            f"at a near tie (both tokens within {max(gaps):.4f} of the "
            f"maximum, TP's and the reference's, <= eps {eps:.4f})")


def tp_logits_check(label, got, want) -> tuple:
    """Print got against want (teacher-forced logits) as fractions of
    max |want| -> (within TP_LIMITS, max fraction, mean fraction)."""
    err = (got - want).abs()
    scale = want.abs().max().item()
    mx, mean = err.max().item() / scale, err.mean().item() / scale
    ok = bool(torch.isfinite(got).all()) and (mx <= TP_LIMITS[0]
                                              and mean <= TP_LIMITS[1])
    print(f"tp_phase: {label}: teacher-forced logits over {len(want)} "
          f"steps: max|err| {err.max().item():.4f} ({mx:.2%} of max|logit| "
          f"{scale:.3f}), mean {err.mean().item():.5f} ({mean:.3%}); limits "
          f"{TP_LIMITS}{'' if ok else ': out of tolerance'}", flush=True)
    return ok, mx, mean


def tp_phase(dev, card, model_size: str = "7b") -> dict:
    """Tensor parallel on one card (the multi-process path, not a speed
    measurement): the 7B int4 engine (tp_engine) under --mesh_model 2
    --dist_backend gloo, rank 0 this process and rank 1 spawned, both on
    cuda:0, each rank drawing the seeded model whole and keeping its
    shard. The 100-frame request (bench.py's 224 px frames, TP_TOKENS
    greedy tokens) and TP_CONTINUOUS requests (a video and a text one) through
    the paged continuous engine, each held against the single-process
    engine of the same seed built first
    in this run. Teacher-forced logits along the reference's tokens
    within TP_LIMITS: the request end to end (TP's own features into the
    TP LLM, prefill and decode_step on the slot cache) and the paged
    requests through their engine's pool at its batch
    (teacher_forced_paged: kernel 10),
    against the reference's through the same paths; the features within
    TP_FEATURE_LIMITS; tokens equal, or parting at a near tie (tp_agree).
    A planted fault (the TP pool read at the wrong heads) must fall
    outside TP_LIMITS. Each rank's launches of kernels 1, 2, 3, A and B
    (the request) and 10 (the continuous engine) and its peak memory are
    printed; every one must have launched on every rank. The ranks'
    arrival-counter buffers (kernels 3 and 9) are each process's own
    allocation."""
    t_phase = time.perf_counter()
    rng = np.random.default_rng(0)
    frames = rng.integers(0, 256, size=(100, 224, 224, 3), dtype=np.uint8)

    ref = tp_engine(dev, model_size)
    ids, lens, texts = tp_prompts(ref)
    prompts = [tp_padded(ids[0, :int(lens[0])].tolist(), dev)]
    prompts += [tp_padded(t, dev) for t in texts]
    with torch.inference_mode():
        ref_feats = ref.encode_video_frames(frames)
    ref_video, ref_cont, ref_ceng = tp_requests(
        ref, ref_feats, ids, lens, texts, lambda cls, *a, **kw: cls(*a, **kw))
    vocab = ref.cfg.llm.vocab_size  # the columns past it are -inf
    forced = [torch.tensor(b, dtype=torch.int32, device=dev)
              for b in ref_cont]
    ref_logits = teacher_forced(ref.model, ids, lens, ref_feats[None],
                                ref_video)[:, :vocab]
    no_feats = [None] * (len(prompts) - 1)
    ref_paged = [lg[:, :vocab] for lg in teacher_forced_paged(
        ref.model, ref_ceng.cache, prompts, [ref_feats[None]] + no_feats,
        forced)]
    del ref, ref_ceng
    gc.collect()
    torch.cuda.empty_cache()

    out_dir = tempfile.mkdtemp(prefix="tp_phase_")
    if torch.cuda.is_available():
        torch.cuda.reset_peak_memory_stats()  # the build's peak, next
    t0 = time.perf_counter()
    session = driver.start(TP_RANKS, "gloo", None, dev.type,
                           entry=("chip_smoke", "tp_follower"),
                           argv=[model_size, dev.type])
    try:
        engine = tp_engine(session.device, model_size)
        probe = driver.new(TPProbe, out_dir)
        probe.report("build")  # each rank's peak: the whole model drawn
        print(f"tp_phase: 2 ranks up and sharded in "
              f"{time.perf_counter() - t0:.2f} s (rank 0 heads "
              f"{engine.model.llm.cfg.num_heads} of "
              f"{engine.model.llm.full_cfg.num_heads}, CLIP heads "
              f"{engine.model.vision.layers[0].num_heads} of "
              f"{engine.cfg.vision.num_heads})",
              flush=True)
        probe.reset()
        t = time.perf_counter()
        feats = engine.encode_video_frames(frames)
        video, cont, ceng = tp_requests(engine, feats, ids, lens, texts,
                                        driver.new, probe)
        run_s = time.perf_counter() - t
        # end to end: the TP features into the TP LLM
        logits = probe.teacher(engine, ids, lens, feats[None],
                               ref_video)[:, :vocab]
        paged = [lg[:, :vocab] for lg in probe.teacher_paged(
            ceng, prompts, [feats[None]] + no_feats, forced)]
        # the planted fault, on the first 8 tokens of the last (a text)
        # request
        faulted = probe.teacher_paged(
            ceng, prompts[-1:], [None], [forced[-1][:TP_FAULT_TOKENS]],
            True)[0][:, :vocab]
        ranks = {tag: probe.read(tag)
                 for tag in ("build", "request", "paged")}
    finally:
        driver.stop()
    failed = []
    feat_err = (feats.float() - ref_feats.float()).abs()
    feat_scale = ref_feats.float().abs().max().item()
    fmx, fmean = (feat_err.max().item() / feat_scale,
                  feat_err.mean().item() / feat_scale)
    print(f"tp_phase: video features (CLIP and pooling under TP) max|err| "
          f"{feat_err.max().item():.4f} ({fmx:.3%} of max|feature| "
          f"{feat_scale:.3f}), mean {feat_err.mean().item():.5f} "
          f"({fmean:.4%}); limits {TP_FEATURE_LIMITS}", flush=True)
    if not (fmx <= TP_FEATURE_LIMITS[0] and fmean <= TP_FEATURE_LIMITS[1]):
        failed.append("video features out of tolerance")
    readings = {}
    checks = ([("100-frame request, end to end", logits, ref_logits,
                video.tolist(), ref_video.tolist())]
              + [(f"paged request {i}", paged[i], ref_paged[i], cont[i],
                  ref_cont[i]) for i in range(len(forced))])
    for label, got, want, toks, ref_toks in checks:
        ok, mx, mean = tp_logits_check(label, got, want)
        readings[label] = [mx, mean]
        if not ok:
            failed.append(f"{label}: teacher-forced logits out of tolerance")
        try:
            print("tp_phase: " + tp_agree(label, toks, ref_toks, got, want),
                  flush=True)
        except AssertionError as e:
            print(f"tp_phase: {e}", flush=True)
            failed.append(str(e))
    ok, mx, mean = tp_logits_check(
        "planted fault (the pool read at the wrong heads), which must "
        "fall outside the limits", faulted,
        ref_paged[-1][:TP_FAULT_TOKENS])
    readings["planted fault"] = [mx, mean]
    if ok:
        failed.append("the planted wrong-heads fault passed TP_LIMITS")
    for r in ranks["build"]:
        print(f"tp_phase rank {r['rank']} build peak {r['peak_gib']:.2f} GiB "
              "(the whole seeded model drawn, then sharded)", flush=True)
    for tag, path in (("request", TP_PATH),
                      ("paged", ("decode_attention_paged",))):
        for r in ranks[tag]:
            print(f"tp_phase rank {r['rank']} {tag} launches "
                  f"{r['launches']}, peak {r['peak_gib']:.2f} GiB",
                  flush=True)
            missing = [k for k in path if not r["launches"].get(k)]
            if missing:
                failed.append(f"rank {r['rank']} {tag}: kernels never "
                              f"launched: {missing}")
    shutil.rmtree(out_dir, ignore_errors=True)
    if failed:
        raise AssertionError(f"tp_phase: {failed}")
    wall = time.perf_counter() - t_phase
    print(f"tp_phase: 100-frame request and {TP_CONTINUOUS} paged requests "
          f"on 2 ranks in {run_s:.2f} s; phase wall {wall:.2f} s; {card}")
    print("tp_phase: no multi-GPU speed is measured: 2 ranks share one card",
          flush=True)
    return {"wall_s": wall, "launches": ranks, "logits": readings}


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda:0")
    card = card_line()
    print(f"card: {card}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"python {sys.version.split()[0]}", flush=True)

    t0 = time.perf_counter()
    lib_path = cuda_lib.build()
    cuda_lib.library()
    print(f"kernels built in {time.perf_counter() - t0:.2f} s: {lib_path}")
    with open(lib_path[:-3] + ".log") as f:
        for line in f:
            if "registers" in line or "spill" in line:
                print("ptxas:", line.strip())

    with torch.inference_mode():
        results = kernel_checks(dev)
    for quant in (None, "int4"):
        small_model_check(dev, quant)
        small_model_check(dev, quant, kv_heads=2)
    torch.cuda.empty_cache()

    # Frames come from a seed, not through an mp4: the native decoder's
    # libav libraries (libavformat.so.59, ...) are not installed on the
    # card's machine, so upload_frames stands in for upload_video.
    rng = np.random.default_rng(0)
    clips = {name: rng.integers(0, 256, size=(n, 240, 320, 3),
                                dtype=np.uint8)
             for name, n in (("long", 100), ("short", 12))}
    requests = [  # (clip or None for the same session, text, temperature)
        ("long", QUESTION, 0.0),
        (None, "What happens next?", 0.0),
        ("short", "Describe the scene.", 0.2),
    ]
    launches = {}
    for quant in (None, "int4"):
        # the chat interface decodes without speculation, as the JAX
        # package's chat CLI does
        label = f"{quant or 'bf16'} chat (speculative=False)"
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        engine = initialize_model(model_size="7b", device=dev, seed=0,
                                  llm_quant=quant, llm_fuse=bool(quant))
        engine.speculative = False
        torch.cuda.synchronize()
        llm = engine.model.llm
        print(f"initialize_model(7b, llm_quant={quant}): "
              f"{time.perf_counter() - t0:.2f} s, peak "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; LLM "
              f"int4 bytes {weight_bytes(llm, ('qvalues_packed',))}, "
              f"int8 bytes {weight_bytes(llm, ('qvalues',))}, scale bytes "
              f"{weight_bytes(llm, ('scales',))}, other bytes "
              f"{weight_bytes(llm, ('kernel', 'weight', 'scale'))}",
              flush=True)
        counts = chat_requests(engine, clips,
                               requests if quant is None else requests[:2],
                               dev, label)
        path = BF16_PATH if quant is None else INT4_PATH
        missing = [k for k in path if not counts.get(k)]
        if missing:
            raise AssertionError(f"{label}: kernels never launched on the "
                                 f"path: {missing}")
        if quant:
            per_step = len(llm.layers) * 4  # wqkv, wo, gate_up, down
            if counts["w4a8_matvec"] < per_step * counts["decode_steps"]:
                raise AssertionError("kernel A launched fewer than 4 x 32 "
                                     "times a decode step")
            if counts["w4a8_block"] < per_step * counts["prefills"]:
                raise AssertionError("kernel B launched fewer than 4 x 32 "
                                     "times a prefill")
        profile_request(engine, clips, dev, label)
        if quant:
            profile_decode_phase(engine, card)
        if quant is None:  # the seed engine's weights as checkpoints
            checkpoint_phase(engine, clips, requests, dev, card)
        # the bf16 kernels' launches are the bf16 path's, A's and B's
        # the int4 path's, kernel 10's the serving path's
        launches.update({k: counts[k] for k in path if k not in launches})
        if quant:
            w4 = w4a16_chat_phase(engine, clips, requests[:2], dev)
            launches.update({k: w4[k] for k in ("w4a16_matvec",
                                                "w4a16_block")})
            served = serving_phase(engine, clips, dev)
            launches["decode_attention_paged"] = served[
                "decode_attention_paged"]
            launches["decode_attention_mxu"] = paged_off_phase(
                engine, dev)["decode_attention_mxu"]
            launches["multi_scale_deformable_attention"] = grounding_phase(
                engine, dev, results)
            evaluated = grounding_eval_phase(engine, dev, results)
            missing = [k for k in GROUNDING_PATH if not evaluated.get(k)]
            if missing:
                raise AssertionError(f"grounding eval: kernels never "
                                     f"launched on the path: {missing}")
            audio = audio_phase(engine, clips, dev, results)
            launches["flash_forward_f32"] = audio["flash_forward_f32"]
        del engine, llm
        gc.collect()
        torch.cuda.empty_cache()
    tp_phase(dev, card)
    batching_phase(clips, dev, results, card)
    launches["decode_attention_pallas"] = gqa_chat_phase(
        clips, requests[:1], dev)["decode_attention_pallas"]
    eval_13b_phase(dev, results)
    learned = learned_grounding_phase(dev, results)
    launches["flash_attention_bhsd_f32"] = learned["flash_attention_bhsd_f32"]
    profile_xmem_phase(dev, card)
    tracking_quality_phase(dev, card)
    save_features_phase(dev, results, card)
    trained = training_phase(dev, results)
    launches.update({k: trained[k] for k in TRAIN_PATH + TRAIN_PATH_F32[1:]})

    # kernel 7's entry also carries the audio path's launches (over the
    # 60 s transcribe) and its checks at the audio shapes
    results["flash_forward"].update(audio_launches=audio["flash_forward"],
                                    audio=audio["checks"])
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": tpu,
         "launches": launches[name], **results[name]}
        for name, (src, tpu) in KERNELS.items()
    ]}))
    print(f"card: {card}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
