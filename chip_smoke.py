#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which raises on failure (exit code != 0):
  1. print the card (nvidia-smi name, power limit) and torch/CUDA versions;
  2. build the CUDA kernels from video_llava_tpu_torch/csrc;
  3. check each kernel against its plain PyTorch version at the chat
     and serving paths' shapes (plus the 336 px CLIP shape, the 12-frame
     pool and 9 valid frames of 12, the int8 caches, the paged pool with
     bf16 and int8 values, kernels 3, 9 and 10 at 65,536 positions,
     for the W4A8 and W4A16 kernels Vicuna-7B's decode and prefill
     linears in the bf16-out build the path launches and in f32 out, a
     flat per-layer weight and a 1100-row prompt, the flat-cache decode
     kernels 9 and 11 at the chat and serving shapes, kernels 3 and 10 at
     head dim 32, kernels A and B at serving's 4-row decode, 36-row
     verify and 256-row prefill window, CLIP's pad keys and values set
     large, the W4A16 block matmul at 2, 8, 36, 256, 768 and 1100 rows,
     and planted faults in the plain versions of kernels 1, 2, 9, 10, 11,
     A, B and both W4A16 kernels that must fail), timing the
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
     profile_request);
  6. free it, build the same model with int4 W4A8 LLM weights (fused
     wqkv/gate_up, int8 lm_head and embedding: --quant int4) and answer
     the 100-frame request and a second turn, launch counts again taken
     over exactly that run, and profile the 100-frame request; then the
     same with the A8 switches off (w4a16_chat_phase: the W4A16 kernels);
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
     clip, with stage times, launch counts, a profile and peak memory;
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
     100-frame request (gqa_chat_phase: kernel 11), profiled, and free it;
  10. train (training_phase): kernels 7 and 8 against their
     plain versions at the training layer's shape and four others, then
     (flash_limit_checks) at b*h = 65,600 through each body of kernel 7
     (bf16 Hopper and WMMA, f32) and at head dim 24 (padded to 32), a
     small model's train steps on the card against the CPU (bf16 and an
     int8 LLM), then `python -m video_llava_tpu_torch.train.train
     --model_size 7b` for 4 optimizer steps on seeded features, with its
     checkpoint, export and a profile of step 3;
  11. print stage times, the kernels' JSON line, the card line and, last,
     {"ok": true, "device": {...}}.
It needs a CUDA card and the repository beside it, and imports no JAX.
"""

from __future__ import annotations

import concurrent.futures
import dataclasses
import gc
import hashlib
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
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
from video_llava_tpu_torch.engine.continuous import SlotRequest
from video_llava_tpu_torch.grounding import fused_clip, results as gresults
from video_llava_tpu_torch.grounding.builders import build_grounding_stack
from video_llava_tpu_torch.media import scene as scene_mod
from video_llava_tpu_torch.models.video_llava import VideoLLaVA
from video_llava_tpu_torch.models import grounding_dino as gdino
from video_llava_tpu_torch.models import wav2vec2 as w2v
from video_llava_tpu_torch.models import whisper as whisper_mod
from video_llava_tpu_torch.models.layers import TreeInit
from video_llava_tpu_torch.ops import (
    attention,
    cuda_lib,
    deformable,
    pooling,
    quant4,
)
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
from video_llava_tpu_torch.runtime.tokenizer import load_tokenizer
from video_llava_tpu_torch.serving.server import (
    ChatModel,
    ContinuousChatModel,
    serve,
)
from video_llava_tpu_torch.train import train
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
    "flash_backward_dq": ("video_llava_tpu_torch/csrc/flash_attention.cu",
                          "video_llava_tpu/ops/attention.py:625"),
    "flash_backward_dkv": ("video_llava_tpu_torch/csrc/flash_attention.cu",
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
GROUNDING_PATH = ("multi_scale_deformable_attention",)
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


def median_ms(fn, calls: int = 10, reps: int = 7,
              capture: bool = True) -> float:
    """Device time of one call: `calls` calls captured in a CUDA graph,
    the graph replayed `reps` times, each replay timed with CUDA events;
    the median over replays, per call. A replay launches back to back,
    so the host's Python overhead around each call (tens of µs, more
    than a decode-sized kernel takes) is not counted. capture=False (an
    autograd backward, which is not captured): the `calls` calls
    launched back to back, each rep timed the same way, so the host
    counts only where it falls behind a call's device time."""
    fn()
    torch.cuda.synchronize()
    if not capture:
        times = []
        for _ in range(reps):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(calls):
                fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end) / calls)
        return statistics.median(times)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    del graph
    return statistics.median(times)


def rotating_ms(fns) -> float:
    """Device time of one call that reads its operands from HBM, not L2:
    `fns` are the same call on different copies (layers) of the operands,
    together past the 50 MB L2, captured one after another in one graph;
    the replay's median time (median_ms) over len(fns)."""
    return median_ms(lambda: [f() for f in fns], calls=1) / len(fns)


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
    return results


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
                            "(anonymous namespace)::", "void flash::"))


def busy_and_names(spans):
    """(name, start ns, end ns) of device activities -> (busy ms: the
    length of the union of their intervals, {name: (total us, calls)})."""
    busy_ns, end = 0.0, float("-inf")
    by_name: dict = {}
    for name, start, stop in sorted(spans, key=lambda s: s[1]):
        busy_ns += max(0.0, stop - max(start, end))
        end = max(end, stop)
        total, calls = by_name.get(name, (0.0, 0))
        by_name[name] = (total + (stop - start) / 1e3, calls + 1)
    return busy_ns / 1e6, by_name


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
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        request()
    device = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not device:
        raise AssertionError(f"{label} profile: no device activity")
    busy_ms, by_name = busy_and_names(
        (e.name, e.time_range.start * 1e3, e.time_range.end * 1e3)
        for e in device)
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
                ids, max_new_tokens=MAX_NEW_TOKENS, temperature=0.0,
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
    block matmul, kernels A and B never), then the profile pass."""
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
        profile_request(engine, clips, dev, label)
    finally:
        quant4.A8_DECODE, quant4.A8_BLOCK = saved
    return counts


def gqa_chat_phase(clips, requests, dev) -> dict:
    """Vicuna-7B with 8 KV heads for its 32 query heads (int4, fused, as
    --quant int4 builds it): `requests` through the chat interface, the
    decode attention through kernel 11 (32 launches a decode step, kernel
    3 never), then the profile pass; the engine is freed after."""
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
    profile_request(engine, clips, dev, label)
    del engine
    gc.collect()
    torch.cuda.empty_cache()
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
    """The two raises kernel 7's wrapper lifted, on the card: b*h past
    the grid's y limit (now along x) through each body, forward against
    the plain forward and, in bf16, kernel 8 against the plain backward;
    head dim 24 (d % 16 == 8, zero-padded with the unpadded d's scale)
    through the bf16 forward and backward and the f32 forward. Limits:
    flash_checks' in bf16 (absolute and lse; gradients of max |ref|),
    F32_FLASH_TOL in f32. Not timed: no path runs these shapes."""
    g = torch.Generator(device=dev).manual_seed(7)
    cases = [((16400, 16, 16, 4, 4, d), dtype)
             for d, dtype in FLASH_WIDE_BODIES]
    cases += [(FLASH_PAD_SHAPE + (24,), dtype)
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
        if not f32:
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


def small_train_check(dev, llm_weights: str = "bf16") -> None:
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
    a near-zero gradient moves by 2 lr."""
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
    for where, dtype in ((dev, torch.bfloat16), ("cpu", torch.float32)):
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
    before = dict(cuda_lib.LAUNCHES)
    for where, model in models.items():
        tx = make_optimizer(1e-3, 0.0, warmup_steps=0, total_steps=4)
        state = init_train_state(model, tx, trainable_mask(model))
        step = make_train_step(tx, grad_accum=2)
        mb = {k: torch.from_numpy(v).to(where) for k, v in batch.items()}
        metrics[where] = []
        for _ in range(2):
            state, m = step(state, mb)
            metrics[where].append((float(m["loss"]), float(m["grad_norm"])))
    if not all(cuda_lib.LAUNCHES[k] > before.get(k, 0) for k in TRAIN_PATH):
        raise AssertionError("small train step did not run kernels 7 and 8")
    for i, ((loss, norm), (loss_ref, norm_ref)) in enumerate(
            zip(metrics[dev], metrics["cpu"])):
        rel_loss = abs(loss - loss_ref) / abs(loss_ref)
        rel_norm = abs(norm - norm_ref) / norm_ref
        print(f"small {llm_weights} train step {i}: loss {loss:.5f} (CPU f32 "
              f"{loss_ref:.5f}, rel {rel_loss:.2e}, limit 2e-2), grad norm "
              f"{norm:.5f} (CPU f32 {norm_ref:.5f}, rel {rel_norm:.2e}, "
              "limit 5e-2)", flush=True)
        if not (np.isfinite(loss) and np.isfinite(norm) and rel_loss <= 2e-2
                and rel_norm <= 5e-2):
            raise AssertionError(f"small {llm_weights} train step {i} "
                                 "disagrees with the CPU")


TRAIN_SAMPLES, TRAIN_LAYER = 32, 7  # samples; the frozen layer checksummed
TRAIN_ROWS = (600, 1000)  # tokens of alternate samples: the 640, 1024 buckets


def write_train_data(root: str):
    """TRAIN_SAMPLES samples of {"video", "conversations": [human
    "<video>\\n...", gpt "..."]} in root/data.json and a (356, 1024) f32
    .npy feature file each in root/features, from
    np.random.default_rng(0). Answers are sized with the byte tokenizer
    so that alternate rows take TRAIN_ROWS tokens: the video block and
    the template alone take 577, so the shortest rows fall in the 640
    bucket, not 512. Returns (data path, feature folder)."""
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
        target = TRAIN_ROWS[i % 2]
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


def trace_busy(path: str):
    """(busy ms, {name: (total us, calls)}) of the device activities
    (kernels, copies, memsets) in a torch.profiler chrome trace."""
    with open(path) as f:
        trace = json.load(f)
    events = trace["traceEvents"] if isinstance(trace, dict) else trace
    return busy_and_names(
        (e["name"], e["ts"] * 1e3, (e["ts"] + e["dur"]) * 1e3)
        for e in events if e.get("ph") == "X"
        and e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset"))


def train_7b(dev) -> dict:
    """The training entry point at full width: python -m
    video_llava_tpu_torch.train.train --model_size 7b (Vicuna-7B + the
    linear projector, bf16, random weights from --seed, tune_mode
    projector+embed) on write_train_data's 32 samples, batch 4 x
    gradient accumulation 2, one epoch: 4 optimizer steps, the profile
    on step 3, the final checkpoint-4 (the whole state, the frozen LLM
    included) and mm_projector.bin, in a temp dir removed afterwards.
    Launch counts over exactly train.main; kernel 7 must run 2 x 32 x 2
    times a step (forward and the remat recompute of each layer of each
    microbatch), dq and dk/dv 32 x 2. A frozen layer must keep its bytes
    and the projector and embed_tokens must move. Then the same command
    for two epochs must resume: restore checkpoint-4 with the trainables
    run 1 ended with and take steps 5-12. Returns run 1's counts."""
    root = tempfile.mkdtemp(prefix="vlt_train_")
    try:
        data, folder = write_train_data(root)
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

        accum, steps = 2, TRAIN_SAMPLES // 8
        argv = ["--data_path", data, "--video_folder", folder,
                "--output_dir", out, "--model_size", "7b",
                "--per_device_train_batch_size", "4",
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
        return launches
    finally:
        shutil.rmtree(root, ignore_errors=True)


def training_phase(dev, results) -> dict:
    """Kernels 7 and 8 (flash_checks, then flash_limit_checks), the small
    train steps in bf16 and with an int8 LLM (small_train_check), then 7B
    through the entry point (train_7b). Returns the 7B run's launch
    counts."""
    t0 = time.perf_counter()
    flash_checks(dev, results)
    flash_limit_checks(dev)
    torch.cuda.empty_cache()
    small_train_check(dev)
    small_train_check(dev, "int8")
    launches = train_7b(dev)
    gc.collect()
    torch.cuda.empty_cache()
    print(f"training phase: {time.perf_counter() - t0:.2f} s", flush=True)
    return launches


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
    around synchronized calls); a third runs under torch.profiler.
    Returns kernel 12's launches of the counted answer."""
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
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            answer(clip)
            torch.cuda.synchronize()
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


def weight_bytes(module, leaves) -> int:
    return sum(p.numel() * p.element_size()
               for n, p in module.named_parameters()
               if n.rsplit(".", 1)[-1] in leaves)


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
            audio = audio_phase(engine, clips, dev, results)
            launches["flash_forward_f32"] = audio["flash_forward_f32"]
        del engine, llm
        gc.collect()
        torch.cuda.empty_cache()
    launches["decode_attention_pallas"] = gqa_chat_phase(
        clips, requests[:1], dev)["decode_attention_pallas"]
    trained = training_phase(dev, results)
    launches.update({k: trained[k] for k in TRAIN_PATH})

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
