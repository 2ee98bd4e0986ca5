#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which raises on failure (exit code != 0):
  1. print the card (nvidia-smi name, power limit) and torch/CUDA versions;
  2. build the CUDA kernels from video_llava_tpu_torch/csrc;
  3. check each kernel against its plain PyTorch version at the chat
     path's shapes (plus the 336 px CLIP shape, the 12-frame pool and
     the int8 cache), timing both with CUDA events;
  4. check a small model end to end: the CUDA path in bf16 against the
     plain path on the CPU in f32;
  5. build Vicuna-7B + CLIP ViT-L/14-224 with random bf16 weights and
     answer three chat requests through VideoChatGPTInterface (a
     100-frame clip at temperature 0, a second turn, a 12-frame clip at
     temperature 0.2; frames from a seed), with every kernel's launch
     count taken over exactly that run;
  6. print stage times, the kernels' JSON line, the card line and, last,
     {"ok": true, "device": {...}}.
It needs a CUDA card and the repository beside it, and imports no JAX.
"""

from __future__ import annotations

import dataclasses
import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

from video_llava_tpu.config import LlamaConfig, VideoLLaVAConfig
from video_llava_tpu.constants import (
    DEFAULT_VID_END_TOKEN,
    DEFAULT_VID_START_TOKEN,
    DEFAULT_VIDEO_PATCH_TOKEN,
    DEFAULT_VIDEO_TOKEN,
)
from video_llava_tpu.runtime.conversation import conv_templates
from video_llava_tpu.runtime.tokenizer import load_tokenizer
from video_llava_tpu_torch.models.video_llava import VideoLLaVA
from video_llava_tpu_torch.ops import attention, cuda_lib, pooling
from video_llava_tpu_torch.runtime.chat import VideoChatGPTInterface
from video_llava_tpu_torch.runtime.model_init import (
    initialize_model,
    random_init_,
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
}
# Kernel vs plain on the card, both bf16 out. flash: the kernel rounds P
# to bf16 for its second product and accumulates in another order;
# decode: the plain version dequantizes int8 to bf16, the kernel keeps
# f32; pool: f32 sums in another order. Each differs from the plain
# version by a few bf16 ulps of outputs of magnitude < 2.
TOL = {"flash_attention_bhsd": 2e-2, "spatio_temporal_pool": 1e-2,
       "decode_attention_stacked": 2e-2}


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def median_ms(fn, iters: int = 20) -> float:
    """Median of `iters` single calls, each timed with CUDA events."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def check(results, name, shape, fn, plain):
    """Kernel vs plain on the same inputs; raise past the tolerance."""
    got, want = fn(), plain()
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs().max().item()
    if not np.isfinite(err) or err > TOL[name]:
        raise AssertionError(f"{name} {shape}: max |err| {err} > {TOL[name]}")
    r = results.setdefault(name, {"max_abs_err": 0.0})
    r["max_abs_err"] = max(r["max_abs_err"], err)
    ms, plain_ms = median_ms(fn), median_ms(plain)
    if "ms" not in r:  # the first shape listed is the chat path's
        r["ms"], r["plain_ms"] = ms, plain_ms
    print(f"check {name} {shape}: max|err| {err:.3e} (tol {TOL[name]}), "
          f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms", flush=True)


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
    # CLIP attention: 100 frames x 16 heads, 224 px then 336 px
    for s, s_pad in ((257, 272), (577, 640)):
        q, k, v = (rnd(100, 16, s_pad, 64) for _ in range(3))
        check(results, "flash_attention_bhsd", (100, 16, s_pad, 64, s),
              lambda: attention.flash_attention_bhsd(q, k, v, kv_len=s),
              lambda: attention.flash_attention_bhsd_plain(q, k, v,
                                                           kv_len=s))
    del q, k, v
    # pooling: 100 frames, then a 12-frame clip
    for t in (100, 12):
        x = rnd(t, 256, 1024)
        check(results, "spatio_temporal_pool", (t, 256, 1024),
              lambda: pooling.spatio_temporal_pool_fused(x, t),
              lambda: pooling.spatio_temporal_pool(x, t))
    # decode attention at the first chat turn's cache, mid-answer
    n_prompt, L = chat_cache_len(VideoLLaVAConfig())
    lens = torch.tensor([n_prompt + MAX_NEW_TOKENS // 2], dtype=torch.int32,
                        device=dev)
    q = rnd(1, 1, 32, 128)
    kc, vc = rnd(32, 1, L, 32, 128), rnd(32, 1, L, 32, 128)
    check(results, "decode_attention_stacked", (32, 1, L, 32, 128, "bf16"),
          lambda: attention.decode_attention_stacked(q, kc, vc, 17, lens),
          lambda: attention.decode_attention_stacked_plain(q, kc, vc, 17,
                                                           lens))
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
                                                           lens, ks, vs))
    return results


def small_model_check(dev) -> None:
    """A small VideoLLaVA (head dims the kernels take) through the CUDA
    path in bf16 against the same weights on the CPU plain path in f32:
    pooled video features and prefill logits, relative to their scale."""
    tok = load_tokenizer(None)
    cfg = dataclasses.replace(
        VideoLLaVAConfig.tiny(),
        llm=dataclasses.replace(LlamaConfig.tiny(vocab_size=512),
                                num_heads=4, num_kv_heads=4, head_dim=64),
        vid_patch_token_id=tok.vid_patch_token_id,
        vid_start_token_id=tok.vid_start_token_id,
        vid_end_token_id=tok.vid_end_token_id,
    )
    ref = VideoLLaVA(cfg, device="cpu", dtype=torch.float32)
    random_init_(ref, torch.Generator().manual_seed(0))
    gpu = VideoLLaVA(cfg, device=dev, dtype=torch.bfloat16)
    gpu.load_state_dict({k: v.to(dev, torch.bfloat16)
                         for k, v in ref.state_dict().items()})
    rng = np.random.default_rng(0)
    pixels = torch.from_numpy(
        rng.normal(size=(12, 56, 56, 3)).astype(np.float32))
    ids = rng.integers(0, 256, size=(1, 256))
    ids[0, 8:8 + cfg.video_token_len] = cfg.vid_patch_token_id
    ids = torch.from_numpy(ids)
    lens = torch.tensor([250], dtype=torch.int32)
    with torch.inference_mode():
        f_ref = ref.encode_video(pixels, 12)
        f_gpu = gpu.encode_video(pixels.to(dev), 12)
        p_ref = ref.prefill(ids, lens, f_ref[None], 264, torch.float32)
        p_gpu = gpu.prefill(ids.to(dev), lens.to(dev), f_gpu[None], 264)
        tok_ref = p_ref.logits_last.argmax(-1)
        d_ref, _ = ref.llm.decode_step(tok_ref.int(), p_ref.cache)
        d_gpu, _ = gpu.llm.decode_step(tok_ref.int().to(dev), p_gpu.cache)
    for name, a, b in (("video features", f_gpu, f_ref),
                       ("prefill logits", p_gpu.logits_last,
                        p_ref.logits_last),
                       ("decode logits", d_gpu, d_ref)):
        a = a.float().cpu()
        rel = ((a - b).abs().max() / b.abs().max()).item()
        print(f"small model {name}: shape {tuple(a.shape)}, max|err| / "
              f"max|ref| = {rel:.3e} (bf16 CUDA vs f32 CPU, limit 5e-2)")
        if not torch.isfinite(a).all() or rel > 5e-2:
            raise AssertionError(f"small model {name} disagrees: {rel}")


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
    small_model_check(dev)
    torch.cuda.empty_cache()

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    engine = initialize_model(model_size="7b", device=dev, seed=0)
    torch.cuda.synchronize()
    print(f"initialize_model(7b): {time.perf_counter() - t0:.2f} s, peak "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB", flush=True)

    llm = engine.model.llm
    stats = {"nonfinite": 0, "prefill_s": 0.0, "decode_steps": 0}
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
        return out

    def decode_step(*a, **kw):
        stats["decode_steps"] += 1
        return decode_fn(*a, **kw)

    llm.logits, engine.model.prefill = logits, prefill
    llm.decode_step = decode_step

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
    # warm-up (cuBLAS handles, allocator) so stage times are steady ones
    engine.encode_video_frames(clips["short"])
    torch.cuda.synchronize()
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
            if (tuple(feats.shape) != (engine.cfg.video_token_len, 1024)
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
        print(f"request {text!r} T={temp}: encode {encode_s * 1e3:.1f} ms, "
              f"prefill {stats['prefill_s'] * 1e3:.1f} ms, decode "
              f"{stats['decode_steps']} steps in {decode_s * 1e3:.1f} ms "
              f"({stats['decode_steps'] / decode_s:.2f} tok/s), answer "
              f"{len(answer)} chars", flush=True)
    launches = dict(cuda_lib.LAUNCHES)
    print(f"launches over the three requests: {launches}")
    print(f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f}"
          " GiB")
    if stats["nonfinite"]:
        raise AssertionError(f"{stats['nonfinite']} non-finite logits")
    missing = [k for k in KERNELS if not launches.get(k)]
    if missing:
        raise AssertionError(f"kernels never launched on the path: {missing}")

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
