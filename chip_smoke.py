#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which raises on failure (exit code != 0):
  1. print the card (nvidia-smi name, power limit) and torch/CUDA versions;
  2. build the CUDA kernels from video_llava_tpu_torch/csrc;
  3. check each kernel against its plain PyTorch version at the chat
     path's shapes (plus the 336 px CLIP shape, the 12-frame pool, the
     int8 cache, and for the W4A8 kernels Vicuna-7B's decode and
     prefill linears in the bf16-out build the path launches and in
     f32 out, a flat per-layer weight and a 1100-row prompt), timing
     both with CUDA events;
  4. check a small model end to end, in bf16 and with int4 W4A8 LLM
     weights: the CUDA path in bf16 against the plain path on the CPU
     in f32;
  5. build Vicuna-7B + CLIP ViT-L/14-224 with random bf16 weights and
     answer three chat requests through VideoChatGPTInterface (a
     100-frame clip at temperature 0, a second turn, a 12-frame clip at
     temperature 0.2; frames from a seed), with every kernel's launch
     count taken over exactly that run; then profile the 100-frame
     request once more (see profile_request);
  6. free it, build the same model with int4 W4A8 LLM weights (fused
     wqkv/gate_up, int8 lm_head and embedding: --quant int4) and answer
     the 100-frame request and a second turn, launch counts again taken
     over exactly that run, and profile the 100-frame request;
  7. print stage times, the kernels' JSON line, the card line and, last,
     {"ok": true, "device": {...}}.
It needs a CUDA card and the repository beside it, and imports no JAX.
"""

from __future__ import annotations

import dataclasses
import gc
import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from video_llava_tpu_torch.config import LlamaConfig, VideoLLaVAConfig
from video_llava_tpu_torch.constants import (
    DEFAULT_VID_END_TOKEN,
    DEFAULT_VID_START_TOKEN,
    DEFAULT_VIDEO_PATCH_TOKEN,
    DEFAULT_VIDEO_TOKEN,
)
from video_llava_tpu_torch.models.video_llava import VideoLLaVA
from video_llava_tpu_torch.ops import attention, cuda_lib, pooling, quant4
from video_llava_tpu_torch.runtime.chat import VideoChatGPTInterface
from video_llava_tpu_torch.runtime.conversation import conv_templates
from video_llava_tpu_torch.runtime.model_init import (
    initialize_model,
    random_init_,
    random_init_quantized_llm_,
)
from video_llava_tpu_torch.runtime.tokenizer import load_tokenizer

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
}
BF16_PATH = ("flash_attention_bhsd", "spatio_temporal_pool",
             "decode_attention_stacked")
# Kernel vs plain on the card, both bf16 out. flash: the kernel rounds P
# to bf16 for its second product and accumulates in another order;
# decode: the plain version dequantizes int8 to bf16, the kernel keeps
# f32; pool: f32 sums in another order. Each differs from the plain
# version by a few bf16 ulps of outputs of magnitude < 2.
TOL = {"flash_attention_bhsd": 2e-2, "spatio_temporal_pool": 1e-2,
       "decode_attention_stacked": 2e-2}
# W4A8 as max|err| / max|ref|: kernel and plain version quantize the
# activations by the same rule and form exact integer partials, so in f32
# out only the order of the f32 sums over groups differs. In bf16 out
# (what the path launches) the two f32 results round to bf16 at most one
# ulp apart, and an ulp is at most 2^-7 of the value.
REL_TOL = {"w4a8_matvec": {torch.float32: 1e-4, torch.bfloat16: 2 ** -7},
           "w4a8_block": {torch.float32: 1e-4, torch.bfloat16: 2 ** -7}}


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def median_ms(fn, calls: int = 10, reps: int = 7) -> float:
    """Device time of one call: `calls` calls captured in a CUDA graph,
    the graph replayed `reps` times, each replay timed with CUDA events;
    the median over replays, per call. A replay launches back to back,
    so the host's Python overhead around each call (tens of µs, more
    than a decode-sized kernel takes) is not counted."""
    fn()
    torch.cuda.synchronize()
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


def check(results, name, shape, fn, plain):
    """Kernel vs plain on the same inputs; raise past the tolerance
    (absolute, or relative to max |ref| for the REL_TOL kernels, by the
    output's dtype)."""
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
    if not np.isfinite(rel) or rel > tol:
        raise AssertionError(f"{name} {shape}: {note}")
    r = results.setdefault(name, {"max_abs_err": 0.0})
    r["max_abs_err"] = max(r["max_abs_err"], err)
    ms, plain_ms = median_ms(fn), median_ms(plain)
    if "ms" not in r:  # the first shape listed is the chat path's
        r["ms"], r["plain_ms"] = ms, plain_ms
    print(f"check {name} {shape}: {note}, max|err| {err:.3e}, "
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
    del q, kc, vc, kq, vq, ks, vs
    w4a8_checks(dev, g, results)
    return results


def w4a8_checks(dev, g, results) -> None:
    """Kernels A and B on Vicuna-7B's linears, bf16 activations as on the
    path. First the build the path launches, bf16 out (its times go in
    the kernels line), against the plain version rounded to bf16; then
    f32 out, where the 1e-4 relative bound is not hidden by bf16
    rounding. Stacked weights are (4, Dh, F), read at layer 2 as a view;
    one weight of each kernel is a flat per-layer tensor."""

    def weight(d, f, layers=None):
        w = torch.randn(layers or 1, d, f, generator=g, device=dev)
        packed, scales = quant4.quantize_tensor_int4(w * d ** -0.5, 128)
        return (packed, scales) if layers else (packed[0], scales[0])

    def act(n, d):
        return torch.randn(n, d, generator=g, device=dev).to(torch.bfloat16)

    cfg = LlamaConfig.vicuna_7b()
    d, f = cfg.hidden_size, cfg.intermediate_size
    wqkv = weight(d, 3 * d, layers=4)
    gate_up = weight(d, 2 * f, layers=4)
    down = weight(f, d, layers=4)
    wo = weight(d, d)  # flat per-layer
    bf16, f32 = torch.bfloat16, torch.float32
    for name, nb, (pk, sc), stacked, out in (
            ("w4a8_matvec", 1, wqkv, True, bf16),
            ("w4a8_matvec", 1, down, True, bf16),
            ("w4a8_block", 768, gate_up, True, bf16),
            ("w4a8_block", 768, down, True, bf16),
            ("w4a8_matvec", 1, wqkv, True, f32),
            ("w4a8_matvec", 1, down, True, f32),
            ("w4a8_matvec", 4, gate_up, True, f32),
            ("w4a8_matvec", 1, wo, False, f32),
            ("w4a8_block", 768, gate_up, True, f32),
            ("w4a8_block", 768, down, True, f32),
            ("w4a8_block", 1100, wo, False, f32)):
        p, s = (pk[2], sc[2]) if stacked else (pk, sc)
        x = act(nb, 2 * p.shape[0])
        kernel = getattr(quant4, name)
        plain = (quant4.int4_matmul_w4a8_xla if name == "w4a8_matvec"
                 else quant4.int4_matmul_w4a8_block_xla)
        check(results, name,
              (nb, 2 * p.shape[0], p.shape[1], "layer 2 of 4" if stacked
               else "flat", f"{str(out)[6:]} out"),
              lambda: kernel(x, p, s, out), lambda: plain(x, p, s).to(out))


SMALL_LIMIT = {None: 5e-2, "int4": 1e-1}


def small_model_check(dev, quant=None) -> None:
    """A small VideoLLaVA (head dims the kernels take) through the CUDA
    path in bf16 against the same weights on the CPU plain path in f32:
    pooled video features, prefill and decode logits, relative to their
    scale. quant="int4": the LLM in the --quant int4 layout (every layer
    kernel int4, a 512-word int4 lm_head, an int8 embedding), so prefill
    runs kernel B and decode kernel A; its limit is wider because an
    int8 activation rounding step (1/127 of a group's absmax) turns a
    bf16-vs-f32 difference into a visible one."""
    tok = load_tokenizer(None)
    cfg = dataclasses.replace(
        VideoLLaVAConfig.tiny(),
        llm=dataclasses.replace(LlamaConfig.tiny(vocab_size=512),
                                num_heads=4, num_kv_heads=4, head_dim=64,
                                intermediate_size=512),
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
    if quant and not all(cuda_lib.LAUNCHES[k] > before.get(k, 0)
                         for k in ("w4a8_matvec", "w4a8_block")):
        raise AssertionError("small int4 model did not run kernels A and B")
    label, limit = quant or "bf16", SMALL_LIMIT[quant]
    for name, a, b in (("video features", f_gpu, f_ref),
                       ("prefill logits", p_gpu.logits_last,
                        p_ref.logits_last),
                       ("decode logits", d_gpu, d_ref)):
        a = a.float().cpu()
        rel = ((a - b).abs().max() / b.abs().max()).item()
        print(f"small {label} model {name}: shape {tuple(a.shape)}, "
              f"max|err| / max|ref| = {rel:.3e} (bf16 CUDA vs f32 CPU, "
              f"limit {limit})")
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
    busy_us, end = 0.0, float("-inf")
    by_name: dict = {}
    for e in sorted(device, key=lambda e: e.time_range.start):
        start, stop = e.time_range.start, e.time_range.end
        busy_us += max(0.0, stop - max(start, end))
        end = max(end, stop)
        total, calls = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (total + stop - start, calls + 1)
    busy_ms = busy_us / 1e3
    print(f"{label} profile, 100-frame request: wall {wall_ms:.1f} ms "
          f"(unprofiled), device busy {busy_ms:.1f} ms over "
          f"{len(device)} device activities, idle share "
          f"{1 - busy_ms / wall_ms:.3f}")
    for name, (total, calls) in sorted(by_name.items(),
                                       key=lambda kv: -kv[1][0])[:12]:
        print(f"{label} profile: {total / 1e3:9.2f} ms {calls:6d} calls  "
              f"{name[:90]}")


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
    small_model_check(dev)
    small_model_check(dev, "int4")
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
        label = quant or "bf16"
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        engine = initialize_model(model_size="7b", device=dev, seed=0,
                                  llm_quant=quant, llm_fuse=bool(quant))
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
        path = BF16_PATH if quant is None else tuple(KERNELS)
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
        # the int4 path's
        launches.update({k: counts[k] for k in path if k not in launches})
        del engine, llm
        gc.collect()
        torch.cuda.empty_cache()

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
