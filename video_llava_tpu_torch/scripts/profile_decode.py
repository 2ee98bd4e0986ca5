"""Decode-step decomposition on the card.

Counterpart of video_llava_tpu/scripts/profile_decode.py. Finds where
the time of the bench decode step goes:
  1. measures the warm per-step latency of the bench decode step (the
     construction of the repository's bench.py: Vicuna-7B with int4
     W4A8 weights in the fused layout, a bf16 KV cache, a 100-frame
     224 px clip and a 512-token prompt holding its 356 video tokens),
     over bursts of 16 chained steps;
  2. profiles `--steps` more steps with torch.profiler and prints the
     device ops by total time (utils/trace_tools) and the device's busy
     time beside the steps' wall time: the non-matmul remainder (cache
     writes, rotary/norm glue, sampling) and the host's share show up.

The model, clip and prompt are built here (runtime/model_init; no import
of bench.py), honouring BENCH_LLM_DTYPE (int4 | int8 | bf16 | auto,
'auto' through the preflight record of BENCH_WEIGHTS), BENCH_MODEL (7b |
13b | tiny), BENCH_KV_DTYPE (int8 | bf16; default int8 with int8
weights, else bf16) and BENCH_FUSE as bench.py does. :func:`run` takes
an engine that is already built.

Usage: python -m video_llava_tpu_torch.scripts.profile_decode
       [--steps 64] [--trace_dir DIR] [--device cuda]
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

NUM_FRAMES = 100
PROMPT_LEN = 512
BURST = 16


def bench_settings(env=None) -> dict:
    """bench.py's model, LLM weight format, KV dtype and fused layout
    from the environment."""
    env = os.environ if env is None else env
    llm_dtype = env.get("BENCH_LLM_DTYPE", "int4")
    if llm_dtype == "auto":
        from video_llava_tpu_torch.engine.quant_select import resolve_quant

        llm_dtype = resolve_quant(
            "auto", env.get("BENCH_WEIGHTS") or None) or "bf16"
    kv = env.get("BENCH_KV_DTYPE", "")
    kv = (("int8" if kv == "int8" else "bf16") if kv
          else ("int8" if llm_dtype == "int8" else "bf16"))
    return {"model": env.get("BENCH_MODEL", "7b"), "llm_dtype": llm_dtype,
            "kv": kv, "fuse": env.get("BENCH_FUSE", "1") == "1"}


def build_engine(settings: dict, device, seed: int = 0):
    """bench.py's model with random weights from `seed` on `device`."""
    from video_llava_tpu_torch.runtime.model_init import initialize_model

    quant = None if settings["llm_dtype"] == "bf16" else settings["llm_dtype"]
    return initialize_model(model_size=settings["model"], device=device,
                            seed=seed, llm_quant=quant,
                            llm_fuse=bool(quant) and settings["fuse"])


def bench_inputs(engine, num_frames: int = NUM_FRAMES,
                 prompt_len: int = PROMPT_LEN, seed: int = 0):
    """bench.py's clip (uint8 frames at the tower's size) and prompt:
    random ids with the video span (start, patches, end) at position 8,
    as (frames, input_ids (1, s), seq_lens (1,)) on the engine's
    device."""
    cfg = engine.cfg
    dev = engine.device
    rng = np.random.default_rng(seed)
    size = cfg.vision.image_size
    frames = torch.as_tensor(
        rng.integers(0, 256, size=(num_frames, size, size, 3)),
        dtype=torch.uint8, device=dev)
    ids = rng.integers(3, min(30000, cfg.llm.vocab_size), size=(1, prompt_len))
    n = cfg.video_token_len
    ids[:, 8] = cfg.vid_start_token_id
    ids[:, 9:9 + n] = cfg.vid_patch_token_id
    ids[:, 9 + n] = cfg.vid_end_token_id
    return (frames, torch.as_tensor(ids, dtype=torch.int32, device=dev),
            torch.full((1,), prompt_len, dtype=torch.int32, device=dev))


def run(engine, steps: int = 64, top: int = 30, trace_dir: str = "",
        kv: str = "bf16", iters: int = 3, num_frames: int = NUM_FRAMES,
        prompt_len: int = PROMPT_LEN, labels=None, print_fn=print) -> dict:
    """The warm step latency over bursts of 16 chained greedy steps
    (utils.timing.measure: the median burst of `iters`, after one
    warm-up burst), then `steps` steps under torch.profiler (the device's
    activity on the card, the host's ops on the CPU), read in memory: the
    top ops by total time printed, and the device busy time (the union
    of the device activities' intervals) beside the profiled steps' wall
    time; with `trace_dir`, the chrome trace written there too. Returns
    the summary (the first JSON line, plus the profile's numbers and
    `top_ops`, the names of the top `top` ops)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from video_llava_tpu_torch.ops.image import normalize_clip
    from video_llava_tpu_torch.utils.timing import measure, sync
    from video_llava_tpu_torch.utils.trace_tools import (
        busy_and_names,
        print_rows,
        span_totals,
    )

    model = engine.model
    dev = engine.device
    frames, input_ids, seq_lens = bench_inputs(engine, num_frames,
                                               prompt_len)
    cache_len = prompt_len + 1 + BURST * (1 + iters) + steps
    with torch.inference_mode():
        pixels = normalize_clip(frames, dtype=torch.bfloat16)
        feats = model.encode_video(pixels)
        pre = model.prefill(input_ids, seq_lens, feats[None], cache_len,
                            torch.int8 if kv == "int8" else torch.bfloat16)
        tok = torch.argmax(pre.logits_last, dim=-1).to(torch.int32)
        state = {"t": tok, "c": pre.cache}

        def step():
            out, state["c"] = model.llm.decode_step(state["t"], state["c"])
            state["t"] = torch.argmax(out, dim=-1).to(torch.int32)
            return out

        sync(step())

        def burst(i):
            out = None
            for _ in range(BURST):
                out = step()
            return out

        t_burst = measure(burst, iters=iters)
        out = {"decode_step_ms": round(t_burst / BURST * 1e3, 3),
               **(labels or {}), "kv": kv}
        print_fn(json.dumps(out))

        # the device's activity on the card (the host's ops would
        # multiply the events), the host's ops on the CPU
        acts = [ProfilerActivity.CUDA if dev.type == "cuda"
                else ProfilerActivity.CPU]
        sync(state["t"])
        with profile(activities=acts) as prof:
            t0 = time.perf_counter()
            for _ in range(steps):
                last = step()
            sync(last)
            wall_ms = (time.perf_counter() - t0) * 1e3
    events = prof.profiler.kineto_results.events()
    device = [(e.name(), e.start_ns(), e.end_ns()) for e in events
              if e.device_type() == DeviceType.CUDA]
    busy_ms = busy_and_names(device)[0] if device else 0.0
    rows = (span_totals(device) if device else span_totals(
        ((e.name(), e.start_ns(), e.end_ns()) for e in events), "all"))
    out.update(profiled_steps=steps,
               profiled_step_ms=round(wall_ms / steps, 3),
               busy_step_ms=round(busy_ms / steps, 3),
               idle_share=round(1 - busy_ms / wall_ms, 3))
    if trace_dir:
        os.makedirs(trace_dir, exist_ok=True)
        out["trace"] = os.path.join(trace_dir, "decode.pt.trace.json")
        prof.export_chrome_trace(out["trace"])
    print_fn(json.dumps(out))
    print_rows(rows, n=top)
    out["top_ops"] = [name for name, _, _ in rows[:top]]
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=64)
    ap.add_argument("--trace_dir", default="")
    ap.add_argument("--top", type=int, default=30)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda)")
    ap.add_argument("--frames", type=int, default=NUM_FRAMES)
    ap.add_argument("--prompt_len", type=int, default=PROMPT_LEN)
    args = ap.parse_args(argv)

    settings = bench_settings()
    engine = build_engine(settings, torch.device(args.device))
    return run(engine, args.steps, args.top, args.trace_dir,
               kv=settings["kv"], num_frames=args.frames,
               prompt_len=args.prompt_len,
               labels={"model": settings["model"],
                       "llm_dtype": settings["llm_dtype"]},
               print_fn=lambda s: print(s, flush=True))


if __name__ == "__main__":
    main()
