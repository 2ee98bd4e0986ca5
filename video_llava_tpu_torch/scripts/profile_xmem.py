"""Decomposition of the XMem propagation step on the card.

Counterpart of video_llava_tpu/scripts/profile_xmem.py. XMem propagation
is the learned grounding build's largest device stage; its key
projections take most of it. This script times the stages separately:
the key encode of a chunk (the ResNet-50 trunk and the key, shrinkage
and selection projections, batched over the chunk as propagate_chunk
encodes it), then the whole propagate_chunk (read, decode, GRU per
frame), at 480 x 832 in f32 with random weights, and with --trace_dir
writes a torch.profiler chrome trace of three chunks and prints its top
25 device ops (utils/trace_tools). Reference: the DEVA/XMem GPU stack
the tracker replaces (grounding_evaluation/grounding_new_api.py:21-24).

Usage: python -m video_llava_tpu_torch.scripts.profile_xmem [--frames 4]
       [--trace_dir DIR] [--device cuda]
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch

from video_llava_tpu_torch.models import xmem
from video_llava_tpu_torch.models.layers import TreeInit
from video_llava_tpu_torch.utils.timing import measure


def main(argv=None, print_fn=print):
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=4)
    ap.add_argument("--height", type=int, default=480)
    ap.add_argument("--width", type=int, default=832)
    ap.add_argument("--objects", type=int, default=4)
    ap.add_argument("--trace_dir", default="")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda)")
    args = ap.parse_args(argv)

    H, W, N, T = args.height, args.width, args.objects, args.frames
    dev = torch.device(args.device)
    cfg = xmem.XMemConfig(max_objects=N)
    rng = np.random.default_rng(0)
    params = xmem.init_params(TreeInit(0, dev), cfg)
    frames = torch.as_tensor(rng.integers(0, 255, (T, H, W, 3)),
                             dtype=torch.uint8, device=dev).float() / 255
    mask0 = torch.as_tensor(rng.random((N, H, W)) > 0.9,
                            dtype=torch.float32, device=dev)
    state = xmem.init_state(cfg, H // 16, W // 16, dev)
    state = xmem.add_reference_step(params, state, frames[0], mask0, N, cfg)
    upd = [False] * T
    deep = [False] * T

    out = {"frames": T, "size": f"{H}x{W}", "objects": N,
           "device": str(dev)}
    with torch.inference_mode():
        # stage 1: key encode (r50 trunk + projections) over the chunk
        def key_fn(i):
            return xmem.batched_key_encode(params, frames)[3]

        t = min(measure(key_fn, iters=10) for _ in range(2))
        out["key_encode_chunk_ms"] = round(t * 1e3, 2)

        # the whole chunk; no frame writes, so the state stays as it is
        def full(i):
            return xmem.propagate_chunk(params, state, frames, upd, deep,
                                        cfg)[0]

        t = min(measure(full, iters=10) for _ in range(2))
        out["propagate_chunk_ms"] = round(t * 1e3, 2)
        out["per_frame_ms"] = round(t / T * 1e3, 2)
        print_fn(json.dumps(out))

        if args.trace_dir:
            from torch.profiler import ProfilerActivity, profile

            from video_llava_tpu_torch.utils import trace_tools

            # the device's activity on the card (the host's ops would
            # multiply the trace), the host's ops on the CPU
            acts = [ProfilerActivity.CUDA if dev.type == "cuda"
                    else ProfilerActivity.CPU]
            with profile(activities=acts) as prof:
                for _ in range(3):
                    r = full(0)
                if dev.type == "cuda":
                    torch.cuda.synchronize(dev)
            del r
            os.makedirs(args.trace_dir, exist_ok=True)
            path = os.path.join(args.trace_dir, "xmem.pt.trace.json")
            prof.export_chrome_trace(path)
            rows = trace_tools.device_op_totals(path)
            out["trace"] = path
            out["trace_source"] = rows.source
            for name, ms, n in rows[:25]:
                print_fn(f"{ms / 3:9.3f} ms  x{n:4d}  {name[:80]}")
    return out


if __name__ == "__main__":
    main(print_fn=lambda s: print(s, flush=True))
