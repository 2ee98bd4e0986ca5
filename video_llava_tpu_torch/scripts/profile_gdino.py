"""Stage-by-stage decomposition of the GroundingDINO forward on the card.

Counterpart of video_llava_tpu/scripts/profile_gdino.py. Times
successive prefixes of `grounding_dino._forward_device` (its `stage`
knob: text, backbone, encoder, two_stage, then the whole forward) at
the shipped 800 px config and prints the cumulative and per-stage delta
ms as JSON lines, so kernel work targets the measured hot stage instead
of a guess. The detector is the port's shipped one (random weights, f32,
as build_grounding_stack builds it; the JAX script casts to bf16). The
reference's equivalent forward is the CUDA groundingdino.predict at
grounding_evaluation/grounding_new_api.py:288.

--impl picks the deformable attention's dispatch (ops/deformable): auto
(kernel 12 on the card), xla (the plain version), pallas (kernel 12) and
pallas_full (kernel 12 with the 2-D tiling switch off; one CUDA kernel
serves both TPU kernels, 12 and 13).

Usage: python -m video_llava_tpu_torch.scripts.profile_gdino [--batch 4]
       [--device cuda]
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from video_llava_tpu_torch.models import grounding_dino as gdino_mod
from video_llava_tpu_torch.utils.timing import measure

STAGES = ("text", "backbone", "encoder", "two_stage", None)


def device_args(detector, batch: int, seed: int = 0):
    """The forward's device arguments for `batch` copies of one seeded
    480 x 832 frame, preprocessed as the detector preprocesses, and the
    prompt 'person . dog .'."""
    rng = np.random.default_rng(seed)
    frame = rng.integers(0, 255, size=(480, 832, 3)).astype(np.uint8)
    dev = detector.device
    pixels = detector._preprocess(torch.as_tensor(frame, device=dev)[None])
    pixels = pixels.expand(batch, -1, -1, -1).contiguous()
    ids = np.asarray([detector.tokenize("person . dog .")], np.int64)
    ids = np.repeat(ids, batch, axis=0)
    mask = np.ones_like(ids)
    self_mask, pos_ids = gdino_mod.generate_text_masks(ids)
    t = lambda a: torch.as_tensor(np.array(a), device=dev)  # noqa: E731
    return (pixels, t(ids), t(mask == 0), t(self_mask), t(pos_ids),
            t(mask == 1))


def run(detector, batch: int = 4, iters: int = 3, print_fn=print):
    """Times each stage prefix (utils.timing.measure: per-iteration
    median, each synced) -> (the JSON summary, the whole forward's
    (logits, boxes) of the timed inputs)."""
    args = device_args(detector, batch)
    prev = 0.0
    out = {"batch": batch, "image_size": detector.image_size}
    full = None
    with torch.inference_mode():
        for st in STAGES:
            def fn(i, st=st):
                return gdino_mod._forward_device(
                    detector.params, detector.cfg, *args, stage=st)

            t = measure(fn, iters=iters)
            name = st or "full"
            out[f"cum_{name}_ms"] = round(t * 1e3, 1)
            out[f"delta_{name}_ms"] = round((t - prev) * 1e3, 1)
            prev = t
            print_fn(json.dumps(out))
            if st is None:
                full = fn(0)
    out["per_frame_ms"] = round(prev * 1e3 / batch, 1)
    print_fn(json.dumps(out))
    return out, full


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--iters", type=int, default=3)
    ap.add_argument("--impl", default="auto",
                    choices=["auto", "xla", "pallas", "pallas_full"],
                    help="deformable-attention dispatch: 'pallas_full' "
                    "pins the full-width kernel (tile2d off)")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda)")
    ap.add_argument("--cfg", default="default", choices=["default", "tiny"],
                    help="'tiny': GroundingDinoConfig.tiny_test at 64 px "
                    "(a quick check on the CPU)")
    args = ap.parse_args(argv)

    from video_llava_tpu_torch.ops import deformable

    saved = (deformable._DEFAULT_IMPL, deformable._TILE2D)
    if args.impl == "pallas_full":
        deformable.set_default_impl("pallas")
        deformable.set_tile2d(False)
    else:
        deformable.set_default_impl(args.impl)
    try:
        cfg = (gdino_mod.GroundingDinoConfig.tiny_test()
               if args.cfg == "tiny" else None)
        detector = gdino_mod.build_detector(None, cfg=cfg,
                                            device=args.device)
        if args.cfg == "tiny":
            detector.image_size = 64
        out, _ = run(detector, args.batch, args.iters,
                     print_fn=lambda s: print(s, flush=True))
    finally:
        deformable.set_default_impl(saved[0])
        deformable.set_tile2d(saved[1])
    return out


if __name__ == "__main__":
    main()
