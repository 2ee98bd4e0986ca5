"""Synthetic J&F tracking-quality benchmark.

Counterpart of video_llava_tpu/scripts/tracking_quality.py. Quantifies
mask-propagation quality — handcrafted-feature STM vs the learned XMem
network (briefly trained here; real checkpoints drop in via
xmem.convert_xmem_checkpoint) — on procedurally generated clips covering
the classic failure modes of appearance tracking:

  * translation        smooth motion, static background (sanity)
  * occlusion          a bar occludes part of the object mid-clip
  * appearance_change  the object recolors mid-clip while a distractor
                       in the OLD color appears near the old position
  * camera_motion      the whole scene translates (global motion)
  * distractor         an identical-looking object crosses the target

Protocol per clip: the tracker receives frame 0 + its ground-truth mask
as the reference, then propagates through the remaining frames with its
shipped memory cadence. J = mean IoU of thresholded masks vs GT over
frames 1..L-1; F = mean boundary F-measure (2 px tolerance) — the
DAVIS-style J&F pair, on synthetic clips (the reference defers this
entirely to DEVA, grounding_new_api.py:503-509, and publishes figures
only). Each propagator is measured twice: as the propagator object, and
through the fused whole-clip dispatch that chat and eval ship.

The trackers run on `--device` (the card by default). The brief XMem
training is torch autograd through the same encoders, memory read and
decoder as propagation (xmem's shipped steps run in inference mode, so
:func:`loss_fn` composes the pieces itself), Adam after a clip to global
norm 1.0, under optax's warmup-cosine schedule written out
(:func:`warmup_cosine`). Convolutions in f32 on the card run in TF32
when torch.backends.cudnn.allow_tf32 is set (PyTorch's default); the
JSON summary records both TF32 flags as they were.

Run:  python -m video_llava_tpu_torch.scripts.tracking_quality
      [--train_steps 150] [--clips 3] [--frames 8] [--json out.json]
      [--device cuda]
"""

from __future__ import annotations

import argparse
import json
import math
import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

H = W = 64
OBJ_R = 8
# Inverse positive-class frequency of the synthetic suite (a r=8 disc
# in 64x64 is ~5% of pixels); used to balance the brief-training BCE.
POS_WEIGHT = 19.0


# -- clip generators -----------------------------------------------------------


def _background(rng) -> np.ndarray:
    """Low-amplitude textured background (so camera motion is visible)."""
    base = rng.uniform(0.10, 0.25, size=(H, W, 1)).astype(np.float32)
    tex = rng.normal(0, 0.02, size=(H, W, 3)).astype(np.float32)
    return np.clip(base + tex, 0, 1)


def _draw_circle(img, cy, cx, r, color):
    yy, xx = np.mgrid[:H, :W]
    m = (yy - cy) ** 2 + (xx - cx) ** 2 <= r * r
    img[m] = color
    return m.astype(np.float32)


def _draw_square(img, cy, cx, r, color):
    y0, y1 = max(cy - r, 0), min(cy + r, H)
    x0, x1 = max(cx - r, 0), min(cx + r, W)
    img[y0:y1, x0:x1] = color
    m = np.zeros((H, W), np.float32)
    m[y0:y1, x0:x1] = 1.0
    return m


def _lerp(a, b, t):
    return a + (b - a) * t


def clip_translation(rng, n):
    bg = _background(rng)
    color = rng.uniform(0.5, 1.0, size=3).astype(np.float32)
    frames, gts = [], []
    for t in range(n):
        f = bg.copy()
        u = t / max(n - 1, 1)
        cy, cx = int(_lerp(14, 48, u)), int(_lerp(12, 50, u))
        m = _draw_circle(f, cy, cx, OBJ_R, color)
        frames.append(f)
        gts.append(m)
    return frames, gts


def clip_occlusion(rng, n):
    bg = _background(rng)
    color = rng.uniform(0.5, 1.0, size=3).astype(np.float32)
    bar_color = rng.uniform(0.0, 0.15, size=3).astype(np.float32)
    bar_x0, bar_x1 = 28, 38
    frames, gts = [], []
    for t in range(n):
        f = bg.copy()
        u = t / max(n - 1, 1)
        cy, cx = 32, int(_lerp(12, 52, u))
        m = _draw_circle(f, cy, cx, OBJ_R, color)
        # occluder drawn ON TOP; GT = visible object pixels
        f[:, bar_x0:bar_x1] = bar_color
        m[:, bar_x0:bar_x1] = 0.0
        frames.append(f)
        gts.append(m)
    return frames, gts


def clip_appearance_change(rng, n):
    bg = _background(rng)
    c_old = np.asarray([0.1, 0.2, 0.9], np.float32)
    c_new = np.asarray([0.1, 0.9, 0.2], np.float32)
    frames, gts = [], []
    for t in range(n):
        f = bg.copy()
        u = t / max(n - 1, 1)
        cy, cx = int(_lerp(16, 44, u)), int(_lerp(16, 44, u))
        color = c_old if t < n // 2 else c_new
        if t >= n // 2:
            # old-color square near the object's OLD position
            _draw_square(f, 20, 20, 7, c_old)
        m = _draw_circle(f, cy, cx, OBJ_R, color)
        frames.append(f)
        gts.append(m)
    return frames, gts


def clip_camera_motion(rng, n):
    bg = _background(rng)
    color = rng.uniform(0.5, 1.0, size=3).astype(np.float32)
    scene = bg.copy()
    m0 = _draw_circle(scene, 30, 30, OBJ_R, color)
    frames, gts = [], []
    for t in range(n):
        dy, dx = 2 * t, 3 * t
        frames.append(np.roll(scene, (dy, dx), axis=(0, 1)).copy())
        gts.append(np.roll(m0, (dy, dx), axis=(0, 1)).copy())
    return frames, gts


def clip_distractor(rng, n):
    bg = _background(rng)
    color = rng.uniform(0.5, 1.0, size=3).astype(np.float32)
    frames, gts = [], []
    for t in range(n):
        f = bg.copy()
        u = t / max(n - 1, 1)
        # target: left -> right along y=24; distractor: right -> left
        # along y=40 (identical appearance, paths nearby but disjoint)
        ty, tx = 24, int(_lerp(12, 52, u))
        dy, dx = 40, int(_lerp(52, 12, u))
        _draw_circle(f, dy, dx, OBJ_R, color)
        m = _draw_circle(f, ty, tx, OBJ_R, color)
        frames.append(f)
        gts.append(m)
    return frames, gts


CLIP_KINDS: Dict[str, Callable] = {
    "translation": clip_translation,
    "occlusion": clip_occlusion,
    "appearance_change": clip_appearance_change,
    "camera_motion": clip_camera_motion,
    "distractor": clip_distractor,
}


# -- metrics --------------------------------------------------------------------


def iou(pred: np.ndarray, gt: np.ndarray) -> float:
    p, g = pred > 0.5, gt > 0.5
    union = np.logical_or(p, g).sum()
    if union == 0:
        return 1.0
    return float(np.logical_and(p, g).sum() / union)


def _boundary(mask: np.ndarray) -> np.ndarray:
    m = mask > 0.5
    er = np.zeros_like(m)
    er[1:-1, 1:-1] = (
        m[1:-1, 1:-1] & m[:-2, 1:-1] & m[2:, 1:-1]
        & m[1:-1, :-2] & m[1:-1, 2:]
    )
    return m & ~er


def _dilate(b: np.ndarray, it: int) -> np.ndarray:
    for _ in range(it):
        b = (
            b
            | np.roll(b, 1, 0) | np.roll(b, -1, 0)
            | np.roll(b, 1, 1) | np.roll(b, -1, 1)
        )
    return b


def boundary_f(pred: np.ndarray, gt: np.ndarray, tol: int = 2) -> float:
    """DAVIS-style contour F-measure with a dilation tolerance band."""
    pb, gb = _boundary(pred), _boundary(gt)
    np_, ng = pb.sum(), gb.sum()
    if np_ == 0 and ng == 0:
        return 1.0
    if np_ == 0 or ng == 0:
        return 0.0
    prec = float((pb & _dilate(gb, tol)).sum() / np_)
    rec = float((gb & _dilate(pb, tol)).sum() / ng)
    return 0.0 if prec + rec == 0 else 2 * prec * rec / (prec + rec)




# -- evaluation ------------------------------------------------------------------


def _table(js: Dict[str, list], fs: Dict[str, list]
           ) -> Dict[str, Dict[str, float]]:
    """Per-kind J, F and their mean, then the mean over kinds."""
    out = {kind: {"J": float(np.mean(js[kind])), "F": float(np.mean(fs[kind])),
                  "JF": float((np.mean(js[kind]) + np.mean(fs[kind])) / 2)}
           for kind in js}
    out["mean"] = {
        k: float(np.mean([v[k] for kk, v in out.items() if kk != "mean"]))
        for k in ("J", "F", "JF")
    }
    return out


def evaluate_tracker(
    make_tracker: Callable[[], object],
    clips: Dict[str, List[Tuple[list, list]]],
) -> Dict[str, Dict[str, float]]:
    """make_tracker() -> object with add_reference(frame, masks) and
    step(frame) -> (max_objects, H, W); fresh instance per clip."""
    js: Dict[str, list] = {}
    fs: Dict[str, list] = {}
    for kind, kind_clips in clips.items():
        js[kind], fs[kind] = [], []
        for frames, gts in kind_clips:
            tr = make_tracker()
            tr.add_reference(frames[0], gts[0][None])
            for f, g in zip(frames[1:], gts[1:]):
                pred = np.asarray(tr.step(f))[0]
                js[kind].append(iou(pred, g))
                fs[kind].append(boundary_f(pred > 0.5, g))
    return _table(js, fs)


class _OracleDetector:
    """The ground-truth box of frame 0 on the first call, nothing after."""

    def __init__(self, box: np.ndarray):
        self.box = box
        self.calls = 0

    def __call__(self, image, prompts):
        first = self.calls == 0
        self.calls += 1
        if first:
            return (self.box, np.asarray([0.9], np.float32),
                    np.asarray([0], np.int64))
        return (np.zeros((0, 4), np.float32), np.zeros((0,), np.float32),
                np.zeros((0,), np.int64))


class _OracleSegmenter:
    """The ground-truth mask of frame 0, whatever the boxes."""

    def __init__(self, gt0: np.ndarray):
        self.gt0 = gt0

    def __call__(self, image, boxes):
        return self.gt0[None].astype(np.float32)


def evaluate_tracker_fused(
    make_propagator: Callable[[], object],
    clips: Dict[str, List[Tuple[list, list]]],
    device=None,
) -> Dict[str, Dict[str, float]]:
    """Same protocol, but driven through the PUBLIC product dispatch
    (GroundedTracker.run_on_list_of_images -> the fused whole-clip
    program) instead of the propagator object: an oracle detector and
    segmenter inject the GT mask at frame 0, the rest of the clip
    propagates inside the fused program. make_propagator() ->
    LearnedMemoryTracker | None (None = the handcrafted STM on
    `device`)."""
    from video_llava_tpu_torch.grounding.memory_tracker import TrackerConfig
    from video_llava_tpu_torch.grounding.tracker import GroundedTracker

    js: Dict[str, list] = {}
    fs: Dict[str, list] = {}
    for kind, kind_clips in clips.items():
        js[kind], fs[kind] = [], []
        for frames, gts in kind_clips:
            gt0 = np.asarray(gts[0])
            ys, xs = np.nonzero(gt0 > 0.5)
            box = np.asarray(
                [[xs.min(), ys.min(), xs.max() + 1, ys.max() + 1]],
                np.float32)
            tr = GroundedTracker(
                detector=_OracleDetector(box),
                segmenter=_OracleSegmenter(gt0),
                detection_every=len(frames),  # frame 0 only
                box_threshold=0.0,
                tracker_cfg=TrackerConfig(max_objects=2),
                propagator=make_propagator(),
                binary_masks=False,
                detect_batch_size=1,
                device=device,
            )
            assert tr.fused_eligible(), "not measuring the fused path"
            res = tr.run_on_list_of_images(
                [np.asarray(f, np.float32) for f in frames], ["object"])
            for r, g in zip(res[1:], gts[1:]):
                pred = np.asarray(r.masks)[0]
                js[kind].append(iou(pred, g))
                fs[kind].append(boundary_f(pred > 0.5, g))
    return _table(js, fs)


def make_clips(seed: int, clips_per_kind: int, n_frames: int):
    rng = np.random.default_rng(seed)
    return {
        kind: [gen(rng, n_frames) for _ in range(clips_per_kind)]
        for kind, gen in CLIP_KINDS.items()
    }


# -- brief XMem training -----------------------------------------------------------


def warmup_cosine(lr: float, steps: int) -> Callable[[int], float]:
    """optax.warmup_cosine_decay_schedule(0, lr, warmup, decay_steps) at
    an update count: linear from 0 to lr over warmup = min(20, max(steps
    // 5, 1)) counts, then cosine to 0 at decay_steps = max(steps, 2).
    The first update (count 0) takes a rate of 0, as optax's does."""
    warmup = min(20, max(steps // 5, 1))
    decay = max(steps, 2)

    def rate(count: int) -> float:
        if count < warmup:
            return lr * count / warmup
        t = min(count - warmup, decay - warmup) / (decay - warmup)
        return lr * 0.5 * (1.0 + math.cos(math.pi * t))

    return rate


def trainable_leaves(tree) -> List[torch.Tensor]:
    """The floating-point leaves of a parameter tree (every leaf that
    jax.grad differentiates: kernels, biases and BN statistics alike),
    set to require gradients, in the tree's order."""
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in trainable_leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in trainable_leaves(v)]
    if isinstance(tree, torch.Tensor) and tree.is_floating_point():
        return [tree.requires_grad_(True)]
    return []


def make_optimizer(leaves: List[torch.Tensor], lr: float, steps: int):
    """(torch.optim.Adam over `leaves` with optax.adam's constants, the
    schedule) of optax.chain(clip_by_global_norm(1.0), adam(schedule))."""
    return (torch.optim.Adam(leaves, lr=lr, betas=(0.9, 0.999), eps=1e-8),
            warmup_cosine(lr, steps))


def optimizer_step(opt, schedule, leaves: List[torch.Tensor],
                   count: int) -> None:
    """One update from the leaves' gradients: clip by global norm 1.0,
    then Adam at schedule(count); the gradients are cleared."""
    torch.nn.utils.clip_grad_norm_(leaves, 1.0)
    for group in opt.param_groups:
        group["lr"] = schedule(count)
    opt.step()
    opt.zero_grad(set_to_none=True)


def loss_fn(params, cfg, f0: torch.Tensor, m0: torch.Tensor,
            f1: torch.Tensor, m1: torch.Tensor) -> torch.Tensor:
    """Next-frame propagation loss of one training pair (frames (H, W, 3)
    in [0, 1], masks (H, W)), differentiable in `params`: the reference
    write of add_reference_step (frame 0's key, its value with the deep
    sensory update) into a fresh state, then propagate_step's read of
    frame 1 stopped at the raw decoder LOGITS. The shipped prob goes
    sigmoid -> soft-aggregate, which underflows to exact 0/1 within one
    optimizer step at random init — log(p+eps) then has exactly-zero
    gradients and all-background becomes an inescapable stationary
    point. BCE in logit space never underflows. Loss: pos-weighted BCE
    (objects ~5% of pixels) + soft Dice."""
    from video_llava_tpu_torch.models import xmem

    h, w = f0.shape[:2]
    masks0 = torch.cat([m0[None], m0.new_zeros((cfg.max_objects - 1, h, w))])
    state = xmem.init_state(cfg, h // 16, w // 16, f0.device)
    # both frames' keys in one batch (the encoder sees each frame alone:
    # its BatchNorms use their statistics)
    f4, f8, f16, key, shrinkage, selection = xmem.batched_key_encode(
        params, torch.stack([f0, f1]))
    value0, hidden = xmem.encode_value(params, f0, f16[0], state.hidden,
                                       masks0, deep_update=True)
    keys0, shrinkage0, values0 = xmem._flat(key[0], shrinkage[0], value0)
    n = keys0.shape[0]
    # the state after the write: slot 0 holds frame 0, the other slots
    # keep init_state's values and are not valid
    mem_keys = torch.cat([keys0[None], state.keys[1:]]).reshape(
        -1, cfg.key_dim)
    mem_shr = torch.cat([shrinkage0[None], state.shrinkage[1:]]).reshape(-1)
    mem_values = torch.cat([values0[None], state.values[1:]]).reshape(
        -1, cfg.max_objects, cfg.value_dim)
    slot_valid = torch.zeros(cfg.mem_slots, dtype=torch.bool,
                             device=f0.device)
    slot_valid[0] = True

    ck, h16, w16 = key.shape[1:]
    readout = xmem.read_memory(
        mem_keys, mem_shr, mem_values, slot_valid.repeat_interleave(n),
        key[1].reshape(ck, n).T, selection[1].reshape(ck, n).T, cfg.top_k,
    ).permute(1, 2, 0).reshape(cfg.max_objects, cfg.value_dim, h16, w16)
    logits, _ = xmem.decode(params, f16[1], f8[1], f4[1], hidden, readout,
                            update_hidden=False)
    z = logits[0]
    bce_pix = z.clamp(min=0) - z * m1 + torch.log1p(torch.exp(-z.abs()))
    wgt = 1.0 + (POS_WEIGHT - 1.0) * m1
    bce = (wgt * bce_pix).sum() / wgt.sum()
    p = torch.sigmoid(z)
    dice = 1.0 - (2 * (p * m1).sum() + 1.0) / (p.sum() + m1.sum() + 1.0)
    return bce + dice


def brief_train_xmem(cfg, train_clips, steps: int, lr: float = 1e-4,
                     seed: int = 0, log_every: int = 25, device=None,
                     losses: Optional[list] = None):
    """A few Adam steps of next-frame propagation loss (loss_fn) on
    training clips DISJOINT from the eval set (different generator
    seed), from XMem's init drawn from `seed` on `device` (the card by
    default). Stands in for a real XMem checkpoint — the point of the
    benchmark is the ARCHITECTURE comparison (learned vs handcrafted
    features), not SOTA numbers. Each step's loss is appended to
    `losses` when given. Returns the parameter tree, no longer requiring
    gradients.

    Gradients through the memory read + grouped decoder are large at
    random init (global norms in the thousands), and Adam moves EVERY
    param by ~lr per step — on a 45M-param net one too-big step
    saturates the output. Clip + warmup-cosine keeps the first steps
    gentle; the logit-space loss keeps gradients alive regardless."""
    from video_llava_tpu_torch.models import xmem
    from video_llava_tpu_torch.models.layers import TreeInit

    device = torch.device(device or "cuda")
    params = xmem.init_params(TreeInit(seed, device), cfg)
    leaves = trainable_leaves(params)

    def t(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=device)

    # training pairs: (ref frame, ref mask, query frame, query mask)
    pairs = []
    for kind_clips in train_clips.values():
        for frames, gts in kind_clips:
            for i in range(1, len(frames)):
                pairs.append((t(frames[0]), t(gts[0]), t(frames[i]),
                              t(gts[i])))
    rng = np.random.default_rng(seed)
    order = rng.permutation(len(pairs))
    opt, schedule = make_optimizer(leaves, lr, steps)
    kept = []
    for i in range(steps):
        loss = loss_fn(params, cfg, *pairs[order[i % len(pairs)]])
        loss.backward()
        optimizer_step(opt, schedule, leaves, i)
        kept.append(loss.detach())
        if log_every and (i + 1) % log_every == 0:
            print(f"  train step {i + 1}/{steps} loss={loss.item():.4f}",
                  flush=True)
    for p in leaves:
        p.requires_grad_(False)
    if losses is not None and kept:
        losses.extend(torch.stack(kept).tolist())
    return params


def format_table(results: Dict[str, Dict[str, Dict[str, float]]]) -> str:
    kinds = list(CLIP_KINDS) + ["mean"]
    trackers = list(results)
    lines = ["| clip | " + " | ".join(
        f"{t} J / F" for t in trackers) + " |"]
    lines.append("|" + "---|" * (len(trackers) + 1))
    for k in kinds:
        row = [k]
        for t in trackers:
            r = results[t][k]
            row.append(f"{r['J']:.2f} / {r['F']:.2f}")
        lines.append("| " + " | ".join(row) + " |")
    return "\n".join(lines)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--train_steps", type=int, default=150)
    p.add_argument("--clips", type=int, default=3, help="clips per kind")
    p.add_argument("--frames", type=int, default=8)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--json", default=None)
    p.add_argument("--xmem_checkpoint", default=None,
                   help="real XMem .pth (skips the brief training)")
    p.add_argument("--lt_frames", type=int, default=0,
                   help="also evaluate LONG clips of this many frames "
                        "with the working ring alone vs ring + "
                        "long-term prototype memory (XMemConfig."
                        "lt_slots) — the >100-frame regime the "
                        "mid-term ring alone cannot cover")
    p.add_argument("--lt_slots", type=int, default=256)
    p.add_argument("--lt_prototypes", type=int, default=16)
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda)")
    args = p.parse_args(argv)

    from video_llava_tpu_torch.grounding.memory_tracker import (
        LearnedMemoryTracker,
        MemoryTracker,
        TrackerConfig,
    )
    from video_llava_tpu_torch.models import xmem

    dev = torch.device(args.device)
    tf32 = {"cudnn.allow_tf32": torch.backends.cudnn.allow_tf32,
            "cuda.matmul.allow_tf32": torch.backends.cuda.matmul.allow_tf32}
    eval_clips = make_clips(args.seed + 1000, args.clips, args.frames)
    cfg = xmem.XMemConfig(max_objects=2, mem_slots=3, top_k=8)

    results = {}
    eval_s = 0.0

    def timed_eval(key, fn):
        nonlocal eval_s
        _sync(dev)
        t0 = time.perf_counter()
        results[key] = fn()
        _sync(dev)
        eval_s += time.perf_counter() - t0

    print("evaluating handcrafted STM...", flush=True)
    timed_eval("handcrafted", lambda: evaluate_tracker(
        lambda: MemoryTracker(TrackerConfig(max_objects=2), device=dev),
        eval_clips))

    losses: List[float] = []
    train_s = None
    if args.xmem_checkpoint:
        from video_llava_tpu_torch.engine.weights import (
            load_torch_checkpoint_file,
        )

        sd = load_torch_checkpoint_file(args.xmem_checkpoint)
        params = xmem.convert_xmem_checkpoint(sd, cfg, device=dev)
        label = "xmem(ckpt)"
    else:
        print(f"briefly training XMem ({args.train_steps} steps)...",
              flush=True)
        train_clips = make_clips(args.seed, args.clips, args.frames)
        _sync(dev)
        t0 = time.perf_counter()
        params = brief_train_xmem(cfg, train_clips, args.train_steps,
                                  seed=args.seed, device=dev, losses=losses)
        _sync(dev)
        train_s = time.perf_counter() - t0
        label = "xmem(brief)"
    print("evaluating learned propagation...", flush=True)
    timed_eval(label, lambda: evaluate_tracker(
        lambda: LearnedMemoryTracker(params, cfg), eval_clips))
    # the same propagators through the PUBLIC fused dispatch — the
    # program the product actually ships (chat/eval) — so the J&F
    # table certifies quality of the fused path, not just the
    # propagator object
    print("evaluating fused dispatch (handcrafted STM)...", flush=True)
    timed_eval("handcrafted(fused)", lambda: evaluate_tracker_fused(
        lambda: None, eval_clips, device=dev))
    print("evaluating fused dispatch (learned)...", flush=True)
    timed_eval(label + "(fused)", lambda: evaluate_tracker_fused(
        lambda: LearnedMemoryTracker(params, cfg), eval_clips, device=dev))

    if args.lt_frames:
        import dataclasses as dc

        long_clips = make_clips(args.seed + 2000, args.clips,
                                args.lt_frames)
        cfg_lt = dc.replace(cfg, lt_slots=args.lt_slots,
                            lt_prototypes=args.lt_prototypes)
        tag = f"{args.lt_frames}f"
        print(f"evaluating {tag} clips, ring only...", flush=True)
        timed_eval(f"xmem(ring,{tag})", lambda: evaluate_tracker(
            lambda: LearnedMemoryTracker(params, cfg), long_clips))
        print(f"evaluating {tag} clips, ring + long-term...", flush=True)
        timed_eval(f"xmem(+LT,{tag})", lambda: evaluate_tracker(
            lambda: LearnedMemoryTracker(params, cfg_lt), long_clips))

    print()
    print(format_table(results))
    summary = {
        "metric": "tracking_jf_mean",
        "value": round(results[label]["mean"]["JF"], 4),
        "unit": "J&F (synthetic suite)",
        "fused_jf_mean": round(results[label + "(fused)"]["mean"]["JF"], 4),
        "detail": results,
        "device": str(dev),
        "tf32": tf32,
        "train_steps": 0 if args.xmem_checkpoint else args.train_steps,
        "train_seconds": train_s,
        "eval_seconds": eval_s,
    }
    if losses:
        k = min(25, len(losses))
        summary["train_loss_first"] = float(np.mean(losses[:k]))
        summary["train_loss_last"] = float(np.mean(losses[-k:]))
    print(json.dumps(summary))
    if args.json:
        with open(args.json, "w") as f:
            json.dump(summary, f, indent=2)
    return summary


if __name__ == "__main__":
    main()
