"""Whole-clip grounded tracking over the learned XMem propagator or the
handcrafted STM.

Counterpart of video_llava_tpu/grounding/fused_clip.py (run_clip_fused
and run_clip_fused_stm). In JAX the clip is one device program (a scan
over detection segments); here it is a plain function over device
tensors with the same semantics: frames in once, detection masks in once,
per segment the detection frame propagates, associates its detections
greedily in area order and writes the slot array to memory, the gap
frames propagate (XMem: the batched key encode of the gap frames, then a
read, decode and GRU a frame, writes on the mem_every cadence; the STM:
confident writes every frame), and the masks come out thresholded and
bit-packed (one device-to-host copy). The JAX module's XMem pieces
(_batched_key_encode, _read_decode, _value_write) are models/xmem.py's
batched_key_encode, read_decode and value_write, which
xmem.propagate_chunk shares.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from video_llava_tpu_torch.grounding import memory_tracker as mt
from video_llava_tpu_torch.models import xmem
from video_llava_tpu_torch.models.xmem import XMemConfig, XMemState
from video_llava_tpu_torch.ops.box_ops import box_iou, masks_to_boxes

_BITS = (128, 64, 32, 16, 8, 4, 2, 1)  # MSB-first


def pack_mask_bits(masks: torch.Tensor) -> torch.Tensor:
    """(..., W) {0, 1} -> (..., W / 8) uint8, MSB-first (numpy
    unpackbits' convention). W must be a multiple of 8."""
    w = masks.shape[-1]
    assert w % 8 == 0, w
    m = masks.to(torch.uint8).reshape(masks.shape[:-1] + (w // 8, 8))
    bits = torch.tensor(_BITS, dtype=torch.uint8, device=masks.device)
    return (m * bits).sum(-1).to(torch.uint8)


def unpack_mask_bits(packed: np.ndarray, w: int) -> np.ndarray:
    """Host inverse of pack_mask_bits -> (..., w) uint8 {0, 1}."""
    return np.unpackbits(packed, axis=-1)[..., :w]


class ObjTable(NamedTuple):
    """Per-slot object bookkeeping (GroundedTracker._objects' twin)."""

    category: torch.Tensor  # (O,) int32
    score: torch.Tensor  # (O,) f32
    count: int


def init_table(cfg) -> ObjTable:
    """cfg: anything with max_objects."""
    o = cfg.max_objects
    return ObjTable(torch.zeros((o,), dtype=torch.int32),
                    torch.zeros((o,), dtype=torch.float32), 0)


def _area_order(det_masks, det_valid, det_cat, det_score):
    """Detections by descending mask area, invalid last (the host path's
    painting order)."""
    areas = (det_masks > 0).sum(dim=(1, 2)).float()
    areas = torch.where(det_valid, areas, -1.0)
    order = torch.argsort(-areas, stable=True)
    return (det_masks[order], det_valid[order], det_cat[order],
            det_score[order])


def associate(prev_prob: torch.Tensor, det_masks: torch.Tensor,
              det_valid: torch.Tensor, det_cat: torch.Tensor,
              det_score: torch.Tensor, table: ObjTable, iou_threshold: float,
              binary: bool) -> Tuple[torch.Tensor, ObjTable]:
    """GroundedTracker._incorporate's greedy matching: each detection, in
    area order, takes its argmax-IoU track when the IoU clears the
    threshold and the track is unclaimed, else becomes a new object while
    slots remain; unmatched tracks keep their propagated mask. prev_prob
    (O, H, W), det_masks (K, H, W) area-ordered -> (slots (O, H, W) f32,
    new table). The K x O decisions run on the host."""
    max_o = prev_prob.shape[0]
    prev_bin = prev_prob > 0.5
    slots = (prev_bin.float() if binary else prev_prob).clone()
    iou = box_iou(masks_to_boxes(det_masks > 0),
                  masks_to_boxes(prev_bin))[0].cpu()
    iou[:, table.count:] = 0.0  # tracks past the count are not alive
    valid = det_valid.cpu().tolist()
    det_cat, det_score = det_cat.cpu(), det_score.cpu()
    cat, score, cnt = table.category.clone(), table.score.clone(), table.count
    used = [False] * max_o
    for d in range(det_masks.shape[0]):
        j = int(torch.argmax(iou[d]))
        matched = valid[d] and float(iou[d, j]) >= iou_threshold and not used[j]
        if matched:
            slots[j] = det_masks[d]
            used[j] = True
        elif valid[d] and cnt < max_o:
            slots[cnt] = det_masks[d]
            cat[cnt], score[cnt] = det_cat[d], det_score[d]
            cnt += 1
    return slots, ObjTable(cat, score, cnt)


def vote_detections(det_masks: torch.Tensor, det_valid: torch.Tensor,
                    nvf: int) -> torch.Tensor:
    """GroundedTracker._vote's twin: keyframe detection i (frame s*nvf)
    survives iff its mask box overlaps (IoU >= 0.5) some detection in at
    least nvf // 2 of the next nvf - 1 frames. det_masks (T, K, H, W),
    det_valid (T, K), T = F * nvf -> keep (F, K) bool."""
    t, k = det_valid.shape
    f = t // nvf
    assert f * nvf == t, (t, nvf)
    boxes = masks_to_boxes(det_masks.float()).reshape(f, nvf, k, 4)
    valid = det_valid.reshape(f, nvf, k)
    iou = torch.stack([
        torch.stack([box_iou(boxes[s, 0], boxes[s, j])[0]
                     for j in range(1, nvf)]) for s in range(f)])
    hit = ((iou >= 0.5) & valid[:, 1:, None, :]).any(-1)  # (F, nvf-1, K)
    votes = hit.int().sum(1)
    return (votes >= nvf // 2) & valid[:, 0]


@torch.inference_mode()
def run_clip_fused(
    params,
    state: XMemState,  # fresh, at the frames' stride-16 grid
    frames: torch.Tensor,  # (T, H, W, 3) uint8 (or f32 in [0, 1])
    det_masks: torch.Tensor,  # (F, K, H, W) uint8/f32 {0, 1}
    det_valid: torch.Tensor,  # (F, K) bool
    det_cat: torch.Tensor,  # (F, K) int32
    det_score: torch.Tensor,  # (F, K) f32
    frame_valid,  # (T,) bool: the padding tail is False
    table: ObjTable,
    cfg: XMemConfig,
    detect_every: int,
    iou_threshold: float = 0.5,
    binary: bool = True,
    pack: bool = True,
    seg_is_det: Optional[torch.Tensor] = None,  # (F,) bool; None: all
):
    """The grounded clip with the XMem propagator. T = F * detect_every;
    frame s * detect_every is segment s's detection frame, whose masks
    are associated as GroundedTracker._incorporate does and written with
    the deep update; the gap frames propagate as xmem.propagate_chunk
    does, with mem_every / deep_update_every on the tracker's frame
    counter (which a detection frame advances twice, by its propagation
    and by its reference write, and which starts with the first object).
    A keyframe that is not a detection frame (semionline's partial tail)
    is a plain propagated frame. Returns (masks (T, O, H, W / 8) packed
    uint8, or (T, O, H, W) uint8 when pack is False, or f32 soft when
    binary is False; categories (F, O); scores (F, O); counts (F,); the
    final state). The per-segment table is the snapshot after its
    detections."""
    E = detect_every
    T = frames.shape[0]
    F_ = T // E
    assert F_ * E == T, (T, E)
    seg_is_det = ([True] * F_ if seg_is_det is None
                  else [bool(x) for x in seg_is_det])
    ok = [bool(x) for x in np.asarray(
        frame_valid.cpu() if isinstance(frame_valid, torch.Tensor)
        else frame_valid)]
    H, W = frames.shape[1:3]
    zeros = torch.zeros((cfg.max_objects, H, W), device=frames.device)

    def out_mask(m):
        return (m > 0.5).to(torch.uint8) if binary else m

    fidx = 0  # LearnedMemoryTracker's frame counter
    outs, cats, scores, counts = [], [], [], []
    for s in range(F_):
        s_ok = ok[s * E:(s + 1) * E]
        is_det = seg_is_det[s]
        sframes = frames[s * E:(s + 1) * E]
        # the key encoder over the detection frame, then over the gap
        # frames together: the batches the host loop's propagator runs
        # (propagate_step, then propagate_chunk), so both paths compute
        # the same values, not values that differ in the last bits
        det_enc = xmem.batched_key_encode(params, sframes[:1])
        gap_enc = xmem.batched_key_encode(params, sframes[1:]) if E > 1 else None
        f4, f8, f16, key, shr, sel = (x[0] for x in det_enc)
        dm, dv, dc, ds = _area_order(det_masks[s].float(), det_valid[s],
                                     det_cat[s], det_score[s])
        # detection frame: propagate (no write), associate, write
        stepped = table.count > 0 and s_ok[0]
        if stepped:
            prev_prob, hidden, state = xmem.read_decode(
                params, state, f16, f8, f4, key, sel, cfg)
            state = state._replace(hidden=hidden)
        else:
            prev_prob = zeros
        u_gap = stepped and not is_det and fidx % cfg.mem_every == 0
        dp_gap = u_gap and fidx % cfg.deep_update_every == 0
        fidx += stepped
        slots, new_table = associate(prev_prob, dm, dv, dc, ds, table,
                                     iou_threshold, binary)
        if s_ok[0] and is_det:
            table = new_table
        wrote = table.count > 0 and s_ok[0] and is_det
        if wrote:
            # num_objects: the live count, as the host loop passes it
            state = state._replace(num_objects=max(state.num_objects,
                                                   table.count))
            state = xmem.value_write(params, state, sframes[0], f16, key, shr,
                                 slots, cfg, deep=True)
        elif u_gap:
            state = xmem.value_write(params, state, sframes[0], f16, key, shr,
                                 prev_prob, cfg, deep=dp_gap)
        fidx += wrote
        seg = [out_mask(slots)]
        # gap frames: propagation on the mem_every cadence
        for t in range(1, E):
            run = state.num_objects > 0 and s_ok[t]
            prob = zeros
            if run:
                u = fidx % cfg.mem_every == 0
                f4, f8, f16, key, shr, sel = (x[t - 1] for x in gap_enc)
                prob, hidden, state = xmem.read_decode(
                    params, state, f16, f8, f4, key, sel, cfg)
                state = state._replace(hidden=hidden)
                if u:
                    state = xmem.value_write(
                        params, state, sframes[t], f16, key, shr, prob, cfg,
                        deep=fidx % cfg.deep_update_every == 0)
            fidx += run
            seg.append(out_mask(prob))
        seg = torch.stack(seg)
        outs.append(pack_mask_bits(seg) if pack else seg)
        cats.append(table.category.clone())
        scores.append(table.score.clone())
        counts.append(table.count)
    return (torch.cat(outs), torch.stack(cats), torch.stack(scores),
            torch.tensor(counts, dtype=torch.int32), state)


def run_clip_fused_stm(
    state: mt.TrackerState,  # fresh
    frames: torch.Tensor,  # (T, H, W, 3) uint8 (or f32 in [0, 1])
    det_masks: torch.Tensor,  # (F, K, H, W) uint8/f32 {0, 1}
    det_valid: torch.Tensor,  # (F, K) bool
    det_cat: torch.Tensor,  # (F, K) int32
    det_score: torch.Tensor,  # (F, K) f32
    frame_valid: torch.Tensor,  # (T,) bool
    table: ObjTable,
    cfg: mt.TrackerConfig,
    detect_every: int,
    iou_threshold: float = 0.5,
    binary: bool = True,
    pack: bool = True,
    seg_is_det: Optional[torch.Tensor] = None,  # (F,) bool; None: all
):
    """The grounded clip with the handcrafted STM. T = F * detect_every;
    frame s * detect_every is segment s's detection frame. Returns (masks
    (T, O, H, ceil(W/8)) packed uint8, or (T, O, H, W) uint8 when pack is
    False, or f32 soft when binary is False; categories (F, O); scores
    (F, O); counts (F,); the final state). The per-segment table is the
    snapshot after its detections."""
    E = detect_every
    T = frames.shape[0]
    F_ = T // E
    assert F_ * E == T, (T, E)
    H, W = frames.shape[1:3]
    pw = -W % 8
    seg_is_det = ([True] * F_ if seg_is_det is None
                  else [bool(x) for x in seg_is_det])
    ok = [bool(x) for x in frame_valid.cpu()]
    n = (H // cfg.patch) * (W // cfg.patch)
    zeros = torch.zeros((n, cfg.max_objects), device=frames.device)

    def out_mask(m):
        if binary:
            m = (m > 0.5).to(torch.uint8)
        if pack:
            m = pack_mask_bits(torch.nn.functional.pad(m, (0, pw)) if pw
                               else m)
        return m

    outs, cats, scores, counts = [], [], [], []
    for s in range(F_):
        s_ok = ok[s * E:(s + 1) * E]
        is_det = seg_is_det[s]
        feats = mt.default_features(frames[s * E:(s + 1) * E], cfg)
        dm, dv, dc, ds = _area_order(det_masks[s].float(), det_valid[s],
                                     det_cat[s], det_score[s])
        # detection frame: propagate (no write), associate, write slots
        grid = (mt._propagate(state, feats[0], cfg)
                if table.count > 0 and s_ok[0] else zeros)
        prev_prob = mt.grid_to_masks(grid, (H, W), cfg)
        slots, new_table = associate(prev_prob, dm, dv, dc, ds, table,
                                     iou_threshold, binary)
        if s_ok[0] and is_det:
            table = new_table
        if table.count > 0 and s_ok[0] and is_det:
            state = mt.write_memory(state, feats[0],
                                    mt.masks_to_grid(slots, cfg),
                                    max(state.num_objects, table.count))
        elif state.num_objects > 0 and s_ok[0] and not is_det:
            # a keyframe that is not a detection frame (semionline's
            # partial tail): a plain step's confident write
            state = mt.write_memory(state, feats[0],
                                    torch.where(grid > 0.5, grid, 0.0),
                                    state.num_objects)
        seg = [out_mask((slots > 0.5).to(torch.uint8) if binary else slots)]
        for t in range(1, E):
            run = state.num_objects > 0 and s_ok[t]
            grid = mt._propagate(state, feats[t], cfg) if run else zeros
            if run:
                state = mt.write_memory(state, feats[t],
                                        torch.where(grid > 0.5, grid, 0.0),
                                        state.num_objects)
            seg.append(out_mask(mt.grid_to_masks(grid, (H, W), cfg)))
        outs.append(torch.stack(seg))
        cats.append(table.category.clone())
        scores.append(table.score.clone())
        counts.append(table.count)
    masks = torch.cat(outs, dim=0)
    return (masks, torch.stack(cats), torch.stack(scores),
            torch.tensor(counts, dtype=torch.int32), state)
