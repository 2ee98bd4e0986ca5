"""Space-time memory mask propagation: handcrafted features (STM) or the
learned XMem network.

Counterpart of video_llava_tpu/grounding/memory_tracker.py. MemoryTracker
(the weights-free propagator of build_grounding_stack) carries masks
across frames by attending from the query frame's patch features
(patch-mean RGB plus position) to a ring buffer of (key, per-object
value) memory slots, top-k sparse. LearnedMemoryTracker has the same
lifecycle over models/xmem.py (the trained propagator of the reference's
deva.step, grounding_new_api.py:503-509).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from video_llava_tpu_torch.models import xmem
from video_llava_tpu_torch.ops.topk import stable_topk


@dataclasses.dataclass(frozen=True)
class TrackerConfig:
    max_objects: int = 8
    mem_slots: int = 8  # memory frames kept (ring buffer)
    patch: int = 8  # feature grid stride in pixels
    temperature: float = 0.05
    top_k: int = 16
    pos_weight: float = 0.4


@dataclasses.dataclass
class TrackerState:
    keys: torch.Tensor  # (S, N, c) memory keys per slot
    values: torch.Tensor  # (S, N, O) soft object assignments per slot
    slot_valid: torch.Tensor  # (S,) bool
    next_slot: int  # ring pointer
    num_objects: int


def default_features(frame: torch.Tensor, cfg: TrackerConfig) -> torch.Tensor:
    """(..., H, W, 3) uint8 (cast / 255) or float in [0, 1] -> (..., N,
    5): patch-mean RGB ++ pos_weight * patch-center coordinates, N =
    (H // p) * (W // p)."""
    if frame.dtype == torch.uint8:
        frame = frame.float() / 255.0
    p = cfg.patch
    H, W = frame.shape[-3], frame.shape[-2]
    gh, gw = H // p, W // p
    lead = frame.shape[:-3]
    x = frame[..., :gh * p, :gw * p, :].reshape(lead + (gh, p, gw, p, 3))
    x = x.mean(dim=(-4, -2))
    dev = frame.device
    ys = (torch.arange(gh, dtype=torch.float32, device=dev) + 0.5) / gh
    xs = (torch.arange(gw, dtype=torch.float32, device=dev) + 0.5) / gw
    pos = torch.stack(torch.meshgrid(ys, xs, indexing="ij"), dim=-1)
    feats = torch.cat([x, (cfg.pos_weight * pos).expand(lead + pos.shape)],
                      dim=-1)
    return feats.reshape(lead + (gh * gw, 5))


def masks_to_grid(masks: torch.Tensor, cfg: TrackerConfig) -> torch.Tensor:
    """(O, H, W) -> (N, O) per-patch object fractions."""
    p = cfg.patch
    o, H, W = masks.shape
    gh, gw = H // p, W // p
    m = masks[:, :gh * p, :gw * p].reshape(o, gh, p, gw, p).float()
    return m.mean(dim=(2, 4)).reshape(o, gh * gw).T


def grid_to_masks(grid: torch.Tensor, hw: Tuple[int, int],
                  cfg: TrackerConfig) -> torch.Tensor:
    """(N, O) -> (O, H, W): nearest upsampling of the patch grid, zero
    in the rows and columns the grid does not cover."""
    H, W = hw
    p = cfg.patch
    gh, gw = H // p, W // p
    g = grid.T.reshape(-1, gh, gw)
    g = g.repeat_interleave(p, dim=1).repeat_interleave(p, dim=2)
    return torch.nn.functional.pad(g, (0, W - gw * p, 0, H - gh * p))


def init_state(cfg: TrackerConfig, num_patches: int, feat_dim: int,
               device=None) -> TrackerState:
    return TrackerState(
        keys=torch.zeros((cfg.mem_slots, num_patches, feat_dim),
                         device=device),
        values=torch.zeros((cfg.mem_slots, num_patches, cfg.max_objects),
                           device=device),
        slot_valid=torch.zeros((cfg.mem_slots,), dtype=torch.bool,
                               device=device),
        next_slot=0, num_objects=0)


def write_memory(state: TrackerState, feats: torch.Tensor,
                 obj_grid: torch.Tensor, num_objects: int) -> TrackerState:
    """A new state with (feats, objects) in the next ring slot (the
    arrays are copied: a state stays what it was, as in JAX)."""
    s = state.next_slot % state.keys.shape[0]
    keys, values = state.keys.clone(), state.values.clone()
    valid = state.slot_valid.clone()
    keys[s], values[s], valid[s] = feats, obj_grid, True
    return TrackerState(keys, values, valid, state.next_slot + 1,
                        max(state.num_objects, int(num_objects)))


def _propagate(state: TrackerState, feats: torch.Tensor,
               cfg: TrackerConfig) -> torch.Tensor:
    """Read the memory with the query frame's features -> (N, O)."""
    S, N, c = state.keys.shape
    mem_k = state.keys.reshape(S * N, c)
    mem_v = state.values.reshape(S * N, cfg.max_objects)
    valid = state.slot_valid.repeat_interleave(N)
    d2 = ((feats ** 2).sum(-1, keepdim=True) - 2.0 * feats @ mem_k.T
          + (mem_k ** 2).sum(-1)[None, :])
    sim = torch.where(valid[None, :], -d2 / cfg.temperature, float("-inf"))
    top_sim, top_idx = stable_topk(sim, min(cfg.top_k, S * N))
    att = torch.softmax(top_sim, dim=-1)
    return torch.einsum("nk,nko->no", att, mem_v[top_idx])


def propagate_step(state: TrackerState, feats: torch.Tensor,
                   cfg: TrackerConfig) -> torch.Tensor:
    return _propagate(state, feats, cfg)


def _default_step(state: TrackerState, frame: torch.Tensor,
                  cfg: TrackerConfig, update_memory: bool,
                  binary: bool = False):
    """Features, memory read, optional confident write, mask upsample."""
    feats = default_features(frame, cfg)
    grid = _propagate(state, feats, cfg)
    if update_memory:
        conf = torch.where(grid > 0.5, grid, 0.0)
        state = write_memory(state, feats, conf, state.num_objects)
    masks = grid_to_masks(grid, (frame.shape[0], frame.shape[1]), cfg)
    if binary:
        masks = (masks > 0.5).to(torch.uint8)
    return masks, state


def _default_add_reference(state: TrackerState, frame: torch.Tensor,
                           masks: torch.Tensor, num_objects: int,
                           cfg: TrackerConfig) -> TrackerState:
    return write_memory(state, default_features(frame, cfg),
                        masks_to_grid(masks, cfg), num_objects)


class MemoryTracker:
    """The reference tracker's lifecycle (add_reference, step, clear)
    over numpy frames and masks, with the state on `device`."""

    def __init__(self, cfg: TrackerConfig = TrackerConfig(),
                 feature_fn=None, device=None):
        self.cfg = cfg
        self.device = torch.device(device or "cpu")
        self._fused = feature_fn is None
        self.feature_fn = feature_fn or (
            lambda f: default_features(f, self.cfg))
        self.state: Optional[TrackerState] = None
        self._hw: Optional[Tuple[int, int]] = None

    def clear(self):
        self.state = None

    def _frame(self, frame) -> torch.Tensor:
        t = torch.as_tensor(np.asarray(frame), device=self.device)
        return t if t.dtype == torch.uint8 else t.float()

    def add_reference(self, frame, masks: np.ndarray,
                      num_objects: Optional[int] = None) -> None:
        """frame (H, W, 3) uint8 or float in [0, 1]; masks (O, H, W)
        binary, padded to max_objects; num_objects the live count when
        `masks` is the whole slot array."""
        frame = self._frame(frame)
        o = masks.shape[0]
        pad = self.cfg.max_objects - o
        if pad < 0:
            masks = masks[:self.cfg.max_objects]
            o, pad = self.cfg.max_objects, 0
        mdtype = np.uint8 if masks.dtype == np.uint8 else np.float32
        m = torch.as_tensor(np.pad(masks.astype(mdtype),
                                   ((0, pad), (0, 0), (0, 0))),
                            device=self.device)
        if self.state is None or self._hw != tuple(frame.shape[:2]):
            n, c = self.feature_fn(frame).shape
            self.state = init_state(self.cfg, n, c, self.device)
            self._hw = tuple(frame.shape[:2])
        o_live = o if num_objects is None else min(num_objects,
                                                   self.cfg.max_objects)
        if self._fused:
            self.state = _default_add_reference(self.state, frame, m, o_live,
                                                self.cfg)
            return
        self.state = write_memory(self.state, self.feature_fn(frame),
                                  masks_to_grid(m, self.cfg), o_live)

    def step(self, frame, update_memory: bool = True,
             binary: bool = False) -> np.ndarray:
        """Propagate to a new frame -> (max_objects, H, W) soft masks
        (binary: uint8 {0, 1})."""
        assert self.state is not None, "add_reference first"
        frame = self._frame(frame)
        if self._fused:
            masks, self.state = _default_step(self.state, frame, self.cfg,
                                              bool(update_memory),
                                              bool(binary))
            return masks.cpu().numpy()
        feats = self.feature_fn(frame)
        grid = propagate_step(self.state, feats, self.cfg)
        if update_memory:
            conf = torch.where(grid > 0.5, grid, 0.0)
            self.state = write_memory(self.state, feats, conf,
                                      self.state.num_objects)
        masks = grid_to_masks(grid, self._hw, self.cfg)
        if binary:
            masks = (masks > 0.5).to(torch.uint8)
        return masks.cpu().numpy()

    @property
    def num_objects(self) -> int:
        return self.state.num_objects if self.state is not None else 0


def edge_pad16(frames: torch.Tensor) -> torch.Tensor:
    """(..., H, W, C) -> the same with H and W padded to multiples of 16
    by repeating the last row and column (numpy's 'edge' pad), any
    dtype, on the frames' device."""
    h, w = frames.shape[-3], frames.shape[-2]
    ph, pw = -h % 16, -w % 16
    if not (ph or pw):
        return frames
    dev = frames.device
    rows = torch.arange(h + ph, device=dev).clamp(max=h - 1)
    cols = torch.arange(w + pw, device=dev).clamp(max=w - 1)
    return frames.index_select(-3, rows).index_select(-2, cols)


class LearnedMemoryTracker:
    """XMem propagation with MemoryTracker's lifecycle (GroundedTracker's
    `propagator`): the trained key/value encoders and grouped decoder of
    models/xmem.py, weights from xmem.convert_xmem_checkpoint (random
    weights work for tests). Frames (numpy or tensors, uint8 or float in
    [0, 1]) go to the parameters' device as they are and pad to
    multiples of 16 there; results come back as numpy, cropped to the
    frame."""

    def __init__(self, params, cfg: Optional[xmem.XMemConfig] = None,
                 mem_every: Optional[int] = None):
        self.cfg = cfg or xmem.XMemConfig()
        if mem_every is not None:
            self.cfg = dataclasses.replace(self.cfg, mem_every=mem_every)
        self.params = params
        self.device = xmem.params_device(params)
        self.state: Optional[xmem.XMemState] = None
        self._hw: Optional[Tuple[int, int]] = None
        self._frame_idx = 0

    def clear(self):
        self.state = None
        self._frame_idx = 0

    def _prep(self, frame) -> torch.Tensor:
        t = (frame if isinstance(frame, torch.Tensor)
             else torch.from_numpy(np.ascontiguousarray(frame)))
        t = t.to(self.device)
        return edge_pad16(t if t.dtype == torch.uint8 else t.float())

    def add_reference(self, frame, masks, num_objects: Optional[int] = None
                      ) -> None:
        """frame (H, W, 3); masks (O, H, W) binary (uint8 or float);
        num_objects the live count when `masks` is the whole slot array
        (without it every slot counts as live, and empty slots' decoder
        noise competes in xmem.aggregate)."""
        self._hw = tuple(frame.shape[:2])
        if not isinstance(masks, torch.Tensor):
            masks = torch.from_numpy(np.asarray(masks))
        o = min(masks.shape[0], self.cfg.max_objects)
        f = self._prep(frame)
        H, W = f.shape[:2]
        mdtype = torch.uint8 if masks.dtype == torch.uint8 else torch.float32
        m = torch.zeros((self.cfg.max_objects, H, W), dtype=mdtype,
                        device=self.device)
        m[:o, :masks.shape[1], :masks.shape[2]] = masks[:o].to(
            device=self.device, dtype=mdtype)
        if self.state is None or tuple(self.state.hidden.shape[2:]) != (
                H // 16, W // 16):
            self.state = xmem.init_state(self.cfg, H // 16, W // 16,
                                         self.device)
        o_live = o if num_objects is None else min(num_objects,
                                                   self.cfg.max_objects)
        self.state = xmem.add_reference_step(self.params, self.state, f, m,
                                             o_live, self.cfg)
        self._frame_idx += 1

    def step(self, frame, update_memory: Optional[bool] = None,
             binary: bool = False) -> np.ndarray:
        """Propagate to a new frame -> (max_objects, H, W) soft masks
        (binary: uint8 {0, 1}, thresholded on the device). Memory writes
        follow the mem_every cadence unless forced."""
        assert self.state is not None, "add_reference first"
        if update_memory is None:
            update_memory = (self._frame_idx % self.cfg.mem_every) == 0
        deep = (update_memory
                and (self._frame_idx % self.cfg.deep_update_every) == 0)
        prob, self.state = xmem.propagate_step(
            self.params, self.state, self._prep(frame), self.cfg,
            update_memory=bool(update_memory), deep_update=bool(deep),
            binary=bool(binary))
        self._frame_idx += 1
        H, W = self._hw
        return prob[:, :H, :W].cpu().numpy()

    def step_chunk(self, frames, pad_to: Optional[int] = None,
                   binary: bool = False) -> np.ndarray:
        """A run of frames in one xmem.propagate_chunk ->
        (len(frames), max_objects, H, W): the same cadence as as many
        step() calls. `pad_to` pads a short chunk by repeating its last
        frame (padded steps write nothing)."""
        assert self.state is not None, "add_reference first"
        t = len(frames)
        H, W = self._hw
        if t == 0:
            return np.zeros((0, self.cfg.max_objects, H, W), np.float32)
        tt = max(pad_to or t, t)
        idx = [self._frame_idx + j for j in range(t)]
        upd = [i % self.cfg.mem_every == 0 for i in idx] + [False] * (tt - t)
        deep = [u and i % self.cfg.deep_update_every == 0
                for u, i in zip(upd, idx)] + [False] * (tt - t)
        valid = [True] * t + [False] * (tt - t)
        stack = [self._prep(f) for f in frames]
        stack += [stack[-1]] * (tt - t)
        probs, self.state = xmem.propagate_chunk(
            self.params, self.state, torch.stack(stack), upd, deep, self.cfg,
            valid=valid, binary=bool(binary))
        self._frame_idx += t
        return probs[:t, :, :H, :W].cpu().numpy()

    @property
    def num_objects(self) -> int:
        return self.state.num_objects if self.state is not None else 0
