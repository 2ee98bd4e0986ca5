"""Batch CLIP spatio-temporal feature pre-extraction.

Counterpart of video_llava_tpu/scripts/save_features.py. Parity:
reference scripts/save_spatio_temporal_clip_features.py:74-139 — for
every video in a directory: uniform-sample 100 frames, CLIP ViT-L/14
penultimate features in f32, spatio-temporal pooling, one pickle of a
(356, 1024) f32 array per video; resume by output existence; per-video
fault tolerance. A clip of fewer frames is zero-padded to --num_frames
and the padding is masked out of the pooling.

The tower runs on the card in f32 (its attention through kernel 1's f32
body, ops/attention.flash_attention_bhsd); the pooling is the plain
ops/pooling.spatio_temporal_pool in f32, as the JAX script pools with
its XLA formulation. Frames decode through media/loader (libav);
:func:`process_videos` takes any frame reader, so frames that do not
come from a file (a machine without libav) go through the same path.

Run: python -m video_llava_tpu_torch.scripts.save_features \\
    --video_dir_path vids/ --clip_feat_path feats/ [--clip_path ckpt]
"""

from __future__ import annotations

import argparse
import os
import pickle
from typing import Callable, Iterable

import numpy as np
import torch

from video_llava_tpu_torch.config import CLIPVisionConfig
from video_llava_tpu_torch.engine import weights as weights_mod
from video_llava_tpu_torch.media.loader import load_video
from video_llava_tpu_torch.models.clip import CLIPVisionTower
from video_llava_tpu_torch.ops.image import normalize_clip
from video_llava_tpu_torch.ops.pooling import spatio_temporal_pool
from video_llava_tpu_torch.runtime.model_init import random_init_


@torch.inference_mode()
def extract(tower: CLIPVisionTower, frames_uint8,
            n_valid: int) -> torch.Tensor:
    """frames (t, H, W, 3) uint8, the first n_valid real -> normalized in
    the tower's dtype, penultimate patch features, pooled over the valid
    frames -> (max_temporal_tokens + patches, hidden) f32 on the tower's
    device."""
    p = tower.class_embedding
    frames = torch.as_tensor(np.ascontiguousarray(frames_uint8))
    pixels = normalize_clip(frames.to(p.device), dtype=p.dtype)
    feats = tower.penultimate_patches(pixels)
    return spatio_temporal_pool(feats, num_valid_frames=n_valid,
                                out_dtype=torch.float32)


def build_extractor(clip_path=None, image_size: int = 224,
                    dtype=torch.float32, device="cuda", seed: int = 0):
    """-> (cfg, tower, extract): CLIP ViT-L/14 at `image_size` in
    `dtype` on `device`, from an HF CLIP directory or drawn from `seed`,
    and :func:`extract`."""
    cfg = CLIPVisionConfig(image_size=image_size)
    tower = CLIPVisionTower(cfg, device=device, dtype=dtype)
    if clip_path and os.path.isdir(clip_path):
        weights_mod.convert_clip_vision(
            weights_mod.checkpoint_shards(clip_path), tower)
    else:
        random_init_(tower, torch.Generator(device=device).manual_seed(seed))
    return cfg, tower.requires_grad_(False), extract


def video_features(tower, extract, frames: np.ndarray,
                   num_frames: int = 100) -> np.ndarray:
    """One video's frames (t <= num_frames, H, W, 3) uint8 -> its pooled
    f32 features, the frames zero-padded to num_frames (masked in the
    pooling)."""
    t = frames.shape[0]
    if t < num_frames:
        frames = np.pad(frames, ((0, num_frames - t), (0, 0), (0, 0),
                                 (0, 0)))
    return extract(tower, frames, t).cpu().numpy()


def process_videos(video_names: Iterable[str],
                   read_frames: Callable[[str], np.ndarray],
                   clip_feat_path: str, tower, extract,
                   num_frames: int = 100) -> int:
    """Write <video id>.pkl into clip_feat_path for each video name:
    skipped when the file is there (resume), a video that fails (its
    read or its encode) printed and skipped. Returns the count of new
    files."""
    done = 0
    for video_name in video_names:
        video_id = video_name.rsplit(".", 1)[0]
        out_path = os.path.join(clip_feat_path, f"{video_id}.pkl")
        if os.path.exists(out_path):  # resume-by-existence
            continue
        try:
            feats = video_features(tower, extract, read_frames(video_name),
                                   num_frames)
            with open(out_path, "wb") as f:
                pickle.dump(feats, f)
            done += 1
            if done % 50 == 0:
                print(f"{done} videos processed", flush=True)
        except Exception as e:  # noqa: BLE001 (reference behavior)
            print(f"Can't process {video_name}: {e}", flush=True)
    return done


def main(argv=None):
    p = argparse.ArgumentParser(
        prog="video_llava_tpu_torch.scripts.save_features")
    p.add_argument("--video_dir_path", required=True)
    p.add_argument("--clip_feat_path", required=True)
    p.add_argument("--clip_path", default=None)
    p.add_argument("--image_size", type=int, default=224)
    p.add_argument("--num_frames", type=int, default=100)
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda)")
    args = p.parse_args(argv)

    _, tower, extract = build_extractor(args.clip_path, args.image_size,
                                        device=args.device)
    os.makedirs(args.clip_feat_path, exist_ok=True)
    size = (args.image_size, args.image_size)
    done = process_videos(
        sorted(os.listdir(args.video_dir_path)),
        lambda name: load_video(os.path.join(args.video_dir_path, name),
                                num_frm=args.num_frames, shape=size),
        args.clip_feat_path, tower, extract, args.num_frames)
    print(f"finished: {done} new feature files")


if __name__ == "__main__":
    main()
