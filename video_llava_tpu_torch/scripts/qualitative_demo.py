"""One-video end-to-end qualitative grounding demo.

Counterpart of video_llava_tpu/scripts/qualitative_demo.py. Parity:
reference grounding_evaluation/gen_qualitative_results.py:39-122 —
infer an answer, tag frames, entity-match, scene-split, track, and
write the annotated video. :func:`run_demo` is the whole pipeline on
frames already decoded; `main` decodes the video with media/loader
(libav: without it the loader's own error is raised) and encodes the
annotated frames back.

Run: python -m video_llava_tpu_torch.scripts.qualitative_demo \\
    --video_path v.mp4 --prompt "What is the man doing?" --output out.mp4
"""

from __future__ import annotations

import argparse
from typing import List, Sequence, Tuple

import numpy as np


def run_demo(engine, tracker, tagger, matcher, frames: np.ndarray,
             native: np.ndarray, prompt: str
             ) -> Tuple[str, Sequence[str], List[np.ndarray]]:
    """frames (t, size, size, 3) uint8 at the vision tower's size, native
    (n, H, W, 3) uint8 at the video's own size -> (the answer, the
    classes tracked, the annotated native frames): engine.infer over
    `frames`, the tagger's top 10 tags of `frames`, the matcher's
    entities of the answer among them (else the first tag), then per
    scene of `native` (media/scene.detect_scenes) the tracker over its
    frames, each frame annotated with its masks and its objects'
    classes (grounding/results.annotate_frame)."""
    from video_llava_tpu_torch.grounding.results import annotate_frame
    from video_llava_tpu_torch.media.scene import detect_scenes

    answer = engine.infer(frames, prompt, num_valid_frames=frames.shape[0])
    tags = tagger.run_on_video(frames.astype(np.float32) / 255.0, top_k=10)
    _, match_state = matcher(answer, tags)
    classes = sorted(set(match_state.values())) or tags[:1]

    annotated = []
    for start, end in detect_scenes(native):
        results = tracker.run_on_list_of_images(list(native[start:end]),
                                                classes)
        for r, frame in zip(results, native[start:end]):
            cids = [o.category_id for o in r.objects]
            annotated.append(annotate_frame(frame, r.masks, cids))
    return answer, classes, annotated


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--video_path", required=True)
    p.add_argument("--prompt", required=True)
    p.add_argument("--output", default="qualitative_out.mp4")
    p.add_argument("--model_name", default=None)
    p.add_argument("--projection_path", default=None)
    p.add_argument("--model_size", default="7b")
    p.add_argument("--dino_checkpoint", default=None)
    p.add_argument("--sam_checkpoint", default=None)
    p.add_argument("--sam_variant", default="mobile",
                   choices=("mobile", "vit_b"))
    p.add_argument("--swin_checkpoint", default=None)
    p.add_argument("--clip_checkpoint", default=None)
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda)")
    args = p.parse_args(argv)

    from video_llava_tpu_torch.grounding.builders import build_grounding_stack
    from video_llava_tpu_torch.media.loader import (
        encode_video,
        load_video,
        load_video_native_size,
    )
    from video_llava_tpu_torch.runtime.model_init import initialize_model

    engine = initialize_model(args.model_name, args.projection_path,
                              model_size=args.model_size, device=args.device)
    size = engine.cfg.vision.image_size
    frames = load_video(args.video_path, shape=(size, size))
    native = load_video_native_size(args.video_path)
    tracker, tagger, matcher = build_grounding_stack(
        args.dino_checkpoint, args.sam_checkpoint, args.swin_checkpoint,
        args.clip_checkpoint, sam_variant=args.sam_variant,
        device=args.device)
    answer, classes, annotated = run_demo(engine, tracker, tagger, matcher,
                                          frames, native, args.prompt)
    print("ANSWER:", answer)
    print("CLASSES:", classes)
    if annotated:
        encode_video(args.output, np.stack(annotated), fps=5.0)
        print("wrote", args.output)


if __name__ == "__main__":
    main()
