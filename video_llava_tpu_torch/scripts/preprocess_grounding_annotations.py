"""Grounding dataset annotation preprocessing.

Counterpart of video_llava_tpu/scripts/preprocess_grounding_annotations.py.
Parity: reference grounding_evaluation/datasets/preproc_vidstg.py and
preproc_hcstvgv2.py —
  * VidOR: per-video trajectory extraction ({tid: {frame: {bbox xyxy,
    ...}}}) merged into per-split JSONs;
  * VidSTG: interrogative + declarative queries flattened to one entry
    per (video, query) with trajectories keyed by target_id;
  * HC-STVG v2: per-video dict -> list with tube frames, ltwh
    trajectories, and video-path mapping.

Run:
  python -m video_llava_tpu_torch.scripts.preprocess_grounding_annotations \
      vidstg --vidor_annotations_dir ... --vidstg_annotations_dir ...
  python -m video_llava_tpu_torch.scripts.preprocess_grounding_annotations \
      hcstvg --video_dir ... --ann_dir ...
"""

from __future__ import annotations

import argparse
import copy
import json
import os


def preproc_vidor_split(split_dir: str) -> dict:
    """VidOR annotations dir (subdirs of per-video JSONs) -> {video_id:
    {video_path, fps, trajectories: {tid: {frame: {bbox xyxy}}}, ...}}."""
    outs = {}
    categories = {}
    for subdir in sorted(os.listdir(split_dir)):
        sub = os.path.join(split_dir, subdir)
        if not os.path.isdir(sub):
            continue
        for name in sorted(os.listdir(sub)):
            with open(os.path.join(sub, name)) as f:
                annot = json.load(f)
            objects = {
                obj["tid"]: obj["category"] for obj in annot["subject/objects"]
            }
            trajectories = {}
            for i_frame, traj in enumerate(annot["trajectories"]):
                for bbox in traj:
                    tid = bbox["tid"]
                    if tid not in trajectories:
                        trajectories[tid] = {}
                        categories.setdefault(objects[tid], len(categories))
                    trajectories[tid][i_frame] = {
                        "bbox": [
                            bbox["bbox"]["xmin"],
                            bbox["bbox"]["ymin"],
                            bbox["bbox"]["xmax"],  # xyxy (reference NOTE)
                            bbox["bbox"]["ymax"],
                        ],
                        "generated": bbox.get("generated"),
                        "tracker": bbox.get("tracker"),
                        "category_id": categories[objects[tid]],
                    }
            outs[annot["video_id"]] = {
                "video_id": annot["video_id"],
                "video_path": annot["video_path"],
                "frame_count": annot["frame_count"],
                "fps": annot["fps"],
                "width": annot["width"],
                "height": annot["height"],
                "objects": objects,
                "trajectories": trajectories,
            }
    return outs


def preproc_vidstg_file(annotations: list, vidor: dict) -> dict:
    """VidSTG raw annotations + VidOR maps -> {'videos': [...],
    'trajectories': {vid: {target_id: traj}}} (dataset consumption
    format, one entry per query with qtype tags)."""
    videos, trajectories = [], {}
    for annot in annotations:
        av = vidor[annot["vid"]]
        base = {
            "original_video_id": annot["vid"],
            "frame_count": annot["frame_count"],
            "fps": annot["fps"],
            "width": annot["width"],
            "height": annot["height"],
            "start_frame": annot["used_segment"]["begin_fid"],
            "end_frame": annot["used_segment"]["end_fid"],
            "tube_start_frame": annot["temporal_gt"]["begin_fid"],
            "tube_end_frame": annot["temporal_gt"]["end_fid"],
            "video_path": av["video_path"],
        }
        for qtype, key in (("interrogative", "questions"),
                           ("declarative", "captions")):
            for query in annot.get(key, []):
                video = copy.deepcopy(base)
                video["caption"] = query["description"]
                video["type"] = query.get("type")
                video["target_id"] = query["target_id"]
                video["video_id"] = len(videos)
                video["qtype"] = qtype
                videos.append(video)
                tid = str(query["target_id"])
                trajectories.setdefault(annot["vid"], {})
                if tid not in trajectories[annot["vid"]]:
                    trajectories[annot["vid"]][tid] = {
                        str(k): v for k, v in av["trajectories"][
                            int(tid) if int(tid) in av["trajectories"] else tid
                        ].items()
                    }
    return {"videos": videos, "trajectories": trajectories}


def preproc_hcstvg(annotations: dict, vid2path: dict) -> list:
    """HC-STVG v2 raw {video.mp4: annot} -> list of video entries
    (reference preproc_hcstvgv2.py:34-49). Trajectories stay ltwh."""
    videos = []
    for video, annot in annotations.items():
        stem = video[:-4]
        videos.append(
            {
                "original_video_id": stem,
                "frame_count": annot["img_num"],
                "width": annot["img_size"][1],
                "height": annot["img_size"][0],
                "tube_start_frame": annot["st_frame"],  # starts with 1
                "tube_end_frame": annot["st_frame"] + len(annot["bbox"]),
                "tube_start_time": annot["st_time"],
                "tube_end_time": annot["ed_time"],
                "video_path": vid2path[stem],
                "caption": annot["English"],
                "video_id": len(videos),
                "trajectory": annot["bbox"],
            }
        )
    return videos


def main(argv=None):
    p = argparse.ArgumentParser()
    sub = p.add_subparsers(dest="cmd", required=True)
    v = sub.add_parser("vidstg")
    v.add_argument("--vidor_annotations_dir", required=True)
    v.add_argument("--vidstg_annotations_dir", required=True)
    h = sub.add_parser("hcstvg")
    h.add_argument("--video_dir", required=True)
    h.add_argument("--ann_dir", required=True)
    args = p.parse_args(argv)

    if args.cmd == "vidstg":
        for split in ["training", "validation"]:
            out = preproc_vidor_split(
                os.path.join(args.vidor_annotations_dir, split)
            )
            with open(
                os.path.join(args.vidstg_annotations_dir, f"vidor_{split}.json"),
                "w",
            ) as f:
                json.dump(out, f)
        for name, vidor_name in [
            ("train_annotations.json", "vidor_training.json"),
            ("val_annotations.json", "vidor_training.json"),
            ("test_annotations.json", "vidor_validation.json"),
        ]:
            path = os.path.join(args.vidstg_annotations_dir, name)
            if not os.path.exists(path):
                continue
            with open(path) as f:
                anns = json.load(f)
            with open(
                os.path.join(args.vidstg_annotations_dir, vidor_name)
            ) as f:
                vidor = json.load(f)
            out = preproc_vidstg_file(anns, vidor)
            out_name = name.split("_")[0] + ".json"
            with open(
                os.path.join(args.vidstg_annotations_dir, out_name), "w"
            ) as f:
                json.dump(out, f)
            print(f"{out_name}: {len(out['videos'])} query-videos")
    else:
        vid2path = {}
        for d in os.listdir(args.video_dir):
            full = os.path.join(args.video_dir, d)
            if os.path.isdir(full):
                for fn in os.listdir(full):
                    vid2path[fn[:-4]] = os.path.join(d, fn)
            elif d.endswith(".mp4"):
                vid2path[d[:-4]] = d
        for name in ["train_v2.json", "val_v2.json"]:
            path = os.path.join(args.ann_dir, name)
            if not os.path.exists(path):
                continue
            with open(path) as f:
                anns = json.load(f)
            out = preproc_hcstvg(anns, vid2path)
            with open(
                os.path.join(args.ann_dir, name[:-5] + "_proc.json"), "w"
            ) as f:
                json.dump(out, f)
            print(f"{name}: {len(out)} videos")


if __name__ == "__main__":
    main()
