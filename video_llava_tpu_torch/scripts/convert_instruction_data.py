"""Instruction-data converters.

Counterpart of video_llava_tpu/scripts/convert_instruction_data.py
(plain Python, the same JSON out). Parity: reference
scripts/convert_instruction_json_to_training_format.py:16-39 and
scripts/filter_for_missing_videos.py:32-69 — VideoInstruct-100K JSON ->
training conversations with alternating <video> placement by sample
parity, optionally filtered to videos whose feature files exist.

Run: python -m video_llava_tpu_torch.scripts.convert_instruction_data \
    --input_json_file in.json --output_json_file out.json \
    [--clip_feature_path feats/]
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Dict, List, Optional


def convert_entries(
    entries: List[Dict], available_ids: Optional[set] = None
) -> List[Dict]:
    out = []
    for i, content in enumerate(entries):
        if available_ids is not None and content["video_id"] not in available_ids:
            continue
        conversations = []
        # alternating <video> placement by parity ("This is critical",
        # filter_for_missing_videos.py:49)
        if i % 2 == 0:
            conversations.append(
                {"from": "human", "value": f"{content['q']}\n<video>"}
            )
        else:
            conversations.append(
                {"from": "human", "value": f"<video>\n{content['q']}"}
            )
        conversations.append({"from": "gpt", "value": content["a"]})
        out.append(
            {
                "id": content["video_id"],
                "video": f"{content['video_id']}.pkl",
                "conversations": conversations,
            }
        )
    return out


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--input_json_file", required=True)
    p.add_argument("--output_json_file", required=True)
    p.add_argument("--clip_feature_path", default=None)
    args = p.parse_args(argv)

    with open(args.input_json_file) as f:
        entries = json.load(f)
    available = None
    if args.clip_feature_path:
        available = {
            f.split(".")[0] for f in os.listdir(args.clip_feature_path)
        }
    out = convert_entries(entries, available)
    print(f"Total annotations retained: {len(out)}")
    with open(args.output_json_file, "w") as f:
        json.dump(out, f)


if __name__ == "__main__":
    main()
