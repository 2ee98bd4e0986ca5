"""Run the full generative benchmark: all five judge axes in sequence.

Counterpart of video_llava_tpu/eval/evaluate_benchmark.py, and of the
reference's quantitative_evaluation/evaluate_benchmark.sh:1-62, which
invokes the five evaluate_benchmark_*.py scripts over the inference
outputs. Here each axis is a judge.py task; results land in one summary
JSON.

Run: python -m video_llava_tpu_torch.eval.evaluate_benchmark \
    --pred_dir preds/ --output_dir out/ [--api_base http://...:8000/v1]
Expects pred files: {general,consistency}.json from
eval/run_inference.py (benchmark/consistency datasets).
"""

from __future__ import annotations

import argparse
import json
import os

from video_llava_tpu_torch.eval.judge import aggregate, run_judge

AXES = [
    ("correctness", "general.json"),
    ("detailed_orientation", "general.json"),
    ("context", "general.json"),
    ("temporal", "temporal.json"),
    ("consistency", "consistency.json"),
]


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--pred_dir", required=True)
    p.add_argument("--output_dir", required=True)
    p.add_argument("--model_name", default="vicuna-13b-v1.5")
    p.add_argument("--num_tasks", type=int, default=4)
    p.add_argument("--api_base", default=None)
    args = p.parse_args(argv)

    summary = {}
    for task, pred_file in AXES:
        pred_path = os.path.join(args.pred_dir, pred_file)
        if not os.path.exists(pred_path):
            print(f"skipping {task}: {pred_path} missing")
            continue
        with open(pred_path) as f:
            preds = json.load(f)
        prediction_set = {}
        for i, sample in enumerate(preds):
            key = f"{sample.get('video_name', i)}_{i}"
            if task == "consistency":
                prediction_set[key] = {
                    "question1": sample.get("Q1", ""),
                    "question2": sample.get("Q2", ""),
                    "answer": sample.get("A", sample.get("answer", "")),
                    "pred1": sample.get("pred1", ""),
                    "pred2": sample.get("pred2", ""),
                }
            else:
                prediction_set[key] = {
                    "question": sample.get("question", sample.get("Q", "")),
                    "answer": sample.get("answer", sample.get("A", "")),
                    "pred": sample.get("pred", ""),
                }
        out_dir = os.path.join(args.output_dir, task)
        run_judge(
            prediction_set, task, out_dir, args.model_name, args.num_tasks,
            args.api_base,
        )
        summary[task] = aggregate(out_dir)
        print(task, summary[task])

    with open(os.path.join(args.output_dir, "benchmark_summary.json"), "w") as f:
        json.dump(summary, f, indent=2)
    print(json.dumps(summary, indent=2))


if __name__ == "__main__":
    main()
