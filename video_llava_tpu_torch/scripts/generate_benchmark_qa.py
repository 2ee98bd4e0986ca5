"""Benchmark QA-pair generation from human captions via an
OpenAI-compatible model.

Counterpart of video_llava_tpu/scripts/generate_benchmark_qa.py. Parity:
reference quantitative_evaluation/benchmark_dataset_generation/
generate_{consistency,temporal,correctness_detail_context}_qa.py —
per-caption ChatCompletion with task-specific prompts, ast.literal_eval
parsing, per-key JSON output, retry-until-complete keyed on output-file
existence. Also covers the HC-STVG interrogative-question generation
(grounding_evaluation/datasets/hcstvg_dataset_extract_interrogative.py):
declarative caption -> 'who ...?' question about the referred person.
Requests go through eval/openai_client.ChatCompletionClient (urllib).

Run: python -m video_llava_tpu_torch.scripts.generate_benchmark_qa \
    --task consistency --gt_json captions.json --output_dir out/
"""

from __future__ import annotations

import argparse
import ast
import json
import os
from multiprocessing.pool import ThreadPool
from typing import Dict

from video_llava_tpu_torch.eval.openai_client import ChatCompletionClient

TASKS: Dict[str, Dict[str, str]] = {
    "consistency": {
        "system": (
            "Your primary task is to formulate two distinct but conceptually"
            " similar questions, such that when asked about the same"
            " video-information, they correspond to the same answer. "
            "------"
            "##TASK:"
            "When given details about a video, generate two questions asked"
            " in different ways. Frame the questions so they are conceptually"
            " alike but phrased differently, leading to the exact same"
            " answer, extractable directly from the given video details. "
            "- Generate TWO questions and ONE answer."
        ),
        "user": (
            "The user input is: {caption}. "
            "Please generate the response in the form of a Python dictionary"
            " string with keys 'Q1', 'Q2', and 'A', where 'Q1' is the first"
            " question, 'Q2' the second question and 'A' the answer to both. "
            "For example: {{'Q1': '...', 'Q2': '...', 'A': '...'}}. "
            "Remember, both questions must extract the same details from the"
            " video, leading to the same answer."
        ),
    },
    "temporal": {
        "system": (
            "Your primary task is to create a question about the temporal"
            " sequence of events in a video, answerable from the given"
            " details. "
            "------"
            "##TASK:"
            "Given details about a video, generate ONE question that tests"
            " understanding of the order in which events happen (what comes"
            " before/after), and ONE answer derived from the details."
        ),
        "user": (
            "The user input is: {caption}. "
            "Please generate the response in the form of a Python dictionary"
            " string with keys 'Q' and 'A'. For example: {{'Q': '...', 'A':"
            " '...'}}."
        ),
    },
    "correctness_detail_context": {
        "system": (
            "Your primary task is to create question-answer pairs probing"
            " factual correctness, level of detail, and contextual"
            " understanding of a video from its description. "
            "------"
            "##TASK:"
            "Given details about a video, generate THREE question-answer"
            " pairs: one testing factual correctness, one requiring a"
            " detailed answer, and one about the overall context."
        ),
        "user": (
            "The user input is: {caption}. "
            "Please generate the response in the form of a Python dictionary"
            " string with keys 'Q1', 'A1', 'Q2', 'A2', 'Q3', 'A3'."
        ),
    },
    "interrogative": {
        # hcstvg_dataset_extract_interrogative.py:58-120 semantics
        "system": (
            "Your task is to convert a declarative sentence describing a"
            " person in a video into a single interrogative question asking"
            " WHO performs the described action, such that the referred"
            " person is the answer."
        ),
        "user": (
            "The sentence is: {caption}. "
            "Please generate the response in the form of a Python dictionary"
            " string with keys 'Q', where its value is the interrogative"
            " question. For example: {{'Q': 'Who is walking towards the"
            " window?'}}."
        ),
    },
}


def annotate(client, model, task, gt: Dict[str, str], keys, output_dir):
    spec = TASKS[task]
    for key in keys:
        try:
            text = client.chat_text(
                model,
                [
                    {"role": "system", "content": spec["system"]},
                    {
                        "role": "user",
                        "content": spec["user"].format(caption=gt[key]),
                    },
                ],
            )
            response_dict = ast.literal_eval(text)
            with open(os.path.join(output_dir, f"{key}.json"), "w") as f:
                json.dump(response_dict, f)
        # a broad except per key, as the reference does: one bad reply
        # (a refusal, a string literal_eval cannot parse) skips that key,
        # and main's loop asks again for every key without a file
        except Exception as e:  # noqa: BLE001 — reference behavior
            print(f"Error processing file '{key}': {e}")


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--task", required=True, choices=sorted(TASKS))
    p.add_argument("--gt_json", required=True,
                   help="{video_id: caption} JSON")
    p.add_argument("--output_dir", required=True)
    p.add_argument("--model_name", default="gpt-3.5-turbo")
    p.add_argument("--num_tasks", type=int, default=4)
    p.add_argument("--api_base", default=None)
    args = p.parse_args(argv)

    with open(args.gt_json) as f:
        gt = json.load(f)
    os.makedirs(args.output_dir, exist_ok=True)
    client = ChatCompletionClient(api_base=args.api_base)
    while True:
        done = {f[:-5] for f in os.listdir(args.output_dir) if f.endswith(".json")}
        todo = [k for k in gt if k not in done]
        if not todo:
            break
        parts = [todo[i :: args.num_tasks] for i in range(args.num_tasks)]
        with ThreadPool(args.num_tasks) as pool:
            pool.starmap(
                annotate,
                [
                    (client, args.model_name, args.task, gt, part,
                     args.output_dir)
                    for part in parts
                    if part
                ],
            )
    print("all QA pairs generated")


if __name__ == "__main__":
    main()
