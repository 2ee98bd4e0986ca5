"""LLM-judge evaluation harness.

Counterpart of video_llava_tpu/eval/judge.py. The six reference scripts
(quantitative_evaluation/evaluate_activitynet_qa.py and
evaluate_benchmark_{1..5}_*.py) share one skeleton: a per-QA
ChatCompletion call, an ast.literal_eval parse, per-key JSON output, a
retry-until-complete loop over a worker pool keyed on output-file
existence (evaluate_activitynet_qa.py:127-154), and accuracy/mean-score
aggregation (:156-200). Here the skeleton is one parameterized module;
the judge prompts below are verbatim benchmark definitions (the metric is
the prompt) and carry their source cites; this package keeps its own copy
of them.

The judge endpoint is any OpenAI-compatible server, such as this
package's serving/ (replacing FastChat,
quantitative_evaluation/README.md:5-16), reached through
eval/openai_client.py (the standard library's HTTP, no `requests`).
"""

from __future__ import annotations

import argparse
import ast
import json
import os
from multiprocessing.pool import ThreadPool
from typing import Dict, List, Optional

from video_llava_tpu_torch.eval.openai_client import ChatCompletionClient

# --- benchmark-defining judge prompts (verbatim; see module docstring) ---

_QA_FOOTER = (
    "Please evaluate the following video-based question-answer pair:\n\n"
    "Question: {question}\n"
    "Correct Answer: {answer}\n"
    "Predicted Answer: {pred}\n\n"
)

JUDGE_TASKS: Dict[str, Dict[str, str]] = {
    # evaluate_activitynet_qa.py:36-61 (yes/no + 0-5 score)
    "activitynet_qa": {
        "system": (
            "You are an intelligent chatbot designed for evaluating the"
            " correctness of generative outputs for question-answer pairs. "
            "Your task is to compare the predicted answer with the correct"
            " answer and determine if they match meaningfully. Here's how"
            " you can accomplish the task:"
            "------"
            "##INSTRUCTIONS: "
            "- Focus on the meaningful match between the predicted answer"
            " and the correct answer.\n"
            "- Consider synonyms or paraphrases as valid matches.\n"
            "- Evaluate the correctness of the prediction compared to the"
            " answer."
        ),
        "user": _QA_FOOTER
        + (
            "Provide your evaluation only as a yes/no and score where the"
            " score is an integer value between 0 and 5, with 5 indicating"
            " the highest meaningful match. "
            "Please generate the response in the form of a Python dictionary"
            " string with keys 'pred' and 'score', where value of 'pred' is "
            " a string of 'yes' or 'no' and value of 'score' is in INTEGER,"
            " not STRING."
            "DO NOT PROVIDE ANY OTHER OUTPUT TEXT OR EXPLANATION. Only"
            " provide the Python dictionary string. "
            "For example, your response should look like this:"
            " {{'pred': 'yes', 'score': 4.8}}."
        ),
    },
    # evaluate_benchmark_1_correctness.py
    "correctness": {
        "system": (
            "You are an intelligent chatbot designed for evaluating the"
            " factual accuracy of generative outputs for video-based"
            " question-answer pairs. "
            "Your task is to compare the predicted answer with the correct"
            " answer and determine if they are factually consistent. Here's"
            " how you can accomplish the task:"
            "------"
            "##INSTRUCTIONS: "
            "- Focus on the factual consistency between the predicted answer"
            " and the correct answer. The predicted answer should not contain"
            " any misinterpretations or misinformation.\n"
            "- The predicted answer must be factually accurate and align with"
            " the video content.\n"
            "- Consider synonyms or paraphrases as valid matches.\n"
            "- Evaluate the factual accuracy of the prediction compared to"
            " the answer."
        ),
        "user": _QA_FOOTER
        + (
            "Provide your evaluation only as a factual accuracy score where"
            " the factual accuracy score is an integer value between 0 and 5,"
            " with 5 indicating the highest level of factual consistency. "
            "Please generate the response in the form of a Python dictionary"
            " string with keys 'score', where its value is the factual"
            " accuracy score in INTEGER, not STRING."
            "DO NOT PROVIDE ANY OTHER OUTPUT TEXT OR EXPLANATION. Only"
            " provide the Python dictionary string. "
            "For example, your response should look like this: {{''score':"
            " 4.8}}."
        ),
    },
    # evaluate_benchmark_2_detailed_orientation.py
    "detailed_orientation": {
        "system": (
            "You are an intelligent chatbot designed for evaluating the"
            " detail orientation of generative outputs for video-based"
            " question-answer pairs. "
            "Your task is to compare the predicted answer with the correct"
            " answer and determine its level of detail, considering both"
            " completeness and specificity. Here's how you can accomplish"
            " the task:"
            "------"
            "##INSTRUCTIONS: "
            "- Check if the predicted answer covers all major points from the"
            " video. The response should not leave out any key aspects.\n"
            "- Evaluate whether the predicted answer includes specific details"
            " rather than just generic points. It should provide comprehensive"
            " information that is tied to specific elements of the video.\n"
            "- Consider synonyms or paraphrases as valid matches.\n"
            "- Provide a single evaluation score that reflects the level of"
            " detail orientation of the prediction, considering both"
            " completeness and specificity."
        ),
        "user": _QA_FOOTER
        + (
            "Provide your evaluation only as a detail orientation score where"
            " the detail orientation score is an integer value between 0 and"
            " 5, with 5 indicating the highest level of detail orientation. "
            "Please generate the response in the form of a Python dictionary"
            " string with keys 'score', where its value is the detail"
            " orientation score in INTEGER, not STRING."
            "DO NOT PROVIDE ANY OTHER OUTPUT TEXT OR EXPLANATION. Only"
            " provide the Python dictionary string. "
            "For example, your response should look like this: {{''score':"
            " 4.8}}."
        ),
    },
    # evaluate_benchmark_3_context.py
    "context": {
        "system": (
            "You are an intelligent chatbot designed for evaluating the"
            " contextual understanding of generative outputs for video-based"
            " question-answer pairs. "
            "Your task is to compare the predicted answer with the correct"
            " answer and determine if the generated response aligns with the"
            " overall context of the video content. Here's how you can"
            " accomplish the task:"
            "------"
            "##INSTRUCTIONS: "
            "- Evaluate whether the predicted answer aligns with the overall"
            " context of the video content. It should not provide information"
            " that is out of context or misaligned.\n"
            "- The predicted answer must capture the main themes and"
            " sentiments of the video.\n"
            "- Consider synonyms or paraphrases as valid matches.\n"
            "- Provide your evaluation of the contextual understanding of the"
            " prediction compared to the answer."
        ),
        "user": _QA_FOOTER
        + (
            "Provide your evaluation only as a contextual understanding score"
            " where the contextual understanding score is an integer value"
            " between 0 and 5, with 5 indicating the highest level of"
            " contextual understanding. "
            "Please generate the response in the form of a Python dictionary"
            " string with keys 'score', where its value is contextual"
            " understanding score in INTEGER, not STRING."
            "DO NOT PROVIDE ANY OTHER OUTPUT TEXT OR EXPLANATION. Only"
            " provide the Python dictionary string. "
            "For example, your response should look like this: {{''score':"
            " 4.8}}."
        ),
    },
    # evaluate_benchmark_4_temporal.py
    "temporal": {
        "system": (
            "You are an intelligent chatbot designed for evaluating the"
            " temporal understanding of generative outputs for video-based"
            " question-answer pairs. "
            "Your task is to compare the predicted answer with the correct"
            " answer and determine if they correctly reflect the temporal"
            " sequence of events in the video content. Here's how you can"
            " accomplish the task:"
            "------"
            "##INSTRUCTIONS: "
            "- Focus on the temporal consistency between the predicted answer"
            " and the correct answer. The predicted answer should correctly"
            " reflect the sequence of events or details as they are presented"
            " in the video content.\n"
            "- Consider synonyms or paraphrases as valid matches, but only if"
            " the temporal order is maintained.\n"
            "- Evaluate the temporal accuracy of the prediction compared to"
            " the answer."
        ),
        "user": _QA_FOOTER
        + (
            "Provide your evaluation only as a temporal accuracy score where"
            " the temporal accuracy score is an integer value between 0 and"
            " 5, with 5 indicating the highest level of temporal consistency. "
            "Please generate the response in the form of a Python dictionary"
            " string with keys 'score', where its value is the temporal"
            " accuracy score in INTEGER, not STRING."
            "DO NOT PROVIDE ANY OTHER OUTPUT TEXT OR EXPLANATION. Only"
            " provide the Python dictionary string. "
            "For example, your response should look like this: {{''score':"
            " 4.8}}."
        ),
    },
    # evaluate_benchmark_5_consistency.py (two-question)
    "consistency": {
        "system": (
            "You are an intelligent chatbot designed for evaluating the"
            " consistency of generative outputs for similar video-based"
            " question-answer pairs. "
            "You will be given two very similar questions, a common answer"
            " common to both the questions and predicted answers for the two"
            " questions ."
            "Your task is to compare the predicted answers for two very"
            " similar question, with a common correct answer and determine if"
            " they are consistent. Here's how you can accomplish the task:"
            "------"
            "##INSTRUCTIONS: "
            "- Focus on the consistency between the two predicted answers and"
            " the correct answer. Both predicted answers should correspond to"
            " the correct answer and to each other, and should not contain any"
            " contradictions or significant differences in the conveyed"
            " information.\n"
            "- Both predicted answers must be consistent with each other and"
            " the correct answer, in terms of the information they provide"
            " about the video content.\n"
            "- Consider synonyms or paraphrases as valid matches, but only if"
            " they maintain the consistency in the conveyed information.\n"
            "- Evaluate the consistency of the two predicted answers compared"
            " to the correct answer."
        ),
        "user": (
            "Please evaluate the following video-based question-answer pair:\n\n"
            "Question 1: {question1}\n"
            "Question 2: {question2}\n"
            "Correct Answer: {answer}\n"
            "Predicted Answer to Question 1: {pred1}\n"
            "Predicted Answer to Question 2: {pred2}\n\n"
            "Provide your evaluation only as a consistency score where the"
            " consistency score is an integer value between 0 and 5, with 5"
            " indicating the highest level of consistency. "
            "Please generate the response in the form of a Python dictionary"
            " string with keys 'score', where its value is the consistency"
            " score in INTEGER, not STRING."
            "DO NOT PROVIDE ANY OTHER OUTPUT TEXT OR EXPLANATION. Only"
            " provide the Python dictionary string. "
            "For example, your response should look like this: {{''score':"
            " 4.8}}."
        ),
    },
}


def judge_messages(task: str, qa: Dict) -> List[Dict[str, str]]:
    spec = JUDGE_TASKS[task]
    return [
        {"role": "system", "content": spec["system"]},
        {"role": "user", "content": spec["user"].format(**qa)},
    ]


def annotate(
    client: ChatCompletionClient,
    model_name: str,
    task: str,
    prediction_set: Dict[str, Dict],
    keys: List[str],
    output_dir: str,
) -> None:
    """Worker: judge each QA pair, write {key}.json (reference
    evaluate_activitynet_qa.py:22-73). Failures are skipped — the outer
    retry loop picks them up."""
    for key in keys:
        qa = prediction_set[key]
        try:
            text = client.chat_text(model_name, judge_messages(task, qa))
            response_dict = ast.literal_eval(text)
            with open(os.path.join(output_dir, f"{key}.json"), "w") as f:
                json.dump([response_dict, qa], f)
        except Exception as e:  # noqa: BLE001 (parity with the reference)
            print(f"Error processing file '{key}': {e}")


def run_judge(
    prediction_set: Dict[str, Dict],
    task: str,
    output_dir: str,
    model_name: str = "vicuna-13b-v1.5",
    num_workers: int = 4,
    api_base: Optional[str] = None,
    max_rounds: int = 999,
    requests_per_second: Optional[float] = None,
) -> None:
    """Retry-until-complete pool loop keyed on output-file existence
    (reference :127-154). requests_per_second caps the pool's combined
    rate against external endpoints (the client also backs off on
    429/5xx per request)."""
    os.makedirs(output_dir, exist_ok=True)
    client = ChatCompletionClient(
        api_base=api_base, requests_per_second=requests_per_second
    )
    for _ in range(max_rounds):
        done = {f[:-5] for f in os.listdir(output_dir) if f.endswith(".json")}
        todo = [k for k in prediction_set if k not in done]
        if not todo:
            break
        parts = [todo[i::num_workers] for i in range(num_workers)]
        with ThreadPool(num_workers) as pool:
            pool.starmap(
                annotate,
                [
                    (client, model_name, task, prediction_set, p, output_dir)
                    for p in parts
                    if p
                ],
            )


def aggregate(output_dir: str) -> Dict[str, float]:
    """Combine per-key judgements (reference :156-200): mean score and,
    when 'pred' is present, accuracy = yes / (yes + no)."""
    scores: List[float] = []
    yes, no = 0, 0
    for name in sorted(os.listdir(output_dir)):
        if not name.endswith(".json"):
            continue
        with open(os.path.join(output_dir, name)) as f:
            result = json.load(f)[0]
        if "score" in result:
            scores.append(float(result["score"]))
        pred = str(result.get("pred", "")).lower()
        if "yes" in pred:
            yes += 1
        elif "no" in pred:
            no += 1
    out = {"average_score": sum(scores) / len(scores) if scores else 0.0}
    if yes + no:
        out["accuracy"] = yes / (yes + no)
    return out


def main(argv=None):
    p = argparse.ArgumentParser(description="LLM-judge evaluation")
    p.add_argument("--task", required=True, choices=sorted(JUDGE_TASKS))
    p.add_argument("--pred_path", required=True,
                   help="predictions JSON (list of QA dicts)")
    p.add_argument("--output_dir", required=True)
    p.add_argument("--output_json", required=True)
    p.add_argument("--model_name", default="vicuna-13b-v1.5")
    p.add_argument("--num_tasks", type=int, default=4)
    p.add_argument("--api_base", default=None)
    p.add_argument("--rps", type=float, default=None,
                   help="cap on combined judge requests/second")
    p.add_argument("--max_rounds", type=int, default=999,
                   help="retry-until-complete round cap (reference loops\n                   indefinitely; lower this for unattended runs)")
    args = p.parse_args(argv)

    with open(args.pred_path) as f:
        preds = json.load(f)
    prediction_set = {}
    for i, sample in enumerate(preds):
        key = str(sample.get("video_name", sample.get("id", i))) + f"_{i}"
        qa = {
            "question": sample.get("question", sample.get("Q", "")),
            "answer": sample.get("answer", sample.get("A", "")),
            "pred": sample.get("pred", ""),
        }
        if args.task == "consistency":
            qa = {
                "question1": sample.get("question1", sample.get("Q1", "")),
                "question2": sample.get("question2", sample.get("Q2", "")),
                "answer": sample.get("answer", sample.get("A", "")),
                "pred1": sample.get("pred1", ""),
                "pred2": sample.get("pred2", ""),
            }
        prediction_set[key] = qa

    run_judge(
        prediction_set, args.task, args.output_dir, args.model_name,
        args.num_tasks, args.api_base,
        max_rounds=args.max_rounds,
        requests_per_second=args.rps,
    )
    results = aggregate(args.output_dir)
    with open(args.output_json, "w") as f:
        json.dump(results, f, indent=2)
    print(json.dumps(results))


if __name__ == "__main__":
    main()
