"""Spatial-grounding benchmark loop (VidSTG / HC-STVG sIoU).

Counterpart of video_llava_tpu/grounding/eval_grounding.py. Parity:
reference grounding_evaluation/eval_grounding.py —
  * `annotate()` (:31-117): referring-expression extraction from the
    LLM answer via an OpenAI-compatible model (FastChat Vicuna there,
    our serving layer here);
  * `iou_per_video` (:123-190): per annotated frame, boxes from tracked
    masks, max IoU vs GT, mean over inter_idx frames;
  * the main loop (:398-506): per video — answer -> referring expression ->
    tracker -> sIoU; per-sample try/except-and-continue; final mean
    sIoU; `gdino_baseline` mode uses the caption/expression directly.
"""

from __future__ import annotations

import ast
import json
import os
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from video_llava_tpu_torch.eval.openai_client import ChatCompletionClient
from video_llava_tpu_torch.grounding.tracker import (
    FrameResult,
    GroundedTracker,
)
from video_llava_tpu_torch.ops.box_ops import box_iou, masks_to_boxes

ANNOTATE_SYSTEM = (
    "You are an intelligent chatbot designed for identifying most relevant"
    " subject/object phrases in video-based question-sentence pairs. "
)

ANNOTATE_INSTRUCTION = (
    "Your task is to compare the question with the sentence, and extract the"
    " subject or object phrase of the sentence that most accurately answers"
    " the given question."
    "The selected phrase should be short and should contain only one noun."
    "The selected phrase can include adjectives that explain the attributes"
    " of the subject/object."
    "The selected phrase should not exceed 4 words."
    "The selected phrase should not include articles ('a', 'the', 'and')."
    "Please generate the response in the form of a Python dictionary string"
    " with keys 'OBJECT', where its value is the extracted phrase in Python"
    " string format."
    "DO NOT PROVIDE ANY OTHER OUTPUT TEXT OR EXPLANATION. Only provide the"
    " Python dictionary. "
    "For example, your response should look like this: {'OBJECT': 'green"
    " toy'}."
)

ANNOTATE_FEW_SHOT = [
    (
        "Question: who is in front of the guitar at the show? \n"
        "Answer: A woman in a black dress is in front of the guitar on"
        " stage. \n\n",
        "{'OBJECT': 'woman in black dress'}",
    ),
    (
        "Question: who points to the window? \n"
        "Answer: The old man is pointing to window. \n\n",
        "{'OBJECT': 'old man'}",
    ),
    (
        "Question: who is inside the blue car? \n"
        "Answer: The driver of the blue car. \n\n",
        "{'OBJECT': 'driver'}",
    ),
]


def annotate_referring_expression(
    question: str,
    answer: str,
    client: Optional[ChatCompletionClient] = None,
    model: str = "vicuna-13b-v1.5",
) -> Optional[Dict]:
    """Reference annotate() (eval_grounding.py:31-117)."""
    client = client or ChatCompletionClient()
    messages = [{"role": "system", "content": ANNOTATE_SYSTEM}]
    first_user = (
        ANNOTATE_INSTRUCTION
        + "Please process the following video-based question-answer pair:\n\n"
        + ANNOTATE_FEW_SHOT[0][0]
    )
    messages.append({"role": "user", "content": first_user})
    messages.append({"role": "assistant", "content": ANNOTATE_FEW_SHOT[0][1]})
    for q, a in ANNOTATE_FEW_SHOT[1:]:
        messages.append({"role": "user", "content": q})
        messages.append({"role": "assistant", "content": a})
    messages.append(
        {
            "role": "user",
            "content": (
                "Please process the following video-based question-answer"
                f" pair:\n\nQuestion: {question}\nAnswer: {answer}\n\n"
            ),
        }
    )
    try:
        text = client.chat_text(model, messages)
        return ast.literal_eval(text)
    except Exception as e:  # noqa: BLE001 — reference behavior
        print(e)
        return None


def iou_per_video(
    results: Sequence[FrameResult],
    inter_idx: Sequence[int],
    img2box: Dict[int, List[List[float]]],
) -> float:
    """Mean over annotated frames of max IoU(pred boxes, GT boxes)
    (reference eval_grounding.py:123-190). Frames with no surviving
    prediction contribute 0."""
    if not inter_idx:
        return 0.0
    by_idx = {r.frame_index: r for r in results}
    s = 0.0
    for idx in inter_idx:
        r = by_idx.get(idx)
        iou = 0.0
        if r is not None:
            masks = r.masks > 0.5
            areas = masks.reshape(masks.shape[0], -1).sum(axis=1)
            live = areas > 0
            if live.any():
                boxes = masks_to_boxes(torch.from_numpy(masks[live]))
                gt = torch.as_tensor(np.asarray(img2box[idx], np.float32))
                iou = float(box_iou(boxes, gt)[0].max())
        s += iou
    return s / len(inter_idx)


def evaluate_dataset(
    dataset,
    tracker: GroundedTracker,
    infer_answer=None,  # (frames, question) -> answer str; None = captions
    client: Optional[ChatCompletionClient] = None,
    judge_model: str = "vicuna-13b-v1.5",
    output_dir: Optional[str] = None,
    use_annotator: bool = True,
    max_samples: Optional[int] = None,
) -> Dict:
    """Full benchmark loop (reference :434-506)."""
    sious: List[float] = []
    per_sample = []
    n = len(dataset) if max_samples is None else min(len(dataset), max_samples)
    for i in range(n):
        try:
            sample = dataset[i]
            question = sample.caption
            if infer_answer is not None:
                answer = infer_answer(sample.frames, question)
            else:
                answer = question
            expr = question
            if use_annotator:
                parsed = annotate_referring_expression(
                    question, answer, client, judge_model
                )
                if parsed and "OBJECT" in parsed:
                    expr = str(parsed["OBJECT"])
            results = tracker.run_on_list_of_images(
                list(sample.frames), [expr]
            )
            siou = iou_per_video(results, sample.inter_idx, sample.img2box)
            sious.append(siou)
            per_sample.append(
                {
                    "video_id": sample.video_id,
                    "caption": question,
                    "answer": answer,
                    "referring_expression": expr,
                    "sIoU": siou,
                }
            )
            if output_dir:
                os.makedirs(output_dir, exist_ok=True)
                with open(
                    os.path.join(output_dir, f"{sample.video_id}.json"), "w"
                ) as f:
                    json.dump(per_sample[-1], f)
        except Exception as e:  # noqa: BLE001 — reference behavior
            print(f"Error processing sample {i}: {e}")
    m_siou = float(np.mean(sious)) if sious else 0.0
    return {"m_sIoU": m_siou, "num_samples": len(sious),
            "per_sample": per_sample}
