"""Entity matching: map phrases in the LLM answer to the tag vocabulary.

Counterpart of video_llava_tpu/grounding/entity_matching.py.

Parity: reference EntityMatchingModule (grounding_evaluation/util/
entity_matching_openai.py:24-184) — a few-shot chat prompt asks an
OpenAI-compatible model to pair text spans with list entities in
"span - entity" lines; the response is parsed into highlight spans and
a {phrase: tag} match_state. We keep the line protocol and the parsing/
highlight semantics; the endpoint is any OpenAI-compatible server
(including our own serving layer).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

from video_llava_tpu_torch.eval.openai_client import ChatCompletionClient

SYSTEM_PROMPT = (
    "You are a helpful assistant. I will give you a list of entities and a"
    " paragraph or sentence. First extract entity phrases that appear in the"
    " text, then find for each one the entity with similar or identical"
    " meaning in the given list. Find all the pairs. The extracted phrases"
    " must come from the given text and the corresponding entity must come"
    " from the given list. If multiple entities can be linked to the same"
    " span of text or vice versa, keep just one and do not merge them."
    " Answer with one pair per line in the form: phrase - entity"
)

FEW_SHOT: List[Tuple[str, str]] = [
    (
        "<List>['dog', 'grass', 'field', 'grassy', 'corgi', 'brown dog',"
        " 'park']</List>"
        "<Text>A brown dog running in the grassy field</Text>",
        "brown dog - brown dog\ngrassy field - field",
    ),
    (
        "<List>['man', 'ride', 'bicycle', 'red', 'passenger train',"
        " 'track']</List>"
        "<Text>A man riding a bicycle next to a red passenger train on the"
        " tracks.</Text>",
        "man - man\nbicycle - bicycle\n"
        "red passenger train - passenger train\ntracks - track",
    ),
    (
        "<List>['horse', 'herd', 'dust', 'grassy', 'field']</List>"
        "<Text>The image shows a large herd of wild horses running across a"
        " wide, open field. The horses are brown and white.</Text>",
        "herd - herd\nwild horses - horse\nfield - field",
    ),
]


def parse_match_response(
    answer: str, text: str, entity_list: Sequence[str]
) -> Tuple[List[Tuple[str, Optional[str]]], Dict[str, str]]:
    """Reference parsing semantics (entity_matching_openai.py:144-184):
    keep 'phrase - entity' lines whose entity is in the list, locate the
    phrase in the text, build ordered non-overlapping highlight spans."""
    res = []
    match_state: Dict[str, str] = {}
    for line in answer.split("\n"):
        if " - " not in line:
            continue
        name, ref = line.split(" - ", maxsplit=1)
        name, ref = name.strip().lower(), ref.strip().lower()
        if ref not in entity_list:
            continue
        match_state[name] = ref
        idx = text.lower().find(name)
        if idx == -1:
            continue
        res.append((name, ref, idx))
    res.sort(key=lambda x: x[2])

    highlight: List[Tuple[str, Optional[str]]] = []
    prev = 0
    for i, (name, ref, idx) in enumerate(res):
        if idx < prev:
            continue  # avoid one-vs-many overlaps
        if idx != prev:
            highlight.append((text[prev:idx], None))
        highlight.append((text[idx : idx + len(name)], f"{i + 1}"))
        prev = idx + len(name)
    if prev < len(text):
        highlight.append((text[prev:], None))
    return highlight, match_state


class EntityMatchingModule:
    def __init__(
        self,
        model: str = "gpt-3.5-turbo",
        client: Optional[ChatCompletionClient] = None,
    ):
        self.model = model
        self.client = client or ChatCompletionClient()

    def __call__(self, text: str, entity_list: Sequence[str]):
        messages = [{"role": "system", "content": SYSTEM_PROMPT}]
        for q, a in FEW_SHOT:
            messages.append({"role": "user", "content": q})
            messages.append({"role": "system", "content": a})
        messages.append(
            {
                "role": "user",
                "content": f"<List>{list(entity_list)}<List><Text>{text}</Text>",
            }
        )
        answer = self.client.chat_text(self.model, messages)
        return parse_match_response(answer, text, entity_list)
