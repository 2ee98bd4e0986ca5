"""Conversation state and prompt templates, as
video_llava_tpu/runtime/conversation.py builds them: both packages must
give the same prompt string byte for byte
(tests/test_torch_conversation_parity.py), since the token ids follow
from it."""

from __future__ import annotations

import dataclasses
import enum
from typing import List, Optional, Tuple


class SeparatorStyle(enum.Enum):
    SINGLE = enum.auto()
    TWO = enum.auto()


@dataclasses.dataclass
class Conversation:
    system: str
    roles: Tuple[str, ...]
    messages: List[List[Optional[str]]]
    sep_style: SeparatorStyle = SeparatorStyle.SINGLE
    sep: str = "###"
    sep2: Optional[str] = None
    version: str = "Unknown"  # "v1": train/data.preprocess takes preprocess_v1

    def get_prompt(self) -> str:
        """SINGLE ends every turn with sep; TWO alternates sep and
        sep2. A message may be a (text, video_path) tuple."""
        seps = ([self.sep, self.sep2] if self.sep_style == SeparatorStyle.TWO
                else [self.sep, self.sep])
        ret = self.system + seps[0]
        for i, (role, message) in enumerate(self.messages):
            if message:
                if isinstance(message, tuple):
                    message = message[0]
                ret += role + ": " + message + seps[i % 2]
            else:
                ret += role + ":"
        return ret

    def append_message(self, role: str, message) -> None:
        self.messages.append([role, message])

    def stop_string(self) -> str:
        """The keyword-stop string for this template."""
        return self.sep2 if self.sep_style == SeparatorStyle.TWO else self.sep

    def copy(self) -> "Conversation":
        return dataclasses.replace(
            self, messages=[[r, m] for r, m in self.messages])


conv_v1_2 = Conversation(
    system=(
        "A chat between a curious human and an artificial intelligence"
        " assistant. The assistant gives helpful, detailed, and polite"
        " answers to the human's questions."
    ),
    roles=("Human", "Assistant"),
    messages=[
        [
            "Human",
            "What are the key differences between renewable and"
            " non-renewable energy sources?",
        ],
        [
            "Assistant",
            "Renewable energy sources are those that can be replenished"
            " naturally.\n",
        ],
    ],
    sep_style=SeparatorStyle.SINGLE,
    sep="###",
)

conv_vicuna_v1_1 = Conversation(
    system=(
        "A chat between a curious user and an artificial intelligence"
        " assistant. The assistant gives helpful, detailed, and polite"
        " answers to the user's questions."
    ),
    roles=("USER", "ASSISTANT"),
    version="v1",
    messages=[],
    sep_style=SeparatorStyle.TWO,
    sep=" ",
    sep2="</s>",
)

_VIDEO_SYSTEM = (
    " a large vision-language assistant. "
    "You are able to understand the video content that the user"
    " provides, and assist the user with a variety of tasks using"
    " natural language."
    "Follow the instructions carefully and explain your answers in"
    " detail based on the provided video."
)

conv_video_chatgpt_v1 = dataclasses.replace(
    conv_vicuna_v1_1, messages=[],
    system="You are Video-ChatGPT," + _VIDEO_SYSTEM)
conv_pg_video_llava = dataclasses.replace(
    conv_vicuna_v1_1, messages=[],
    system="You are PG-Video-LLaVA," + _VIDEO_SYSTEM)

default_conversation = conv_v1_2
conv_templates = {
    "default": conv_v1_2,
    "video-chatgpt_v1": conv_video_chatgpt_v1,
    "vicuna_v1_1": conv_vicuna_v1_1,
    "pg-video-llava": conv_pg_video_llava,
}
