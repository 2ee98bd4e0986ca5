"""Port parity of the chat slice: a second chat turn reuses the video."""

import numpy as np

from torch_slice_pair import slice_pair  # noqa: F401 (fixture)
from video_llava_tpu.runtime.chat import VideoChatGPTInterface as JaxInterface
from video_llava_tpu_torch.media.loader import encode_video
from video_llava_tpu_torch.runtime.chat import VideoChatGPTInterface


def test_chat_second_turn_matches_jax(slice_pair, tmp_path):
    """A second turn reuses the uploaded video and the history."""
    jax_engine, engine = slice_pair
    rng = np.random.default_rng(1)
    path = str(tmp_path / "clip.mp4")
    encode_video(path, rng.integers(0, 256, size=(5, 64, 64, 3),
                                    dtype=np.uint8), fps=4, codec="mpeg4")
    answers = []
    for iface in (JaxInterface(jax_engine, temperature=0.0,
                               max_output_tokens=5),
                  VideoChatGPTInterface(engine, temperature=0.0,
                                        max_output_tokens=5)):
        iface.upload_video(path)
        iface.add_text("What is happening?", path)
        first = iface.answer()
        iface.add_text("And then?", path)
        answers.append((first, iface.answer(), iface.state.get_prompt()))
    assert answers[0] == answers[1]
