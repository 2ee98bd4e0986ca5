"""The grounding builders put their models on the card unless the caller
asks for the CPU: the default `device` of GroundingDINO's build_detector,
build_sam, build_tagger (which drew their weights on the CPU before) and
of the stack's other builders is "cuda". Checked by reading the
signatures, so no card is needed."""

import inspect

from video_llava_tpu_torch.grounding import builders
from video_llava_tpu_torch.models import grounding_dino


def test_grounding_builders_default_to_the_card():
    for fn in (grounding_dino.build_detector, builders.build_sam,
               builders.build_tagger, builders.build_grounding_stack,
               builders.build_clip_filter, builders.random_clip_filter,
               builders.build_xmem_propagator):
        default = inspect.signature(fn).parameters["device"].default
        assert default == "cuda", (fn.__qualname__, default)
