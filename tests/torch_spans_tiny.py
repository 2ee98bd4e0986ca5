"""Shared by the span tests (tests/test_torch_spans*.py): the tiny
configuration's engine on the CPU, its prompts and greedy settings, the
recorder turned on for a block, a span around a block, and the check
that a call's spans tile it."""

import contextlib

import numpy as np
import torch

from video_llava_tpu_torch.config import GenerationConfig
from video_llava_tpu_torch.runtime.model_init import initialize_model
from video_llava_tpu_torch.utils import trace_tools

MAX_GAP_NS = 100_000


def tiny_engine(seed=0):
    return initialize_model(model_size="tiny", device="cpu", seed=seed,
                            dtype=torch.float32)


@contextlib.contextmanager
def recording():
    """The recorder on and empty inside the block; off and empty after."""
    trace_tools.drain()
    trace_tools.enable()
    try:
        yield
    finally:
        trace_tools.enable(False)


@contextlib.contextmanager
def opened(name):
    """A recorder span around the block, ended if the block raises."""
    sp = trace_tools.begin(name)
    try:
        yield
    finally:
        trace_tools.end(sp)


def prompts(b=2, s=16, seed=0):
    """(b, s) right-padded ids and their lengths (s, s - 3, ...)."""
    rng = np.random.default_rng(seed)
    ids = torch.from_numpy(rng.integers(3, 30000, (b, s)))
    lens = torch.tensor([s - 3 * r for r in range(b)], dtype=torch.int32)
    for r in range(b):
        ids[r, int(lens[r]):] = 0
    return ids, lens


def greedy(max_new, eos=-1):
    return GenerationConfig(max_new_tokens=max_new, temperature=0.0,
                            do_sample=False, eos_token_id=eos,
                            pad_token_id=0)


def run(engine, gen, b=2):
    ids, lens = prompts(b)
    return engine.generate_tokens(ids, lens, None, gen, seed=0,
                                  speculative=False)


def check_tiling(spans, outer):
    """`spans` are one prefill, then decode steps, each starting where
    the last ended (within MAX_GAP_NS), all inside `outer` and under
    it."""
    assert spans[0].name == "generate.prefill"
    assert all(s.name == "generate.decode_step" for s in spans[1:])
    assert outer.start_ns <= spans[0].start_ns
    assert spans[-1].end_ns <= outer.end_ns
    for a, c in zip(spans, spans[1:]):
        assert a.end_ns <= c.start_ns <= a.end_ns + MAX_GAP_NS
    for s in spans:
        assert s.start_ns <= s.end_ns
        assert s.parent == outer.id
