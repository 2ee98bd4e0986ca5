"""utils/trace_tools' span recorder in the engine's decode loop, on the
tiny configuration on the CPU: off, nothing is recorded; on, a batch
gives one ``generate.prefill`` and one ``generate.decode_step`` a loop
iteration (answer length - 1), which tile the call in order under the
span open around it, and greedy tokens are bit-identical on and off.
Also the keyword loop's spans and a span left open by an exception
inside an enclosing span."""

import pytest
import torch

from torch_spans_tiny import (
    check_tiling,
    greedy,
    opened,
    prompts,
    recording,
    run,
    tiny_engine,
)
from video_llava_tpu_torch.engine.generate import generate_with_keywords
from video_llava_tpu_torch.utils import trace_tools


@pytest.fixture(scope="module")
def engine():
    return tiny_engine()


def test_generate_spans_tile_the_call(engine):
    """Cases (max_new_tokens, rows, stop): 1 token (no loop iteration:
    the prefill ends at the loop's return), 5 tokens over 2 rows, and 8
    tokens for a row that stops on the id it greedily emits at index 3,
    so the loop's head read of `done` ends it early."""
    for max_new, b, stop_at in ((1, 2, None), (5, 2, None), (8, 1, 3)):
        gen = greedy(max_new)
        trace_tools.enable(False)
        if stop_at is not None:
            gen = greedy(max_new, eos=int(run(engine, gen, b).tokens[
                0, stop_at]))
        with opened("call"):
            off = run(engine, gen, b)
        assert trace_tools.drain() == [], "recorded while off"
        with recording():
            with opened("call"):
                on = run(engine, gen, b)
            spans = trace_tools.drain()
        assert torch.equal(on.tokens, off.tokens)
        assert torch.equal(on.lengths, off.lengths)
        outer, inner = spans[0], spans[1:]
        assert outer.name == "call" and outer.parent is None
        answer = int(on.lengths.max())
        assert answer < max_new if stop_at is not None else (
            answer == max_new)
        assert len(inner) == 1 + answer - 1, (max_new, answer)
        check_tiling(inner, outer)


def test_keyword_loop_records_prefill_and_steps(engine):
    """generate_with_keywords: its first chunk ends the prefill span;
    each chunk's last step ends at the chunk's copy to the host, and the
    forward between chunks is a step of its own, so the call records
    one step a decode forward (answer - 1). Only the host's keyword
    check between chunks lies outside the spans."""
    ids, lens = prompts(b=1)
    with recording():
        with opened("chat"):
            _, res = generate_with_keywords(
                engine.model, greedy(7), ids, lens[:1], None, None,
                decode_fn=lambda t: "", keyword_check_every=3)
        spans = trace_tools.drain()
    outer, inner = spans[0], spans[1:]
    assert outer.name == "chat"
    assert int(res.lengths[0]) == 7
    # chunks of 3, 3 and 1 tokens: 2 + 1 + 2 + 1 + 0 forwards
    assert [s.name for s in inner] == (["generate.prefill"]
                                       + ["generate.decode_step"] * 6)
    assert all(s.parent == outer.id for s in inner)
    # tiled within a chunk; the keyword check after steps 2 and 5
    gaps = [c.start_ns - a.end_ns for a, c in zip(inner, inner[1:])]
    assert all(g >= 0 for g in gaps)
    assert [g for i, g in enumerate(gaps) if i not in (2, 5)] == [0] * 4
    assert outer.start_ns <= inner[0].start_ns
    assert inner[-1].end_ns <= outer.end_ns


def test_exception_drops_spans_left_open():
    """A span left open by an exception ends unrecorded when the span
    around it ends; later spans take the right parent."""
    with recording():
        with pytest.raises(RuntimeError):
            with opened("outer"):
                trace_tools.begin("orphan")
                raise RuntimeError
        with opened("next"):
            trace_tools.end(trace_tools.begin("child"))
        spans = trace_tools.drain()
    assert [s.name for s in spans] == ["outer", "next", "child"]
    assert spans[0].parent is None and spans[1].parent is None
    assert spans[2].parent == spans[1].id
    assert trace_tools.drain() == []
    assert trace_tools.begin("off") is None
