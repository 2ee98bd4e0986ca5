"""utils/trace_tools' span recorder when the engine's generate raises
with no span around the call (a serving thread's failed request): the
spans the call left open are dropped, so the thread's later spans take
the right parent, and a failure in the prefill or in a decode step
records only what had ended before it."""

import pytest

from torch_spans_tiny import (
    check_tiling,
    greedy,
    opened,
    recording,
    run,
    tiny_engine,
)
from video_llava_tpu_torch.utils import trace_tools


def test_failed_call_leaves_no_span_open(monkeypatch):
    engine = tiny_engine()
    llm = engine.model.llm
    decode_step = llm.decode_step
    calls = {"n": 0}

    def fail_second(*args, **kwargs):
        calls["n"] += 1
        if calls["n"] == 2:
            raise RuntimeError("decode step")
        return decode_step(*args, **kwargs)

    def fail(*args, **kwargs):
        raise RuntimeError("prefill")

    for where, target, fn, ended in (
            ("prefill", engine.model, fail, []),
            ("decode", llm, fail_second,
             ["generate.prefill", "generate.decode_step"])):
        with recording():
            with monkeypatch.context() as m:
                m.setattr(target, where == "prefill" and "prefill"
                          or "decode_step", fn)
                with pytest.raises(RuntimeError, match=where[:6]):
                    run(engine, greedy(5))
            assert trace_tools._STACK.open == []
            with opened("next"):
                run(engine, greedy(3))
            spans = trace_tools.drain()
        failed = [s for s in spans if s.parent is None and s.name != "next"]
        assert [s.name for s in failed] == ended, where
        nxt = next(s for s in spans if s.name == "next")
        assert nxt.parent is None
        mine = [s for s in spans if s.parent == nxt.id]
        assert len(mine) == 3
        check_tiling(mine, nxt)
