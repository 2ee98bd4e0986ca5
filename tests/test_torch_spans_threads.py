"""utils/trace_tools' span recorder across threads: two threads run the
tiny engine's generate_tokens at once, each inside its own outer span;
each thread's ``generate.*`` spans take its own outer span as parent and
tile its call."""

import threading

from torch_spans_tiny import (
    check_tiling,
    greedy,
    opened,
    recording,
    run,
    tiny_engine,
)
from video_llava_tpu_torch.utils import trace_tools


def test_threads_keep_their_own_parents():
    engine = tiny_engine()
    barrier = threading.Barrier(2, timeout=60)
    errors = []

    def work(i):
        try:
            with opened(f"thread{i}"):
                barrier.wait()
                run(engine, greedy(4 + i))
                barrier.wait()
        except Exception as e:  # reported by the main thread
            errors.append(e)

    with recording():
        threads = [threading.Thread(target=work, args=(i,))
                   for i in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
            assert not t.is_alive()
        spans = trace_tools.drain()
    assert not errors
    outers = {s.name: s for s in spans if s.name.startswith("thread")}
    for i in range(2):
        outer = outers[f"thread{i}"]
        mine = [s for s in spans if s.parent == outer.id]
        assert len(mine) == 1 + (4 + i) - 1
        check_tiling(mine, outer)
    assert len(spans) == 2 + 4 + 5
