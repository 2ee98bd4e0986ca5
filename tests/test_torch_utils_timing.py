"""utils/timing.py beside the JAX package's: sync finds the first tensor
leaf of nested lists, tuples, dicts and NamedTuples and waits on the
card only for a CUDA tensor (torch.cuda.synchronize is recorded here,
not called); measure (a per-iteration median) and measure_amortized (a
mean) of a sleep within 20% of it in both packages, on a fake clock
(tests/torch_fake_clock.py) put under `time` in both timing modules: a
reading costs one tick and the sleep advances the clock, so both
packages' median, mean and sync round trip (the rtt each measurement
subtracts) equal the sleep and the tick exactly, whatever the host's
load."""

from typing import NamedTuple

import jax.numpy as jnp
import torch

from torch_fake_clock import FakeClock
from video_llava_tpu.utils import timing as jtiming
from video_llava_tpu_torch.utils import timing


class Pair(NamedTuple):
    a: object
    b: object


def test_sync_and_measure_match_jax(monkeypatch):
    x, y = torch.zeros(2), torch.ones(3)
    for nested, want in (([], None), ({}, None), ((None, [3, "a"]), None),
                         (x, x), ([[], (x, y)], x), ({"k": [{}, (y, x)]}, y),
                         (Pair(None, {"z": [x]}), x),
                         ({"a": (), "b": {"c": y}}, y)):
        assert timing._first_tensor(nested) is want
    calls = []
    monkeypatch.setattr(torch.cuda, "synchronize", calls.append)
    for nested in ([], x, {"k": [(y,)]}, Pair(x, y)):
        timing.sync(nested)
    assert calls == []

    clock = FakeClock()
    monkeypatch.setattr(timing, "time", clock)
    monkeypatch.setattr(jtiming, "time", clock)
    sleep = 2.0 ** -6  # 15.625 ms: exact in binary, as the tick is

    def torch_fn(i):
        clock.sleep(sleep)
        return {"out": [torch.full((2,), float(i))]}

    def jax_fn(i):
        clock.sleep(sleep)
        return {"out": [jnp.full((2,), float(i))]}

    for measure in ("measure", "measure_amortized"):
        got = getattr(timing, measure)(torch_fn, iters=5)
        want = getattr(jtiming, measure)(jax_fn, iters=5)
        for t in (got, want):
            assert abs(t - sleep) <= 0.2 * sleep, (measure, t)
            assert t == sleep, (measure, t)
    for rtt in (timing.fetch_rtt(), jtiming.fetch_rtt()):
        assert 0.0 <= rtt < 0.01
        assert rtt == clock.TICK
