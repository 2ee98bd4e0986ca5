"""Device-accurate timing on the card.

Counterpart of video_llava_tpu/utils/timing.py. CUDA launches return
before the device has run them, so a wall-clock time must wait for the
device: :func:`sync` does, through torch.cuda.synchronize on the device
of the output. `measure` syncs every iteration and subtracts the sync's
own round trip; `measure_amortized` syncs once. :func:`median_ms` and
:func:`rotating_ms` are device times from CUDA-graph replays timed with
CUDA events, with no host overhead (chip_smoke.py's kernel times).
"""

from __future__ import annotations

import statistics
import time
from typing import Callable, Optional

import numpy as np
import torch


def _first_tensor(out) -> Optional[torch.Tensor]:
    """The first tensor leaf of any nesting of lists, tuples and dicts
    (NamedTuples included), in order."""
    if isinstance(out, torch.Tensor):
        return out
    if isinstance(out, dict):
        out = list(out.values())
    if isinstance(out, (list, tuple)):
        for x in out:
            t = _first_tensor(x)
            if t is not None:
                return t
    return None


def sync(out) -> None:
    """Block until `out` (a tensor, or any nesting of lists, tuples and
    dicts of them) is computed: torch.cuda.synchronize on the device of
    its first tensor. A CPU tensor is ready when it is returned, so
    nothing waits then."""
    x = _first_tensor(out)
    if x is not None and x.device.type == "cuda":
        torch.cuda.synchronize(x.device)


def fetch_rtt(device=None) -> float:
    """Median seconds of one synchronize of an idle `device` (0 work):
    the round trip that each timed iteration of :func:`measure` adds.
    On the CPU, the cost of the no-op sync."""
    z = torch.zeros((), device=device)
    sync(z + 0)
    ts = []
    for _ in range(5):
        t0 = time.perf_counter()
        sync(z)
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts))


def measure(fn: Callable[[int], object], iters: int = 5, warmup: int = 1
            ) -> float:
    """True per-iteration MEDIAN seconds of `fn(i)`: every iteration is
    individually synchronized and corrected for the sync's round trip.
    Use for headline latency numbers (a real p50).

    fn must return tensors (any nesting); iterations may differ in an
    argument (e.g. a generator seed) so nothing is reused."""
    device = None
    for i in range(warmup):
        out = fn(i)
        sync(out)
        x = _first_tensor(out)
        device = x.device if x is not None else device
    rtt = fetch_rtt(device)
    ts = []
    for i in range(iters):
        t0 = time.perf_counter()
        sync(fn(1000 + i))
        ts.append(max(time.perf_counter() - t0 - rtt, 1e-9))
    return float(np.median(ts))


def measure_amortized(fn: Callable[[int], object], iters: int = 5,
                      warmup: int = 1) -> float:
    """MEAN per-iteration seconds: launches all iterations and syncs once
    at the end. Lower overhead than `measure` for very short ops (one
    round trip in all), but it is a mean, not a percentile."""
    device = None
    for i in range(warmup):
        out = fn(i)
        sync(out)
        x = _first_tensor(out)
        device = x.device if x is not None else device
    rtt = fetch_rtt(device)
    t0 = time.perf_counter()
    outs = [fn(1000 + i) for i in range(iters)]
    # a device runs a stream in order: syncing the last output waits for
    # every launched iteration
    sync(outs[-1])
    total = time.perf_counter() - t0 - rtt
    return max(total, 1e-9) / iters


def median_ms(fn, calls: int = 10, reps: int = 7,
              capture: bool = True) -> float:
    """Device time of one call: `calls` calls captured in a CUDA graph,
    the graph replayed `reps` times, each replay timed with CUDA events;
    the median over replays, per call. A replay launches back to back,
    so the host's Python overhead around each call (tens of µs, more
    than a decode-sized kernel takes) is not counted. capture=False (an
    autograd backward, which is not captured): the `calls` calls
    launched back to back, each rep timed the same way, so the host
    counts only where it falls behind a call's device time."""
    fn()
    torch.cuda.synchronize()
    if not capture:
        times = []
        for _ in range(reps):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(calls):
                fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end) / calls)
        return statistics.median(times)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    del graph
    return statistics.median(times)


def rotating_ms(fns) -> float:
    """Device time of one call that reads its operands from HBM, not L2:
    `fns` are the same call on different copies (layers) of the operands,
    together past the 50 MB L2, captured one after another in one graph;
    the replay's median time (median_ms) over len(fns)."""
    return median_ms(lambda: [f() for f in fns], calls=1) / len(fns)
